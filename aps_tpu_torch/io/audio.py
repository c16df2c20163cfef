#!/usr/bin/env python
"""Audio IO: wav read/write and the kaldi-style wav.scp reader (the port's
own copy of what it needs from aps_tpu/io/audio.py: read_audio,
write_audio, AudioReader). The wav.scp value grammar is the same: plain
paths, "cmd ... |" pipes and "file.ark:offset" archives."""

import io
import os
import subprocess
import warnings
from typing import IO, Any, Dict, Optional, Union

import numpy as np

from aps_tpu_torch.io.base import BaseReader
from aps_tpu_torch.io.wav import wav_read, wav_read_header, wav_write

__all__ = ["read_audio", "write_audio", "AudioReader"]


def read_audio(fname: Union[str, IO[Any]],
               beg: int = 0,
               end: Optional[int] = None,
               norm: bool = True,
               sr: int = 16000) -> np.ndarray:
    """Read audio -> C x N (multi-channel) or N, float32."""
    samps, ret_sr = wav_read(fname, beg=beg, end=end, norm=norm)
    if sr > 0 and sr != ret_sr:
        raise RuntimeError(f"Expect sr={sr} of {fname}, get {ret_sr} instead")
    if samps.ndim != 1:
        samps = np.transpose(samps)
    return samps


def write_audio(fname: Union[str, IO[Any]],
                samps: np.ndarray,
                sr: int = 16000,
                norm: bool = True) -> None:
    """Write 16-bit PCM; accepts C x S or S (channel-major gets
    transposed)."""
    samps = np.asarray(samps, dtype=np.float32)
    if samps.ndim != 1 and samps.shape[0] < samps.shape[1]:
        samps = np.squeeze(np.transpose(samps))
    if isinstance(fname, str):
        parent = os.path.dirname(fname)
        if parent:
            os.makedirs(parent, exist_ok=True)
    wav_write(fname, samps, sr=sr, norm=norm)


class AudioReader(BaseReader):
    """Random/sequential reader over a kaldi wav.scp. Three value forms:
      plain path        /path/to/utt.wav
      shell pipe        sox /path/utt.wav -t wav - remix 1 |
      archive offset    /path/to/wav.ark:51243
    Archive handles are opened once and kept for the reader's lifetime."""

    def __init__(self,
                 wav_scp: str,
                 sr: int = 16000,
                 norm: bool = True,
                 channel: int = -1,
                 failed_if_error: bool = True) -> None:
        super(AudioReader, self).__init__(wav_scp, num_tokens=2)
        self.sr = sr
        self.ch = channel
        self.norm = norm
        self.failed_if_error = failed_if_error
        self._ark_handles: Dict[str, IO[Any]] = {}

    @staticmethod
    def _is_pipe(value: str) -> bool:
        return value.endswith("|")

    @staticmethod
    def _is_ark(value: str) -> bool:
        return ".ark:" in value

    def _open_ark(self, value: str) -> IO[Any]:
        """"file.ark:offset" -> cached handle seeked to the wav payload."""
        path, _, offset = value.rpartition(":")
        if not path or ":" in path:
            raise RuntimeError(f"Value format error: {value}")
        if path not in self._ark_handles:
            self._ark_handles[path] = open(path, "rb")
        handle = self._ark_handles[path]
        handle.seek(int(offset))
        return handle

    @staticmethod
    def _run_pipe(value: str) -> IO[Any]:
        """Run the "cmd ... |" form, buffer its stdout as a wav stream."""
        proc = subprocess.run(value[:-1], shell=True, capture_output=True)
        if proc.returncode != 0:
            raise RuntimeError(f"Command \"{value[:-1]}\" failed:\n"
                               f"{proc.stderr.decode()}")
        return io.BytesIO(proc.stdout)

    def _load(self, key: str) -> Optional[np.ndarray]:
        value = self.index_dict[key]
        if self._is_ark(value):
            stream = self._open_ark(value)
        elif self._is_pipe(value):
            stream = self._run_pipe(value)
        else:
            stream = value
        try:
            samps = read_audio(stream, norm=self.norm, sr=self.sr)
        except RuntimeError:
            if self.failed_if_error:
                raise
            warnings.warn(f"Failed to read audio {key}: {value}")
            return None
        if self.ch >= 0 and samps.ndim == 2:
            samps = samps[self.ch]
        return samps

    def nsamps(self, key: str) -> int:
        value = self.index_dict[key]
        # header-only fast path for plain files
        if not self._is_ark(value) and not self._is_pipe(value):
            return wav_read_header(value).num_frames
        return self._load(key).shape[-1]

    def duration(self, key: str) -> float:
        return self.nsamps(key) / self.sr
