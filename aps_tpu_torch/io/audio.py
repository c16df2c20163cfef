#!/usr/bin/env python
"""Audio IO: wav read/write, the kaldi-style wav.scp reader and RIR
convolution (the port's own copy of what it needs from
aps_tpu/io/audio.py: read_audio, write_audio, add_room_response,
AudioReader, group_segments, SegmentAudioReader). The wav.scp value grammar
is the same: plain paths, "cmd ... |" pipes and "file.ark:offset"
archives."""

import io
import os
import subprocess
import warnings
from collections import defaultdict
from typing import IO, Any, Dict, Optional, Union

import numpy as np
import scipy.signal as ss

from aps_tpu_torch.io.base import BaseReader
from aps_tpu_torch.io.wav import wav_read, wav_read_header, wav_write

__all__ = [
    "read_audio", "write_audio", "add_room_response", "AudioReader",
    "SegmentAudioReader", "group_segments"
]


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


def _direct_path_rir(rir_ch0: np.ndarray, sr: int,
                     keep_duration: float) -> np.ndarray:
    """Zero the RIR tail: keep [peak - 1ms, peak + keep_duration) around
    the direct-path arrival, so convolving with it yields the early
    (non-reverberant) image."""
    peak = int(np.argmax(rir_ch0))
    lo = max(0, peak - int(0.001 * sr))
    hi = min(rir_ch0.size, peak + int(keep_duration * sr))
    kept = np.zeros_like(rir_ch0)
    kept[lo:hi] = rir_ch0[lo:hi]
    return kept


def add_room_response(spk: np.ndarray,
                      rir: np.ndarray,
                      early_energy: bool = False,
                      early_revb_duration: float = 0.05,
                      sr: int = 16000):
    """Convolve a close-talk signal with (multi-channel) RIRs.
    spk: S; rir: N x R -> (revb N x S, early_revb or None, power).
    Power is the channel-0 mean square — of the early image when
    early_energy is set, of the full reverberant image otherwise."""
    spk = np.asarray(spk)
    if spk.ndim != 1:
        raise RuntimeError(f"Can not convolve rir with {spk.ndim}D signals")
    rir = np.atleast_2d(np.asarray(rir))
    # FFT convolution: all channels at once, O(R log R) per sample block
    wet = ss.fftconvolve(rir, spk[None, :], axes=-1)[:, :spk.size]
    wet = np.ascontiguousarray(wet)
    if not early_energy:
        return wet, None, float(np.mean(wet[0]**2))
    early = ss.fftconvolve(_direct_path_rir(rir[0], sr, early_revb_duration),
                           spk)[:spk.size]
    return wet, early, float(np.mean(early**2))


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


def group_segments(segment: str, sr: int, wav_scp: str = "") -> Dict:
    """Group a kaldi segments file ("seg utt beg end") by utterance key."""
    seg_reader = BaseReader(
        segment, num_tokens=4,
        value_processor=lambda x: (x[0], float(x[1]), float(x[2])))
    wav_reader = BaseReader(wav_scp, num_tokens=2) if wav_scp else None
    grouped = defaultdict(list)
    for seg_key, (utt_key, beg, end) in seg_reader:
        if wav_reader is not None and utt_key not in wav_reader:
            continue
        grouped[utt_key].append((seg_key, int(sr * beg), int(sr * end)))
    return grouped


class SegmentAudioReader(object):
    """Sequential reader over (wav.scp, segments)."""

    def __init__(self,
                 wav_scp: str,
                 segment: str,
                 sr: int = 16000,
                 norm: bool = True,
                 channel: int = -1):
        self.audio_reader = AudioReader(wav_scp, sr=sr, norm=norm,
                                        channel=channel)
        self.segment = group_segments(segment, sr, wav_scp=wav_scp)

    def __len__(self):
        return sum(len(v) for v in self.segment.values())

    def __iter__(self):
        for utt_key in self.segment:
            audio = self.audio_reader[utt_key]
            for seg_key, beg, end in self.segment[utt_key]:
                yield seg_key, audio[..., beg:end]
