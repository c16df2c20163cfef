#!/usr/bin/env python
"""Minimal RIFF/WAVE codec (the port's own copy of aps_tpu/io/wav.py).
Supports PCM16/PCM32/IEEE-float, mono/multi-channel, chunk-range reads and file-like objects (needed for
"file.ark:offset" and piped "cmd |" wav.scp entries)."""

import struct
from typing import IO, Optional, Tuple, Union

import numpy as np

WAVE_FORMAT_PCM = 0x0001
WAVE_FORMAT_IEEE_FLOAT = 0x0003
WAVE_FORMAT_EXTENSIBLE = 0xFFFE


class WavInfo(object):

    def __init__(self, sr, num_channels, num_frames, bits, fmt, data_offset):
        self.sr = sr
        self.num_channels = num_channels
        self.num_frames = num_frames
        self.bits = bits
        self.fmt = fmt
        self.data_offset = data_offset


def _parse_header(fd: IO) -> WavInfo:
    base = fd.tell()
    riff = fd.read(12)
    if len(riff) != 12 or riff[:4] != b"RIFF" or riff[8:12] != b"WAVE":
        raise RuntimeError("Not a RIFF/WAVE file")
    fmt = None
    while True:
        hdr = fd.read(8)
        if len(hdr) < 8:
            raise RuntimeError("Missing data chunk in WAVE file")
        chunk_id, size = hdr[:4], struct.unpack("<I", hdr[4:])[0]
        if chunk_id == b"fmt ":
            body = fd.read(size)
            (audio_fmt, num_channels, sr, _, block_align,
             bits) = struct.unpack("<HHIIHH", body[:16])
            if audio_fmt == WAVE_FORMAT_EXTENSIBLE and size >= 40:
                audio_fmt = struct.unpack("<H", body[24:26])[0]
            fmt = (audio_fmt, num_channels, sr, block_align, bits)
        elif chunk_id == b"data":
            if fmt is None:
                raise RuntimeError("Malformed WAVE: data before fmt")
            audio_fmt, num_channels, sr, block_align, bits = fmt
            # streamed files may carry size 0 / 0xffffffff: infer from file
            if size in (0, 0xFFFFFFFF):
                cur = fd.tell()
                fd.seek(0, 2)
                size = fd.tell() - cur
                fd.seek(cur)
            num_frames = size // (num_channels * (bits // 8))
            return WavInfo(sr, num_channels, num_frames, bits, audio_fmt,
                           fd.tell())
        else:
            fd.seek(size + (size & 1), 1)


def _decode(raw: bytes, info: WavInfo, norm: bool) -> np.ndarray:
    if info.fmt == WAVE_FORMAT_IEEE_FLOAT:
        data = np.frombuffer(raw, dtype="<f4" if info.bits == 32 else "<f8")
        data = data.astype(np.float32)
        if not norm:
            data = data * 32768.0
    elif info.bits == 16:
        data = np.frombuffer(raw, dtype="<i2")
        data = data.astype(np.float32) / (32768.0 if norm else 1.0)
    elif info.bits == 32:
        data = np.frombuffer(raw, dtype="<i4")
        data = data.astype(np.float32) / (2147483648.0 if norm else 65536.0)
    elif info.bits == 8:
        data = np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0
        data = data / (128.0 if norm else 1 / 256.0)
    else:
        raise RuntimeError(f"Unsupported PCM width: {info.bits}")
    if info.num_channels > 1:
        data = data.reshape(-1, info.num_channels)
    return data


def wav_read_header(fobj: Union[str, IO]) -> WavInfo:
    if isinstance(fobj, str):
        with open(fobj, "rb") as fd:
            return _parse_header(fd)
    return _parse_header(fobj)


def wav_read(fobj: Union[str, IO],
             beg: int = 0,
             end: Optional[int] = None,
             norm: bool = True) -> Tuple[np.ndarray, int]:
    """Read samples (frames [beg, end)) -> (samps T or T x C, sr)."""

    def impl(fd):
        info = _parse_header(fd)
        stop = info.num_frames if end is None else min(end, info.num_frames)
        width = info.num_channels * (info.bits // 8)
        if beg:
            fd.seek(beg * width, 1)
        raw = fd.read(max(stop - beg, 0) * width)
        return _decode(raw, info, norm), info.sr

    if isinstance(fobj, str):
        with open(fobj, "rb") as fd:
            return impl(fd)
    return impl(fobj)


def wav_write(fobj: Union[str, IO],
              samps: np.ndarray,
              sr: int = 16000,
              norm: bool = True) -> None:
    """Write PCM16 WAVE. samps: T or T x C float32; norm=True means samples
    are in [-1, 1] and get scaled to int16."""
    if samps.ndim == 1:
        num_channels = 1
    else:
        num_channels = samps.shape[1]
    pcm = samps * 32768.0 if norm else samps
    pcm = np.clip(pcm, -32768, 32767).astype("<i2")
    data = pcm.tobytes()
    hdr = b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE"
    hdr += b"fmt " + struct.pack("<IHHIIHH", 16, WAVE_FORMAT_PCM,
                                 num_channels, sr,
                                 sr * num_channels * 2, num_channels * 2, 16)
    hdr += b"data" + struct.pack("<I", len(data))
    if isinstance(fobj, str):
        with open(fobj, "wb") as fd:
            fd.write(hdr + data)
    else:
        fobj.write(hdr + data)
