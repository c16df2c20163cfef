#!/usr/bin/env python
"""Kaldi binary archive (ark/scp) matrix and vector IO (the port's own copy
of aps_tpu/loader/kaldi_io.py, plain numpy).

Binary float/double matrices ("FM"/"DM") and vectors ("FV"/"DV"), kaldi's
compressed matrices ("CM"/"CM2"/"CM3", read and written), scp files with
"path:offset" values, and writing (ark[,scp]) pairs. The bytes written and
the arrays read are those of aps_tpu's module."""

import struct
from typing import IO, Tuple

import numpy as np

from aps_tpu_torch.io.base import BaseReader


def _expect(fd: IO, token: bytes):
    got = fd.read(len(token))
    if got != token:
        raise RuntimeError(f"Expected token {token!r}, got {got!r}")


def _read_int32(fd: IO) -> int:
    size = fd.read(1)[0]
    if size != 4:
        raise RuntimeError(f"Unsupported int size: {size}")
    return struct.unpack("<i", fd.read(4))[0]


def read_binary_mat(fd: IO) -> np.ndarray:
    """Read one kaldi binary matrix/vector at the current offset."""
    _expect(fd, b"\0B")
    token = b""
    while not token.endswith(b" "):
        token += fd.read(1)
    token = token.strip()
    if token in (b"FM", b"DM"):
        rows = _read_int32(fd)
        cols = _read_int32(fd)
        dtype = "<f4" if token == b"FM" else "<f8"
        data = np.frombuffer(fd.read(rows * cols * int(dtype[-1])),
                             dtype=dtype)
        return data.reshape(rows, cols).astype(np.float32)
    if token in (b"FV", b"DV"):
        dim = _read_int32(fd)
        dtype = "<f4" if token == b"FV" else "<f8"
        data = np.frombuffer(fd.read(dim * int(dtype[-1])), dtype=dtype)
        return data.astype(np.float32)
    if token in (b"CM", b"CM2", b"CM3"):
        return _read_compressed_mat(fd, token)
    raise RuntimeError(f"Unsupported kaldi object type: {token!r}")


# ---------------------------------------------------------------------------
# Kaldi CompressedMatrix ("CM"/"CM2"/"CM3") codec. Real-world feats.scp
# dumps are usually compressed (copy-feats --compress=true), so am@kaldi
# needs this. Layout (kaldi/src/matrix/compressed-matrix.cc):
#   GlobalHeader: <f min_value> <f range> <i num_rows> <i num_cols>  (raw)
#   CM : num_cols x PerColHeader{4 x uint16 percentiles}, then
#        uint8 data stored COLUMN-major; each byte maps into one of three
#        linear segments [p0,p25] (0..64), [p25,p75] (64..192),
#        [p75,p100] (192..255)
#   CM2: uint16 data row-major, linear in [min_value, min_value+range]
#   CM3: uint8  data row-major, linear in [min_value, min_value+range]
# ---------------------------------------------------------------------------

_GLOBAL_HEADER = struct.Struct("<ffii")


def _read_compressed_mat(fd: IO, token: bytes) -> np.ndarray:
    min_value, rng, rows, cols = _GLOBAL_HEADER.unpack(
        fd.read(_GLOBAL_HEADER.size))
    if token == b"CM2":
        data = np.frombuffer(fd.read(rows * cols * 2), dtype="<u2")
        mat = min_value + rng * data.astype(np.float32) / 65535.0
        return mat.reshape(rows, cols)
    if token == b"CM3":
        data = np.frombuffer(fd.read(rows * cols), dtype=np.uint8)
        mat = min_value + rng * data.astype(np.float32) / 255.0
        return mat.reshape(rows, cols)
    # "CM": per-column percentile headers + column-major bytes
    headers = np.frombuffer(fd.read(cols * 8), dtype="<u2").reshape(cols, 4)
    pct = min_value + rng * headers.astype(np.float32) / 65535.0  # cols x 4
    data = np.frombuffer(fd.read(rows * cols),
                         dtype=np.uint8).reshape(cols, rows)
    v = data.astype(np.float32)
    p0, p25, p75, p100 = (pct[:, i:i + 1] for i in range(4))
    lo = p0 + (p25 - p0) * (v / 64.0)
    mid = p25 + (p75 - p25) * ((v - 64.0) / 128.0)
    hi = p75 + (p100 - p75) * ((v - 192.0) / 63.0)
    cols_mat = np.where(v <= 64, lo, np.where(v <= 192, mid, hi))
    return np.ascontiguousarray(cols_mat.T)


def _float_to_uint16(value: np.ndarray, min_value: float,
                     rng: float) -> np.ndarray:
    scaled = (np.asarray(value, dtype=np.float64) - min_value) / \
        (rng if rng > 0 else 1.0) * 65535.0
    return np.clip(np.rint(scaled), 0, 65535).astype("<u2")


def write_compressed_mat(fd: IO, mat: np.ndarray,
                         method: str = "CM") -> int:
    """Write a kaldi-compressed matrix; returns the value offset."""
    offset = fd.tell()
    mat = np.asarray(mat, dtype=np.float32)
    if mat.ndim != 2:
        raise RuntimeError(f"Expect 2D array, got {mat.ndim}")
    rows, cols = mat.shape
    min_value = float(mat.min())
    rng = float(mat.max() - min_value)
    if rng <= 0:
        rng = 1.0
    fd.write(b"\0B" + method.encode() + b" ")
    fd.write(_GLOBAL_HEADER.pack(min_value, rng, rows, cols))
    if method == "CM2":
        fd.write(_float_to_uint16(mat, min_value, rng).tobytes())
        return offset
    if method == "CM3":
        scaled = (mat - min_value) / rng * 255.0
        fd.write(np.clip(np.rint(scaled), 0, 255).astype(np.uint8).tobytes())
        return offset
    if method != "CM":
        raise RuntimeError(f"Unknown compression method: {method}")
    # per-column percentiles quantized through the uint16 grid (so the
    # reader's dequantized percentiles match the encoder's exactly)
    pct = np.percentile(mat, [0, 25, 75, 100], axis=0)  # 4 x cols
    pct_u16 = _float_to_uint16(pct.T, min_value, rng)  # cols x 4
    fd.write(pct_u16.tobytes())
    p = min_value + rng * pct_u16.astype(np.float64) / 65535.0
    p0, p25, p75, p100 = (p[:, i:i + 1] for i in range(4))
    v = mat.T.astype(np.float64)  # cols x rows
    lo = (v - p0) / np.maximum(p25 - p0, 1e-10) * 64.0
    mid = 64.0 + (v - p25) / np.maximum(p75 - p25, 1e-10) * 128.0
    hi = 192.0 + (v - p75) / np.maximum(p100 - p75, 1e-10) * 63.0
    enc = np.where(v < p25, lo, np.where(v < p75, mid, hi))
    fd.write(np.clip(np.rint(enc), 0, 255).astype(np.uint8).tobytes())
    return offset


def read_kaldi_mat(path: str) -> np.ndarray:
    """Read a single-object ark file or "ark:offset" location."""
    if ":" in path and path.rsplit(":", 1)[1].isdigit():
        fname, offset = path.rsplit(":", 1)
        with open(fname, "rb") as fd:
            fd.seek(int(offset))
            return read_binary_mat(fd)
    with open(path, "rb") as fd:
        # archives hold "key <obj>" pairs; single-object files start with \0B
        head = fd.read(2)
        fd.seek(0)
        if head == b"\0B":
            return read_binary_mat(fd)
        _read_key(fd)
        return read_binary_mat(fd)


def _read_key(fd: IO) -> str:
    key = b""
    while True:
        c = fd.read(1)
        if not c:
            return ""
        if c == b" ":
            return key.decode()
        key += c


def write_binary_mat(fd: IO, mat: np.ndarray) -> int:
    """Write one kaldi float32 matrix/vector; return its value offset."""
    offset = fd.tell()
    fd.write(b"\0B")
    mat = np.asarray(mat, dtype=np.float32)
    if mat.ndim == 2:
        fd.write(b"FM ")
        fd.write(b"\4" + struct.pack("<i", mat.shape[0]))
        fd.write(b"\4" + struct.pack("<i", mat.shape[1]))
    elif mat.ndim == 1:
        fd.write(b"FV ")
        fd.write(b"\4" + struct.pack("<i", mat.shape[0]))
    else:
        raise RuntimeError(f"Expect 1/2D array, got {mat.ndim}")
    fd.write(mat.astype("<f4").tobytes())
    return offset


class ScriptReader(BaseReader):
    """feats.scp reader: values are "/path/feats.ark:offset"."""

    def __init__(self, scp_path: str):
        super(ScriptReader, self).__init__(scp_path, num_tokens=2)
        self.mngr = {}

    def _load(self, key: str) -> np.ndarray:
        value = self.index_dict[key]
        fname, offset = value.rsplit(":", 1)
        if fname not in self.mngr:
            self.mngr[fname] = open(fname, "rb")
        fd = self.mngr[fname]
        fd.seek(int(offset))
        return read_binary_mat(fd)


class ArchiveReader(object):
    """Sequential reader over a kaldi ark of matrices."""

    def __init__(self, ark_path: str):
        self.ark_path = ark_path

    def __iter__(self):
        with open(self.ark_path, "rb") as fd:
            while True:
                key = _read_key(fd)
                if not key:
                    break
                yield key, read_binary_mat(fd)


class ArchiveWriter(object):
    """Write "key matrix" pairs to ark (+scp index); compress selects a
    kaldi compression format ("CM"/"CM2"/"CM3", "" = raw float32)."""

    def __init__(self, ark_path: str, scp_path: str = "",
                 compress: str = ""):
        self.ark_path = ark_path
        self.scp_path = scp_path
        self.compress = compress

    def __enter__(self):
        self.ark_fd = open(self.ark_path, "wb")
        self.scp_fd = open(self.scp_path, "w") if self.scp_path else None
        return self

    def write(self, key: str, mat: np.ndarray):
        self.ark_fd.write(key.encode() + b" ")
        if self.compress and np.asarray(mat).ndim == 2:
            offset = write_compressed_mat(self.ark_fd, mat,
                                          method=self.compress)
        else:
            offset = write_binary_mat(self.ark_fd, mat)
        if self.scp_fd:
            self.scp_fd.write(f"{key} {self.ark_path}:{offset}\n")

    def __exit__(self, *args):
        self.ark_fd.close()
        if self.scp_fd:
            self.scp_fd.close()
