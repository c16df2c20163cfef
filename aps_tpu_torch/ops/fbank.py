#!/usr/bin/env python
"""Fused log-(mel-)filterbank: wav N x S -> N x T x M in one CUDA kernel.

Port of aps_tpu/ops/pallas/fbank.py::fused_logmel. The kernel
(csrc/fbank.cu) frames the waveform with the per-frame pre-emphasis head
rule, windows, takes the real FFT of each frame as a complex FFT of half its
size in shared memory (Stockham stages of the radices `fft_plan` gives; in
float64, see the kernel's header), forms power or magnitude, projects onto
each mel filter's band of nonzero bins (`mel_bands`) and takes the floored
log, writing only the features. `fused_logmel_plain` is the same function
in plain PyTorch, with the dense DFT of the JAX package: the wrapper uses it
for CPU tensors, and the kernel is held against it on the card. The window,
the mel matrix's bands and the twiddle table reach the device once, in the
`Operands` that their owner makes with `operands` (the feature transform
keeps one for each device): a call copies nothing from the host."""

from functools import lru_cache
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from aps_tpu_torch.ops import build

__all__ = ["fused_logmel", "fused_logmel_plain", "operands", "Operands",
           "fft_plan", "mel_bands"]

# the kernel's largest transform: two buffers of a block's frames fit in
# shared memory up to it
MAX_FFT_SIZE = 4096


def fft_plan(fft_size: int) -> List[int]:
    """The radices of the kernel's Stockham stages over the complex
    transform of fft_size / 2 points, in order: 4 while 4 divides what is
    left, else 3, else 5, else 2. The kernel runs the stages it is given
    (`radices`). Raises ValueError for a size the kernel does not
    take: odd, above MAX_FFT_SIZE, or with a prime factor above 5."""
    rest = fft_size // 2
    ok = fft_size >= 2 and fft_size % 2 == 0 and fft_size <= MAX_FFT_SIZE
    plan = []
    while ok and rest > 1:
        radix = next((r for r in (4, 3, 5, 2) if rest % r == 0), None)
        if radix is None:
            ok = False
            break
        plan.append(radix)
        rest //= radix
    if not ok:
        raise ValueError(f"fused_logmel: fft_size {fft_size} is not "
                         "supported by the CUDA kernel, which takes even "
                         f"sizes up to {MAX_FFT_SIZE} whose prime factors "
                         "are 2, 3 and 5 (its FFT has radix 2, 3, 4 and 5 "
                         "stages)")
    return plan


def radices(fft_size: int) -> int:
    """fft_plan(fft_size) as the kernel takes it: 3 bits a stage, the first
    stage's radix in the lowest bits."""
    return sum(r << 3 * i for i, r in enumerate(fft_plan(fft_size)))


def mel_bands(mel: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(lo, hi): for each column m of the F x M filterbank, the rows [lo[m],
    hi[m]) hold all of its nonzero entries (lo = hi = 0 for a column of
    zeros)."""
    nz = np.asarray(mel) != 0
    any_nz = nz.any(0)
    lo = np.where(any_nz, nz.argmax(0), 0)
    hi = np.where(any_nz, nz.shape[0] - nz[::-1].argmax(0), 0)
    return lo.astype(np.int32), hi.astype(np.int32)


def band_tables(mel: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The kernel's mel operands: (vals, bands), the coefficients of each
    column's band [lo, hi) packed one after another (and a zero, so that
    vals is never empty), and M x 3 int32 rows (lo, hi, offset of mel[lo, m]
    in vals)."""
    lo, hi = mel_bands(mel)
    off = np.concatenate([[0], np.cumsum(hi - lo)[:-1]]).astype(np.int32)
    vals = np.concatenate([mel[lo[m]:hi[m], m] for m in range(mel.shape[1])]
                          + [np.zeros(1, np.float32)])
    return vals.astype(np.float32), np.stack([lo, hi, off], -1)


@lru_cache(maxsize=8)
def _dft_tables(fft_size: int, win_length: int, device: torch.device):
    """(win_length x F) cos/sin real-DFT tables, F = fft_size//2 + 1,
    computed in float64 and stored float32 (as the JAX package does)."""
    n = np.arange(win_length)
    k = np.arange(fft_size // 2 + 1)
    ang = -2.0 * np.pi * np.outer(n, k) / fft_size
    cos = torch.from_numpy(np.cos(ang).astype(np.float32)).to(device)
    sin = torch.from_numpy(np.sin(ang).astype(np.float32)).to(device)
    return cos, sin


def _twiddles(fft_size: int) -> torch.Tensor:
    """fft_size x 2 float64: exp(-2 pi i m / fft_size), m < fft_size, as
    (cos, sin) pairs (the kernel's FFT runs in float64)."""
    ang = -2.0 * np.pi * np.arange(fft_size) / fft_size
    return torch.from_numpy(np.stack([np.cos(ang), np.sin(ang)], -1))


def _window(window, fft_size: int, normalized: bool,
            device: torch.device) -> torch.Tensor:
    win = torch.as_tensor(np.asarray(window, dtype=np.float32), device=device)
    if normalized:
        win = win / np.sqrt(fft_size)
    return win.contiguous()


class Operands(NamedTuple):
    """What fused_logmel takes besides the waveform and its scalars: the
    host arrays (the plain version reads them) and, for a CUDA device, the
    kernel's operands there (None for the CPU)."""
    window: np.ndarray  # W float32
    fft_size: int
    mel: Optional[np.ndarray]  # F x M float32
    normalized: bool
    device: torch.device
    # the window on the device, divided by sqrt(fft_size) when normalized
    dev_window: Optional[torch.Tensor] = None
    twiddle: Optional[torch.Tensor] = None  # fft_size x 2 float64
    mel_vals: Optional[torch.Tensor] = None  # band_tables
    mel_bands: Optional[torch.Tensor] = None
    radices: int = 0  # the stages the kernel runs: radices(fft_size)


def operands(window: np.ndarray,
             fft_size: int,
             mel: Optional[np.ndarray] = None,
             normalized: bool = False,
             device="cpu") -> Operands:
    """fused_logmel's operands for a front end on a device, copied there
    once. On a CUDA device it raises ValueError for what the kernel does not
    take: an fft_size that fft_plan refuses, a window longer than fft_size,
    a mel matrix without fft_size // 2 + 1 rows."""
    window = np.array(window, dtype=np.float32)
    mel = None if mel is None else np.array(mel, dtype=np.float32)
    device = torch.device(device)
    host = Operands(window, fft_size, mel, bool(normalized), device)
    if device.type == "cpu":
        return host
    plan = radices(fft_size)
    if len(window) > fft_size:
        raise ValueError(f"fused_logmel: window {len(window)} > fft_size "
                         f"{fft_size}")
    if mel is not None and mel.shape[0] != fft_size // 2 + 1:
        raise ValueError(f"fused_logmel: mel is {mel.shape}, expected "
                         f"{fft_size // 2 + 1} x M")
    dev_window = _window(window, fft_size, normalized, device)
    ops = host._replace(device=dev_window.device, dev_window=dev_window,
                        twiddle=_twiddles(fft_size).to(device), radices=plan)
    if mel is None:
        return ops
    vals, bands = band_tables(mel)
    return ops._replace(mel_vals=torch.from_numpy(vals).to(device),
                        mel_bands=torch.from_numpy(bands).to(device))


def fused_logmel_plain(wav: torch.Tensor,
                       window: np.ndarray,
                       fft_size: int,
                       frame_hop: int,
                       mel: Optional[np.ndarray] = None,
                       pre_emphasis: float = 0.97,
                       normalized: bool = False,
                       use_power: bool = False,
                       mag_eps: float = 0.0,
                       log_lower_bound: float = 0.0,
                       log_eps: float = 1e-8) -> torch.Tensor:
    """Plain PyTorch version of fused_logmel (the window and the mel matrix
    as numpy arrays), in the waveform's dtype."""
    W = int(np.asarray(window).shape[0])
    frames = wav.unfold(-1, W, frame_hop)  # N x T x W
    if pre_emphasis > 0:
        head = frames[..., :1] * (1 - pre_emphasis)
        rest = frames[..., 1:] - pre_emphasis * frames[..., :-1]
        frames = torch.cat([head, rest], dim=-1)
    frames = frames * _window(window, fft_size, normalized,
                              wav.device).to(wav.dtype)
    cos, sin = (t.to(wav.dtype) for t in _dft_tables(fft_size, W,
                                                      wav.device))
    re = frames @ cos
    im = frames @ sin
    power = re * re + im * im
    feat = power if use_power else torch.sqrt(power + mag_eps)
    if mel is not None:
        feat = feat @ torch.as_tensor(np.asarray(mel, dtype=np.float32),
                                      device=wav.device).to(wav.dtype)
    if log_lower_bound > 0:
        return torch.log(log_lower_bound + feat)
    return torch.log(torch.clamp_min(feat, log_eps))


_ARGTYPES = [
    build.P, build.I, build.I, build.I,  # wav, N, S, T
    build.P, build.I, build.I,  # window, W, hop
    build.I, build.P, build.I,  # fft_size, twiddle, radices
    build.P, build.P, build.I,  # mel_vals, mel_bands, M
    build.F, build.I, build.F, build.F, build.F,  # pre, power, eps, lb, eps
    build.P, build.P  # out, stream
]


def launch(wav: torch.Tensor, ops: Operands, frame_hop: int,
           pre_emphasis: float = 0.97, use_power: bool = False,
           mag_eps: float = 0.0, log_lower_bound: float = 0.0,
           log_eps: float = 1e-8) -> torch.Tensor:
    """Launch the kernel on operands already on the card and checked ->
    N x T x M features. fused_logmel is the public entry; this one lets a
    check time the kernel's launch apart from the wrapper's checks."""
    N, S = wav.shape
    W = ops.dev_window.shape[0]
    T = (S - W) // frame_hop + 1
    M = ops.fft_size // 2 + 1 if ops.mel is None else ops.mel.shape[1]
    out = torch.empty((N, T, M), dtype=torch.float32, device=wav.device)
    mel = ops.mel is not None
    lib = build.load("fbank", "aps_fused_logmel", _ARGTYPES)
    rc = lib.aps_fused_logmel(
        wav.data_ptr(), N, S, T, ops.dev_window.data_ptr(), W, frame_hop,
        ops.fft_size, ops.twiddle.data_ptr(), ops.radices,
        ops.mel_vals.data_ptr() if mel else None,
        ops.mel_bands.data_ptr() if mel else None, M, float(pre_emphasis),
        int(bool(use_power)), float(mag_eps), float(log_lower_bound),
        float(log_eps), out.data_ptr(), build.stream_ptr(wav.device))
    build.check(lib, rc, "fused_logmel")
    build.count_launch("fused_logmel")
    return out


def fused_logmel(wav: torch.Tensor,
                 ops: Operands,
                 frame_hop: int,
                 pre_emphasis: float = 0.97,
                 use_power: bool = False,
                 mag_eps: float = 0.0,
                 log_lower_bound: float = 0.0,
                 log_eps: float = 1e-8) -> torch.Tensor:
    """wav: N x S float32 -> log-mel N x T x M (log-spectrogram with
    M = fft_size//2 + 1 when ops has no mel matrix). ops: `operands` of the
    analysis window, fft_size, the F x M filterbank and normalized, for the
    wav's device. CPU tensors take the plain version; a CUDA tensor launches
    csrc/fbank.cu."""
    if wav.device != ops.device:
        raise ValueError(f"fused_logmel: wav is on {wav.device}, its "
                         f"operands on {ops.device}")
    if wav.device.type == "cpu":
        return fused_logmel_plain(wav, ops.window, ops.fft_size, frame_hop,
                                  ops.mel, pre_emphasis, ops.normalized,
                                  use_power, mag_eps, log_lower_bound,
                                  log_eps)
    if wav.dim() != 2:
        raise ValueError(f"fused_logmel: wav must be N x S, got "
                         f"{tuple(wav.shape)}")
    if wav.shape[1] < len(ops.window):
        raise ValueError(f"fused_logmel: {wav.shape[1]} samples hold no "
                         f"{len(ops.window)}-sample frame")
    build.require_cuda("fused_logmel", {"wav": wav})
    return launch(wav, ops, frame_hop, pre_emphasis, use_power, mag_eps,
                  log_lower_bound, log_eps)
