#!/usr/bin/env python
"""Fused log-(mel-)filterbank: wav N x S -> N x T x M in one CUDA kernel.

Port of aps_tpu/ops/pallas/fbank.py::fused_logmel. The kernel
(csrc/fbank.cu) frames the waveform with the per-frame pre-emphasis head
rule, windows, takes the real DFT against cached cos/sin tables, forms power
or magnitude, projects onto the mel filterbank and takes the floored log,
writing only the features. `fused_logmel_plain` is the same function in
plain PyTorch: the wrapper uses it for CPU tensors, and the kernel is held
against it on the card."""

from functools import lru_cache
from typing import Optional

import numpy as np
import torch

from aps_tpu_torch.ops import build

__all__ = ["fused_logmel", "fused_logmel_plain"]


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


def _window(window, fft_size: int, normalized: bool,
            device: torch.device) -> torch.Tensor:
    win = torch.as_tensor(np.asarray(window, dtype=np.float32), device=device)
    if normalized:
        win = win / np.sqrt(fft_size)
    return win.contiguous()


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
    """Plain PyTorch version of fused_logmel (same arguments)."""
    W = int(np.asarray(window).shape[0])
    frames = wav.unfold(-1, W, frame_hop)  # N x T x W
    if pre_emphasis > 0:
        head = frames[..., :1] * (1 - pre_emphasis)
        rest = frames[..., 1:] - pre_emphasis * frames[..., :-1]
        frames = torch.cat([head, rest], dim=-1)
    frames = frames * _window(window, fft_size, normalized, wav.device)
    cos, sin = _dft_tables(fft_size, W, wav.device)
    re = frames @ cos
    im = frames @ sin
    power = re * re + im * im
    feat = power if use_power else torch.sqrt(power + mag_eps)
    if mel is not None:
        feat = feat @ torch.as_tensor(np.asarray(mel, dtype=np.float32),
                                      device=wav.device)
    if log_lower_bound > 0:
        return torch.log(log_lower_bound + feat)
    return torch.log(torch.clamp_min(feat, log_eps))


_ARGTYPES = [
    build.P, build.I, build.I, build.I,  # wav, N, S, T
    build.P, build.I, build.I,  # window, W, hop
    build.P, build.P, build.I,  # cos, sin, F
    build.P, build.I,  # mel, M
    build.F, build.I, build.F, build.F, build.F,  # pre, power, eps, lb, eps
    build.P, build.P  # out, stream
]


def fused_logmel(wav: torch.Tensor,
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
    """wav: N x S float32 -> log-mel N x T x M (log-spectrogram with
    M = fft_size//2 + 1 when mel is None). window: the win_length analysis
    window; mel: F x M filterbank. CPU tensors take the plain version; a
    CUDA tensor launches csrc/fbank.cu."""
    args = (window, fft_size, frame_hop, mel, pre_emphasis, normalized,
            use_power, mag_eps, log_lower_bound, log_eps)
    if wav.device.type == "cpu":
        return fused_logmel_plain(wav, *args)
    if wav.dim() != 2:
        raise ValueError(f"fused_logmel: wav must be N x S, got "
                         f"{tuple(wav.shape)}")
    N, S = wav.shape
    W = int(np.asarray(window).shape[0])
    T = (S - W) // frame_hop + 1
    if T < 1:
        raise ValueError(f"fused_logmel: {S} samples hold no {W}-sample "
                         "frame")
    F = fft_size // 2 + 1
    if W > fft_size:
        raise ValueError(f"fused_logmel: window {W} > fft_size {fft_size}")
    dev = wav.device
    win = _window(window, fft_size, normalized, dev)
    cos, sin = _dft_tables(fft_size, W, dev)
    mel_t = None
    M = F
    if mel is not None:
        mel_t = torch.as_tensor(np.asarray(mel, dtype=np.float32),
                                device=dev).contiguous()
        if mel_t.shape[0] != F:
            raise ValueError(f"fused_logmel: mel is {tuple(mel_t.shape)}, "
                             f"expected {F} x M")
        M = mel_t.shape[1]
    tensors = {"wav": wav, "window": win, "cos": cos, "sin": sin}
    if mel_t is not None:
        tensors["mel"] = mel_t
    build.require_cuda("fused_logmel", tensors)
    out = torch.empty((N, T, M), dtype=torch.float32, device=dev)
    lib = build.load("fbank", "aps_fused_logmel", _ARGTYPES)
    rc = lib.aps_fused_logmel(
        wav.data_ptr(), N, S, T, win.data_ptr(), W, frame_hop,
        cos.data_ptr(), sin.data_ptr(), F,
        None if mel_t is None else mel_t.data_ptr(), M,
        float(pre_emphasis), int(bool(use_power)), float(mag_eps),
        float(log_lower_bound), float(log_eps), out.data_ptr(),
        build.stream_ptr(dev))
    build.check(lib, rc, "fused_logmel")
    build.count_launch("fused_logmel")
    return out
