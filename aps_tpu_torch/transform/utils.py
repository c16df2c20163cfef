#!/usr/bin/env python
"""DSP helpers of the front end: windows, STFT geometry, mel matrix, frame
counts, framing, overlap-add and the STFT and its inverse.

Port of aps_tpu/transform/utils.py (init_window, fft_size_of, _stft_geometry,
make_window, mel_filter, dct_matrix, num_frames, speed_perturb_filter,
frame_signal, overlap_add, forward_stft, inverse_stft, splice_feature). The coefficient
tables are made with numpy, as in the JAX package, so both packages get the
same float32 tables; num_frames takes ints or tensors. A spectrum is a
complex64 tensor N x (C) x F x T: aps_tpu packs it as a real ... x 2 pair only
because its TPU runtime has no complex64."""

import math
from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from aps_tpu_torch.const import EPSILON


def init_window(wnd: str, frame_len: int) -> np.ndarray:
    """Periodic window coefficients (torch.*_window(periodic=True))."""

    def periodic(fn, n):
        return fn(n + 1)[:-1]

    wnd_tpl = {
        "hann": lambda n: periodic(np.hanning, n),
        "sqrthann": lambda n: periodic(np.hanning, n)**0.5,
        "hamm": lambda n: periodic(np.hamming, n),
        "blackman": lambda n: periodic(np.blackman, n),
        "bartlett": lambda n: periodic(np.bartlett, n),
        "rect": np.ones,
    }
    if wnd not in wnd_tpl:
        raise RuntimeError(f"Unknown window type: {wnd}")
    return wnd_tpl[wnd](frame_len).astype(np.float32)


def fft_size_of(frame_len: int, round_pow_of_two: bool = True) -> int:
    return 2**math.ceil(math.log2(frame_len)) if round_pow_of_two else frame_len


def _stft_geometry(frame_len: int, round_pow_of_two: bool,
                   mode: str) -> Tuple[int, int]:
    """Return (fft_size, win_length). kaldi always rounds to pow2 and keeps
    frame_len-sample windows; librosa center-pads the window to fft_size."""
    if mode not in ("librosa", "kaldi"):
        raise ValueError(f"Unsupported STFT mode: {mode}")
    fft_size = fft_size_of(frame_len, round_pow_of_two or mode == "kaldi")
    win_length = frame_len if mode == "kaldi" else fft_size
    return fft_size, win_length


def make_window(wnd: str, frame_len: int, round_pow_of_two: bool,
                mode: str) -> np.ndarray:
    """Window padded to the analysis length for the given mode."""
    fft_size, win_length = _stft_geometry(frame_len, round_pow_of_two, mode)
    window = init_window(wnd, frame_len)
    if mode == "librosa" and fft_size != frame_len:
        lpad = (fft_size - frame_len) // 2
        window = np.pad(window, (lpad, fft_size - frame_len - lpad))
    return window.astype(np.float32)


def mel_filter(frame_len: int,
               round_pow_of_two: bool = True,
               num_bins: Optional[int] = None,
               sr: int = 16000,
               num_mels: int = 80,
               fmin: float = 0.0,
               fmax: Optional[float] = None,
               norm: bool = False) -> np.ndarray:
    """HTK-mel triangular filterbank, num_mels x (N//2+1)
    (librosa filters.mel(htk=True, norm="slaney" if norm else None))."""
    if num_bins is None:
        N = fft_size_of(frame_len, round_pow_of_two)
    else:
        N = (num_bins - 1) * 2
    freq_upper = sr // 2
    if fmax is None:
        fmax = freq_upper
    else:
        fmax = min(fmax + freq_upper if fmax < 0 else fmax, freq_upper)
    fmin = max(0, fmin)

    def hz2mel(f):
        return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)

    def mel2hz(m):
        return 700.0 * (10.0**(np.asarray(m, dtype=np.float64) / 2595.0) - 1.0)

    fft_freqs = np.linspace(0, sr / 2, N // 2 + 1)
    mel_pts = mel2hz(np.linspace(hz2mel(fmin), hz2mel(fmax), num_mels + 2))
    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0, np.minimum(lower, upper))
    if norm:
        enorm = 2.0 / (mel_pts[2:num_mels + 2] - mel_pts[:num_mels])
        weights *= enorm[:, None]
    return weights.astype(np.float32)


def dct_matrix(num_ceps: int, num_mels: int, lifter: float = 0) -> np.ndarray:
    """Orthonormal DCT-II matrix (num_ceps x num_mels), rows scaled by the
    sinusoidal lifter 1 + lifter / 2 * sin(pi k / lifter) when lifter > 0."""
    n = np.arange(num_mels)
    k = np.arange(num_ceps)[:, None]
    dct = np.cos(np.pi * k * (2 * n + 1) / (2 * num_mels))
    dct[0] *= 1.0 / math.sqrt(num_mels)
    dct[1:] *= math.sqrt(2.0 / num_mels)
    if lifter > 0:
        cepw = 1 + 0.5 * lifter * np.sin(np.pi * np.arange(num_ceps) / lifter)
        dct *= cepw[:, None]
    return dct.astype(np.float32)


def num_frames(wav_len, frame_len: int, frame_hop: int,
               round_pow_of_two: bool = True, mode: str = "librosa",
               center: bool = False):
    """Frame count for given sample counts (int or tensor)."""
    _, win_length = _stft_geometry(frame_len, round_pow_of_two, mode)
    if center:
        wav_len = wav_len + 2 * (win_length // 2)
    return (wav_len - win_length) // frame_hop + 1


def speed_perturb_filter(src_sr: int,
                         dst_sr: int,
                         cutoff_ratio: float = 0.95,
                         num_zeros: int = 64) -> np.ndarray:
    """Polyphase resampling filter bank, dst_sr x src_sr x K (after gcd
    reduction). Windowed-sinc design following lilfilter/resampler."""
    if src_sr == dst_sr:
        raise ValueError(f"src_sr == dst_sr: {src_sr}/{dst_sr}")
    gcd = math.gcd(src_sr, dst_sr)
    src_sr = src_sr // gcd
    dst_sr = dst_sr // gcd
    if src_sr == 1 or dst_sr == 1:
        raise ValueError("integer-factor resampling not supported")
    zeros_per_block = min(src_sr, dst_sr) * cutoff_ratio
    padding = 1 + int(num_zeros / zeros_per_block)
    times = (np.arange(dst_sr)[:, None, None] / float(dst_sr) -
             np.arange(src_sr)[None, :, None] / float(src_sr) -
             np.arange(2 * padding + 1)[None, None, :] + padding)
    window = np.heaviside(1 - np.abs(times / padding), 0.0) * \
        (0.5 + 0.5 * np.cos(times / padding * math.pi))
    weight = np.sinc(times * zeros_per_block) * window * \
        zeros_per_block / float(src_sr)
    return weight.astype(np.float32)


def splice_feature(feats: torch.Tensor, lctx: int = 1, rctx: int = 1,
                   op: str = "cat") -> torch.Tensor:
    """Splice left/right context frames, the edges clamped: ... x T x F ->
    ... x T x F*(lctx + rctx + 1) (op "cat") or ... x T x F x (lctx + rctx
    + 1) (op "stack")."""
    if lctx + rctx == 0:
        return feats
    if op not in ("cat", "stack"):
        raise ValueError(f"Unknown op for feature splicing: {op}")
    T = feats.shape[-2]
    ctx = [feats.index_select(-2, torch.arange(c, c + T, device=feats.device
                                               ).clamp(0, T - 1))
           for c in range(-lctx, rctx + 1)]
    return torch.cat(ctx, -1) if op == "cat" else torch.stack(ctx, -1)


def frame_signal(wav: torch.Tensor, win_length: int,
                 frame_hop: int) -> torch.Tensor:
    """... x S -> ... x T x W strided frames (a view)."""
    return wav.unfold(-1, win_length, frame_hop)


def overlap_add(frames: torch.Tensor, frame_hop: int) -> torch.Tensor:
    """... x T x W -> ... x S, S = (T - 1) * hop + W: the frames summed at
    their offsets (the inverse of frame_signal's gather)."""
    lead, (T, W) = frames.shape[:-2], frames.shape[-2:]
    S = (T - 1) * frame_hop + W
    cols = frames.reshape(-1, T, W).transpose(1, 2)
    out = F.fold(cols, output_size=(1, S), kernel_size=(1, W),
                 stride=(1, frame_hop))
    return out.reshape(lead + (S,))


@lru_cache(maxsize=16)
def _window(window: str, frame_len: int, round_pow_of_two: bool, mode: str,
            device: torch.device) -> torch.Tensor:
    """make_window's table on a device, copied there once: a copy from
    pageable host memory in every call would wait for the card's queue."""
    return torch.from_numpy(
        make_window(window, frame_len, round_pow_of_two, mode)).to(device)


def forward_stft(wav: torch.Tensor,
                 frame_len: int,
                 frame_hop: int,
                 window: str = "sqrthann",
                 round_pow_of_two: bool = True,
                 return_polar: bool = False,
                 pre_emphasis: float = 0,
                 normalized: bool = False,
                 onesided: bool = True,
                 center: bool = False,
                 mode: str = "librosa",
                 eps: float = EPSILON) -> torch.Tensor:
    """STFT: N x (C) x S float32 -> N x (C) x F x T complex64, or with
    return_polar N x (C) x F x T x 2 float32 holding (magnitude, phase) as
    aps_tpu packs them (the magnitude sqrt(re^2 + im^2 + eps)).

    An rfft (fft for onesided=False) of the framed, windowed signal; for a
    frame shorter than fft_size (kaldi mode) the transform's zero-padding is
    aps_tpu's DFT matrix truncated to win_length rows. torch.fft computes in
    float32 whatever the TF32 flags say, as aps_tpu forces its DFT products
    to float32 ("highest")."""
    fft_size, win_length = _stft_geometry(frame_len, round_pow_of_two, mode)
    win = _window(window, frame_len, round_pow_of_two, mode, wav.device)
    if center:
        pad = win_length // 2
        shape = wav.shape
        wav = F.pad(wav.reshape(-1, 1, shape[-1]), (pad, pad),
                    mode="reflect").reshape(shape[:-1] + (-1,))
    frames = frame_signal(wav, win_length, frame_hop)
    if pre_emphasis > 0:
        frames = torch.cat([
            frames[..., :1] * (1 - pre_emphasis),
            frames[..., 1:] - pre_emphasis * frames[..., :-1]
        ], -1)
    frames = frames * win
    if onesided:
        spec = torch.fft.rfft(frames, n=fft_size)
    else:
        spec = torch.fft.fft(frames, n=fft_size)
    if normalized:
        spec = spec / math.sqrt(fft_size)
    # ... x T x F -> ... x F x T
    spec = spec.transpose(-1, -2)
    if return_polar:
        mag = torch.sqrt(spec.real**2 + spec.imag**2 + eps)
        return torch.stack([mag, torch.angle(spec)], -1)
    return spec


def inverse_stft(transform: torch.Tensor,
                 frame_len: int,
                 frame_hop: int,
                 window: str = "sqrthann",
                 round_pow_of_two: bool = True,
                 return_polar: bool = False,
                 normalized: bool = False,
                 onesided: bool = True,
                 center: bool = False,
                 mode: str = "librosa",
                 eps: float = EPSILON) -> torch.Tensor:
    """iSTFT: (N) x F x T complex64 (with return_polar: (N) x F x T x 2
    magnitude and phase) -> N x S float32.

    The one-sided inverse DFT (irfft, which like aps_tpu's inverse matrix
    ignores the imaginary parts of the DC and Nyquist bins) cut to
    win_length samples, windowed, overlap-added and divided by the
    overlap-added squared window plus eps, as aps_tpu divides; with center
    win_length // 2 samples are cut from each end, so S = (T - 1) * hop.
    Not torch.istft: that divides without eps and refuses a window that
    fails its NOLA check."""
    if return_polar:
        transform = torch.polar(transform[..., 0], transform[..., 1])
    if transform.dim() == 2:
        transform = transform[None]
    fft_size, win_length = _stft_geometry(frame_len, round_pow_of_two, mode)
    win = _window(window, frame_len, round_pow_of_two, mode,
                  transform.device)
    # N x F x T -> N x T x F
    spec = transform.transpose(-1, -2)
    if not onesided:
        spec = spec[..., :fft_size // 2 + 1]
    frames = torch.fft.irfft(spec, n=fft_size)[..., :win_length]
    if normalized:
        frames = frames * math.sqrt(fft_size)
    wav = overlap_add(frames * win, frame_hop)
    T = frames.shape[-2]
    denorm = overlap_add((win**2).expand(T, win_length), frame_hop)
    if center:
        pad = win_length // 2
        wav = wav[..., pad:-pad]
        denorm = denorm[..., pad:-pad]
    return wav / (denorm + eps)
