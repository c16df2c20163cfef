#!/usr/bin/env python
"""Built-in STOI (short-time objective intelligibility, Taal et al. 2011).

The port's own copy of aps_tpu/metric/stoi.py (numpy and scipy only): the
fall-back of aps_stoi when the optional pystoi package is absent.
Implements the standard algorithm with pystoi's constants so scores are
comparable: resample to 10 kHz, drop silent frames (40 dB dynamic range),
256-sample hann STFT with 50% overlap (512-point FFT), 15 one-third-octave
bands from 150 Hz, 30-frame segments, per-segment energy normalization
with a -15 dB SDR clip, and the mean short-time correlation over all bands
and segments."""

from typing import Tuple

import numpy as np

FS = 10000          # internal sample rate
N_FRAME = 256       # analysis frame (25.6 ms at 10 kHz)
NFFT = 512
NUMBAND = 15
MINFREQ = 150.0     # center frequency of the first 1/3-octave band
N_SEG = 30          # frames per intermediate-intelligibility segment
BETA = -15.0        # lower SDR clip in dB
DYN_RANGE = 40.0    # silent-frame removal range in dB
EPS = np.finfo(np.float64).eps


def _resample(x: np.ndarray, fs: int) -> np.ndarray:
    if fs == FS:
        return x
    from math import gcd
    from scipy.signal import resample_poly
    g = gcd(int(fs), FS)
    return resample_poly(x, FS // g, int(fs) // g)


def _third_octave_matrix() -> np.ndarray:
    """NUMBAND x (NFFT//2+1) binary band-sum matrix (pystoi's scheme:
    nearest-bin band edges at cf / 2^(1/6) .. cf * 2^(1/6))."""
    f = np.linspace(0, FS / 2, NFFT // 2 + 1)
    cf = MINFREQ * 2.0**(np.arange(NUMBAND) / 3.0)
    lo = cf / 2.0**(1.0 / 6.0)
    hi = cf * 2.0**(1.0 / 6.0)
    obm = np.zeros((NUMBAND, f.size))
    for k in range(NUMBAND):
        a = int(np.argmin(np.abs(f - lo[k])))
        b = int(np.argmin(np.abs(f - hi[k])))
        obm[k, a:b] = 1.0
    return obm


def _frames(x: np.ndarray) -> np.ndarray:
    hop = N_FRAME // 2
    n = max((x.size - N_FRAME) // hop + 1, 0)
    if n == 0:
        return np.zeros((0, N_FRAME))
    idx = np.arange(N_FRAME)[None, :] + hop * np.arange(n)[:, None]
    return x[idx]


def _remove_silent(x: np.ndarray, y: np.ndarray) -> Tuple[np.ndarray,
                                                          np.ndarray]:
    """Drop frames of the REFERENCE more than DYN_RANGE below its peak,
    and overlap-add the survivors back to waveforms (pystoi semantics)."""
    w = np.hanning(N_FRAME + 2)[1:-1]
    xf = _frames(x) * w
    yf = _frames(y) * w
    if xf.shape[0] == 0:
        return x, y
    edb = 20 * np.log10(np.linalg.norm(xf, axis=1) + EPS)
    mask = edb > (edb.max() - DYN_RANGE)
    xf, yf = xf[mask], yf[mask]
    hop = N_FRAME // 2
    n = xf.shape[0]
    out_len = (n - 1) * hop + N_FRAME if n else 0
    xo = np.zeros(out_len)
    yo = np.zeros(out_len)
    for i in range(n):  # overlap-add of the kept frames
        xo[i * hop:i * hop + N_FRAME] += xf[i]
        yo[i * hop:i * hop + N_FRAME] += yf[i]
    return xo, yo


def _band_spectrogram(x: np.ndarray, obm: np.ndarray) -> np.ndarray:
    w = np.hanning(N_FRAME + 2)[1:-1]
    fr = _frames(x) * w
    spec = np.abs(np.fft.rfft(fr, n=NFFT, axis=1))**2  # n x F
    return np.sqrt(spec @ obm.T)  # n x NUMBAND band amplitudes


def stoi(ref: np.ndarray, est: np.ndarray, fs: int = 16000) -> float:
    """STOI in [~0, 1] of estimate `est` against clean reference `ref`."""
    ref = np.asarray(ref, dtype=np.float64)
    est = np.asarray(est, dtype=np.float64)
    if ref.shape != est.shape:
        raise ValueError("stoi: ref/est length mismatch")
    x = _resample(ref, fs)
    y = _resample(est, fs)
    x, y = _remove_silent(x, y)
    obm = _third_octave_matrix()
    X = _band_spectrogram(x, obm)  # frames x bands
    Y = _band_spectrogram(y, obm)
    if X.shape[0] < N_SEG:
        raise ValueError("stoi: not enough non-silent frames "
                         f"({X.shape[0]} < {N_SEG}) — signal too short")
    clip = 10.0**(-BETA / 20.0)
    corrs = []
    for m in range(N_SEG, X.shape[0] + 1):
        Xs = X[m - N_SEG:m]  # N_SEG x bands
        Ys = Y[m - N_SEG:m]
        alpha = np.linalg.norm(Xs, axis=0, keepdims=True) / (
            np.linalg.norm(Ys, axis=0, keepdims=True) + EPS)
        Yn = np.minimum(Ys * alpha, Xs * (1 + clip))
        xc = Xs - Xs.mean(axis=0, keepdims=True)
        yc = Yn - Yn.mean(axis=0, keepdims=True)
        num = np.sum(xc * yc, axis=0)
        den = np.linalg.norm(xc, axis=0) * np.linalg.norm(yc, axis=0) + EPS
        corrs.append(num / den)
    return float(np.mean(corrs))
