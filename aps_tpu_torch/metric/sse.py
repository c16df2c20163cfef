#!/usr/bin/env python
"""SSE metrics: SiSNR / SNR (numpy), STOI and BSS-eval SDR (built-in
implementations, optional packages used when installed) and PESQ (gated
on the optional pypesq package).

The port's own copy of aps_tpu/metric/sse.py (numpy and scipy only): the
same functions, the same fall-backs and the same values."""

from itertools import permutations
from typing import Callable, Optional

import numpy as np


def aps_sisnr(s: np.ndarray,
              x: np.ndarray,
              eps: float = 1e-8,
              remove_dc: bool = True,
              fs: Optional[int] = None) -> float:
    """SiSNR(reference s, estimate x) in dB."""

    def l2(v):
        return np.linalg.norm(v, 2)

    if remove_dc:
        x = x - np.mean(x)
        s = s - np.mean(s)
    t = np.inner(x, s) * s / (l2(s)**2 + eps)
    n = x - t
    return float(20 * np.log10(l2(t) / (l2(n) + eps) + eps))


def aps_snr(s: np.ndarray, x: np.ndarray, eps: float = 1e-8,
            fs: Optional[int] = None) -> float:
    return float(20 * np.log10(
        np.linalg.norm(s) / (np.linalg.norm(x - s) + eps) + eps))


def aps_pesq(ref: np.ndarray, est: np.ndarray, fs: int = 16000) -> float:
    try:
        from pypesq import pesq
    except ImportError as e:
        raise ImportError("PESQ requires the 'pypesq' package") from e
    return pesq(ref, est, fs=fs)


def aps_stoi(ref: np.ndarray, est: np.ndarray, fs: int = 16000) -> float:
    try:
        from pystoi import stoi
        return stoi(ref, est, fs_sig=fs)
    except ImportError:
        # built-in implementation (same algorithm + constants; see
        # aps_tpu_torch/metric/stoi.py) — no optional package needed
        from aps_tpu_torch.metric.stoi import stoi
        return stoi(ref, est, fs=fs)


def _permute_eval(eval_func: Callable, ref, est,
                  compute_permutation: bool = False,
                  fs: Optional[int] = None):

    def eval_sum(ref, est):
        return sum(eval_func(s, x, fs=fs) for s, x in zip(ref, est))

    if est.ndim == 1:
        return eval_func(ref, est, fs=fs)
    N = est.shape[0]
    if N != ref.shape[0]:
        raise RuntimeError("est/ref speaker-count mismatch")
    metric, perm = [], []
    for order in permutations(range(N)):
        est_permu = np.stack([est[n] for n in order])
        metric.append(eval_sum(ref, est_permu) / N)
        perm.append(order)
    if not compute_permutation:
        return max(metric)
    max_idx = int(np.argmax(metric))
    return max(metric), perm[max_idx]


def permute_sse_metric(name: str, ref, est,
                       compute_permutation: bool = False,
                       fs: Optional[int] = None):
    """name in {sisnr, snr, pesq, stoi, sdr}."""
    funcs = {"sisnr": aps_sisnr, "snr": aps_snr, "pesq": aps_pesq,
             "stoi": aps_stoi}
    if name in funcs:
        return _permute_eval(funcs[name], ref, est,
                             compute_permutation=compute_permutation, fs=fs)
    if name == "sdr":
        if ref.ndim == 1:
            ref, est = ref[None, :], est[None, :]
        try:
            from museval.metrics import bss_eval_images
            sdr, *_, popt = bss_eval_images(ref[..., None], est[..., None])
            score = float(np.mean(sdr))
            return (score, popt) if compute_permutation else score
        except ImportError:
            # built-in BSS-eval (v3 sources semantics, 512-tap allowed
            # distortion filter) — no optional package needed
            sdr, popt = _bss_eval_sdr(ref, est)
            score = float(np.mean(sdr))
            return (score, popt) if compute_permutation else score
    raise ValueError(f"Unknown metric: {name}")


def _proj_matrices(ref: np.ndarray, est: np.ndarray, L: int):
    """Least-squares projection helpers: Gram matrix of all references at
    lags 0..L-1 and est/ref lagged cross-correlations, via FFT."""
    nsrc, T = ref.shape
    nfft = int(2**np.ceil(np.log2(T + L)))
    rf = np.fft.rfft(ref, n=nfft)
    ef = np.fft.rfft(est, n=nfft)
    # G[j*L+a, k*L+b] = sum_t ref_j[t-a] ref_k[t-b] = corr_jk[b-a]
    corr = np.fft.irfft(rf[:, None] * rf[None].conj(), n=nfft)  # J x K x n
    G = np.zeros((nsrc * L, nsrc * L))
    idx = np.subtract.outer(np.arange(L), np.arange(L))  # a-b
    for j in range(nsrc):
        for k in range(nsrc):
            G[j * L:(j + 1) * L, k * L:(k + 1) * L] = \
                corr[j, k][-idx % nfft]
    # D[i, j*L+a] = sum_t est_i[t] ref_j[t-a]
    xcorr = np.fft.irfft(ef[:, None] * rf[None].conj(), n=nfft)
    D = xcorr[:, :, :L].reshape(est.shape[0], nsrc * L)
    return G, D


def _bss_eval_sdr(ref: np.ndarray, est: np.ndarray, L: int = 512):
    """BSS-eval SDR with permutation search. ref/est: S x T ->
    (per-source SDR under the best permutation, permutation)."""
    nsrc, T = ref.shape
    L = min(L, max(T // 4, 1))
    G, D = _proj_matrices(ref, est, L)
    G = G + np.eye(nsrc * L) * (1e-10 * np.trace(G) / (nsrc * L) + 1e-12)
    e_est = np.einsum("it,it->i", est, est)
    # s_target for pairing (i, j): projection of est_i onto the shifted
    # copies of ref_j; the residual ||est - P est||^2 = ||est||^2 -
    # ||P est||^2 (orthogonal projection) is e_interf + e_artif
    sdr_pair = np.zeros((est.shape[0], nsrc))
    for j in range(nsrc):
        Gj = G[j * L:(j + 1) * L, j * L:(j + 1) * L]
        Dj = D[:, j * L:(j + 1) * L]
        cj = np.linalg.solve(Gj, Dj.T).T
        s_target = np.einsum("ik,ik->i", cj, Dj)
        distortion = np.maximum(e_est - s_target, 1e-12)
        sdr_pair[:, j] = 10 * np.log10(
            np.maximum(s_target, 1e-12) / distortion)
    best, best_perm = None, None
    for order in permutations(range(nsrc)):
        tot = sum(sdr_pair[i, j] for i, j in enumerate(order))
        if best is None or tot > best:
            best, best_perm = tot, order
    return np.asarray([sdr_pair[i, j]
                       for i, j in enumerate(best_perm)]), best_perm
