#!/usr/bin/env python
"""One CTC prefix-scorer step over flat candidate lanes (joint CTC/attention
decoding).

Port of aps_tpu/ops/pallas/ctc_score.py::ctc_score_step: phi, the gamma_n
and gamma_b log-linear recursions over T, the logsumexp extension score,
the eos full-prefix score and the delta against the old score, for
L = beams x candidates lanes at once. The parent beams' gammas and scores
may be passed unexpanded (P = L / C columns for C candidates a beam): lane l
reads column l / (L / P). The CUDA kernel (csrc/ctc_score.cu) solves the
recursions as a chunked parallel scan over T; `ctc_score_step_plain` is the
same recursion as a serial loop in plain PyTorch, used for CPU tensors and
held against the kernel on the card."""

from typing import Tuple, Union

import torch

from aps_tpu_torch.const import MIN_F32
from aps_tpu_torch.ops import build

__all__ = ["ctc_score_step", "ctc_score_step_plain"]

Flag = Union[bool, float, torch.Tensor]


def _flag(is_first: Flag, device: torch.device) -> torch.Tensor:
    """is_first as a 1 x 1 float32 tensor on device."""
    if isinstance(is_first, torch.Tensor):
        return is_first.to(device=device, dtype=torch.float32).reshape(1, 1)
    return torch.full((1, 1), float(is_first), dtype=torch.float32,
                      device=device)


def _check_shapes(p_c, gamma_nx, gamma_bx, p_blank, repeat_ok, eos_mask,
                  old_score) -> int:
    """-> P, the parent columns of gamma_nx, gamma_bx and old_score."""
    T, L = p_c.shape
    P = gamma_nx.shape[-1]
    if P < 1 or L % P != 0:
        raise ValueError(f"ctc_score_step: gamma_nx is "
                         f"{tuple(gamma_nx.shape)}, expected {T} x P with P "
                         f"dividing {L}")
    for key, t, want in (("gamma_nx", gamma_nx, (T, P)),
                         ("gamma_bx", gamma_bx, (T, P)),
                         ("repeat_ok", repeat_ok, (1, L)),
                         ("eos_mask", eos_mask, (1, L)),
                         ("old_score", old_score, (1, P))):
        if tuple(t.shape) != want:
            raise ValueError(f"ctc_score_step: {key} is {tuple(t.shape)}, "
                             f"expected {want}")
    if p_blank.dim() != 2 or p_blank.shape[0] != T or \
            L % p_blank.shape[1] != 0:
        raise ValueError(f"ctc_score_step: p_blank is "
                         f"{tuple(p_blank.shape)}, expected {T} x G with G "
                         f"dividing {L}")
    return P


def ctc_score_step_plain(p_c: torch.Tensor, gamma_nx: torch.Tensor,
                         gamma_bx: torch.Tensor, p_blank: torch.Tensor,
                         repeat_ok: torch.Tensor, eos_mask: torch.Tensor,
                         old_score: torch.Tensor, is_first: Flag
                         ) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of ctc_score_step (same arguments): the parent
    columns expanded to the lanes, then the two recursions as a loop over T,
    vectorised over the lanes."""
    P = _check_shapes(p_c, gamma_nx, gamma_bx, p_blank, repeat_ok, eos_mask,
                      old_score)
    T, L = p_c.shape
    if P != L:
        gamma_nx, gamma_bx, old_score = (
            x.repeat_interleave(L // P, dim=1)
            for x in (gamma_nx, gamma_bx, old_score))
    pb = p_blank.repeat_interleave(L // p_blank.shape[1], dim=1)
    first = _flag(is_first, p_c.device)[0] > 0
    low = torch.full((L,), MIN_F32, dtype=p_c.dtype, device=p_c.device)
    gn_rep = torch.where(repeat_ok[0] > 0, gamma_nx[:-1], low)
    phi = torch.logaddexp(gamma_bx[:-1], gn_rep)  # (T-1) x L
    a = torch.cat([torch.where(first, p_c[0], low)[None], phi + p_c[1:]])
    gamma_n = torch.empty_like(p_c)
    gamma_b = torch.empty_like(p_c)
    x = torch.clamp_min(a[0], MIN_F32)
    y = low
    gamma_n[0], gamma_b[0] = x, y
    for t in range(1, T):
        y = torch.clamp_min(torch.logaddexp(y + pb[t], x + pb[t]), MIN_F32)
        x = torch.clamp_min(torch.logaddexp(x + p_c[t], a[t]), MIN_F32)
        gamma_n[t], gamma_b[t] = x, y
    score = torch.clamp_min(torch.logsumexp(a, dim=0), MIN_F32)
    full_prefix = torch.logaddexp(gamma_bx[-1], gamma_nx[-1])
    score = torch.where(eos_mask[0] > 0, full_prefix, score)[None]
    return gamma_n, gamma_b, score, score - old_score


_ARGTYPES = [
    build.P, build.P, build.P, build.P, build.I,  # p_c gnx gbx p_blank G
    build.P, build.P, build.P, build.P,  # repeat_ok eos_mask old is_first
    build.I, build.I, build.I,  # T L P
    build.P, build.P, build.P, build.P, build.P  # gn gb score delta stream
]


def ctc_score_step(p_c: torch.Tensor, gamma_nx: torch.Tensor,
                   gamma_bx: torch.Tensor, p_blank: torch.Tensor,
                   repeat_ok: torch.Tensor, eos_mask: torch.Tensor,
                   old_score: torch.Tensor, is_first: Flag
                   ) -> Tuple[torch.Tensor, ...]:
    """CTC prefix-scorer step over flat (T, L) lanes, L = B*C.

    Args:
        p_c: T x L log p(t, cand)
        gamma_nx / gamma_bx: T x P prefix gammas, P dividing L: P = L (one
            column a lane) or the parent beams unexpanded (P = L / C, lane l
            reads column l / C)
        p_blank: T x G blank log-probs, G dividing L (G = 1: one shared
            column; G = N: one column per utterance, lanes utterance-major)
        repeat_ok: 1 x L (1.0 where cand != last token of the prefix)
        eos_mask: 1 x L (1.0 where cand == eos)
        old_score: 1 x P prefix scores, columns as gamma_nx's
        is_first: 1 x 1 tensor or a Python scalar (> 0: empty prefix)
    Returns:
        (gamma_n T x L, gamma_b T x L, score 1 x L, delta 1 x L)
    CPU tensors take ctc_score_step_plain; CUDA tensors launch
    csrc/ctc_score.cu."""
    if p_c.device.type == "cpu":
        return ctc_score_step_plain(p_c, gamma_nx, gamma_bx, p_blank,
                                    repeat_ok, eos_mask, old_score,
                                    is_first)
    _check_shapes(p_c, gamma_nx, gamma_bx, p_blank, repeat_ok, eos_mask,
                  old_score)
    dev = p_c.device
    isf = _flag(is_first, dev).contiguous()
    build.require_cuda(
        "ctc_score_step", {
            "p_c": p_c, "gamma_nx": gamma_nx, "gamma_bx": gamma_bx,
            "p_blank": p_blank, "repeat_ok": repeat_ok,
            "eos_mask": eos_mask, "old_score": old_score, "is_first": isf
        })
    out = (torch.empty_like(p_c), torch.empty_like(p_c),
           torch.empty_like(repeat_ok), torch.empty_like(repeat_ok))
    launch(p_c, gamma_nx, gamma_bx, p_blank, repeat_ok, eos_mask, old_score,
           isf, out)
    return out


def launch(p_c, gamma_nx, gamma_bx, p_blank, repeat_ok, eos_mask, old_score,
           is_first, out) -> None:
    """Launch csrc/ctc_score.cu on checked CUDA tensors (is_first a 1 x 1
    float32 tensor) into out = (gamma_n, gamma_b, score, delta).
    ctc_score_step is the public entry; this one lets a check time the
    kernel without the wrapper's host work."""
    T, L = p_c.shape
    lib = build.load("ctc_score", "aps_ctc_score_step", _ARGTYPES)
    rc = lib.aps_ctc_score_step(p_c.data_ptr(), gamma_nx.data_ptr(),
                                gamma_bx.data_ptr(), p_blank.data_ptr(),
                                p_blank.shape[1], repeat_ok.data_ptr(),
                                eos_mask.data_ptr(), old_score.data_ptr(),
                                is_first.data_ptr(), T, L, gamma_nx.shape[1],
                                *[x.data_ptr() for x in out],
                                build.stream_ptr(p_c.device))
    build.check(lib, rc, "ctc_score_step")
    build.count_launch("ctc_score_step")
