#!/usr/bin/env python
"""Flat-lane beam selection helpers (port of aps_tpu/asr/beam_search/att.py:
segmented_topk, _per_utt)."""

from typing import Optional

import torch


def segmented_topk(total: torch.Tensor, cand: Optional[torch.Tensor],
                   num_utts: int, K: int):
    """Per-utterance top-K beam selection over flat lanes.
    total: (N*K, C) fused scores; cand: (N*K, C) candidate token ids (or
    None -> token id = column index). Returns (score, beam_idx, tok,
    flat_idx), flat (N*K,) each: global lane indices of the parents, the
    chosen tokens and indices into the per-utterance K*C candidate axis
    for scorer-state gathers."""
    N = num_utts
    C = total.shape[-1]
    score_u, idx_u = torch.topk(total.reshape(N, K * C), K, dim=-1)
    base = torch.arange(N, device=total.device)[:, None]
    beam_idx = (base * K + idx_u // C).reshape(-1)
    if cand is None:
        tok = (idx_u % C).reshape(-1)
    else:
        tok = torch.gather(cand.reshape(N, K * C), 1, idx_u).reshape(-1)
    flat_idx = (base * (K * C) + idx_u).reshape(-1)
    return score_u.reshape(-1), beam_idx, tok, flat_idx


def _per_utt(x: torch.Tensor, num_utts: int, reduce) -> torch.Tensor:
    """Reduce a flat (N*K,) lane vector per utterance -> (N,)."""
    return reduce(x.reshape(num_utts, -1), dim=1)
