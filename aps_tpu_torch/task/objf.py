#!/usr/bin/env python
"""Objective functions of the ASR tasks (port of aps_tpu/task/objf.py:
ce_objf, ls_objf, ctc_objf).

ctc_objf calls torch.nn.functional.ctc_loss where aps_tpu calls
optax.ctc_loss (a library call outside any kernel on both sides). optax
clamps an impossible alignment (a target longer than its input allows) at
about 1e5 per utterance; PyTorch gives inf, which zero_infinity turns into 0
with a zero gradient. A batch with such an utterance therefore differs
between the two; every feasible batch agrees to float32 rounding."""

from typing import Optional

import torch
import torch.nn.functional as tf

from aps_tpu_torch.const import EPSILON, IGNORE_ID


def _masked_targets(outs: torch.Tensor, tgts: torch.Tensor):
    mask = tgts != IGNORE_ID
    safe = torch.where(mask, tgts, torch.zeros_like(tgts)).clamp(
        0, outs.shape[-1] - 1)
    return mask, safe


def ce_objf(outs: torch.Tensor, tgts: torch.Tensor,
            reduction: str = "mean") -> torch.Tensor:
    """Cross entropy with IGNORE_ID masking.
    outs: N x T x V logits, tgts: N x T -> scalar."""
    mask, safe = _masked_targets(outs, tgts)
    logp = tf.log_softmax(outs, dim=-1)
    nll = -logp.gather(-1, safe[..., None])[..., 0]
    loss = (nll * mask).sum()
    return loss / (mask.sum() if reduction == "mean" else outs.shape[0])


def ls_objf(outs: torch.Tensor,
            tgts: torch.Tensor,
            method: str = "uniform",
            reduction: str = "mean",
            lsm_factor: float = 0.1,
            label_count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Label-smoothed KL loss. outs: N x T x V, tgts: N x T -> scalar."""
    if method not in ("uniform", "unigram"):
        raise ValueError(f"Unknown label smoothing method: {method}")
    V = outs.shape[-1]
    mask, safe = _masked_targets(outs, tgts)
    onehot = tf.one_hot(safe, V).to(outs.dtype)
    if method == "uniform":
        dist = torch.full_like(outs, lsm_factor / (V - 1))
    else:
        if label_count is None or label_count.shape[-1] != V:
            raise RuntimeError("#label_count does not match #vocab_size")
        # zero out the target entry, renormalize to lsm_factor
        dist = label_count.to(outs).expand_as(outs) * (1 - onehot)
        dist = dist * lsm_factor / dist.sum(-1, keepdim=True)
    dist = dist * (1 - onehot) + onehot * (1 - lsm_factor)
    logp = tf.log_softmax(outs, dim=-1)
    # KL(dist || softmax(outs))
    kld = (dist * (torch.log(dist.clamp_min(EPSILON)) - logp)).sum(-1)
    loss = (kld * mask).sum()
    return loss / (mask.sum() if reduction == "mean" else outs.shape[0])


def ctc_objf(outs: torch.Tensor,
             tgts: torch.Tensor,
             out_len: torch.Tensor,
             tgt_len: torch.Tensor,
             blank: int = 0,
             reduction: str = "mean",
             add_softmax: bool = True) -> torch.Tensor:
    """CTC loss. outs: N x T x V logits (log-probs when add_softmax is
    False), tgts: N x L (no blanks, IGNORE_ID padded), out_len/tgt_len: N
    -> scalar: the sum over utterances divided by sum(tgt_len) ("mean") or
    by N."""
    N = outs.shape[0]
    logp = tf.log_softmax(outs, dim=-1) if add_softmax else outs
    safe = torch.where(tgts == IGNORE_ID, torch.zeros_like(tgts), tgts)
    loss = tf.ctc_loss(logp.transpose(0, 1), safe, out_len, tgt_len,
                       blank=blank, reduction="sum", zero_infinity=True)
    return loss / (tgt_len.sum() if reduction == "mean" else N)
