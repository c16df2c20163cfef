#!/usr/bin/env python
"""Objective functions of the ASR and separation tasks (port of
aps_tpu/task/objf.py: ce_objf, ls_objf, ctc_objf; sisnr_objf, snr_objf,
dpcl_objf and DpclObjfComputer, multiple_objf, permu_invarint_objf,
hybrid_permu_objf).

ctc_objf calls torch.nn.functional.ctc_loss where aps_tpu calls
optax.ctc_loss (a library call outside any kernel on both sides). optax
clamps an impossible alignment (a target longer than its input allows) at
about 1e5 per utterance; PyTorch gives inf, which zero_infinity turns into 0
with a zero gradient. A batch with such an utterance therefore differs
between the two; every feasible batch agrees to float32 rounding.

Every denominator (the tokens of "mean", the utterances of "batchmean",
the entries of a mean) is the global batch's in a data-parallel step
(aps_tpu_torch.distributed.global_sum and global_mean): each rank's loss
is its rows' sum over the global count, so the ranks' gradients add up to
the one-process gradient whatever rows each rank holds."""

from itertools import permutations
from typing import Any, Callable, List, Optional

import torch
import torch.nn.functional as tf

from aps_tpu_torch.const import EPSILON, IGNORE_ID
from aps_tpu_torch.distributed import global_mean, global_sum


def _masked_targets(outs: torch.Tensor, tgts: torch.Tensor):
    mask = tgts != IGNORE_ID
    safe = torch.where(mask, tgts, torch.zeros_like(tgts)).clamp(
        0, outs.shape[-1] - 1)
    return mask, safe


def _denominator(mask: torch.Tensor, outs: torch.Tensor, reduction: str):
    """The tokens ("mean") or the utterances of the global batch."""
    return global_sum(mask.sum() if reduction == "mean" else outs.shape[0],
                      device=outs.device)


def ce_objf(outs: torch.Tensor, tgts: torch.Tensor,
            reduction: str = "mean") -> torch.Tensor:
    """Cross entropy with IGNORE_ID masking.
    outs: N x T x V logits, tgts: N x T -> scalar."""
    mask, safe = _masked_targets(outs, tgts)
    logp = tf.log_softmax(outs, dim=-1)
    nll = -logp.gather(-1, safe[..., None])[..., 0]
    loss = (nll * mask).sum()
    return loss / _denominator(mask, outs, reduction)


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
    return loss / _denominator(mask, outs, reduction)


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
    return loss / global_sum(tgt_len.sum() if reduction == "mean" else N,
                             device=outs.device)


def _l2norm(mat: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    return torch.sqrt((mat**2).sum(-1, keepdim=keepdim))


def sisnr_objf(x: torch.Tensor,
               s: torch.Tensor,
               eps: float = EPSILON,
               zero_mean: bool = True,
               non_nagetive: bool = False) -> torch.Tensor:
    """Scale-invariant SNR in dB. x (estimate), s (reference): N x S -> N."""
    if x.shape != s.shape:
        raise RuntimeError(f"Shape mismatch in si-snr: {tuple(x.shape)} vs "
                           f"{tuple(s.shape)}")
    if zero_mean:
        x = x - x.mean(-1, keepdim=True)
        s = s - s.mean(-1, keepdim=True)
    t = (x * s).sum(-1, keepdim=True) * s / (_l2norm(s, keepdim=True)**2 +
                                             eps)
    snr_linear = _l2norm(t) / (_l2norm(x - t) + eps)
    if non_nagetive:
        return 10 * torch.log10(1 + snr_linear**2)
    return 20 * torch.log10(eps + snr_linear)


def snr_objf(x: torch.Tensor,
             s: torch.Tensor,
             eps: float = EPSILON,
             snr_max: float = -1,
             non_nagetive: bool = False) -> torch.Tensor:
    """Plain SNR in dB (thresholded at snr_max when it is positive).
    x (estimate), s (reference): N x S -> N."""
    if x.shape != s.shape:
        raise RuntimeError(f"Shape mismatch in snr: {tuple(x.shape)} vs "
                           f"{tuple(s.shape)}")
    if snr_max > 0:
        threshold = 10**(-snr_max / 10)
        s_norm = _l2norm(s)**2
        x_s_norm = _l2norm(x - s)**2
        return 10 * torch.log10(s_norm + eps) - 10 * torch.log10(
            threshold * s_norm + x_s_norm + eps)
    snr_linear = _l2norm(s) / (_l2norm(x - s) + eps)
    if non_nagetive:
        return 10 * torch.log10(1 + snr_linear**2)
    return 20 * torch.log10(eps + snr_linear)


def dpcl_objf(net_embed: torch.Tensor,
              classes: torch.Tensor,
              weights: torch.Tensor,
              num_spks: int = 2) -> torch.Tensor:
    """Deep clustering loss. net_embed: N x FT x D, classes / weights:
    N x F x T -> N (divided by the number of frames)."""
    N, F, T = classes.shape
    ref_embed = tf.one_hot(classes.reshape(N, F * T),
                           num_spks).to(net_embed.dtype)

    def affinity(v, y):
        return (torch.einsum("nid,nie->nde", v, y)**2).sum((1, 2))

    w = torch.sqrt(weights.reshape(N, F * T, 1))
    out = net_embed * w
    ref = ref_embed * w
    loss = affinity(out, out) + affinity(ref, ref) - 2 * affinity(out, ref)
    return loss / T


class DpclObjfComputer(object):
    """DPCL loss from the embeddings and the sources' magnitudes: each TF
    bin belongs to its loudest source and weighs its share of the
    mixture's magnitude."""

    def __call__(self,
                 embedding: torch.Tensor,
                 magnitude_ref: torch.Tensor,
                 magnitude_mix: torch.Tensor,
                 mean: bool = True) -> torch.Tensor:
        """embedding: N x FT x D, magnitude_ref: N x F x T x S,
        magnitude_mix: N x F x T."""
        classes = torch.argmax(magnitude_ref, -1)
        weights = magnitude_mix / magnitude_mix.sum((-1, -2), keepdim=True)
        loss = dpcl_objf(embedding, classes, weights,
                         num_spks=magnitude_ref.shape[-1])
        return global_mean(loss) if mean else loss


def multiple_objf(inp: List[Any],
                  ref: List[Any],
                  objf: Callable,
                  weight: Optional[List[float]] = None,
                  transform: Optional[Callable] = None,
                  batchmean: bool = False) -> torch.Tensor:
    """Weighted sum of per-pair losses."""
    if len(inp) != len(ref):
        raise ValueError(f"#inp vs #ref: {len(inp)} vs {len(ref)}")
    num_tasks = len(inp)
    if weight is None:
        weight = [1 / num_tasks] * num_tasks
    if len(weight) != len(inp):
        raise RuntimeError(f"Missing weight ({len(weight)}) for {num_tasks}")
    if transform:
        inp = [transform(i) for i in inp]
        ref = [transform(r) for r in ref]
    loss = sum(s * objf(o, r) for s, o, r in zip(weight, inp, ref))
    return global_mean(loss) if batchmean else loss


def permu_invarint_objf(inp: List[Any],
                        ref: List[Any],
                        objf: Callable,
                        transform: Optional[Callable] = None,
                        batchmean: bool = False,
                        return_permutation: bool = False):
    """Permutation-invariant loss: the minimum over the speaker
    permutations (itertools order), taken over one stacked P x N tensor."""
    num_spks = len(inp)
    if num_spks != len(ref):
        raise ValueError(f"#inp vs #ref: {num_spks} vs {len(ref)}")
    if transform:
        inp = [transform(i) for i in inp]
        ref = [transform(r) for r in ref]
    if num_spks == 1:
        return objf(inp[0], ref[0])

    def permu_objf(permu):
        return sum(objf(inp[s], ref[t]) for s, t in enumerate(permu)) / \
            len(permu)

    loss_mat = torch.stack(
        [permu_objf(p) for p in permutations(range(num_spks))])
    loss, index = loss_mat.min(dim=0)
    if batchmean:
        loss = global_mean(loss)
    if return_permutation:
        return loss, index
    return loss


# correctly-spelled alias
permutation_invariant_objf = permu_invarint_objf


def hybrid_permu_objf(out: List[Any],
                      ref: List[Any],
                      objf: Callable,
                      transform: Optional[Callable] = None,
                      weight: Optional[List[float]] = None,
                      permute: bool = True,
                      permu_num_spks: int = 2) -> torch.Tensor:
    """PIT over the first permu_num_spks branches + plain weighted loss on
    the residual branches (e.g. a noise output)."""
    num_branch = len(out)
    if num_branch != len(ref):
        raise RuntimeError(f"{len(ref)} references vs {num_branch} outputs")
    if permute:
        loss = permu_invarint_objf(out[:permu_num_spks],
                                   ref[:permu_num_spks],
                                   objf,
                                   transform=transform)
        if num_branch > permu_num_spks:
            num_weight = num_branch - (permu_num_spks - 1)
            if weight is None:
                weight = [1 / num_weight] * num_weight
            other = multiple_objf(out[permu_num_spks:], ref[permu_num_spks:],
                                  objf, weight=weight[1:])
            loss = weight[0] * loss + other
    else:
        loss = multiple_objf(out, ref, objf, weight=weight,
                             transform=transform)
    return loss
