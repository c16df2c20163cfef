#!/usr/bin/env python
"""RNN-Transducer loss in plain PyTorch (port of aps_tpu/ops/rnnt.py::
rnnt_loss; no TPU kernel, and no library loss: torchaudio is not a
dependency).

The forward variables run as aps_tpu's do: one step a frame over all
(N, U+1) cells at once, the label recursion inside a frame

    alpha[t, u] = logaddexp(alpha[t-1, u] + blank(t-1, u),
                            alpha[t, u-1] + label(t, u-1))

closed by a log-cumsum-exp over u of (A - C_t), C_t the cumulative label
scores. The semantics are aps_tpu's:

  * masked transitions are NEG_INF = -1e30, not -inf;
  * labels are clipped to [0, V-1];
  * label transitions at and past each utterance's label_lens are masked;
  * alpha is read at each utterance's own last frame (logit_lens - 1,
    clipped to [0, T-1]) and label count (clipped to [0, U]);
  * reduction "sum", "mean" or anything else for the N losses.

The gradient is autograd's through torch.logcumsumexp. The entries of C_t
past an utterance's labels reach -k x 1e30; logcumsumexp's backward stays
finite there, and the gradient is exactly 0 past each utterance's frames
and labels, as jax.grad of aps_tpu's loss is (tests/test_torch_transducer.py
holds both, and chip_smoke.py holds the card's gradient)."""

import torch
import torch.nn.functional as tf

NEG_INF = -1e30

__all__ = ["rnnt_loss"]


def rnnt_loss(logits: torch.Tensor,
              labels: torch.Tensor,
              logit_lens: torch.Tensor,
              label_lens: torch.Tensor,
              blank: int = 0,
              reduction: str = "sum") -> torch.Tensor:
    """Transducer loss.
    logits: N x T x U+1 x V joint outputs (pre-softmax); labels: N x U
    token ids (no blanks); logit_lens, label_lens: N -> the summed or mean
    negative log-likelihood, or the N of them."""
    N, T, U1, V = logits.shape
    dev = logits.device
    # half-precision logits are promoted to float32; float64 stays
    logp = torch.log_softmax(
        logits.to(torch.promote_types(logits.dtype, torch.float32)), -1)
    lp_blank = logp[..., blank]
    labels = labels.long().clamp(0, V - 1)
    lp_label = torch.gather(
        logp[:, :, :U1 - 1], -1,
        labels[:, None, :, None].expand(N, T, U1 - 1, 1))[..., 0]
    # no label transition from u = U, nor at or past each label length
    lp_label = tf.pad(lp_label, (0, 1), value=NEG_INF)
    valid = torch.arange(U1, device=dev)[None, :] < \
        label_lens.to(dev)[:, None]
    lp_label = lp_label.masked_fill(~valid[:, None, :], NEG_INF)
    # C[n, t, u] = sum_{j < u} lp_label[n, t, j]
    C = torch.cumsum(tf.pad(lp_label[..., :-1], (1, 0)), -1)
    alpha = C[:, 0]
    alphas = [alpha]
    for t in range(1, T):
        A = alpha + lp_blank[:, t - 1]
        alpha = torch.logcumsumexp(A - C[:, t], -1) + C[:, t]
        alphas.append(alpha)
    alphas = torch.stack(alphas, 0)                      # T x N x U+1
    t_last = (logit_lens.to(dev).long() - 1).clamp(0, T - 1)
    u_last = label_lens.to(dev).long().clamp(0, U1 - 1)
    n = torch.arange(N, device=dev)
    nll = -(alphas[t_last, n, u_last] + lp_blank[n, t_last, u_last])
    if reduction == "sum":
        return nll.sum()
    if reduction == "mean":
        return nll.mean()
    return nll
