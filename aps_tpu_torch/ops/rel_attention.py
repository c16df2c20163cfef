#!/usr/bin/env python
"""Flash attention with relative-position scores (forward only).

Port of the forward of aps_tpu/ops/pallas/rel_attention.py::
flash_attention_rel:

    score[b,h,l,s] = (q_c[b,h,l] . k[b,h,s]
                      + q_p[b,h,l] . pose[hp, s - l + T - 1]) * scale

with hp = 0 for a shared table (Hp == 1, Shaw) or h (Hp == H, XL), keys
s >= k_len[b] masked (suffix padding), an optional causal mask, and fully
masked rows giving 0. Self-attention only (Tq == Tk == T).

The CUDA kernel is csrc/rel_attention.cu; `rel_mha_reference` is the same
function in plain PyTorch, used for CPU tensors and held against the kernel
on the card. There is no backward yet: a call that needs a gradient
raises."""

from typing import Optional

import torch

from aps_tpu_torch.asr.transformer.utils import digit_shift
from aps_tpu_torch.ops import build

__all__ = ["flash_attention_rel", "rel_mha_reference"]


def rel_mha_reference(q_c: torch.Tensor,
                      q_p: torch.Tensor,
                      k: torch.Tensor,
                      v: torch.Tensor,
                      pose: torch.Tensor,
                      k_len: Optional[torch.Tensor] = None,
                      causal: bool = False) -> torch.Tensor:
    """Dense plain-PyTorch version. q_c/q_p/k/v: B x H x T x D,
    pose: Hp x 2T-1 x D, k_len: B."""
    B, H, T, D = q_c.shape
    scale = D**-0.5
    s = torch.einsum("bhld,bhsd->bhls", q_c, k)
    g = torch.einsum("bhld,hpd->bhlp", q_p,
                     pose.expand((H,) + tuple(pose.shape[1:])))
    s = (s + digit_shift(g)) * scale
    pos = torch.arange(T, device=q_c.device)
    mask = torch.ones((1, 1, T, T), dtype=torch.bool, device=q_c.device)
    if k_len is not None:
        mask = pos[None, None, None, :] < k_len.to(q_c.device)[:, None, None,
                                                               None]
    if causal:
        mask = mask & (pos[None, None, None, :] <= pos[None, None, :, None])
    s = torch.where(mask, s, torch.finfo(s.dtype).min)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m) * mask
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bhls,bhsd->bhld", p / torch.clamp_min(l, 1e-30), v)
    return torch.where(l > 0, o, torch.zeros_like(o))


_ARGTYPES = [
    build.P, build.P, build.P, build.P, build.P, build.P,  # qc qp k v pose kl
    build.I, build.I, build.I, build.I, build.I,  # B H Hp T D
    build.F, build.I, build.P, build.P  # scale causal out stream
]
_HEAD_DIMS = (16, 32, 64)


def flash_attention_rel(q_c: torch.Tensor,
                        q_p: torch.Tensor,
                        k: torch.Tensor,
                        v: torch.Tensor,
                        pose: torch.Tensor,
                        k_len: Optional[torch.Tensor] = None,
                        causal: bool = False) -> torch.Tensor:
    """Blocked softmax attention with in-kernel relative-position scores.

    q_c/q_p/k/v: B x H x T x D float32, pose: Hp x (2T-1) x D with Hp in
    {1, H}, k_len: optional B valid key lengths. Scores are scaled by
    D**-0.5. Returns B x H x T x D.
    CPU tensors take rel_mha_reference; CUDA tensors launch
    csrc/rel_attention.cu (D in {16, 32, 64})."""
    tensors = {"q_c": q_c, "q_p": q_p, "k": k, "v": v, "pose": pose}
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in tensors.values()):
        raise NotImplementedError(
            "flash_attention_rel has no backward yet (it comes with the "
            "training port); call it under torch.no_grad()")
    B, H, T, D = q_c.shape
    for key, t in tensors.items():
        if key != "pose" and tuple(t.shape) != (B, H, T, D):
            raise ValueError(f"flash_attention_rel: {key} is "
                             f"{tuple(t.shape)}, expected {(B, H, T, D)} "
                             "(self-attention only)")
    Hp = pose.shape[0]
    if pose.dim() != 3 or Hp not in (1, H) or pose.shape[1] != 2 * T - 1 \
            or pose.shape[2] != D:
        raise ValueError(f"flash_attention_rel: pose must be (Hp, 2T-1, D) "
                         f"with Hp in {{1, {H}}}, got {tuple(pose.shape)} "
                         f"for T={T}")
    if q_c.device.type == "cpu":
        return rel_mha_reference(q_c, q_p, k, v, pose, k_len=k_len,
                                 causal=causal)
    if D not in _HEAD_DIMS:
        raise ValueError(f"flash_attention_rel: head dim {D} not in "
                         f"{_HEAD_DIMS}")
    build.require_cuda("flash_attention_rel", tensors)
    dev = q_c.device
    if k_len is None:
        klen = torch.full((B,), T, dtype=torch.int32, device=dev)
    else:
        klen = k_len.to(device=dev, dtype=torch.int32).contiguous()
        if tuple(klen.shape) != (B,):
            raise ValueError(f"flash_attention_rel: k_len is "
                             f"{tuple(klen.shape)}, expected ({B},)")
    scale = D**-0.5
    out = torch.empty_like(q_c)
    lib = build.load("rel_attention", "aps_rel_attention_fwd", _ARGTYPES)
    rc = lib.aps_rel_attention_fwd(q_c.data_ptr(), q_p.data_ptr(),
                                   k.data_ptr(), v.data_ptr(),
                                   pose.data_ptr(), klen.data_ptr(), B, H,
                                   Hp, T, D, float(scale), int(bool(causal)),
                                   out.data_ptr(), build.stream_ptr(dev))
    build.check(lib, rc, "flash_attention_rel")
    build.count_launch("flash_attention_rel")
    return out
