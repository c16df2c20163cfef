#!/usr/bin/env python
"""Flash attention with relative-position scores, forward and backward.

Port of aps_tpu/ops/pallas/rel_attention.py::flash_attention_rel:

    score[b,h,l,s] = (q_c[b,h,l] . k[b,h,s]
                      + q_p[b,h,l] . pose[hp, s - l + T - 1]) * scale

with hp = 0 for a shared table (Hp == 1, Shaw) or h (Hp == H, XL), keys
s >= k_len[b] masked (suffix padding), an optional causal mask, and fully
masked rows giving 0. Self-attention only (Tq == Tk == T).

On CUDA tensors the forward is csrc/rel_attention.cu and the backward
csrc/rel_attention_bwd.cu (dq_c/dq_p, dk/dv and dpose kernels), joined by
the autograd Function `_FlashRel`; a failed build or launch raises.
`rel_mha_reference` and `rel_mha_backward_reference` are the same
functions in plain PyTorch: the first serves CPU tensors (autograd gives
its gradient), and both are held against the kernels on the card."""

from typing import Optional, Tuple

import torch

from aps_tpu_torch.asr.transformer.utils import digit_shift
from aps_tpu_torch.ops import build

__all__ = [
    "flash_attention_rel", "rel_mha_reference", "rel_mha_backward_reference"
]


def _attn_mask(T: int, k_len: Optional[torch.Tensor], causal: bool,
               device) -> torch.Tensor:
    """(B or 1) x 1 x T x T bool, True where key s is visible to row l."""
    pos = torch.arange(T, device=device)
    mask = torch.ones((1, 1, T, T), dtype=torch.bool, device=device)
    if k_len is not None:
        mask = pos[None, None, None, :] < k_len.to(device)[:, None, None,
                                                           None]
    if causal:
        mask = mask & (pos[None, None, None, :] <= pos[None, None, :, None])
    return mask


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
    mask = _attn_mask(T, k_len, causal, q_c.device)
    s = torch.where(mask, s, torch.finfo(s.dtype).min)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m) * mask
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bhls,bhsd->bhld", p / torch.clamp_min(l, 1e-30), v)
    return torch.where(l > 0, o, torch.zeros_like(o))


def rel_mha_backward_reference(
        q_c: torch.Tensor,
        q_p: torch.Tensor,
        k: torch.Tensor,
        v: torch.Tensor,
        pose: torch.Tensor,
        do: torch.Tensor,
        k_len: Optional[torch.Tensor] = None,
        causal: bool = False
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
           torch.Tensor]:
    """Dense plain-PyTorch backward of rel_mha_reference, by the explicit
    formulas the kernels implement (no autograd inside): given do, the
    gradient of the output, returns (dq_c, dq_p, dk, dv, dpose)."""
    B, H, T, D = q_c.shape
    Hp = pose.shape[0]
    scale = D**-0.5
    dev = q_c.device
    # rel[l, s] = s - l + T - 1, the pose row of entry (l, s)
    pos = torch.arange(T, device=dev)
    rel = pos[None, :] - pos[:, None] + T - 1
    band = pose.expand((H,) + tuple(pose.shape[1:]))[:, rel]  # H x T x T x D
    s = (torch.einsum("bhld,bhsd->bhls", q_c, k) +
         torch.einsum("bhld,hlsd->bhls", q_p, band)) * scale
    mask = _attn_mask(T, k_len, causal, dev)
    s = torch.where(mask, s, torch.finfo(s.dtype).min)
    m = s.amax(-1, keepdim=True)
    e = torch.exp(s - m) * mask
    l = e.sum(-1, keepdim=True)
    p = torch.where(l > 0, e / torch.clamp_min(l, 1e-30),
                    torch.zeros_like(e))
    o = torch.einsum("bhls,bhsd->bhld", p, v)
    dp = torch.einsum("bhld,bhsd->bhls", do, v)
    delta = (do * o).sum(-1, keepdim=True)
    ds = p * (dp - delta) * scale
    dq_c = torch.einsum("bhls,bhsd->bhld", ds, k)
    dq_p = torch.einsum("bhls,hlsd->bhld", ds, band)
    dk = torch.einsum("bhls,bhld->bhsd", ds, q_c)
    dv = torch.einsum("bhls,bhld->bhsd", p, do)
    # every (l, s) adds ds[l, s] q_p[l] into table row rel[l, s]
    contrib = torch.einsum("bhls,bhld->hlsd", ds, q_p)
    if Hp == 1:
        contrib = contrib.sum(0, keepdim=True)
    dpose = torch.zeros_like(pose)
    dpose.index_add_(1, rel.reshape(-1), contrib.reshape(Hp, T * T, D))
    return dq_c, dq_p, dk, dv, dpose


_HEAD_DIMS = (16, 32, 64)
_IN = [build.P] * 6  # q_c q_p k v pose k_len
_DIMS = [build.I] * 5 + [build.F, build.I]  # B H Hp T D scale causal
_FWD_ARGTYPES = _IN + _DIMS + [build.P] * 3  # out lse stream
# do lse delta, dims, two outputs (dpose: scratch and output), stream
_BWD_ARGTYPES = _IN + [build.P] * 3 + _DIMS + [build.P] * 3


BACKWARD_KERNELS = ("dq", "dkv", "dpose")


def launch_forward(q_c, q_p, k, v, pose, klen, causal: bool, want_lse: bool):
    """Launch the forward kernel on checked CUDA tensors (klen int32) ->
    (out, lse or None). flash_attention_rel is the public entry; this one
    and launch_backward_kernel let a check time each kernel alone."""
    B, H, T, D = q_c.shape
    out = torch.empty_like(q_c)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q_c.device) \
        if want_lse else None
    lib = build.load("rel_attention", "aps_rel_attention_fwd", _FWD_ARGTYPES)
    rc = lib.aps_rel_attention_fwd(
        q_c.data_ptr(), q_p.data_ptr(), k.data_ptr(), v.data_ptr(),
        pose.data_ptr(), klen.data_ptr(), B, H, pose.shape[0], T, D,
        float(D**-0.5), int(causal), out.data_ptr(),
        lse.data_ptr() if want_lse else None, build.stream_ptr(q_c.device))
    build.check(lib, rc, "flash_attention_rel")
    build.count_launch("flash_attention_rel")
    return out, lse


def launch_backward_kernel(kernel: str, q_c, q_p, k, v, pose, klen, do, lse,
                           delta, causal: bool
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch one of BACKWARD_KERNELS on checked CUDA tensors: "dq" ->
    (dq_c, dq_p), "dkv" -> (dk, dv), "dpose" -> (dpose, the per-(b, h)
    partial tables it was summed from). delta = sum(do * out, -1)."""
    B, H, T, D = q_c.shape
    if kernel == "dpose":
        outs = (torch.empty((B * H, 2 * T - 1, D), dtype=torch.float32,
                            device=q_c.device), torch.empty_like(pose))
    else:
        outs = (torch.empty_like(q_c), torch.empty_like(q_c))
    entry = f"aps_rel_attention_{kernel}"
    lib = build.load("rel_attention_bwd", entry, _BWD_ARGTYPES)
    rc = getattr(lib, entry)(
        q_c.data_ptr(), q_p.data_ptr(), k.data_ptr(), v.data_ptr(),
        pose.data_ptr(), klen.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), B, H, pose.shape[0], T, D, float(D**-0.5),
        int(causal), outs[0].data_ptr(), outs[1].data_ptr(),
        build.stream_ptr(q_c.device))
    build.check(lib, rc, f"flash_attention_rel_{kernel}")
    build.count_launch(f"flash_attention_rel_{kernel}")
    return outs[::-1] if kernel == "dpose" else outs


class _FlashRel(torch.autograd.Function):
    """flash_attention_rel on CUDA tensors with a gradient: the forward
    kernel also writes lse; backward launches the dq, dk/dv and dpose
    kernels (k_len gets no gradient)."""

    @staticmethod
    def forward(ctx, q_c, q_p, k, v, pose, klen, causal):
        out, lse = launch_forward(q_c, q_p, k, v, pose, klen, causal, True)
        ctx.save_for_backward(q_c, q_p, k, v, pose, klen, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, do):
        *args, out, lse = ctx.saved_tensors
        do = do.contiguous()
        build.require_cuda("flash_attention_rel backward", {"do": do})
        delta = (do * out).sum(-1)
        grads = [launch_backward_kernel(kernel, *args, do, lse, delta,
                                        ctx.causal)
                 for kernel in BACKWARD_KERNELS]
        return (*grads[0], *grads[1], grads[2][0], None, None)


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
    D**-0.5. Returns B x H x T x D; gradients flow to q_c, q_p, k, v and
    pose.
    CPU tensors take rel_mha_reference (and autograd through it); CUDA
    tensors launch the kernels of csrc/rel_attention.cu and, for the
    gradient, csrc/rel_attention_bwd.cu (D in {16, 32, 64})."""
    tensors = {"q_c": q_c, "q_p": q_p, "k": k, "v": v, "pose": pose}
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
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in tensors.values()):
        return _FlashRel.apply(q_c, q_p, k, v, pose, klen, bool(causal))
    return launch_forward(q_c, q_p, k, v, pose, klen, bool(causal), False)[0]
