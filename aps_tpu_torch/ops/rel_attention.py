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
the autograd Function `_FlashRel`; a failed build or launch raises. The
kernels copy rows 16 bytes at a time, so an operand at an odd storage
offset is copied first. A head up to 128 wide and not 16, 32, 64 or 128
is zero-padded up, table included, and runs at its true scale
(attention.with_padded_heads; K2's kernels take such a head unpadded,
these do not yet); a wider one runs the wide kernels of
csrc/wide_attention.cu (forward with lse, dq, dk/dv and dpose with the
same arguments, any width, on the tensor cores: 32 rows a block, the
head split in quarters between four warps a row group, a head over 256
in passes of 256 columns), counted under the same names.
`rel_mha_reference` and `rel_mha_backward_reference` are the same
functions in plain PyTorch: the first serves CPU tensors (autograd gives
its gradient), and both are held against the kernels on the card, as is
`rel_lse_reference` against the forward's lse."""

from typing import Optional, Tuple

import torch

from aps_tpu_torch.asr.transformer.utils import digit_shift
from aps_tpu_torch.ops import build
from aps_tpu_torch.ops.attention import (_OCCUPANCY_KEYS, _aligned,
                                         _source, is_wide, with_padded_heads)

__all__ = [
    "flash_attention_rel", "rel_mha_reference", "rel_lse_reference",
    "rel_mha_backward_reference"
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


def _scale(D: int, softmax_scale: Optional[float]) -> float:
    return float(softmax_scale) if softmax_scale is not None else D**-0.5


def _rel_scores(q_c, q_p, k, pose, k_len, causal, softmax_scale=None):
    """Masked scaled scores, B x H x T x T (the dtype's minimum where a key
    is not visible), and the mask."""
    B, H, T, D = q_c.shape
    s = torch.einsum("bhld,bhsd->bhls", q_c, k)
    g = torch.einsum("bhld,hpd->bhlp", q_p,
                     pose.expand((H,) + tuple(pose.shape[1:])))
    s = (s + digit_shift(g)) * _scale(D, softmax_scale)
    mask = _attn_mask(T, k_len, causal, q_c.device)
    return torch.where(mask, s, torch.finfo(s.dtype).min), mask


def rel_lse_reference(q_c: torch.Tensor,
                      q_p: torch.Tensor,
                      k: torch.Tensor,
                      pose: torch.Tensor,
                      k_len: Optional[torch.Tensor] = None,
                      causal: bool = False) -> torch.Tensor:
    """Plain-PyTorch row-wise log-sum-exp of the masked scores, B x H x T,
    as the forward kernel writes it for the backward: 1e30 for a row
    without a visible key."""
    s, mask = _rel_scores(q_c, q_p, k, pose, k_len, causal)
    lse = torch.logsumexp(s, -1)
    return torch.where(mask.any(-1), lse, torch.full_like(lse, 1e30))


def rel_mha_reference(q_c: torch.Tensor,
                      q_p: torch.Tensor,
                      k: torch.Tensor,
                      v: torch.Tensor,
                      pose: torch.Tensor,
                      k_len: Optional[torch.Tensor] = None,
                      causal: bool = False,
                      softmax_scale: Optional[float] = None) -> torch.Tensor:
    """Dense plain-PyTorch version. q_c/q_p/k/v: B x H x T x D,
    pose: Hp x 2T-1 x D, k_len: B; softmax_scale defaults to D**-0.5."""
    s, mask = _rel_scores(q_c, q_p, k, pose, k_len, causal, softmax_scale)
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


_HEAD_DIMS = (16, 32, 64, 128)
_IN = [build.P] * 6  # q_c q_p k v pose k_len
_DIMS = [build.I] * 5 + [build.F, build.I]  # B H Hp T D scale causal
_FWD_ARGTYPES = _IN + _DIMS + [build.P] * 3  # out lse stream
# do lse delta, dims, two outputs (dpose: scratch and output), stream; dq
# also reads the forward's output (before the stream)
_BWD_ARGTYPES = _IN + [build.P] * 3 + _DIMS + [build.P] * 3
_DQ_ARGTYPES = _BWD_ARGTYPES[:-1] + [build.P] * 2


BACKWARD_KERNELS = ("dq", "dkv", "dpose")


def launch_forward(q_c, q_p, k, v, pose, klen, causal: bool, want_lse: bool,
                   scale: Optional[float] = None):
    """Launch the forward kernel on checked, 16-byte aligned CUDA tensors
    (klen int32; scale D**-0.5 unless given) -> (out, lse or None).
    flash_attention_rel is the public entry; this one and
    launch_backward_kernel let a check time each kernel alone."""
    B, H, T, D = q_c.shape
    out = torch.empty_like(q_c)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q_c.device) \
        if want_lse else None
    src, entry = _source(D, "rel_attention", "aps_rel_attention_fwd")
    lib = build.load(src, entry, _FWD_ARGTYPES)
    rc = getattr(lib, entry)(
        q_c.data_ptr(), q_p.data_ptr(), k.data_ptr(), v.data_ptr(),
        pose.data_ptr(), klen.data_ptr(), B, H, pose.shape[0], T, D,
        _scale(D, scale), int(causal), out.data_ptr(),
        lse.data_ptr() if want_lse else None, build.stream_ptr(q_c.device))
    build.check(lib, rc, "flash_attention_rel")
    build.count_launch("flash_attention_rel")
    return out, lse


def launch_backward_kernel(kernel: str, q_c, q_p, k, v, pose, klen, do, lse,
                           out, delta, causal: bool,
                           scale: Optional[float] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch one of BACKWARD_KERNELS on checked, 16-byte aligned CUDA
    tensors: "dq" -> (dq_c, dq_p), "dkv" -> (dk, dv), "dpose" -> (dpose,
    the per-(b, h) partial tables it was summed from). out is the forward's
    output and delta a B x H x T float32 buffer: "dq" forms delta =
    sum(do * out, -1) and writes it there; "dkv" and "dpose" read it (and
    not out), so they run after dq."""
    B, H, T, D = q_c.shape
    if kernel == "dpose":
        outs = (torch.empty((B * H, 2 * T - 1, D), dtype=torch.float32,
                            device=q_c.device), torch.empty_like(pose))
    else:
        outs = (torch.empty_like(q_c), torch.empty_like(q_c))
    src, entry = _source(D, "rel_attention_bwd",
                         f"aps_rel_attention_{kernel}")
    lib = build.load(src, entry,
                     _DQ_ARGTYPES if kernel == "dq" else _BWD_ARGTYPES)
    extra = [out.data_ptr()] if kernel == "dq" else []
    rc = getattr(lib, entry)(
        q_c.data_ptr(), q_p.data_ptr(), k.data_ptr(), v.data_ptr(),
        pose.data_ptr(), klen.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), B, H, pose.shape[0], T, D, _scale(D, scale),
        int(causal), outs[0].data_ptr(), outs[1].data_ptr(), *extra,
        build.stream_ptr(q_c.device))
    build.check(lib, rc, f"flash_attention_rel_{kernel}")
    build.count_launch(f"flash_attention_rel_{kernel}")
    return outs[::-1] if kernel == "dpose" else outs


def occupancy(D: int, kernel: str):
    """How kernel "fwd", "dq", "dkv" or "dpose" sits on an SM of the current
    card at head dim D: registers and bytes of local memory (spills) a
    thread, bytes of dynamic shared memory a block, resident blocks an SM,
    and query rows a forward block, key rows a dq tile, query rows a dk/dv
    tile or table rows a dpose block."""
    import ctypes
    info = (ctypes.c_int * 5)()
    if kernel == "fwd":
        lib = build.load("rel_attention", "aps_rel_attention_fwd_occupancy",
                         [build.I, build.P])
        rc = lib.aps_rel_attention_fwd_occupancy(D, info)
    else:
        lib = build.load("rel_attention_bwd",
                         "aps_rel_attention_bwd_occupancy",
                         [build.I, build.I, build.P])
        rc = lib.aps_rel_attention_bwd_occupancy(
            D, BACKWARD_KERNELS.index(kernel), info)
    build.check(lib, rc, f"flash_attention_rel {kernel} occupancy")
    rows = "query_rows" if kernel == "fwd" else "tile_rows"
    return dict(zip(_OCCUPANCY_KEYS + (rows,), info))


class _FlashRel(torch.autograd.Function):
    """flash_attention_rel on CUDA tensors with a gradient: the forward
    kernel also writes lse; backward launches the dq kernel (which also
    forms delta), then dk/dv and dpose (k_len gets no gradient)."""

    @staticmethod
    def forward(ctx, q_c, q_p, k, v, pose, klen, causal, scale):
        out, lse = launch_forward(q_c, q_p, k, v, pose, klen, causal, True,
                                  scale)
        ctx.save_for_backward(q_c, q_p, k, v, pose, klen, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, do):
        *args, out, lse = ctx.saved_tensors
        do = _aligned(do.contiguous())
        build.require_cuda("flash_attention_rel backward", {"do": do})
        delta = torch.empty_like(lse)
        grads = [launch_backward_kernel(kernel, *args, do, lse, out, delta,
                                        ctx.causal, ctx.scale)
                 for kernel in BACKWARD_KERNELS]
        return (*grads[0], *grads[1], grads[2][0], None, None, None)


def flash_attention_rel(q_c: torch.Tensor,
                        q_p: torch.Tensor,
                        k: torch.Tensor,
                        v: torch.Tensor,
                        pose: torch.Tensor,
                        k_len: Optional[torch.Tensor] = None,
                        causal: bool = False,
                        softmax_scale: Optional[float] = None
                        ) -> torch.Tensor:
    """Blocked softmax attention with in-kernel relative-position scores.

    q_c/q_p/k/v: B x H x T x D float32, pose: Hp x (2T-1) x D with Hp in
    {1, H}, k_len: optional B valid key lengths. Scores are scaled by
    softmax_scale, D**-0.5 by default. Returns B x H x T x D; gradients
    flow to q_c, q_p, k, v and pose.
    CPU tensors take rel_mha_reference (and autograd through it); CUDA
    tensors launch the kernels of csrc/rel_attention.cu and, for the
    gradient, csrc/rel_attention_bwd.cu (D in {16, 32, 64, 128}; any
    other D up to 128 zero-padded up by with_padded_heads; a wider one
    the tensor-core tiles of csrc/wide_attention.cu)."""
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
                                 causal=causal, softmax_scale=softmax_scale)
    scale = _scale(D, softmax_scale)
    if D not in _HEAD_DIMS and not is_wide(D):
        return with_padded_heads(flash_attention_rel, "flash_attention_rel",
                                 (q_c, q_p, k, v, pose), k_len, causal,
                                 softmax_scale=scale)
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
        return _FlashRel.apply(*map(_aligned, (q_c, q_p, k, v, pose)), klen,
                               bool(causal), scale)
    return launch_forward(*map(_aligned, (q_c, q_p, k, v, pose)), klen,
                          bool(causal), False, scale)[0]
