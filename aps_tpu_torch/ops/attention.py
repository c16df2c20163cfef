#!/usr/bin/env python
"""Flash (blocked, online-softmax) multi-head attention, forward and
backward.

Port of aps_tpu/ops/pallas/attention.py::flash_attention:

    score[b,h,l,s] = q[b,h,l] . k[b,h,s] * scale (+ bias[h,l,s])

with an optional additive bias H x Tq x Tk that is shared over the batch
and added after the scaling, keys s >= k_len[b] masked (suffix padding), an
optional causal mask (aligned top-left when Tq != Tk), and rows without a
visible key giving 0. Tq need not equal Tk.

On CUDA tensors the forward is csrc/attention.cu and the backward
csrc/attention_bwd.cu, joined by the autograd Function `_Flash`; a failed
build or launch raises. The backward replaces the TPU kernels _dq_kernel,
_dkv_kernel and _dbias_kernel of aps_tpu's flash_attention. The forward,
dq and dk/dv are bound by arithmetic (4, 6 and 8 Tq Tk D operations a head
on a few T D floats), so they run on the tensor cores: a block owns 64
rows, streams the other side through a two-stage cp.async ring, keeps its
sums in registers and does every product as three TF32 products on the
split operands, which gives float32's accuracy (csrc/attn_tiles.cuh). The
dq kernel also forms delta = sum(do * out, -1) and hands it to the two
others, so dq is launched first. dbias (one block per tile, the batch
summed in order; no model passes a bias) is as first ported. Every kernel
owns its reduction: outputs and gradients repeat bit for bit from run to
run. The kernels copy rows 16 bytes at a time, so an operand at an odd
storage offset is copied first (`_aligned`). They are built for head
widths 16, 32, 64 and 128; any other head up to 128 (8 in the tests'
SepFormer, 96) is launched as it is and runs the tiles of the next of
them (65 to 96: tiles of 96, built for such heads alone), its rows
staged at their own width and zero-filled in shared memory, 4 bytes a
copy where they leave the 16-byte grid, and only its true columns
written: no padded copy and no slice (`with_padded_heads` is left to
the relative-position kernels, which still pad such a head). A head
wider than 128 runs the wide kernels of csrc/wide_attention.cu with the
same arguments, counted under the same names: the forward, dq and dk/dv
on the tensor cores as above, each block's head split between two
warpgroups that add their partial scores through shared memory, and a
head over 256 in passes of 256 columns; dbias a warp an entry on the
CUDA cores. They take every width, a ragged one without a padded copy.
`mha_reference` and `mha_backward_reference` are the same functions in plain
PyTorch: the first serves CPU tensors (autograd gives its gradient), and
both are held against the kernels on the card."""

from typing import Optional, Tuple

import torch

from aps_tpu_torch.ops import build

__all__ = [
    "flash_attention", "mha_reference", "mha_backward_reference",
    "with_padded_heads"
]

_NEG_INF = -1.0e30


def _attn_mask(Tq: int, Tk: int, k_len: Optional[torch.Tensor], causal: bool,
               device) -> torch.Tensor:
    """(B or 1) x 1 x Tq x Tk bool, True where key s is visible to row l."""
    col = torch.arange(Tk, device=device)[None, None, None, :]
    mask = torch.ones((1, 1, Tq, Tk), dtype=torch.bool, device=device)
    if k_len is not None:
        mask = (col < k_len.to(device)[:, None, None, None]).expand(
            -1, 1, Tq, Tk)
    if causal:
        row = torch.arange(Tq, device=device)[None, None, :, None]
        mask = mask & (col <= row)
    return mask


def _probs(q, k, bias, mask, scale):
    """Masked softmax of the scores, 0 on rows without a visible key."""
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if bias is not None:
        s = s + bias[None]
    s = torch.where(mask, s, _NEG_INF)
    m = s.amax(-1, keepdim=True)
    e = torch.exp(s - m) * mask
    l = e.sum(-1, keepdim=True)
    return torch.where(l > 0, e / torch.clamp_min(l, 1e-30),
                       torch.zeros_like(e))


def mha_reference(q: torch.Tensor,
                  k: torch.Tensor,
                  v: torch.Tensor,
                  bias: Optional[torch.Tensor] = None,
                  k_len: Optional[torch.Tensor] = None,
                  causal: bool = False,
                  softmax_scale: Optional[float] = None) -> torch.Tensor:
    """Dense plain-PyTorch version of flash_attention. q: B x H x Tq x D,
    k/v: B x H x Tk x D, bias: H x Tq x Tk, k_len: B."""
    D = q.shape[-1]
    scale = softmax_scale if softmax_scale is not None else D**-0.5
    mask = _attn_mask(q.shape[2], k.shape[2], k_len, causal, q.device)
    p = _probs(q, k, bias, mask, scale)
    return torch.einsum("bhqk,bhkd->bhqd", p, v)


def mha_backward_reference(
        q: torch.Tensor,
        k: torch.Tensor,
        v: torch.Tensor,
        do: torch.Tensor,
        bias: Optional[torch.Tensor] = None,
        k_len: Optional[torch.Tensor] = None,
        causal: bool = False,
        softmax_scale: Optional[float] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
           Optional[torch.Tensor]]:
    """Dense plain-PyTorch backward of mha_reference, by the explicit
    formulas the kernels implement (no autograd inside): given do, the
    gradient of the output, returns (dq, dk, dv, dbias); dbias is None
    without a bias, and carries no trailing scale (the bias is added after
    the scaling)."""
    D = q.shape[-1]
    scale = softmax_scale if softmax_scale is not None else D**-0.5
    mask = _attn_mask(q.shape[2], k.shape[2], k_len, causal, q.device)
    p = _probs(q, k, bias, mask, scale)
    o = torch.einsum("bhqk,bhkd->bhqd", p, v)
    dp = torch.einsum("bhqd,bhkd->bhqk", do, v)
    delta = (do * o).sum(-1, keepdim=True)
    dpre = p * (dp - delta)
    ds = dpre * scale
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do)
    dbias = None if bias is None else dpre.sum(0).to(bias.dtype)
    return dq, dk, dv, dbias


_HEAD_DIMS = (16, 32, 64, 128)


def with_padded_heads(fn, name: str, padded, *args, **kwargs
                      ) -> torch.Tensor:
    """fn(*padded, *args, **kwargs) with each tensor of `padded` zero-padded
    on its last (head) axis from D up to the next width the kernels are
    built for, and the output sliced back to D: how flash_attention_rel
    runs a head up to 128 that its kernels are not built for (K2's kernels
    take such a head as it is). Zero columns change no q . k product, no
    relative term and no gradient of the true columns, and the padded
    columns of v give output columns that the slice drops; the caller
    passes the true scale D**-0.5 in kwargs. A D over 128 is passed as it
    is: the wide kernels take every width."""
    D = padded[0].shape[-1]
    width = next((w for w in _HEAD_DIMS if w >= D), D)
    out = fn(*(torch.nn.functional.pad(t, (0, width - D)) for t in padded),
             *args, **kwargs)
    return out[..., :D]


_IN = [build.P] * 5  # q k v bias k_len
_DIMS = [build.I] * 5 + [build.F, build.I]  # B H Tq Tk D scale causal
_FWD_ARGTYPES = _IN + _DIMS + [build.P] * 3  # out lse stream
# do lse delta, dims, two more pointers (dq: dq and the forward's output;
# dkv: dk and dv; dbias: dbias, null), stream
_BWD_ARGTYPES = _IN + [build.P] * 3 + _DIMS + [build.P] * 3

BACKWARD_KERNELS = ("dq", "dkv", "dbias")


def is_wide(D: int) -> bool:
    """True when a head of width D runs the wide kernels
    (csrc/wide_attention.cu) instead of those built for 16, 32, 64 and
    128."""
    return D > _HEAD_DIMS[-1]


def _source(D: int, name: str, entry: str):
    """(source, entry point) of kernel `entry` of csrc/<name>.cu at head
    width D: the wide kernels' twin for D over 128."""
    if is_wide(D):
        return "wide_attention", entry.replace("_attention_",
                                               "_attention_wide_", 1)
    return name, entry


def launch_forward(q, k, v, bias, klen, scale: float, causal: bool,
                   want_lse: bool):
    """Launch the forward kernel on checked CUDA tensors (bias or None, klen
    int32) -> (out, lse or None). flash_attention is the public entry; this
    one and launch_backward_kernel let a check time each kernel alone."""
    B, H, Tq, D = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device) \
        if want_lse else None
    src, entry = _source(D, "attention", "aps_attention_fwd")
    lib = build.load(src, entry, _FWD_ARGTYPES)
    rc = getattr(lib, entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if bias is None else bias.data_ptr(), klen.data_ptr(), B, H, Tq,
        k.shape[2], D, float(scale), int(causal), out.data_ptr(),
        lse.data_ptr() if want_lse else None, build.stream_ptr(q.device))
    build.check(lib, rc, "flash_attention")
    build.count_launch("flash_attention")
    return out, lse


def launch_backward_kernel(kernel: str, q, k, v, bias, klen, do, lse, out,
                           delta, scale: float, causal: bool):
    """Launch one of BACKWARD_KERNELS on checked CUDA tensors -> dq, (dk,
    dv) or dbias (H x Tq x Tk float32; needs a bias). out is the forward's
    output and delta a B x H x Tq float32 buffer: "dq" forms delta = sum(do *
    out, -1) in its prologue and writes it there; "dkv" and "dbias" read it
    (and not out), so they run after dq."""
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    if kernel == "dq":
        outs = (torch.empty_like(q), out)
    elif kernel == "dkv":
        outs = (torch.empty_like(k), torch.empty_like(v))
    else:
        if bias is None:
            raise ValueError("flash_attention_dbias needs a bias")
        outs = (torch.empty((H, Tq, Tk), dtype=torch.float32,
                            device=q.device), None)
    src, entry = _source(D, "attention_bwd", f"aps_attention_{kernel}")
    lib = build.load(src, entry, _BWD_ARGTYPES)
    rc = getattr(lib, entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if bias is None else bias.data_ptr(), klen.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), B, H, Tq, Tk, D,
        float(scale), int(causal), outs[0].data_ptr(),
        None if outs[1] is None else outs[1].data_ptr(),
        build.stream_ptr(q.device))
    build.check(lib, rc, f"flash_attention_{kernel}")
    build.count_launch(f"flash_attention_{kernel}")
    return outs if kernel == "dkv" else outs[0]


_OCCUPANCY_KEYS = ("registers", "local_bytes", "smem_bytes", "blocks_per_sm")


def forward_occupancy(D: int):
    """How the forward kernel sits on an SM of the current card at head dim
    D: registers and bytes of local memory (spills) a thread, bytes of
    dynamic shared memory a block, resident blocks an SM, query rows a
    block."""
    import ctypes
    lib = build.load("attention", "aps_attention_fwd_occupancy",
                     [build.I, build.P])
    info = (ctypes.c_int * 5)()
    rc = lib.aps_attention_fwd_occupancy(D, info)
    build.check(lib, rc, "flash_attention occupancy")
    return dict(zip(_OCCUPANCY_KEYS + ("query_rows",), info))


def backward_occupancy(D: int, kernel: str):
    """How the "dq" or "dkv" kernel sits on an SM of the current card at
    head dim D: registers and bytes of local memory (spills) a thread, bytes
    of dynamic shared memory a block, resident blocks an SM, streamed rows a
    tile."""
    import ctypes
    lib = build.load("attention_bwd", "aps_attention_bwd_occupancy",
                     [build.I, build.I, build.P])
    info = (ctypes.c_int * 5)()
    rc = lib.aps_attention_bwd_occupancy(D, int(kernel == "dkv"), info)
    build.check(lib, rc, "flash_attention backward occupancy")
    return dict(zip(_OCCUPANCY_KEYS + ("stream_rows",), info))


WIDE_KERNELS = ("K2 forward", "K2 dq", "K2 dk/dv", "K2 dbias", "K3 forward",
                "K3 dq", "K3 dk/dv", "K3 dpose", "K2 forward, D > 256",
                "K2 dq, D > 256", "K2 dk/dv, D > 256", "K3 forward, D > 256",
                "K3 dq, D > 256", "K3 dk/dv, D > 256", "K3 dpose, D > 256")


def wide_occupancy():
    """How each wide kernel (heads over 128, csrc/wide_attention.cu) sits
    on an SM of the current card: registers and bytes of local memory
    (spills) a thread, shared memory a block (static and dynamic), resident
    blocks an SM, head columns a pass (0 for K2's dbias, a warp an entry)
    and threads a block, by WIDE_KERNELS name (K2's forward, dq and dk/dv
    and K3's forward, dq, dk/dv and dpose: the tiles that hold a head up to
    256 whole, and those that run a wider one in passes)."""
    import ctypes
    lib = build.load("wide_attention", "aps_wide_attention_occupancy",
                     [build.I, build.P])
    out = {}
    for index, name in enumerate(WIDE_KERNELS):
        info = (ctypes.c_int * 6)()
        rc = lib.aps_wide_attention_occupancy(index, info)
        build.check(lib, rc, f"wide {name} occupancy")
        out[name] = dict(zip(_OCCUPANCY_KEYS + ("columns_a_pass", "threads"),
                             info))
    return out


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """The kernels copy rows 16 bytes at a time (cp.async) where the head
    width allows it; a contiguous view at an odd storage offset starts off
    that grid, so it is copied."""
    return t.clone() if t.data_ptr() % 16 else t


class _Flash(torch.autograd.Function):
    """flash_attention on CUDA tensors with a gradient: the forward kernel
    also writes lse; backward launches the dq kernel (which also forms
    delta), then dk/dv, and the dbias kernel when a bias asks for its
    gradient (k_len gets none)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, klen, scale, causal):
        out, lse = launch_forward(q, k, v, bias, klen, scale, causal, True)
        ctx.save_for_backward(q, k, v, bias, klen, out, lse)
        ctx.scale, ctx.causal = scale, causal
        return out

    @staticmethod
    def backward(ctx, do):
        *args, out, lse = ctx.saved_tensors
        do = _aligned(do.contiguous())
        build.require_cuda("flash_attention backward", {"do": do})
        delta = torch.empty_like(lse)
        run = lambda kernel: launch_backward_kernel(  # noqa: E731
            kernel, *args, do, lse, out, delta, ctx.scale, ctx.causal)
        dq = run("dq")
        dk, dv = run("dkv")
        dbias = run("dbias") if ctx.needs_input_grad[3] else None
        return dq, dk, dv, dbias, None, None, None


def flash_attention(q: torch.Tensor,
                    k: torch.Tensor,
                    v: torch.Tensor,
                    bias: Optional[torch.Tensor] = None,
                    k_len: Optional[torch.Tensor] = None,
                    causal: bool = False,
                    softmax_scale: Optional[float] = None) -> torch.Tensor:
    """Blocked softmax attention; see the module docstring.

    q: B x H x Tq x D, k/v: B x H x Tk x D float32; bias: optional H x Tq x
    Tk additive bias shared over the batch (receives a gradient); k_len:
    optional B valid key lengths; softmax_scale defaults to D**-0.5. Returns
    B x H x Tq x D; gradients flow to q, k, v and bias.
    CPU tensors take mha_reference (and autograd through it); CUDA tensors
    launch the kernels of csrc/attention.cu and, for the gradient,
    csrc/attention_bwd.cu (any D up to 128, one that is not 16, 32, 64 or
    128 in the tiles of the next of them, unpadded; a wider one those of
    csrc/wide_attention.cu)."""
    if q.dim() != 4:
        raise ValueError(f"flash_attention: q is {tuple(q.shape)}, expected "
                         "B x H x Tq x D")
    B, H, Tq, D = q.shape
    Tk = k.shape[2] if k.dim() == 4 else -1
    for key, t in (("k", k), ("v", v)):
        if tuple(t.shape) != (B, H, Tk, D):
            raise ValueError(f"flash_attention: {key} is {tuple(t.shape)}, "
                             f"expected {(B, H, Tk, D)}")
    if bias is not None and tuple(bias.shape) != (H, Tq, Tk):
        raise ValueError(f"flash_attention: bias is {tuple(bias.shape)}, "
                         f"expected {(H, Tq, Tk)}")
    if k_len is not None and tuple(k_len.shape) != (B,):
        raise ValueError(f"flash_attention: k_len is {tuple(k_len.shape)}, "
                         f"expected ({B},)")
    if q.is_cpu:
        return mha_reference(q, k, v, bias=bias, k_len=k_len, causal=causal,
                             softmax_scale=softmax_scale)
    if Tq == 0 or Tk == 0 or D == 0:
        raise ValueError(f"flash_attention: empty sequence or head (Tq {Tq}, "
                         f"Tk {Tk}, D {D})")
    tensors = {"q": q, "k": k, "v": v}
    if bias is not None:
        tensors["bias"] = bias
    build.require_cuda("flash_attention", tensors)
    dev = q.device
    scale = float(softmax_scale) if softmax_scale is not None else D**-0.5
    if k_len is None:
        klen = torch.full((B,), Tk, dtype=torch.int32, device=dev)
    else:
        klen = k_len.to(device=dev, dtype=torch.int32).contiguous()
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in tensors.values()):
        return _Flash.apply(_aligned(q), _aligned(k), _aligned(v), bias, klen,
                            scale, bool(causal))
    return launch_forward(_aligned(q), _aligned(k), _aligned(v), bias, klen,
                          scale, bool(causal), False)[0]
