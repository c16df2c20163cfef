#!/usr/bin/env python
"""One eval-mode Conv-TasNet TCN block with folded weights (the separation
fast path).

Port of aps_tpu/ops/pallas/tcn.py::tcn_block_fused: 1x1 conv B -> H + bias,
PReLU, BatchNorm affine, 3-tap dilated depthwise conv (symmetric or causal,
zero padding of the intermediate), PReLU, BatchNorm affine, 1x1 conv H -> B
+ bias, residual, with the activations never leaving the chip between the
two products. The CUDA kernel (csrc/tcn.cu) gives one block 64 output rows
and 256 output columns of one batch row, runs both products on the tensor
cores (bfloat16 directly, float32 as three TF32 products of split
operands) and runs at any T; the TPU kernel's slab count, its fast-memory
budget and `tcn_fused_fits` have no counterpart.
`tcn_block_reference` is the same function in plain PyTorch, used for CPU
tensors and held against the kernel on the card.

Types: x and the two kernels float32 or bfloat16 (the same for all three),
pack and bias2 float32. Both products accumulate in float32, y2 is rounded
to the kernels' type before the second, the residual is added in float32 and
the output has x's type."""

import torch

from aps_tpu_torch.ops import build

__all__ = ["tcn_block_fused", "tcn_block_reference", "PACK_ROWS"]

# pack rows, all H-wide float32, in this order: c1, g1, h1, w0, w1, w2, cb,
# g2, h2, a1, a2
PACK_ROWS = 11
# the kernel's limits: pieces of 4 elements along the channel axes, and at
# most two groups of 256 output columns
MAX_B = 512


def _check_shapes(x, kernel1, pack, kernel2, bias2, dilation) -> None:
    if x.dim() != 3:
        raise ValueError(f"tcn_block_fused: x is {tuple(x.shape)}, expected "
                         "N x T x B")
    B = x.shape[2]
    if kernel1.dim() != 2 or kernel1.shape[0] != B:
        raise ValueError(f"tcn_block_fused: kernel1 is "
                         f"{tuple(kernel1.shape)}, expected {B} x H")
    H = kernel1.shape[1]
    for key, t, shape in (("pack", pack, (PACK_ROWS, H)),
                          ("kernel2", kernel2, (H, B)),
                          ("bias2", bias2, (1, B))):
        if tuple(t.shape) != shape:
            raise ValueError(f"tcn_block_fused: {key} is {tuple(t.shape)}, "
                             f"expected {shape}")
    if int(dilation) < 1:
        raise ValueError(f"tcn_block_fused: dilation {dilation} < 1")


def _prelu(x: torch.Tensor, slope: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, x, slope * x)


def tcn_block_reference(x: torch.Tensor, kernel1: torch.Tensor,
                        pack: torch.Tensor, kernel2: torch.Tensor,
                        bias2: torch.Tensor, dilation: int,
                        causal: bool = False) -> torch.Tensor:
    """Plain PyTorch version of tcn_block_fused (same arguments): the folded
    block as aps_tpu/sse/bss/tcn.py's shifted-add fold computes it, with the
    products accumulated in float32 as the kernel does."""
    _check_shapes(x, kernel1, pack, kernel2, bias2, dilation)
    T, d = x.shape[1], int(dilation)
    c1, g1, h1, w0, w1, w2, cb, g2, h2, a1, a2 = pack.unbind(0)
    z = x.float() @ kernel1.float() + c1
    z = _prelu(z, a1) * g1 + h1
    pad = (2 * d, 0) if causal else (d, d)
    zp = torch.nn.functional.pad(z, (0, 0) + pad)
    z2 = w0 * zp[:, :T] + w1 * zp[:, d:T + d] + w2 * zp[:, 2 * d:2 * d + T] \
        + cb
    z2 = _prelu(z2, a2) * g2 + h2
    out = z2.to(kernel2.dtype).float() @ kernel2.float() + bias2 + x.float()
    return out.to(x.dtype)


_ARGTYPES = [
    build.P, build.P, build.P, build.P, build.P, build.P,  # x k1 pack k2 b2 out
    build.I, build.I, build.I, build.I,  # N T B H
    build.I, build.I, build.I, build.P  # dilation causal is_bf16 stream
]


def tcn_block_fused(x: torch.Tensor, kernel1: torch.Tensor,
                    pack: torch.Tensor, kernel2: torch.Tensor,
                    bias2: torch.Tensor, dilation: int,
                    causal: bool = False) -> torch.Tensor:
    """One fused eval-mode TCN block.

    Args:
        x: N x T x B input (float32 or bfloat16)
        kernel1: B x H folded input 1x1 kernel (ScaleLinear scale applied),
            of x's type
        pack: PACK_ROWS x H float32 rows [c1, g1, h1, w0, w1, w2, cb, g2, h2,
            prelu1-slope, prelu2-slope]: biases, BN affines and depthwise
            taps, scalars broadcast to rows
        kernel2: H x B folded output 1x1 kernel, of x's type
        bias2: 1 x B folded output bias, float32
        dilation: depthwise dilation
        causal: left-only padding when True
    Returns:
        N x T x B of x's type
    CPU tensors take tcn_block_reference; CUDA tensors launch csrc/tcn.cu."""
    if x.device.type == "cpu":
        return tcn_block_reference(x, kernel1, pack, kernel2, bias2, dilation,
                                   causal=causal)
    _check_shapes(x, kernel1, pack, kernel2, bias2, dilation)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"tcn_block_fused: x has dtype {x.dtype}, expected "
                        "float32 or bfloat16")
    build.require_cuda("tcn_block_fused",
                       {"x": x, "kernel1": kernel1, "kernel2": kernel2},
                       dtype=x.dtype)
    build.require_cuda("tcn_block_fused", {"pack": pack, "bias2": bias2})
    if pack.device != x.device or bias2.device != x.device:
        raise ValueError(f"tcn_block_fused: pack and bias2 are on "
                         f"{pack.device} and {bias2.device}, x on {x.device}")
    N, T, B = x.shape
    H = kernel1.shape[1]
    if B % 4 or H % 4 or B > MAX_B:
        raise ValueError(f"tcn_block_fused: the kernel takes B and H that "
                         f"are multiples of 4 with B <= {MAX_B}, got B={B}, "
                         f"H={H}")
    # the kernel copies rows 16 bytes at a time
    x, kernel1, pack, kernel2 = (t.clone() if t.data_ptr() % 16 else t
                                 for t in (x, kernel1, pack, kernel2))
    out = torch.empty_like(x)
    lib = build.load("tcn", "aps_tcn_block_fused", _ARGTYPES)
    rc = lib.aps_tcn_block_fused(x.data_ptr(), kernel1.data_ptr(),
                                 pack.data_ptr(), kernel2.data_ptr(),
                                 bias2.data_ptr(), out.data_ptr(), N, T, B, H,
                                 int(dilation), int(bool(causal)),
                                 int(x.dtype == torch.bfloat16),
                                 build.stream_ptr(x.device))
    build.check(lib, rc, "tcn_block_fused")
    build.count_launch("tcn_block_fused")
    return out


def launch_plan(T: int, B: int, dilation: int, dtype=torch.float32):
    """How csrc/tcn.cu runs a block of T frames, B channels at a dilation on
    the current card: staged rows of y a block (the first product's rows),
    output rows a block, blocks a batch row, column groups, and the
    instance's registers, local bytes (spills) a thread, shared bytes a
    block and resident blocks an SM. repeat = staged rows x blocks / T is
    how often the first product is done over for the taps."""
    import ctypes
    lib = build.load("tcn", "aps_tcn_block_fused_plan",
                     [build.I, build.I, build.I, build.I, build.P])
    info = (ctypes.c_int * 8)()
    rc = lib.aps_tcn_block_fused_plan(int(T), int(B), int(dilation),
                                      int(dtype == torch.bfloat16), info)
    build.check(lib, rc, "tcn_block_fused plan")
    plan = dict(zip(("staged_rows", "out_rows", "blocks_per_row",
                     "column_groups", "registers", "local_bytes",
                     "smem_bytes", "blocks_per_sm"), info))
    plan["repeat"] = plan["staged_rows"] * plan["blocks_per_row"] / T
    return plan
