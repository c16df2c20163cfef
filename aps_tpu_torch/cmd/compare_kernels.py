#!/usr/bin/env python
"""Time versions of a kernel source against each other on the card, in one
process and on the same inputs.

Each given source is built with the port's own nvcc flags and its C entry
is called directly: the K2 forward (`aps_attention_fwd`) at the long-form
decode and training shapes and at B = 16, T = 1024 beside the library's
`scaled_dot_product_attention`; K5 (`aps_tcn_block_fused`) at the
separation batch's shape (32 x 3905 frames, B = 256, H = 512) at every
dilation of a repeat, in float32 and bfloat16. The versions run in the
order given, so pass them as parent, change, change, parent. A version is
any file: the parent's source from `git archive`, or a copy with one
constant changed. Each result is also checked against the plain version.

    python -m aps_tpu_torch.cmd.compare_kernels \\
        --attention parent/attention.cu aps_tpu_torch/csrc/attention.cu \\
        --tcn parent/tcn.cu aps_tpu_torch/csrc/tcn.cu
"""

import argparse
import ctypes
import statistics
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from aps_tpu_torch.ops import build
from aps_tpu_torch.ops.attention import _FWD_ARGTYPES, mha_reference
from aps_tpu_torch.ops.tcn import _ARGTYPES as _TCN_ARGTYPES
from aps_tpu_torch.ops.tcn import tcn_block_reference

# (B, T, valid keys) of the long-form decode, the long-form training step
# and a wide shape; H = 4, D = 64
ATTENTION_SHAPES = ((4, 710, 600), (8, 690, 600), (16, 1024, 1024))
# the separation batch: N, T, B, H, and the dilations of a repeat
TCN_SHAPE = (32, 3905, 256, 512)
TCN_DILATIONS = (1, 2, 4, 8, 16, 32, 64, 128)
QUEUED = 10


def compile_all(sources, out_dir: Path):
    """Build each source (headers found beside csrc/) -> ctypes libraries."""

    def one(item):
        n, src = item
        out = out_dir / f"v{n}.so"
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, f"-I{build.CSRC}", "-o",
               str(out), str(src)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
        return ctypes.CDLL(str(out))

    with ThreadPoolExecutor(max_workers=max(1, len(sources))) as pool:
        return list(pool.map(one, enumerate(sources)))


def time_ms(fn, iters=20, calls=1):
    """Median ms of `calls` calls between two events, over iters samples."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        beg = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        beg.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(beg.elapsed_time(end) / calls)
    return statistics.median(times)


def compare_attention(sources, dev, gen):
    libs = compile_all(sources, Path(tempfile.mkdtemp()))
    for lib in libs:
        lib.aps_attention_fwd.argtypes = _FWD_ARGTYPES
    stream = torch.cuda.current_stream(dev).cuda_stream
    H, D = 4, 64
    for B, T, valid in ATTENTION_SHAPES:
        q, k, v = (torch.randn((B, H, T, D), generator=gen).to(dev)
                   for _ in range(3))
        k_len = torch.full((B,), valid, dtype=torch.int32, device=dev)
        out = torch.empty_like(q)
        lse = torch.empty((B, H, T), device=dev)
        want = mha_reference(q, k, v, k_len=k_len)
        mask = (torch.arange(T, device=dev)[None] < k_len[:, None])[:, None,
                                                                     None]
        library = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa
            q, k, v, attn_mask=mask)
        print(f"K2 forward B={B} H={H} T={T} D={D} k_len={valid}: library "
              f"{time_ms(library):.4f} ms (queued "
              f"{time_ms(library, calls=QUEUED):.4f})", flush=True)
        for src, lib in zip(sources, libs):
            run = lambda: lib.aps_attention_fwd(  # noqa: E731
                q.data_ptr(), k.data_ptr(), v.data_ptr(), None,
                k_len.data_ptr(), B, H, T, T, D, D**-0.5, 0, out.data_ptr(),
                lse.data_ptr(), stream)
            if run() != 0:
                raise RuntimeError(f"{src}: launch failed")
            torch.cuda.synchronize()
            err = (out - want).abs().max().item()
            print(f"  {src}: {time_ms(run):.4f} ms (queued "
                  f"{time_ms(run, calls=QUEUED):.4f}), max abs err "
                  f"{err:.3e}", flush=True)


def compare_tcn(sources, dev, gen):
    libs = compile_all(sources, Path(tempfile.mkdtemp()))
    for lib in libs:
        lib.aps_tcn_block_fused.argtypes = _TCN_ARGTYPES
    stream = torch.cuda.current_stream(dev).cuda_stream
    N, T, B, H = TCN_SHAPE
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn((N, T, B), generator=gen).to(dev, dtype)
        k1 = (torch.randn((B, H), generator=gen) / B**0.5).to(dev, dtype)
        k2 = (torch.randn((H, B), generator=gen) / H**0.5).to(dev, dtype)
        pack = 0.3 * torch.randn((11, H), generator=gen)
        pack[[1, 7]] = 1.0
        pack[[9, 10]] = 0.25
        pack = pack.to(dev)
        bias2 = (0.1 * torch.randn((1, B), generator=gen)).to(dev)
        out = torch.empty_like(x)
        total = [0.0] * len(sources)
        for d in TCN_DILATIONS:
            want = tcn_block_reference(x, k1, pack, k2, bias2, d).float()
            row = []
            for n, (src, lib) in enumerate(zip(sources, libs)):
                run = lambda: lib.aps_tcn_block_fused(  # noqa: E731
                    x.data_ptr(), k1.data_ptr(), pack.data_ptr(),
                    k2.data_ptr(), bias2.data_ptr(), out.data_ptr(), N, T, B,
                    H, d, 0, int(dtype == torch.bfloat16), stream)
                if run() != 0:
                    raise RuntimeError(f"{src}: launch failed")
                torch.cuda.synchronize()
                err = (out.float() - want).abs().max().item()
                ms = time_ms(run, iters=10)
                total[n] += ms
                row.append(f"{ms:.4f} ms (err {err:.2e})")
            print(f"K5 {str(dtype).split('.')[1]} N={N} T={T} B={B} H={H} "
                  f"d={d}: " + "; ".join(row), flush=True)
        print(f"K5 {str(dtype).split('.')[1]}, one repeat of 8 dilations: "
              + "; ".join(f"{src} {ms:.4f} ms"
                          for src, ms in zip(sources, total)), flush=True)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="Time versions of the K2 forward and K5 sources on the "
        "card, in the order given",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("--attention", nargs="*", default=[],
                        help="versions of csrc/attention.cu")
    parser.add_argument("--tcn", nargs="*", default=[],
                        help="versions of csrc/tcn.cu")
    parser.add_argument("--seed", type=int, default=1)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("compare_kernels times kernels on the card; torch "
                           "sees no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    gen = torch.Generator().manual_seed(args.seed)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)
    if args.attention:
        compare_attention(args.attention, dev, gen)
    if args.tcn:
        compare_tcn(args.tcn, dev, gen)


if __name__ == "__main__":
    main()
