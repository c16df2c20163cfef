#!/usr/bin/env python
"""Time versions of a kernel source against each other on the card, in one
process and on the same inputs.

Each given source is built with the port's own nvcc flags and its C entry
is called directly: the K2 forward (`aps_attention_fwd`) at the long-form
decode and training shapes and at B = 16, T = 1024 beside the library's
`scaled_dot_product_attention`; K5 (`aps_tcn_block_fused`) at the
separation batch's shape (32 x 3905 frames, B = 256, H = 512) at every
dilation of a repeat, in float32 and bfloat16; K3's backward kernels dq
(`aps_rel_attention_dq`), dk/dv (`aps_rel_attention_dkv`) and dpose
(`aps_rel_attention_dpose`, with its reduction) at the flagship training
step's shape (B = 32, H = 4, T = 231,
200 valid frames each, one shared table) and at T = 700 with per-head
tables, a causal mask and ragged k_len; K3's forward
(`aps_rel_attention_fwd`, with lse) at the flagship decode's shape (B = 8,
T = 233, 200 valid, q_c = q_p as the encoder passes them) and at the
step's; K4 (`aps_ctc_score_step`) at the flagship decode's lanes (T = 233,
L = 8 x 8 x 12) and the long-form decode's (T = 710, L = 4 x 8 x 12). A K4
source whose entry takes P gets the parent beams' gammas unexpanded (P = L
/ 12, as the search step passes them); an older one gets them expanded. K1
(`aps_fused_logmel`) with the flagship's front end at the four batches the
paths give it (decode 8 x 149003 samples, step 32 x 147884, long-form
decode 4 x 454718, long-form step 8 x 441576): a source whose entry takes
the twiddle table (the FFT) gets it, the stages' radices and the mel
bands, an older one the dense DFT's cos/sin tables and the mel matrix.
The versions run in the order given, so pass them as parent, change,
change, parent. A version is any file: the parent's source from `git
archive`, or an edited copy (one constant changed, or K4's serial walk).
Each result is also checked against the plain version. `--occupancy`
prints, for K2's and K3's kernels as the repository builds them, at every
head width they are built for and for the wide kernels of heads over 128,
the registers and bytes of local memory (spills) a thread, the shared
memory a block and the blocks an SM. `--sass OLD NEW` (given once for
each pair) compiles both versions of a source to sm_90a machine code and
compares, instruction for instruction (cuobjdump -sass), every kernel
instantiation the old version has with the new version's instantiation of
the same template arguments (a trailing `false` the new template added,
such as K2's kRagged, left out): it prints each pair as identical or by
its first differing instruction, and the kernels only the new version has.

    python -m aps_tpu_torch.cmd.compare_kernels \\
        --attention parent/attention.cu aps_tpu_torch/csrc/attention.cu \\
        --tcn parent/tcn.cu aps_tpu_torch/csrc/tcn.cu \\
        --rel-bwd parent/rel_attention_bwd.cu \\
        aps_tpu_torch/csrc/rel_attention_bwd.cu \\
        --rel-fwd parent/rel_attention.cu \\
        aps_tpu_torch/csrc/rel_attention.cu \\
        --ctc parent/ctc_score.cu aps_tpu_torch/csrc/ctc_score.cu \\
        --fbank parent/fbank.cu aps_tpu_torch/csrc/fbank.cu
    python -m aps_tpu_torch.cmd.compare_kernels --occupancy
    python -m aps_tpu_torch.cmd.compare_kernels \\
        --sass parent/attention.cu aps_tpu_torch/csrc/attention.cu \\
        --sass parent/attention_bwd.cu aps_tpu_torch/csrc/attention_bwd.cu
"""

import argparse
import ctypes
import re
import statistics
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from aps_tpu_torch.ops import build
from aps_tpu_torch.ops.attention import _FWD_ARGTYPES, mha_reference
from aps_tpu_torch.ops.ctc_score import _ARGTYPES as _CTC_ARGTYPES
from aps_tpu_torch.ops.ctc_score import ctc_score_step_plain
from aps_tpu_torch.ops.rel_attention import _FWD_ARGTYPES as _REL_ARGTYPES
from aps_tpu_torch.ops.rel_attention import (_BWD_ARGTYPES, _DQ_ARGTYPES,
                                             launch_forward,
                                             rel_lse_reference,
                                             rel_mha_backward_reference,
                                             rel_mha_reference)
from aps_tpu_torch.ops.tcn import _ARGTYPES as _TCN_ARGTYPES
from aps_tpu_torch.ops.tcn import tcn_block_reference

# (B, T, valid keys) of the long-form decode, the long-form training step
# and a wide shape; H = 4, D = 64
ATTENTION_SHAPES = ((4, 710, 600), (8, 690, 600), (16, 1024, 1024))
# the separation batch: N, T, B, H, and the dilations of a repeat
TCN_SHAPE = (32, 3905, 256, 512)
TCN_DILATIONS = (1, 2, 4, 8, 16, 32, 64, 128)
# K3's backward: (B, T, Hp, causal, k_len) of the flagship training step
# and of a long causal shape with per-head tables; H = 4, D = 64
REL_SHAPES = ((32, 231, 1, False, [200] * 32),
              (8, 700, 4, True, [700, 683, 350, 1, 0, 610, 3, 233]))
# K3's forward: (B, T, valid keys) of the flagship decode batch and step
REL_FWD_SHAPES = ((8, 233, 200), (32, 231, 200))
# K4: (T, utterances) of the flagship and long-form decode batches; beam 8,
# ctc beam 12
CTC_SHAPES = ((233, 8), (710, 4))
# K1: (path, N, S) of the front end's batches
FBANK_SHAPES = (("decode", 8, 149003), ("training", 32, 147884),
                ("long-form decode", 4, 454718),
                ("long-form training", 8, 441576))
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


def compare_rel_bwd(sources, dev, gen):
    """dq, dk/dv and dpose of each version of csrc/rel_attention_bwd.cu
    (dk/dv and dpose read the delta that dq wrote). A version
    whose dq takes the forward's output forms delta itself (and writes
    it); an older one reads it: both are given the same delta buffer,
    filled with sum(do * out) before every call."""
    libs = compile_all(sources, Path(tempfile.mkdtemp()))
    writes_delta = []
    for src, lib in zip(sources, libs):
        text = Path(src).read_text()
        new = re.search(r"aps_rel_attention_dq\([^)]*const float\* out",
                        text) is not None
        writes_delta.append(new)
        lib.aps_rel_attention_dq.argtypes = \
            _DQ_ARGTYPES if new else _BWD_ARGTYPES
        lib.aps_rel_attention_dkv.argtypes = _BWD_ARGTYPES
        lib.aps_rel_attention_dpose.argtypes = _BWD_ARGTYPES
    stream = torch.cuda.current_stream(dev).cuda_stream
    H, D = 4, 64
    for B, T, Hp, causal, lens in REL_SHAPES:
        q_c, q_p, k, v, do = (torch.randn((B, H, T, D), generator=gen).to(dev)
                              for _ in range(5))
        pose = (0.3 * torch.randn((Hp, 2 * T - 1, D), generator=gen)).to(dev)
        klen = torch.tensor(lens, dtype=torch.int32, device=dev)
        out, lse = launch_forward(q_c, q_p, k, v, pose, klen, causal, True)
        delta_ref = (do * out).sum(-1)
        delta = delta_ref.clone()
        want = rel_mha_backward_reference(q_c, q_p, k, v, pose, do,
                                          k_len=klen, causal=causal)
        dq_c, dq_p = torch.empty_like(q_c), torch.empty_like(q_c)
        dk, dv = torch.empty_like(q_c), torch.empty_like(q_c)
        partial = torch.empty((B * H, 2 * T - 1, D), device=dev)
        dpose = torch.empty_like(pose)
        head = [q_c.data_ptr(), q_p.data_ptr(), k.data_ptr(), v.data_ptr(),
                pose.data_ptr(), klen.data_ptr(), do.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), B, H, Hp, T, D, D**-0.5,
                int(causal)]
        label = (f"B={B} H={H} T={T} D={D} Hp={Hp} causal={causal} k_len="
                 + (f"{lens[0]}" if len(set(lens)) == 1 else "ragged"))
        for src, lib, new in zip(sources, libs, writes_delta):
            tail = [out.data_ptr()] if new else []
            runs = {
                "dq": lambda: lib.aps_rel_attention_dq(  # noqa: E731
                    *head, dq_c.data_ptr(), dq_p.data_ptr(), *tail, stream),
                "dkv": lambda: lib.aps_rel_attention_dkv(  # noqa: E731
                    *head, dk.data_ptr(), dv.data_ptr(), stream),
                "dpose": lambda: lib.aps_rel_attention_dpose(  # noqa: E731
                    *head, partial.data_ptr(), dpose.data_ptr(), stream)}
            line = []
            for kernel, run in runs.items():
                delta.copy_(delta_ref)
                if run() != 0:
                    raise RuntimeError(f"{src}: {kernel} launch failed")
                torch.cuda.synchronize()
                got = {"dq": (dq_c, dq_p), "dkv": (dk, dv),
                       "dpose": (dpose,)}[kernel]
                ref = {"dq": want[:2], "dkv": want[2:4],
                       "dpose": want[4:]}[kernel]
                err = max((x - y).abs().max().item()
                          for x, y in zip(got, ref))
                line.append(f"{kernel} {time_ms(run):.4f} ms (queued "
                            f"{time_ms(run, calls=QUEUED):.4f}), max abs err "
                            f"{err:.3e}")
            print(f"K3 backward {label}: {src}: " + "; ".join(line),
                  flush=True)


def compare_rel_fwd(sources, dev, gen):
    """K3's forward (with lse, as a training step launches it; the decode
    launches it without) of each version of csrc/rel_attention.cu."""
    libs = compile_all(sources, Path(tempfile.mkdtemp()))
    for lib in libs:
        lib.aps_rel_attention_fwd.argtypes = _REL_ARGTYPES
    stream = torch.cuda.current_stream(dev).cuda_stream
    H, D = 4, 64
    for B, T, valid in REL_FWD_SHAPES:
        q_c, k, v = (torch.randn((B, H, T, D), generator=gen).to(dev)
                     for _ in range(3))
        pose = (0.3 * torch.randn((1, 2 * T - 1, D), generator=gen)).to(dev)
        klen = torch.full((B,), valid, dtype=torch.int32, device=dev)
        want = rel_mha_reference(q_c, q_c, k, v, pose, k_len=klen)
        lse_want = rel_lse_reference(q_c, q_c, k, pose, k_len=klen)
        out = torch.empty_like(q_c)
        lse = torch.empty((B, H, T), device=dev)
        for src, lib in zip(sources, libs):
            for with_lse in (False, True):
                run = lambda: lib.aps_rel_attention_fwd(  # noqa: E731
                    q_c.data_ptr(), q_c.data_ptr(), k.data_ptr(),
                    v.data_ptr(), pose.data_ptr(), klen.data_ptr(), B, H, 1,
                    T, D, D**-0.5, 0, out.data_ptr(),
                    lse.data_ptr() if with_lse else None, stream)
                if run() != 0:
                    raise RuntimeError(f"{src}: launch failed")
                torch.cuda.synchronize()
                err = (out - want).abs().max().item()
                if with_lse:
                    err = max(err, (lse - lse_want).abs().max().item())
                print(f"K3 forward B={B} H={H} T={T} D={D} k_len={valid}"
                      f"{' with lse' if with_lse else ''}: {src}: "
                      f"{time_ms(run):.4f} ms (queued "
                      f"{time_ms(run, calls=QUEUED):.4f}), max abs err "
                      f"{err:.3e}", flush=True)


def compare_ctc(sources, dev, gen):
    """K4 of each version of csrc/ctc_score.cu at the two decode paths'
    shapes, each with the argument list its source declares."""
    libs = compile_all(sources, Path(tempfile.mkdtemp()))
    takes_p = []
    for src, lib in zip(sources, libs):
        text = Path(src).read_text()
        new = re.search(r"int T, int L, int P,", text) is not None
        takes_p.append(new)
        lib.aps_ctc_score_step.argtypes = _CTC_ARGTYPES if new else \
            _CTC_ARGTYPES[:11] + _CTC_ARGTYPES[12:]
    stream = torch.cuda.current_stream(dev).cuda_stream
    beam, C = 8, 12
    for T, utts in CTC_SHAPES:
        L, P = utts * beam * C, utts * beam
        p_c = -1.0 - 3.0 * torch.rand((T, L), generator=gen)
        gnx = torch.cumsum(-2.0 * torch.rand((T, P), generator=gen), 0)
        gbx = torch.cumsum(-2.0 * torch.rand((T, P), generator=gen), 0)
        gnx[:, ::7] = -3.402823466e38
        pb = -0.05 - 0.5 * torch.rand((T, utts), generator=gen)
        rok = (torch.rand((1, L), generator=gen) > 0.1).float()
        eos = (torch.rand((1, L), generator=gen) > 0.92).float()
        old = -50.0 * torch.rand((1, P), generator=gen)
        compact = [x.to(dev) for x in (p_c, gnx, gbx, pb, rok, eos, old)]
        full = list(compact)
        for i in (1, 2, 6):
            full[i] = compact[i].repeat_interleave(C, dim=1).contiguous()
        isf = torch.zeros((1, 1), device=dev)
        want = ctc_score_step_plain(*compact, isf)
        outs = [torch.empty((T, L), device=dev) for _ in range(2)] + \
            [torch.empty((1, L), device=dev) for _ in range(2)]
        for src, lib, new in zip(sources, libs, takes_p):
            ops, dims = (compact, [T, L, P]) if new else (full, [T, L])
            run = lambda: lib.aps_ctc_score_step(  # noqa: E731
                *[x.data_ptr() for x in ops[:4]], utts,
                *[x.data_ptr() for x in ops[4:]], isf.data_ptr(), *dims,
                *[x.data_ptr() for x in outs], stream)
            if run() != 0:
                raise RuntimeError(f"{src}: launch failed")
            torch.cuda.synchronize()
            err = 0.0
            for g, w in zip(outs, want):
                live = ~((g <= -1.7e38) & (w <= -1.7e38))
                err = max(err, (g - w).abs()[live].max().item())
            print(f"K4 T={T} L={L} P={dims[-1] if new else L}: {src}: "
                  f"{time_ms(run):.4f} ms (queued "
                  f"{time_ms(run, calls=QUEUED):.4f}), max abs err "
                  f"{err:.3e}", flush=True)


def compare_fbank(sources, dev, gen):
    """K1 of each version of csrc/fbank.cu with the flagship's front end at
    the four path batches, each with the operands its entry declares."""
    from aps_tpu_torch.const import EPSILON
    from aps_tpu_torch.flagship import flagship_conf
    from aps_tpu_torch.ops import fbank
    from aps_tpu_torch.transform.asr import AsrTransform
    libs = compile_all(sources, Path(tempfile.mkdtemp()))
    ffts = []  # whether the source's entry takes the FFT's operands
    for src, lib in zip(sources, libs):
        ffts.append("const double* twiddle" in Path(src).read_text())
        lib.aps_fused_logmel.argtypes = fbank._ARGTYPES if ffts[-1] else \
            [build.P, build.I, build.I, build.I, build.P, build.I, build.I,
             build.P, build.P, build.I, build.P, build.I, build.F, build.I,
             build.F, build.F, build.F, build.P, build.P]
    stream = torch.cuda.current_stream(dev).cuda_stream
    tf = AsrTransform(**flagship_conf()["asr_transform"])
    n, hop = tf.fft_size, tf.frame_hop
    W, F, M = len(tf.window), n // 2 + 1, tf.mel.shape[1]
    ops = tf.fbank_operands(dev)
    cos, sin = fbank._dft_tables(n, W, dev)
    mel = torch.from_numpy(np.ascontiguousarray(tf.mel)).to(dev)
    for path, N, S in FBANK_SHAPES:
        wav = (0.1 * torch.randn((N, S), generator=gen)).to(dev)
        T = (S - W) // hop + 1
        want = fbank.fused_logmel_plain(wav, tf.window, n, hop, mel=tf.mel,
                                        log_eps=EPSILON)
        out = torch.empty((N, T, M), device=dev)
        tail = [0.97, 0, 0.0, 0.0, EPSILON, out.data_ptr(), stream]
        for src, lib, fft in zip(sources, libs, ffts):
            tables = [n, ops.twiddle.data_ptr(), ops.radices,
                      ops.mel_vals.data_ptr(), ops.mel_bands.data_ptr(),
                      M] if fft else [cos.data_ptr(), sin.data_ptr(), F,
                                      mel.data_ptr(), M]
            run = lambda: lib.aps_fused_logmel(  # noqa: E731
                wav.data_ptr(), N, S, T, ops.dev_window.data_ptr(), W, hop,
                *tables, *tail)
            if run() != 0:
                raise RuntimeError(f"{src}: launch failed")
            torch.cuda.synchronize()
            err = (out - want).abs().max().item()
            print(f"K1 {path} N={N} S={S} T={T} fft={n}: {src}: "
                  f"{time_ms(run):.4f} ms (queued "
                  f"{time_ms(run, calls=QUEUED):.4f}), max abs err "
                  f"{err:.3e}", flush=True)


_SASS_FUNCTION = re.compile(r"Function : (\S+)")
_SASS_INSTRUCTION = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;")
_TEMPLATE_ARGS = re.compile(r"I((?:L[ib]\d+E)+)E")


def kernel_key(mangled: str):
    """(the last name of a mangled _ZN...E nested name, its template
    arguments as mangled): the anonymous namespace's name differs from
    file to file, the kernel's does not."""
    pos, last = 3, mangled
    while mangled.startswith("_ZN") and pos < len(mangled) and \
            mangled[pos].isdigit():
        digits = re.match(r"\d+", mangled[pos:]).group(0)
        pos += len(digits)
        last = mangled[pos:pos + int(digits)]
        pos += int(digits)
    args = _TEMPLATE_ARGS.match(mangled, pos)
    return last, args.group(1) if args else ""


def sass_kernels(src: Path, out_dir: Path):
    """{(kernel, template arguments): its sm_90a instructions} of a source,
    compiled with the port's flags (its own directory's headers first)."""
    cubin = out_dir / f"{src.stem}-{abs(hash(str(src)))}.cubin"
    flags = [f for f in build.NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC")]
    proc = subprocess.run(
        [build.nvcc_path(), *flags, "-cubin", f"-I{src.parent}",
         f"-I{build.CSRC}", "-o", str(cubin), str(src)],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
    cuobjdump = Path(build.nvcc_path()).parent / "cuobjdump"
    text = subprocess.run([str(cuobjdump), "-sass", str(cubin)],
                          capture_output=True, text=True, check=True).stdout
    kernels, key = {}, None
    for line in text.splitlines():
        head = _SASS_FUNCTION.search(line)
        if head:
            key = kernel_key(head.group(1))
            kernels[key] = []
        elif key is not None:
            op = _SASS_INSTRUCTION.search(line)
            if op:
                kernels[key].append(op.group(1))
    return kernels


def compare_sass(pairs) -> None:
    """Print, for each (old, new) pair of sources, whether every kernel of
    the old one compiles to the same instructions in the new one."""
    with tempfile.TemporaryDirectory() as tmp:
        for old_src, new_src in pairs:
            old = sass_kernels(Path(old_src), Path(tmp))
            new = sass_kernels(Path(new_src), Path(tmp))
            matched = set()
            for (name, args), code in sorted(old.items()):
                twin = next((k for k in ((name, args + "Lb0E"), (name, args))
                             if k in new), None)
                if twin is None:
                    print(f"sass {Path(new_src).name}: {name}<{args}> is "
                          "gone", flush=True)
                    continue
                matched.add(twin)
                other = new[twin]
                if other == code:
                    print(f"sass {Path(new_src).name}: {name}<{args}> "
                          f"identical ({len(code)} instructions)", flush=True)
                    continue
                at = next((i for i, (a, b) in enumerate(zip(code, other))
                           if a != b), min(len(code), len(other)))
                print(f"sass {Path(new_src).name}: {name}<{args}> DIFFERS "
                      f"({len(code)} against {len(other)} instructions; "
                      f"first at {at}: {code[at] if at < len(code) else '-'}"
                      f" | {other[at] if at < len(other) else '-'})",
                      flush=True)
            for name, args in sorted(set(new) - matched):
                print(f"sass {Path(new_src).name}: {name}<{args}> is new "
                      f"({len(new[(name, args)])} instructions)", flush=True)


def print_occupancy() -> None:
    """Registers, local bytes, shared memory and blocks an SM of K2's and
    K3's kernels (the repository's sources) at each head width."""
    from aps_tpu_torch.ops import attention, rel_attention
    for D in attention._HEAD_DIMS:
        rows = {"K2 forward": attention.forward_occupancy(D),
                "K2 dq": attention.backward_occupancy(D, "dq"),
                "K2 dk/dv": attention.backward_occupancy(D, "dkv")}
        for kernel in ("fwd",) + rel_attention.BACKWARD_KERNELS:
            rows[f"K3 {kernel}"] = rel_attention.occupancy(D, kernel)
        for name, info in rows.items():
            print(f"occupancy D={D} {name}: " + ", ".join(
                f"{key} {value}" for key, value in info.items()), flush=True)
    for name, info in attention.wide_occupancy().items():
        print(f"occupancy D>128 {name}: " + ", ".join(
            f"{key} {value}" for key, value in info.items()), flush=True)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="Time versions of the K2 forward, K5, K3 backward, K3 "
        "forward, K4 and K1 sources on the card, in the order given",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("--attention", nargs="*", default=[],
                        help="versions of csrc/attention.cu")
    parser.add_argument("--tcn", nargs="*", default=[],
                        help="versions of csrc/tcn.cu")
    parser.add_argument("--rel-bwd", nargs="*", default=[],
                        help="versions of csrc/rel_attention_bwd.cu")
    parser.add_argument("--rel-fwd", nargs="*", default=[],
                        help="versions of csrc/rel_attention.cu")
    parser.add_argument("--ctc", nargs="*", default=[],
                        help="versions of csrc/ctc_score.cu")
    parser.add_argument("--fbank", nargs="*", default=[],
                        help="versions of csrc/fbank.cu")
    parser.add_argument("--occupancy", action="store_true",
                        help="print how K2's and K3's kernels sit on an SM "
                        "at each head width")
    parser.add_argument("--sass", nargs=2, action="append", default=[],
                        metavar=("OLD", "NEW"),
                        help="compare the machine code of two versions of a "
                        "source, kernel by kernel")
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
    if args.sass:
        compare_sass(args.sass)
    if args.occupancy:
        print_occupancy()
    if args.attention:
        compare_attention(args.attention, dev, gen)
    if args.tcn:
        compare_tcn(args.tcn, dev, gen)
    if args.rel_bwd:
        compare_rel_bwd(args.rel_bwd, dev, gen)
    if args.rel_fwd:
        compare_rel_fwd(args.rel_fwd, dev, gen)
    if args.ctc:
        compare_ctc(args.ctc, dev, gen)
    if args.fbank:
        compare_fbank(args.fbank, dev, gen)


if __name__ == "__main__":
    main()
