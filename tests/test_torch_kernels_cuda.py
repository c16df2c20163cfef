#!/usr/bin/env python
"""PyTorch port: each hand-written CUDA kernel against its plain PyTorch
version, and the dispatch rule of the wrappers (CPU tensors take the plain
version and launch nothing; a CUDA tensor launches the kernel once).

This file imports no jax, so it also runs on a machine that has the card
but not the JAX stack:

    python -m pytest tests/test_torch_kernels_cuda.py --noconftest -q

Tests that need the card carry the `cuda` marker and skip without one."""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from aps_tpu_torch.const import EPSILON, MIN_F32  # noqa: E402
from aps_tpu_torch.asr.transformer import impl  # noqa: E402
from aps_tpu_torch.ops import build  # noqa: E402
from aps_tpu_torch.ops.attention import (flash_attention,  # noqa: E402
                                         mha_backward_reference,
                                         mha_reference)
from aps_tpu_torch.ops.ctc_score import (ctc_score_step,  # noqa: E402
                                         ctc_score_step_plain)
from aps_tpu_torch.ops.fbank import (fused_logmel,  # noqa: E402
                                     fused_logmel_plain, operands)
from aps_tpu_torch.ops.rel_attention import (  # noqa: E402
    flash_attention_rel, launch_forward, rel_lse_reference,
    rel_mha_backward_reference, rel_mha_reference)
from aps_tpu_torch.ops.tcn import (PACK_ROWS, tcn_block_fused,  # noqa: E402
                                   tcn_block_reference)
from aps_tpu_torch.transform.utils import make_window, mel_filter  # noqa

# kernel vs plain version, both float32 on the card: log-mel features after
# 512-term DFT sums in another order; O(1) attention outputs; CTC values
# up to ~1e3 after 233 steps of the same recursion
LOGMEL_ATOL = 1e-3
# a log-mel band below this share of its frame's largest band is at float32
# resolution (the frame's sums carry errors of ~1e-6 of their largest term)
LOGMEL_FLOOR = 1e-5
ATT_ATOL = 1e-3
# attention gradients: dq/dk/dv entries are O(1) sums of T float32 terms;
# a dpose row sums up to T * B (* H for a shared table) terms, in another
# order than the plain version's index_add_, so its bound scales with the
# largest entry of the reference
GRAD_ATOL = 1e-3
DPOSE_RTOL = 1e-4
CTC_ATOL, CTC_RTOL = 1e-3, 1e-5
# TCN block: O(1) outputs after two float32 products of depth B and H in
# another order; in bfloat16 the output itself is rounded to 8 bits of
# mantissa and a y2 entry may round the other way before the second product
TCN_ATOL = 1e-4
TCN_BF16_ATOL, TCN_BF16_RTOL = 3e-2, 2e-2


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel, no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda:0")


def _fbank_args(N, S, with_mel):
    gen = torch.Generator().manual_seed(N + S)
    wav = 0.1 * torch.randn((N, S), generator=gen)
    win = make_window("hamm", 400, True, "librosa")
    mel = mel_filter(400, num_mels=80).T if with_mel else None
    return wav, win, 512, 160, mel


def _logmel(wav, window, fft_size, hop, mel=None, normalized=False, **kw):
    """fused_logmel on this front end's operands for the wav's device."""
    return fused_logmel(wav, operands(window, fft_size, mel, normalized,
                                      wav.device), hop, **kw)


def _rel_args(B, H, T, D, Hp):
    gen = torch.Generator().manual_seed(T + Hp)
    q_c, q_p, k, v = (torch.randn((B, H, T, D), generator=gen)
                      for _ in range(4))
    pose = 0.3 * torch.randn((Hp, 2 * T - 1, D), generator=gen)
    k_len = torch.tensor([T, T - 77, 1, 0] + [T // 3] * (B - 4),
                         dtype=torch.int32)[:B]
    return [q_c, q_p, k, v, pose], k_len


def _att_args(B, H, Tq, Tk, D):
    """q, k, v, a bias that differs between the heads, and k_len with a
    full, a ragged, a one-key and (from B = 4 on) a no-key entry."""
    gen = torch.Generator().manual_seed(Tq + Tk)
    q = torch.randn((B, H, Tq, D), generator=gen)
    k, v = (torch.randn((B, H, Tk, D), generator=gen) for _ in range(2))
    bias = torch.randn((H, Tq, Tk), generator=gen)
    bias[1:] *= 2.0
    k_len = torch.tensor([Tk, max(Tk - 77, 2), 1, 0] + [Tk // 3] * (B - 4),
                         dtype=torch.int32)[:B]
    return [q, k, v], bias, k_len


def _ctc_args(T, L, G, P=None):
    """Scorer operands; the parent's gammas and scores over P columns
    (default L: one a lane)."""
    P = L if P is None else P
    rng = np.random.default_rng(L + T)
    f32 = np.float32
    p_c = (-1 - 3 * rng.random((T, L))).astype(f32)
    gnx = np.cumsum(-2 * rng.random((T, P)), 0).astype(f32)
    gbx = np.cumsum(-2 * rng.random((T, P)), 0).astype(f32)
    gnx[:, ::5] = MIN_F32
    gbx[:2] = MIN_F32
    pb = (-0.05 - 0.5 * rng.random((T, G))).astype(f32)
    rok = (rng.random((1, L)) > 0.25).astype(f32)
    eosm = (rng.random((1, L)) > 0.8).astype(f32)
    old = (-20 * rng.random((1, P))).astype(f32)
    return [torch.from_numpy(a) for a in (p_c, gnx, gbx, pb, rok, eosm, old)]


def _tcn_args(N, T, B, H, dtype=torch.float32):
    """A folded block at the magnitudes the model gives: unit-scale inputs,
    kernels scaled by 1 / sqrt(fan-in), BN gains near 1, PReLU slopes near
    0.25."""
    rng = np.random.default_rng(T + B)
    f32 = lambda a: torch.from_numpy(np.asarray(a, dtype=np.float32))  # noqa
    x = f32(rng.standard_normal((N, T, B)))
    k1 = f32(rng.standard_normal((B, H)) / np.sqrt(B))
    k2 = f32(rng.standard_normal((H, B)) / np.sqrt(H))
    pack = 0.3 * rng.standard_normal((PACK_ROWS, H))
    pack[[1, 7]] = 1 + 0.2 * rng.random((2, H))  # g1, g2
    pack[[9, 10]] = 0.25 + 0.1 * rng.random((2, 1))  # the PReLU slopes
    bias2 = f32(0.1 * rng.standard_normal((1, B)))
    return (x.to(dtype), k1.to(dtype), f32(pack), k2.to(dtype), bias2)


def _assert_ctc_close(got, want):
    """Entries at or below MIN_F32 / 2 on both sides compare equal."""
    for g, w in zip(got, want):
        g, w = g.cpu(), w.cpu()
        live = ~((g <= MIN_F32 / 2) & (w <= MIN_F32 / 2))
        assert torch.isfinite(g[live]).all()
        torch.testing.assert_close(g[live], w[live], atol=CTC_ATOL,
                                   rtol=CTC_RTOL)


def test_cpu_tensors_take_the_plain_versions():
    """On CPU tensors every wrapper returns its plain version's result and
    launches (and builds) nothing. Two calls of the same plain version need
    not agree to the bit: a CPU BLAS may block a product's sums differently
    from call to call (it picks kernels by the buffers' alignment), so the
    matmul-based ones compare at the kernel tolerances."""
    build.reset_launches()
    args = _fbank_args(2, 4000, True)
    torch.testing.assert_close(_logmel(*args, log_eps=EPSILON),
                               fused_logmel_plain(*args, log_eps=EPSILON),
                               atol=LOGMEL_ATOL, rtol=0)
    rel, k_len = _rel_args(4, 2, 90, 16, 1)
    torch.testing.assert_close(flash_attention_rel(*rel, k_len=k_len),
                               rel_mha_reference(*rel, k_len=k_len),
                               atol=ATT_ATOL, rtol=0)
    att, bias, k_len = _att_args(3, 2, 50, 70, 16)
    torch.testing.assert_close(
        flash_attention(*att, bias=bias, k_len=k_len, causal=True),
        mha_reference(*att, bias=bias, k_len=k_len, causal=True),
        atol=ATT_ATOL, rtol=0)
    ctc = _ctc_args(20, 24, 2)
    for g, w in zip(ctc_score_step(*ctc, True),
                    ctc_score_step_plain(*ctc, True)):
        torch.testing.assert_close(g, w, atol=0, rtol=0)
    tcn = _tcn_args(2, 50, 16, 32)
    torch.testing.assert_close(tcn_block_fused(*tcn, 4, causal=True),
                               tcn_block_reference(*tcn, 4, causal=True),
                               atol=TCN_ATOL, rtol=0)
    assert all(n == 0 for n in build.LAUNCHES.values()), build.LAUNCHES


def _kernel_body(text: str, name: str) -> str:
    """The body of the __global__ function `name` in a CUDA source."""
    head = re.search(r"__global__ void[^{;]*?\b" + name + r"\(", text)
    assert head is not None, name
    beg = text.index("{", head.end())
    depth = 0
    for end in range(beg, len(text)):
        depth += {"{": 1, "}": -1}.get(text[end], 0)
        if depth == 0:
            return text[beg:end + 1]
    raise AssertionError(f"{name}: unbalanced braces")


@pytest.mark.parametrize("source,product", [
    ("attention.cu", "mma_f32<"),
    ("rel_attention.cu", "mma_f32<"),
    ("tcn.cu", "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32"),
    ("rel_attention_bwd.cu:rel_attn_dq_kernel", "mma_f32<"),
    ("rel_attention_bwd.cu:rel_attn_dpose_kernel", "mma_f32<"),
    ("rel_attention_bwd.cu:rel_attn_dkv_kernel", "mma_f32<"),
])
def test_kernel_sources_use_the_tensor_cores(source, product):
    """K2's forward, K5 and K3's forward, dq, dk/dv and dpose run every
    product on the tensor cores (mma.sync, the three-pass TF32 split of
    attn_tiles.cuh for float32) and stage their operands with its cp.async
    ring: a later edit that goes back to the CUDA-core loops (fmaf over
    shared memory) fails here. "file:kernel" holds that kernel's body alone
    (the file's reduction kernel sums partial tables on the CUDA cores)."""
    csrc = build.CSRC
    source, _, kernel = source.partition(":")
    text = (csrc / source).read_text()
    tiles = (csrc / "attn_tiles.cuh").read_text()
    assert '#include "attn_tiles.cuh"' in text
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in tiles
    assert "mma_f32" in tiles and "cp.async" in tiles
    if kernel:
        text = _kernel_body(text, kernel)
    assert product in text
    assert "cp_async_commit()" in text and "cp_async_wait<" in text
    assert "stage_rows_async" in text or "stage_window_async" in text or \
        "stage_rows_of<" in text or "cp_async_16" in text
    assert "fmaf(" not in text


@pytest.mark.parametrize("source", ["attention.cu", "attention_bwd.cu",
                                    "rel_attention.cu",
                                    "rel_attention_bwd.cu"])
def test_attention_kernels_are_built_for_heads_of_128(source):
    """K2's and K3's kernels are instantiated for heads of 128 (the
    wrappers pad 65-127 up to it). K3's tiles at 128 keep every product on
    the tensor cores: the forward streams 16-key tiles and splits q_c's
    fragments at every tile, dq streams 16-key tiles, and the sizes that
    decide it are checked against a block's shared memory at compile time."""
    text = (build.CSRC / source).read_text()
    assert "case 128: return static_cast<int>(fn<128>(__VA_ARGS__));" in text
    if source == "rel_attention.cu":
        tiles = re.search(r"struct Tiles \{(.*?)\};", text, re.S).group(1)
        assert "kKeys = D <= 64 ? 32 : 16;" in tiles
        assert "kHoldQ = D <= 64;" in tiles
        assert "smem_floats<128>() * 4 <= 232448" in text
        body = _kernel_body(text, "rel_attn_fwd_kernel")
        assert body.count("mma_f32<NT>(s, qa[") == 2
    if source == "rel_attention_bwd.cu":
        tiles = re.search(r"struct DqTiles \{(.*?)\};", text, re.S).group(1)
        assert "kKeys = D <= 64 ? 64 : 16;" in tiles
        for kernel in ("dq", "dpose", "dkv"):
            assert f"{kernel}_smem_floats<128>() * 4 <= kMaxSmemBytes" in text
        assert "__launch_bounds__(kThreads, dkv_blocks_per_sm<D>())" in text
    if source == "attention_bwd.cu":
        assert "__launch_bounds__(kThreads, blocks_per_sm<D>())" in text
        # dbias is csrc/attention_dbias.cu's one kernel, at every width
        assert "sbias_smem" not in text and "attn_dbias_kernel" not in text
        assert 'extern "C" int aps_attention_dbias(' not in text


def test_wide_attention_k2_kernels_use_the_tensor_cores():
    """K2's forward, dq and dk/dv at heads over 128 (csrc/wide_attention.cu)
    run on the tensor cores: the partial scores of a warp's half of the
    head through `partial` (mma_f32, the three-pass TF32 split), the output
    and gradient products through `accumulate`, the operands staged by
    cp.async (16 bytes a copy, 4 off the 16-byte grid), the two warps of a
    row group adding their partials through shared memory; the entry points
    launch these tiles, and the CUDA-core loops (a warp a row) are gone
    from the file. A later edit that takes K2 back to them fails here."""
    text = (build.CSRC / "wide_attention.cu").read_text()
    assert '#include "attn_tiles.cuh"' in text
    assert "mma_f32<NT>(s, fa1, fb1);" in text
    assert "mma_f32<NT>(dp, fa2, fb2);" in text
    assert "mma_tf32(acc[n0 + i], a.big, b[i].big);" in text
    assert "cp_async_16(tile + r * kLd + c," in text
    assert "cp_async_4(tile + r * kLd + c," in text
    assert "kFwdSmemFloats * 4 <= kMaxSmemBytes" in text
    fwd = _kernel_body(text, "k2_fwd_kernel")
    bwd = _kernel_body(text, "k2_bwd_kernel")
    assert fwd.count("partial<NT, false>(") == 2
    assert "accumulate(o, ap, tv," in fwd
    assert bwd.count("partial<NT, true>(") == 2
    assert "accumulate(acc1, ads, ty1," in bwd
    assert "accumulate(acc2, ap, ty2," in bwd
    for body in (fwd, bwd):
        assert "pair_sync(rg);" in body
        assert "cp_async_commit();" in body and "cp_async_wait<0>();" in body
        for loop in ("score<", "dot(", "p_ds<", "__ldg"):
            assert loop not in body, loop
    for entry, launch in (("fwd", "launch_fwd<"), ("dq", "launch_bwd<false, "),
                          ("dkv", "launch_bwd<true, ")):
        beg = text.index(f'extern "C" int aps_attention_wide_{entry}(')
        body = text[beg:text.index("\n}\n", beg)]
        assert body.count(f"k2tc::{launch}") == 2, entry
    for kernel in ("fwd_kernel<false>", "dq_kernel<false>",
                   "dkv_kernel<false>"):
        assert kernel not in text


def test_wide_attention_k3_kernels_use_the_tensor_cores():
    """K3's forward, dq, dk/dv and dpose at heads over 128
    (csrc/wide_attention.cu) run on the tensor cores: every product through
    mma_f32 (the three-pass TF32 split) or `accumulate`, the operands staged
    by cp.async, the four warps of a row group adding their partials
    through shared memory, the relative term read along the diagonal of a
    skew tile (dpose: the two warps of a quarter share the window's content
    scores, summed over the quarters as they are read); the K3 entry points
    launch these tiles (resident up to 256 columns, in passes over), and no
    CUDA-core loop (a warp a row: score<, dot(, __ldg) and no atomic is
    left in them. A later edit that takes K3 back to the CUDA cores fails
    here."""
    text = (build.CSRC / "wide_attention.cu").read_text()
    assert "namespace k3tc {" in text
    assert "kSmemFloats * 4 <= k2tc::kMaxSmemBytes" in text
    bodies = {name: _kernel_body(text, name) for name in (
        "k3_fwd_kernel", "k3_dq_kernel", "k3_dkv_kernel", "k3_dpose_kernel")}
    for name, body in bodies.items():
        assert body.count("dot_rows<") >= 2, name
        assert "accumulate(" in body, name
        if name == "k3_dpose_kernel":
            assert "quarter_sync(w.qt);" in body and "publish(" in body
            assert "dot_rows<kWinFrags>(cs, " in body
        else:
            assert "sum4<NT>(" in body and "group_sync(w.rg);" in body, name
            assert "put_skew(" in body, name
        assert "stage<" in body and "cp_async_commit();" in body, name
        assert "cp_async_wait<0>();" in body, name
        for loop in ("score<", "dot(", "p_ds", "__ldg", "atomic"):
            assert loop not in body, (name, loop)
    assert "mma_f32<N>(x, fa, fb);" in text
    # the staging and the products into accumulators are K2's (k2tc)
    assert "using k2tc::accumulate;" in text and "using k2tc::stage;" in text
    assert "mma_tf32(acc[n0 + i], a.big, b[i].big);" in text
    assert "cp_async_16(tile + r * kLd + c," in text
    assert "cp_async_4(tile + r * kLd + c," in text
    for held in ("dot_held<NT>(dp, hdo,", "dot_held<NT>(dp, hv,",
                 "dot_held<NT>(rel, hp_rows,"):
        assert held in text, held
    for entry, launch in (("fwd", "launch_fwd<"), ("dq", "launch_dq<"),
                          ("dkv", "launch_dkv<"), ("dpose", "launch_dpose<")):
        beg = text.index(f'extern "C" int aps_rel_attention_wide_{entry}(')
        body = text[beg:text.index("\n}\n", beg)]
        assert body.count(f"k3tc::{launch}") == 2, entry
        assert "atomic" not in body, entry
    assert "atomic" not in _kernel_body(text, "dpose_sum_kernel")
    for kernel in ("fwd_kernel<<<", "dq_kernel<<<", "dkv_kernel<<<",
                   "dpose_partial_kernel"):
        assert kernel not in text.replace("k3_fwd_kernel<", "").replace(
            "k3_dq_kernel<", "").replace("k3_dkv_kernel<", ""), kernel


def test_flash_attention_launches_narrow_heads_unpadded():
    """K2's kernels take any head up to 128 at its true width: their C
    entries dispatch a width that is not 16, 32, 64 or 128 to the ragged
    tiles of the next one (stage_rows_ragged: rows at their own stride,
    zeros past the width, 4-byte copies off the 16-byte grid, the true
    columns written), and flash_attention no longer reaches
    with_padded_heads (left to K3's D <= 128 kernels)."""
    import inspect

    from aps_tpu_torch.ops import attention, rel_attention
    assert "with_padded_heads" not in inspect.getsource(
        attention.flash_attention)
    assert "with_padded_heads" in inspect.getsource(
        rel_attention.flash_attention_rel)
    tiles = (build.CSRC / "attn_tiles.cuh").read_text()
    assert "void stage_rows_ragged(" in tiles
    assert "cp_async_4(dst + e, ok ? from + e : src, ok);" in tiles
    for source, kernels in (("attention.cu", ("attn_fwd_kernel",)),
                            ("attention_bwd.cu", ("attn_bwd_tiles_kernel",))):
        text = (build.CSRC / source).read_text()
        assert "case 128: return static_cast<int>(fn<128, true>(" in text
        assert "attn_tiles::tile_width(D)" in text
        for kernel in kernels:
            body = _kernel_body(text, kernel)
            assert "const int W = kRagged ? dim : D;" in body, kernel
    for kernel in ("attn_fwd_kernel", "attn_bwd_tiles_kernel"):
        text = (build.CSRC / ("attention.cu" if kernel == "attn_fwd_kernel"
                              else "attention_bwd.cu")).read_text()
        assert "stage_rows_of<kRagged, D," in _kernel_body(text, kernel)
    # dbias takes every width in one kernel: a ragged chunk of the head is
    # zero-filled past D, and rows off the 16-byte grid go a float a copy
    text = (build.CSRC / "attention_dbias.cu").read_text()
    assert "const bool ok = live && c0 + c < D;" in text
    assert "const bool ok = live && c0 + c + e < D;" in text
    assert "cp_async_4(dst + e, ok ? from + e : src, ok);" in text
    assert "kRagged" not in text and "tile_width(" not in text


def test_attention_dbias_is_one_tiled_kernel():
    """K2's dbias is one kernel for every head width
    (csrc/attention_dbias.cu): 64 x 64 tiles of a head, the batch looped
    over in order inside the block, s and dp on the tensor cores (mma_f32,
    the three-pass TF32 split; each chunk's products added with rounding)
    from chunks of the head staged by cp.async
    into a ring that runs across the (batch entry, chunk) sequence, the
    bias read once a block; no atomics, no dispatch on the width, no
    CUDA-core loop. The thread-an-entry kernel of attention_bwd.cu and the
    warp-an-entry kernel of wide_attention.cu are gone, and the wrapper
    sends every width to the one entry."""
    import inspect

    from aps_tpu_torch.ops import attention
    text = (build.CSRC / "attention_dbias.cu").read_text()
    assert '#include "attn_tiles.cuh"' in text
    assert len(re.findall(r"__global__ void", text)) == 2
    body = _kernel_body(text, "attn_dbias_tiles_kernel")
    assert "mma_f32<kNT>(part, fa, fb);" in body
    assert "product(s, tq, tk);" in body and "product(dp, tdo, tv);" in body
    # a chunk's products are added to s and dp with rounding
    assert "sum[j][c] += part[j][c];" in body
    assert "cp_async_commit();" in body
    assert "cp_async_wait<kStages - 2>();" in body
    assert body.count("stage_chunk(") == 4
    assert "cp_async_16(dst, ok ? from : src, ok);" in text
    assert "constexpr int kStages = 3;" in text
    assert "next_live(b_beg)" in body and "next_live(cb + 1)" in body
    assert "bias_h[static_cast<size_t>(l) * a.Tk + sk]" in body
    assert body.count("bias_h[") == 1  # the bias tile, once a block
    for loop in ("fmaf(", "atomicAdd", "__ldg", "dot("):
        assert loop not in text, loop
    assert "template <" not in text and "switch (D)" not in text
    entries = re.findall(r'extern "C" int (aps_\w+)\(', text)
    assert entries == ["aps_attention_dbias", "aps_attention_dbias_occupancy"]
    assert "acc += partial[group * n + i];" in _kernel_body(
        text, "dbias_sum_kernel")
    wide = (build.CSRC / "wide_attention.cu").read_text()
    assert " dbias_kernel(" not in wide
    assert "aps_attention_wide_dbias" not in wide
    bwd = (build.CSRC / "attention_bwd.cu").read_text()
    assert "attn_dbias_kernel" not in bwd and "kPerThread" not in bwd
    launch = inspect.getsource(attention._launch_dbias)
    assert 'build.load("attention_dbias", "aps_attention_dbias",' in launch
    assert "_source(" not in launch
    assert "K2 dbias" not in attention.WIDE_KERNELS


@pytest.mark.parametrize("B,H,Tq,Tk,sms,groups", [
    (8, 4, 690, 690, 132, 1),     # the long-form step: 484 tiles
    (4, 2, 129, 129, 132, 4),     # 18 tiles: a group a batch entry
    (144, 2, 16, 16, 132, 132),   # heads of 8 in SepFormer's chunks
    (1, 2, 16, 16, 132, 1),
    (16, 1, 65, 65, 132, 16),
    (8, 4, 300, 300, 4, 1),       # a small card: 100 tiles fill it
])
def test_attention_dbias_groups(B, H, Tq, Tk, sms, groups):
    """The batch is cut into groups (a block each, partial tiles added in
    order) only where the tiles are too few to fill two blocks an SM."""
    from aps_tpu_torch.ops.attention import dbias_groups
    assert dbias_groups(B, H, Tq, Tk, sms) == groups


def test_ctc_score_kernel_scans_over_chunks():
    """csrc/ctc_score.cu solves the recursions as a chunked scan over T (32
    chunks a block, the maps scanned with warp shuffles) and reads the
    parent's columns in place: a later edit that goes back to one thread
    walking a lane through T fails here."""
    text = (build.CSRC / "ctc_score.cu").read_text()
    body = _kernel_body(text, "ctc_score_kernel")
    assert re.search(r"constexpr int kChunks = 32;", text)
    assert "__shfl_up_sync" in text and "m.after(e)" in body
    assert "then_frame" in body and "__syncthreads()" in body
    assert "g.L / g.P" in body
    assert re.search(r"int T, int L, int P,", text)


def test_fbank_kernel_is_an_fft():
    """csrc/fbank.cu computes each frame's spectrum by Stockham stages of
    radix 4, 3, 5 and 2 (those the wrapper passes) and the real-FFT split
    step, in float64, and takes no cos/sin tables: a later edit that goes
    back to a dense DFT over W x F fails here."""
    text = (build.CSRC / "fbank.cu").read_text()
    body = _kernel_body(text, "fbank_fft_kernel")
    for radix in (2, 3, 4, 5):
        assert f"fft_stage<{radix}>(src, dst" in body
    assert "butterfly<R>(v)" in text and "cmul(tw[k], o)" in body
    assert "double2* src = buf0;" in body
    entry = text[text.index('extern "C" int aps_fused_logmel('):]
    assert "const double* twiddle" in entry and "cos" not in entry
    # the stages are the ones the wrapper passes (ops.fbank.fft_plan): the
    # radix rule is written once, in Python
    assert "for (unsigned plan = a.radices; plan != 0; plan >>= 3)" in body
    assert "int radices" in entry and "% 4 == 0" not in text
    assert "dft_" not in text
    assert not re.search(r"for \(int j = 0; j < (a\.)?W;", text)
    assert "__ldg(a.mel_bands" in body


@pytest.mark.cuda
@pytest.mark.parametrize("with_mel", [True, False])
def test_fused_logmel_kernel_matches_plain(cuda_device, with_mel):
    """csrc/fbank.cu == the plain version on 8 s utterances padded to
    their duration bucket, as decode_batch gives them."""
    wav, *rest = _fbank_args(4, 149003, with_mel)
    wav = wav.to(cuda_device)
    build.reset_launches()
    got = _logmel(wav, *rest, log_eps=EPSILON)
    assert build.LAUNCHES["fused_logmel"] == 1
    want = fused_logmel_plain(wav, *rest, log_eps=EPSILON)
    if with_mel:
        torch.testing.assert_close(got, want, atol=LOGMEL_ATOL, rtol=0)
    else:
        # a log-spectrogram bin near a spectral zero is ill-conditioned in
        # the log domain; compare magnitudes against each frame's peak
        mag, ref = got.exp(), want.exp()
        peak = ref.amax(-1, keepdim=True)
        assert ((mag - ref).abs() / peak).max().item() <= 1e-5


# (N, S) of the front end's batches: the flagship step (32 x the loader's
# padded length), the long-form decode's and step's
FBANK_PATHS = [(32, 147884), (4, 454718), (8, 441576)]
# frames a block at fft_size 512 (csrc/fbank.cu)
FBANK_BLOCK_FRAMES = 8
# (pre_emphasis, normalized, use_power, log_lower_bound)
FBANK_OPTIONS = [(0.97, False, False, 0.0), (0.0, False, False, 0.0),
                 (0.97, True, True, 1.0), (0.96, False, True, 0.0)]


def _logmel_float64(wav, window, fft_size, hop, mel=None, pre_emphasis=0.97,
                    normalized=False, use_power=False, log_lower_bound=0.0,
                    log_eps=EPSILON):
    """fused_logmel's function in float64 (torch.fft.rfft of each frame):
    the referee where the float32 roundings of the plain version's own
    dense sums reach the tolerance, as in the log of a mel band whose power
    lies four orders below its neighbours' (seen: kernel and plain version
    each some 5e-4 from it there, on either side)."""
    frames = wav.double().unfold(-1, len(window), hop)
    if pre_emphasis > 0:
        frames = torch.cat([frames[..., :1] * (1 - pre_emphasis),
                            frames[..., 1:] - pre_emphasis * frames[..., :-1]],
                           -1)
    win = torch.from_numpy(np.asarray(window, np.float64)).to(wav.device)
    if normalized:
        win = win / np.sqrt(fft_size)
    spec = torch.fft.rfft(frames * win, n=fft_size)
    feat = spec.real**2 + spec.imag**2
    if not use_power:
        feat = feat.sqrt()
    if mel is not None:
        feat = feat @ torch.from_numpy(np.asarray(mel, np.float64)).to(
            wav.device)
    if log_lower_bound > 0:
        return torch.log(log_lower_bound + feat).float()
    return torch.log(torch.clamp_min(feat, log_eps)).float()


def _assert_logmel_close(got, want, with_mel):
    if with_mel:
        torch.testing.assert_close(got, want, atol=LOGMEL_ATOL, rtol=0)
    else:
        mag, ref = got.exp(), want.exp()
        peak = ref.amax(-1, keepdim=True)
        assert ((mag - ref).abs() / peak).max().item() <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("N,S", FBANK_PATHS + [
    (3, 512 + 160 * (frames - 1))
    for frames in (1, FBANK_BLOCK_FRAMES - 1, FBANK_BLOCK_FRAMES,
                   FBANK_BLOCK_FRAMES + 1)])
@pytest.mark.parametrize("options", FBANK_OPTIONS)
def test_fused_logmel_kernel_at_path_shapes_and_block_edges(
        cuda_device, N, S, options):
    """The FFT kernel == the function in float64 at the step's and the
    long-form path's batches and at frame counts around a block's 8
    frames, with pre-emphasis off, a normalized window, power and the log's
    lower bound; two launches give the same bits."""
    pre, normalized, use_power, lower = options
    wav, win, fft_size, hop, mel = _fbank_args(N, S, True)
    wav = wav.to(cuda_device)
    kw = dict(mel=mel, pre_emphasis=pre, normalized=normalized,
              use_power=use_power, log_lower_bound=lower, log_eps=EPSILON)
    got = _logmel(wav, win, fft_size, hop, **kw)
    assert got.shape == (N, (S - len(win)) // hop + 1, 80)
    _assert_logmel_close(got, _logmel_float64(wav, win, fft_size, hop,
                                              **kw), True)
    assert torch.equal(got, _logmel(wav, win, fft_size, hop, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("recipe", ["wsj", "timit"])
@pytest.mark.parametrize("N,S", [(8, 149003), (32, 128000)])
def test_fused_logmel_kernel_on_the_delta_recipes(cuda_device, recipe, N, S):
    """K1 through the asr transform of examples/asr/{wsj,timit}/conf/
    1a.yaml (int16 rescale, pre-emphasis 0.97 and 0.96, 80 mel bins; the
    deltas follow the kernel) at a decode batch of 8 x 8 s padded to its
    bucket and a training batch of 32 x 8 s: == the function in float64,
    one launch each, two launches give the same bits."""
    from pathlib import Path

    from aps_tpu_torch.conf import load_yaml
    from aps_tpu_torch.transform.asr import AsrTransform
    conf = load_yaml(str(Path(__file__).resolve().parents[1] / "examples" /
                         "asr" / recipe / "conf" / "1a.yaml"))
    tf = AsrTransform(**conf["asr_transform"])
    assert "delta" in tf.steps and tf.rescale is not None
    gen = torch.Generator().manual_seed(N + S)
    wav = tf.rescale(0.1 * torch.randn((N, S), generator=gen)).to(cuda_device)
    build.reset_launches()
    got = tf._fbank_log(wav)
    assert build.LAUNCHES["fused_logmel"] == 1
    want = _logmel_float64(wav, tf.window, tf.fft_size, tf.frame_hop,
                           mel=tf.mel, pre_emphasis=tf.pre_emphasis,
                           use_power=tf.use_power,
                           log_lower_bound=tf.log_lower_bound, log_eps=tf.eps)
    assert got.shape == (N, (S - len(tf.window)) // tf.frame_hop + 1, 80)
    # a band whose magnitude lies at float32's resolution of its frame (the
    # kernel takes the frame in float32, pre-emphasis and window included)
    # is held by its magnitude, relative to the frame's largest band (seen:
    # 2.0e-3 in the log of a band 1.6e-6 of its frame's largest, at the
    # lowest band of int16-scale noise after pre-emphasis); the others in
    # the log
    mag, ref = got.exp(), want.exp()
    peak = ref.amax(-1, keepdim=True)
    floor = ref <= LOGMEL_FLOOR * peak
    assert ((got - want).abs() <= LOGMEL_ATOL)[~floor].all()
    assert ((mag - ref).abs() <= LOGMEL_FLOOR * peak)[floor].all()
    assert torch.equal(got, tf._fbank_log(wav))


@pytest.mark.cuda
@pytest.mark.parametrize("fft_size", [256, 400, 1024])
@pytest.mark.parametrize("full_window", [True, False])
@pytest.mark.parametrize("with_mel", [True, False])
def test_fused_logmel_kernel_at_other_fft_sizes(cuda_device, fft_size,
                                                full_window, with_mel):
    """fft_size 256 (radix 4 and a final 2), 400 (radix 5) and 1024, with
    a window of fft_size samples or shorter (kaldi's: zeros past W), against
    the function in float64."""
    frame_len = fft_size if full_window else fft_size * 3 // 4
    win = make_window("hamm", frame_len, False, "kaldi")
    mel = mel_filter(fft_size, round_pow_of_two=False,
                     num_mels=40).T if with_mel else None
    gen = torch.Generator().manual_seed(fft_size)
    wav = (0.1 * torch.randn((3, 20000), generator=gen)).to(cuda_device)
    kw = dict(mel=mel, log_eps=EPSILON)
    got = _logmel(wav, win, fft_size, 160, **kw)
    _assert_logmel_close(got, _logmel_float64(wav, win, fft_size, 160,
                                              **kw), with_mel)
    assert torch.equal(got, _logmel(wav, win, fft_size, 160, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("fft_size", [402, 448, 375])
def test_fused_logmel_kernel_refuses_other_fft_sizes(cuda_device, fft_size):
    """A size with a prime factor above 5, or an odd one, raises and names
    the size; nothing is launched."""
    win = np.hamming(300).astype(np.float32)
    wav = torch.zeros((1, 4000), device=cuda_device)
    build.reset_launches()
    with pytest.raises(ValueError, match=f"fft_size {fft_size} "):
        _logmel(wav, win, fft_size, 160)
    assert build.LAUNCHES["fused_logmel"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,D,Hp,causal,lens", [
    (8, 233, 64, 1, False, "path"),  # the flagship decode batch
    (32, 231, 64, 1, False, "path"),  # the flagship step
    (8, 233, 64, 1, False, "ragged"),
    (8, 233, 64, 4, True, "ragged"),
    (4, 65, 64, 4, True, "ragged"),
    (4, 129, 64, 4, True, "ragged"),
    (8, 700, 64, 4, True, "ragged"),
    (4, 77, 16, 2, False, "ragged"),
    (4, 129, 32, 1, True, "ragged"),
    (4, 640, 64, 1, True, "corner"),
    (4, 640, 64, 4, True, "corner"),
])
def test_rel_attention_kernel_matches_plain(cuda_device, B, T, D, Hp, causal,
                                            lens):
    """csrc/rel_attention.cu == the plain version, its lse == the plain
    log-sum-exp (1e30 where a row sees no key), and two launches give the
    same bits: the decode's and the step's shapes, ragged T over several
    64-row blocks and 32-key tiles, per-head tables, causal, suffix k_len
    including 1 and 0 (a fully masked row gives 0), and the one-key
    corner, whose error is printed."""
    H = 4 if D == 64 else 2
    rel, k_len = _rel_args(B, H, T, D, Hp)  # ragged: T, T - 77, 1, 0, ...
    if lens == "path":  # 200 of T valid
        k_len = torch.full((B,), 200, dtype=torch.int32)
    elif lens == "corner":  # one key under a long causal mask
        k_len = torch.tensor([1, 1, T, 2], dtype=torch.int32)
    rel = [t.to(cuda_device) for t in rel]
    k_len = k_len.to(cuda_device)
    build.reset_launches()
    got = flash_attention_rel(*rel, k_len=k_len, causal=causal)
    assert build.LAUNCHES["flash_attention_rel"] == 1
    want = rel_mha_reference(*rel, k_len=k_len, causal=causal)
    torch.testing.assert_close(got, want, atol=ATT_ATOL, rtol=0)
    out, lse = launch_forward(*rel, k_len, causal, True)
    assert torch.equal(out, got)
    lse_want = rel_lse_reference(*rel[:3], rel[4], k_len=k_len,
                                 causal=causal)
    torch.testing.assert_close(lse, lse_want, atol=ATT_ATOL, rtol=0)
    again = launch_forward(*rel, k_len, causal, True)
    assert torch.equal(again[0], out) and torch.equal(again[1], lse)
    for b, n in enumerate(k_len.tolist()):
        if n == 0:
            assert torch.count_nonzero(got[b]) == 0
    if lens == "corner":
        print(f"one-key corner (k_len 1, causal, T = {T}, Hp = {Hp}): max "
              f"abs err out {(got - want).abs().max().item():.3e}, lse "
              f"{(lse - lse_want).abs().max().item():.3e}")


@pytest.mark.cuda
@pytest.mark.parametrize("T,D,Hp,causal", [(129, 8, 1, True),
                                           (65, 40, 2, False)])
def test_rel_attention_kernel_pads_other_heads(cuda_device, T, D, Hp,
                                               causal):
    """A head of 8 or 40 runs through the kernel zero-padded to 16 or 64
    (table too) at its own scale D**-0.5: one launch, the plain version's
    output, and at another scale too."""
    rel, k_len = _rel_args(4, 2, T, D, Hp)
    rel = [t.to(cuda_device) for t in rel]
    k_len = k_len.to(cuda_device)
    build.reset_launches()
    got = flash_attention_rel(*rel, k_len=k_len, causal=causal)
    assert build.LAUNCHES["flash_attention_rel"] == 1
    assert got.shape == rel[0].shape
    want = rel_mha_reference(*rel, k_len=k_len, causal=causal)
    torch.testing.assert_close(got, want, atol=ATT_ATOL, rtol=0)
    scaled = flash_attention_rel(*rel, k_len=k_len, causal=causal,
                                 softmax_scale=0.05)
    torch.testing.assert_close(
        scaled, rel_mha_reference(*rel, k_len=k_len, causal=causal,
                                  softmax_scale=0.05), atol=ATT_ATOL, rtol=0)


@pytest.mark.cuda
def test_rel_attention_kernel_rejects_bad_input(cuda_device):
    rel, _ = _rel_args(4, 2, 40, 16, 1)
    rel = [t.to(cuda_device) for t in rel]
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_rel(rel[0].transpose(2, 3).contiguous().transpose(
            2, 3), *rel[1:])
    # a head of 80 runs zero-padded to 128; one over 128 runs the wide
    # kernels
    padded = [torch.ones((1, 1, 8, 80), device=cuda_device)] * 4
    table = torch.zeros((1, 15, 80), device=cuda_device)
    torch.testing.assert_close(flash_attention_rel(*padded, table),
                               rel_mha_reference(*padded, table),
                               atol=ATT_ATOL, rtol=0)
    wide = [torch.ones((1, 1, 8, 160), device=cuda_device)] * 4
    table = torch.zeros((1, 15, 160), device=cuda_device)
    torch.testing.assert_close(flash_attention_rel(*wide, table),
                               rel_mha_reference(*wide, table),
                               atol=ATT_ATOL, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 2, 31, 32, 33, 233, 710])
@pytest.mark.parametrize("L", [384, 768, 6144])
@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("shared_blank", [False, True])
def test_ctc_score_step_kernel_matches_plain(cuda_device, T, L, compact,
                                             shared_blank):
    """csrc/ctc_score.cu == the plain version, both is_first, at the decode
    lanes of 4, 8 and 64 utterances x beam 8 x ctc beam 12: the parent's
    gammas and scores expanded (P = L) or read in place (P = L / 12), one
    blank column a batch (G = 1) or an utterance (G = N), T below, at and
    above the 32 chunks of a block and at the two paths' encoder lengths;
    two launches give the same bits."""
    N = L // 96
    ops = [t.to(cuda_device) for t in _ctc_args(
        T, L, 1 if shared_blank else N, L // 12 if compact else L)]
    for is_first in (True, False):
        build.reset_launches()
        got = ctc_score_step(*ops, is_first)
        assert build.LAUNCHES["ctc_score_step"] == 1
        _assert_ctc_close(got, ctc_score_step_plain(*ops, is_first))
        for g, a in zip(got, ctc_score_step(*ops, is_first)):
            assert torch.equal(g, a)


@pytest.mark.cuda
@pytest.mark.parametrize("T,L", [(801, 768), (929, 768), (300, 768),
                                 (233, 1536)])
def test_ctc_score_step_kernel_at_the_att_paths(cuda_device, T, L):
    """K4 at the RNN attention recipes' searches: TIMIT's encoder does not
    subsample (8 s: 801 frames, 929 padded to the decode's bucket; 3 s:
    300) at 8 utterances x beam 8 x ctc beam 12; WSJ's 8 s (233 frames
    padded) at beam 16. The parents' operands in place, one blank column an
    utterance; == the plain version, two launches give the same bits."""
    N = 8
    ops = [t.to(cuda_device) for t in _ctc_args(T, L, N, L // 12)]
    for is_first in (True, False):
        got = ctc_score_step(*ops, is_first)
        _assert_ctc_close(got, ctc_score_step_plain(*ops, is_first))
        for g, a in zip(got, ctc_score_step(*ops, is_first)):
            assert torch.equal(g, a)


@pytest.mark.cuda
def test_rel_mha_on_cuda_runs_the_kernel_or_raises(cuda_device):
    """RelMultiheadAttention on the card launches the kernel wherever the
    call is eligible; an attn_mask or active attention dropout takes the
    dense path on the card, as in aps_tpu, and launches nothing; a padding
    mask that is not a suffix raises."""
    E, H, T = 64, 4, 50
    tmod = impl.RelMultiheadAttention(E, H, dropout=0.1).eval().to(
        cuda_device)
    x = torch.randn(2, T, E, device=cuda_device)
    pose = torch.randn(2 * T - 1, E // H, device=cuda_device)
    build.reset_launches()
    with torch.no_grad():
        flash, weight = tmod(x, x, x, inj_pose=pose)
    assert weight is None and build.LAUNCHES["flash_attention_rel"] == 1
    build.reset_launches()
    with torch.no_grad():
        dense, weight = tmod(x, x, x, inj_pose=pose,
                             attn_mask=torch.zeros(T, T, device=cuda_device))
        assert weight.shape == (2, T, T)
        torch.testing.assert_close(dense, flash, atol=ATT_ATOL, rtol=0)
        out, weight = tmod.train()(x, x, x, inj_pose=pose)
        assert weight.shape == (2, T, T) and torch.isfinite(out).all()
    assert not any(build.LAUNCHES.values())
    holes = torch.zeros(2, T, dtype=torch.bool, device=cuda_device)
    holes[1, 3] = True
    with torch.no_grad(), pytest.raises(ValueError, match="suffix"):
        tmod.eval()(x, x, x, inj_pose=pose, key_padding_mask=holes)


GRAD_NAMES = ("dq_c", "dq_p", "dk", "dv", "dpose")


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,T,D,Hp,causal", [
    (4, 2, 40, 16, 1, False),
    (4, 2, 77, 32, 2, True),
    (8, 4, 233, 64, 1, False),
    (8, 4, 233, 64, 4, True),
    (4, 4, 700, 64, 1, True),
    # the edges of dq's 64 query rows and dpose's 64 table rows (2T - 1 =
    # 125, 127, 129, 257), the flagship step's T, per-head tables at T = 700
    (4, 2, 63, 16, 2, False),
    (4, 2, 64, 32, 1, True),
    (4, 4, 65, 64, 4, False),
    (4, 4, 65, 64, 1, True),
    (4, 2, 129, 16, 1, True),
    (4, 4, 129, 32, 4, False),
    (8, 4, 231, 64, 1, False),
    (4, 4, 700, 64, 4, False),
    # heads the kernels are not built for, zero-padded to 16 and 64
    (4, 2, 65, 8, 1, True),
    (4, 2, 129, 40, 2, False),
])
def test_rel_attention_backward_kernels_match_plain(cuda_device, B, H, T, D,
                                                    Hp, causal):
    """csrc/rel_attention_bwd.cu (dq, dk/dv, dpose) through the autograd
    Function == rel_mha_backward_reference == autograd through
    rel_mha_reference, with ragged T, k_len including 1 and 0 (fully masked
    rows: zero gradients, no NaN) and every kernel launched once."""
    rel, k_len = _rel_args(B, H, T, D, Hp)
    rel = [t.to(cuda_device).requires_grad_() for t in rel]
    k_len = k_len.to(cuda_device)
    gen = torch.Generator().manual_seed(T)
    do = torch.randn(rel[0].shape, generator=gen).to(cuda_device)
    build.reset_launches()
    out = flash_attention_rel(*rel, k_len=k_len, causal=causal)
    got = torch.autograd.grad(out, rel, do)
    for name in ("", "_dq", "_dkv", "_dpose"):
        assert build.LAUNCHES["flash_attention_rel" + name] == 1
    plain = rel_mha_backward_reference(*[t.detach() for t in rel], do,
                                       k_len=k_len, causal=causal)
    auto = torch.autograd.grad(
        rel_mha_reference(*rel, k_len=k_len, causal=causal), rel, do)
    for name, g, w, a in zip(GRAD_NAMES, got, plain, auto):
        assert torch.isfinite(g).all(), name
        atol = GRAD_ATOL if name != "dpose" else \
            GRAD_ATOL + DPOSE_RTOL * w.abs().max().item()
        torch.testing.assert_close(g, w, atol=atol, rtol=0, msg=name)
        torch.testing.assert_close(g, a, atol=atol, rtol=0, msg=name)
    # padded keys (s >= k_len) get exactly zero dk, dv; so does the whole
    # batch entry whose k_len is 0
    for g in got[2:4]:
        assert torch.count_nonzero(g[1, :, T - 77:]) == 0
        assert torch.count_nonzero(g[3]) == 0
    assert torch.count_nonzero(got[0][3]) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("T,Hp", [(233, 1), (700, 4)])
def test_rel_attention_backward_is_deterministic(cuda_device, T, Hp):
    """No kernel uses atomics; dpose sums per-(b, h) partial tables in a
    fixed order: two runs give the same bits."""
    rel, k_len = _rel_args(8, 4, T, 64, Hp)
    rel = [t.to(cuda_device).requires_grad_() for t in rel]
    do = torch.ones_like(rel[0])
    runs = []
    for _ in range(2):
        out = flash_attention_rel(*rel, k_len=k_len.to(cuda_device))
        runs.append(torch.autograd.grad(out, rel, do))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("T,D,Hp,causal", [
    (63, 16, 4, False), (64, 32, 1, True), (65, 64, 4, False),
    (129, 64, 1, True), (231, 64, 1, False), (700, 64, 4, True)])
def test_rel_attention_dkv_kernel_is_deterministic(cuda_device, T, D, Hp,
                                                   causal):
    """dk/dv launched twice on the same delta gives the same bits at the
    edges of its 64 key rows and 16-row query tiles (k_len 0 and 1
    included), and matches the plain backward."""
    from aps_tpu_torch.ops.rel_attention import launch_backward_kernel
    rel, k_len = _rel_args(4, 4, T, D, Hp)
    rel = [t.to(cuda_device) for t in rel]
    k_len = k_len.to(cuda_device)
    gen = torch.Generator().manual_seed(T + D)
    do = torch.randn(rel[0].shape, generator=gen).to(cuda_device)
    out, lse = launch_forward(*rel, k_len, causal, True)
    delta = torch.empty_like(lse)
    args = (*rel, k_len, do, lse, out, delta, causal)
    launch_backward_kernel("dq", *args)
    first = launch_backward_kernel("dkv", *args)
    second = launch_backward_kernel("dkv", *args)
    want = rel_mha_backward_reference(*rel, do, k_len=k_len, causal=causal)
    for a, b, w in zip(first, second, want[2:4]):
        assert torch.equal(a, b)
        torch.testing.assert_close(a, w, atol=GRAD_ATOL, rtol=0)


@pytest.mark.cuda
def test_rel_attention_backward_takes_an_unaligned_view(cuda_device):
    """dq and dpose copy 16 bytes at a time: an operand, or a gradient of
    the output, that is a contiguous view one float into its storage is
    copied by the wrapper and gets the same gradients."""
    rel, k_len = _rel_args(4, 2, 40, 16, 1)
    rel = [t.to(cuda_device) for t in rel]
    k_len = k_len.to(cuda_device)
    odd = torch.zeros(rel[0].numel() + 1, device=cuda_device)[1:]
    odd = odd.view(rel[0].shape).copy_(rel[0])
    assert odd.is_contiguous() and odd.data_ptr() % 16
    do = torch.ones(odd.numel() + 1, device=cuda_device)[1:].view(odd.shape)
    grads = []
    for q_c in (odd, rel[0].clone()):
        leaves = [q_c] + [t.clone() for t in rel[1:]]
        leaves = [t.requires_grad_() for t in leaves]
        grads.append(torch.autograd.grad(
            flash_attention_rel(*leaves, k_len=k_len), leaves, do))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("Hp", [1, 4])
def test_rel_attention_backward_one_key_corner(cuda_device, Hp):
    """Batch entries that see one key under a long causal mask: every
    gradient within the tolerances of the plain version; the errors of dq
    and dpose are printed (a key that is the only one its 640 rows see
    gives sums that cancel)."""
    T = 640
    rel, _ = _rel_args(4, 4, T, 64, Hp)
    rel = [t.to(cuda_device).requires_grad_() for t in rel]
    k_len = torch.tensor([1, 1, T, 2], dtype=torch.int32, device=cuda_device)
    gen = torch.Generator().manual_seed(Hp)
    do = torch.randn(rel[0].shape, generator=gen).to(cuda_device)
    got = torch.autograd.grad(
        flash_attention_rel(*rel, k_len=k_len, causal=True), rel, do)
    plain = rel_mha_backward_reference(*[t.detach() for t in rel], do,
                                       k_len=k_len, causal=True)
    errs = {}
    for name, g, w in zip(GRAD_NAMES, got, plain):
        atol = GRAD_ATOL if name != "dpose" else \
            GRAD_ATOL + DPOSE_RTOL * w.abs().max().item()
        errs[name] = (g - w).abs().max().item()
        torch.testing.assert_close(g, w, atol=atol, rtol=0, msg=name)
    print(f"one-key corner (k_len 1, causal, T = {T}, Hp = {Hp}): max abs "
          "err " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))


@pytest.mark.cuda
def test_rel_attention_gradcheck_style(cuda_device):
    """Directional derivative by central differences (float64 plain
    version) against the kernels' gradients at a small ragged shape."""
    rel, k_len = _rel_args(4, 2, 19, 16, 1)
    k_len = k_len.to(cuda_device)
    rel = [t.to(cuda_device).requires_grad_() for t in rel]
    gen = torch.Generator().manual_seed(5)
    do = torch.randn(rel[0].shape, generator=gen).to(cuda_device)
    grads = torch.autograd.grad(
        flash_attention_rel(*rel, k_len=k_len), rel, do)
    dirs = [torch.randn(t.shape, generator=gen).to(cuda_device) for t in rel]
    want = sum((g * d).sum().item() for g, d in zip(grads, dirs))
    eps = 1e-3
    f64 = lambda sign: (rel_mha_reference(  # noqa: E731
        *[(t.detach() + sign * eps * d).double() for t, d in zip(rel, dirs)],
        k_len=k_len) * do.double()).sum().item()
    numeric = (f64(1) - f64(-1)) / (2 * eps)
    assert abs(numeric - want) <= 1e-3 * max(1.0, abs(numeric))


@pytest.mark.cuda
def test_rel_mha_trains_on_cuda_without_attention_dropout(cuda_device):
    """In training RelMultiheadAttention with dropout 0 goes through the
    autograd Function (all four kernels launch); with dropout > 0 it takes
    the dense path on the card and launches none."""
    E, H, T = 64, 4, 50
    tmod = impl.RelMultiheadAttention(E, H, dropout=0.0).train().to(
        cuda_device)
    x = torch.randn(2, T, E, device=cuda_device, requires_grad=True)
    pose = torch.randn(2 * T - 1, E // H, device=cuda_device,
                       requires_grad=True)
    build.reset_launches()
    out, _ = tmod(x, x, x, inj_pose=pose)
    out.sum().backward()
    for name in ("", "_dq", "_dkv", "_dpose"):
        assert build.LAUNCHES["flash_attention_rel" + name] == 1
    assert torch.isfinite(x.grad).all() and torch.isfinite(pose.grad).all()
    build.reset_launches()
    out, weight = impl.RelMultiheadAttention(E, H, dropout=0.1).train().to(
        cuda_device)(x, x, x, inj_pose=pose)
    out.sum().backward()
    assert weight is not None and not any(build.LAUNCHES.values())


ATT_GRAD_NAMES = ("dq", "dk", "dv", "dbias")


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Tq,Tk,D,causal,with_bias", [
    (4, 4, 601, 601, 64, False, False),
    (4, 4, 601, 601, 64, True, True),
    (5, 2, 200, 300, 32, False, True),
    (5, 2, 300, 200, 16, True, False),
    (16, 4, 1024, 1024, 64, False, False),
    (4, 1, 1, 37, 64, False, True),
    # heads the kernel is not built for, zero-padded to 16 and 64
    (4, 2, 250, 250, 8, False, False),
    (5, 2, 77, 130, 40, True, True),
])
def test_attention_kernel_matches_plain(cuda_device, B, H, Tq, Tk, D, causal,
                                        with_bias):
    """csrc/attention.cu == the plain version: ragged Tq and Tk against the
    16 x 32 tiles, Tq != Tk, causal, a bias that differs between the heads,
    suffix k_len including 1 and 0 (a row without a key gives 0)."""
    att, bias, k_len = _att_args(B, H, Tq, Tk, D)
    att = [t.to(cuda_device) for t in att]
    bias = bias.to(cuda_device) if with_bias else None
    k_len = k_len.to(cuda_device)
    build.reset_launches()
    got = flash_attention(*att, bias=bias, k_len=k_len, causal=causal)
    assert build.LAUNCHES["flash_attention"] == 1
    want = mha_reference(*att, bias=bias, k_len=k_len, causal=causal)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, atol=ATT_ATOL, rtol=0)
    assert torch.count_nonzero(got[3]) == 0
    scaled = flash_attention(*att, bias=bias, k_len=k_len, causal=causal,
                             softmax_scale=0.05)
    torch.testing.assert_close(
        scaled, mha_reference(*att, bias=bias, k_len=k_len, causal=causal,
                              softmax_scale=0.05), atol=ATT_ATOL, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("Tq,Tk,D,causal,with_bias", [
    (63, 63, 64, False, False),
    (64, 64, 64, True, False),
    (65, 65, 32, False, True),
    (129, 129, 64, True, True),
    (31, 129, 16, False, False),
    (32, 65, 64, True, True),
    (33, 33, 32, True, False),
    (129, 64, 16, False, True),
    (65, 200, 64, True, False),
])
def test_attention_forward_at_the_tile_edges(cuda_device, Tq, Tk, D, causal,
                                             with_bias):
    """The forward's row tiles (64 query rows a block, 32 keys a streamed
    tile) at lengths on either side of them, every head dim, Tq != Tk,
    causal, with and without the bias: the output == the plain version,
    rows without a key give 0 and lse = 1e30, every other lse == the plain
    log-sum-exp, and two launches give the same bits."""
    from aps_tpu_torch.ops.attention import launch_forward
    att, bias, k_len = _att_args(5, 2, Tq, Tk, D)
    q, k, v = [t.to(cuda_device) for t in att]
    bias = bias.to(cuda_device) if with_bias else None
    k_len = k_len.to(cuda_device)
    scale = D**-0.5
    out, lse = launch_forward(q, k, v, bias, k_len, scale, causal, True)
    again, lse2 = launch_forward(q, k, v, bias, k_len, scale, causal, True)
    assert torch.equal(out, again) and torch.equal(lse, lse2)
    want = mha_reference(q, k, v, bias=bias, k_len=k_len, causal=causal)
    torch.testing.assert_close(out, want, atol=ATT_ATOL, rtol=0)
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if bias is not None:
        s = s + bias[None]
    col = torch.arange(Tk, device=cuda_device)
    mask = (col[None, None, None, :] < k_len[:, None, None, None]).expand(
        -1, 2, Tq, Tk)
    if causal:
        mask = mask & (col[None, None, None, :]
                       <= torch.arange(Tq, device=cuda_device)[:, None])
    dead = ~mask.any(-1)
    assert torch.count_nonzero(out[dead]) == 0
    assert bool((lse[dead] == 1e30).all())
    live = torch.logsumexp(torch.where(mask, s, -torch.inf), -1)[~dead]
    torch.testing.assert_close(lse[~dead], live, atol=ATT_ATOL, rtol=0)


@pytest.mark.cuda
def test_attention_forward_one_key_corner(cuda_device):
    """Batch entries that see one key under a long causal mask: every row
    of entry 0 gives v[0]; the error against the plain version is printed
    (the three-pass products keep it near float32's rounding)."""
    T = 640
    att, _, _ = _att_args(4, 4, T, T, 64)
    q, k, v = [t.to(cuda_device) for t in att]
    k_len = torch.tensor([1, 1, T, 2], dtype=torch.int32, device=cuda_device)
    got = flash_attention(q, k, v, k_len=k_len, causal=True)
    want = mha_reference(q, k, v, k_len=k_len, causal=True)
    err = (got - want).abs().max().item()
    print(f"one-key corner (k_len 1, causal, T = {T}): max abs err {err:.3e}")
    torch.testing.assert_close(got, want, atol=ATT_ATOL, rtol=0)
    torch.testing.assert_close(got[0], v[0, :, :1].expand(-1, T, -1),
                               atol=1e-6, rtol=0)


@pytest.mark.cuda
def test_attention_kernel_matches_the_library_call(cuda_device):
    """Without a bias one PyTorch call computes the same function (rows
    with at least one key): scaled_dot_product_attention in float32."""
    att, _, _ = _att_args(4, 4, 300, 300, 64)
    att = [t.to(cuda_device) for t in att]
    k_len = torch.tensor([300, 223, 1, 100], dtype=torch.int32,
                         device=cuda_device)
    mask = (torch.arange(300, device=cuda_device)[None, :]
            < k_len[:, None])[:, None, None, :]
    want = torch.nn.functional.scaled_dot_product_attention(
        *att, attn_mask=mask)
    got = flash_attention(*att, k_len=k_len)
    torch.testing.assert_close(got, want, atol=ATT_ATOL, rtol=0)


@pytest.mark.cuda
def test_attention_kernel_rejects_bad_input(cuda_device):
    att, bias, _ = _att_args(2, 2, 40, 40, 16)
    q, k, v = [t.to(cuda_device) for t in att]
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(2, 3).contiguous().transpose(2, 3), k, v)
    # a head of 80 runs zero-padded to 128; one over 128 runs the wide
    # kernels
    padded = [torch.ones((1, 1, 8, 80), device=cuda_device)] * 3
    torch.testing.assert_close(flash_attention(*padded),
                               mha_reference(*padded), atol=ATT_ATOL,
                               rtol=0)
    wide = [torch.ones((1, 1, 8, 160), device=cuda_device)] * 3
    torch.testing.assert_close(flash_attention(*wide), mha_reference(*wide),
                               atol=ATT_ATOL, rtol=0)
    with pytest.raises(ValueError, match="not CUDA"):
        flash_attention(q, k, v, bias=bias)
    with pytest.raises(TypeError, match="dtype"):
        flash_attention(q.half(), k.half(), v.half())


@pytest.mark.cuda
def test_attention_backward_takes_an_unaligned_view(cuda_device):
    """The backward copies 16 bytes at a time: a contiguous view one float
    into its storage is copied by the wrapper and gets its gradient."""
    att, _, _ = _att_args(2, 2, 40, 40, 16)
    q, k, v = [t.to(cuda_device) for t in att]
    odd = torch.zeros(q.numel() + 1, device=cuda_device)[1:].view(q.shape)
    odd.copy_(q)
    assert odd.is_contiguous() and odd.data_ptr() % 16
    torch.testing.assert_close(flash_attention(odd, k, v),
                               flash_attention(q, k, v))
    do = torch.ones(q.numel() + 1, device=cuda_device)[1:].view(q.shape)
    grads = [torch.autograd.grad(flash_attention(t.requires_grad_(), k, v),
                                 t, do)[0] for t in (odd, q.clone())]
    assert torch.equal(*grads)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Tq,Tk,D,causal,with_bias", [
    (4, 2, 40, 40, 16, False, True),
    (5, 2, 77, 130, 32, True, True),
    (5, 2, 130, 77, 32, True, False),
    (8, 4, 601, 601, 64, False, False),
    (4, 4, 601, 601, 64, True, True),
    (4, 4, 700, 700, 64, False, True),
    # on either side of the 64-row tiles of dq and dk/dv, k_len inside a
    # tile, causal with Tq != Tk, every head dim
    (4, 2, 63, 63, 16, False, False),
    (4, 2, 64, 64, 32, True, False),
    (4, 2, 65, 129, 64, False, True),
    (4, 2, 129, 65, 32, True, True),
    (5, 2, 64, 129, 64, True, False),
    (5, 2, 129, 64, 16, False, False),
    (5, 4, 129, 129, 64, True, False),
    # heads the kernels are not built for, zero-padded to 16 and 64
    (4, 2, 250, 250, 8, False, False),
    (5, 2, 65, 129, 40, True, True),
])
def test_attention_backward_kernels_match_plain(cuda_device, B, H, Tq, Tk, D,
                                                causal, with_bias):
    """csrc/attention_bwd.cu (dq and dk/dv on the tensor cores in 64-row
    tiles, dbias) through the autograd Function == mha_backward_reference
    == autograd through mha_reference, with ragged Tq and Tk, k_len
    including 1 and 0 (rows without a key: zero gradients, no NaN) and
    every kernel launched once (dbias only when there is a bias)."""
    att, bias, k_len = _att_args(B, H, Tq, Tk, D)
    leaves = [t.to(cuda_device).requires_grad_() for t in att]
    if with_bias:
        leaves.append(bias.to(cuda_device).requires_grad_())
    t_bias = leaves[3] if with_bias else None
    k_len = k_len.to(cuda_device)
    gen = torch.Generator().manual_seed(Tq)
    do = torch.randn(leaves[0].shape, generator=gen).to(cuda_device)
    build.reset_launches()
    out = flash_attention(*leaves[:3], bias=t_bias, k_len=k_len,
                          causal=causal)
    got = torch.autograd.grad(out, leaves, do)
    for name in ("", "_dq", "_dkv"):
        assert build.LAUNCHES["flash_attention" + name] == 1
    assert build.LAUNCHES["flash_attention_dbias"] == int(with_bias)
    plain = mha_backward_reference(*[t.detach() for t in leaves[:3]], do,
                                   bias=None if t_bias is None
                                   else t_bias.detach(), k_len=k_len,
                                   causal=causal)
    auto = torch.autograd.grad(
        mha_reference(*leaves[:3], bias=t_bias, k_len=k_len, causal=causal),
        leaves, do)
    for name, g, w, a in zip(ATT_GRAD_NAMES, got, plain, auto):
        assert torch.isfinite(g).all(), name
        torch.testing.assert_close(g, w, atol=GRAD_ATOL, rtol=0, msg=name)
        torch.testing.assert_close(g, a, atol=GRAD_ATOL, rtol=0, msg=name)
    # keys past k_len get exactly zero dk, dv; so does the whole batch entry
    # whose k_len is 0, and its dq
    for g in got[1:3]:
        assert torch.count_nonzero(g[1, :, int(k_len[1]):]) == 0
        assert torch.count_nonzero(g[3]) == 0
    assert torch.count_nonzero(got[0][3]) == 0


# K2's dbias (csrc/attention_dbias.cu) at heads below, on and off the
# 16-byte grid, through several chunks of 32 columns (1100: 35, the last
# ragged), and at lengths on either side of its 64 x 64 tiles
DBIAS_DIMS = [8, 16, 40, 64, 96, 128, 160, 256, 1100]
DBIAS_SHAPES = [(4, 63, 63, False), (4, 64, 65, True), (5, 65, 129, True),
                (4, 129, 64, False)]


def _dbias_run(dev, B, H, Tq, Tk, D, causal):
    """(the dbias kernel's result, its plain version, a relaunch) on
    _att_args' operands, delta formed by the dq kernel."""
    from aps_tpu_torch.ops.attention import (launch_backward_kernel,
                                             launch_forward)
    att, bias, k_len = _att_args(B, H, Tq, Tk, D)
    q, k, v = [t.to(dev) for t in att]
    bias, k_len = bias.to(dev), k_len.to(dev)
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(
        D + Tq)).to(dev)
    scale = D**-0.5
    out, lse = launch_forward(q, k, v, bias, k_len, scale, causal, True)
    delta = torch.empty_like(lse)
    run = lambda kernel: launch_backward_kernel(  # noqa: E731
        kernel, q, k, v, bias, k_len, do, lse, out, delta, scale, causal)
    run("dq")
    build.reset_launches()
    got = run("dbias")
    assert build.LAUNCHES["flash_attention_dbias"] == 1
    want = mha_backward_reference(q, k, v, do, bias=bias, k_len=k_len,
                                  causal=causal)[3]
    return got, want, run("dbias")


@pytest.mark.cuda
@pytest.mark.parametrize("D", DBIAS_DIMS)
@pytest.mark.parametrize("B,Tq,Tk,causal", DBIAS_SHAPES)
def test_attention_dbias_kernel_matches_plain(cuda_device, D, B, Tq, Tk,
                                              causal):
    """The dbias kernel alone == mha_backward_reference's dbias, with
    k_len 1 and 0 in the batch (from B = 4 on), Tq != Tk, causal; two
    launches give the same bits."""
    got, want, again = _dbias_run(cuda_device, B, 2, Tq, Tk, D, causal)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, atol=GRAD_ATOL, rtol=0)
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,T,D,causal", [
    (1, 4, 129, 64, True),     # one batch entry
    (144, 2, 16, 8, False),    # SepFormer's heads of 8: the batch split
    (144, 2, 16, 8, True),
    (16, 1, 65, 256, False),   # split, a tile of four blocks' columns
])
def test_attention_dbias_kernel_batch_split(cuda_device, B, H, T, D, causal):
    """At B = 1 one block a tile; where the tiles are too few for the card
    the batch is cut into groups whose partial tiles a second pass adds in
    order: still == the plain version, and bit-equal over two launches."""
    from aps_tpu_torch.ops.attention import _sm_count, dbias_groups
    groups = dbias_groups(B, H, T, T, _sm_count(cuda_device))
    assert (groups > 1) == (B > 1)
    got, want, again = _dbias_run(cuda_device, B, H, T, T, D, causal)
    torch.testing.assert_close(got, want, atol=GRAD_ATOL, rtol=0)
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 256])
def test_attention_dbias_is_deterministic(cuda_device, D):
    """dbias sums over the batch in order inside one block: two runs give
    the same bits, at a narrow and a wide head."""
    att, bias, k_len = _att_args(8, 4, 233, 233, D)
    leaves = [t.to(cuda_device).requires_grad_() for t in att + [bias]]
    do = torch.ones_like(leaves[0])
    runs = []
    for _ in range(2):
        out = flash_attention(*leaves[:3], bias=leaves[3],
                              k_len=k_len.to(cuda_device))
        runs.append(torch.autograd.grad(out, leaves, do))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
def test_attention_backward_is_deterministic(cuda_device, causal):
    """dq and dk/dv each own their sums (a block per 64 rows, no atomics):
    two runs give the same bits, at a length that is ragged against the
    tiles."""
    att, _, k_len = _att_args(8, 4, 233, 233, 64)
    leaves = [t.to(cuda_device).requires_grad_() for t in att]
    do = torch.randn(leaves[0].shape,
                     generator=torch.Generator().manual_seed(3)).to(
                         cuda_device)
    runs = []
    for _ in range(2):
        out = flash_attention(*leaves, k_len=k_len.to(cuda_device),
                              causal=causal)
        runs.append(torch.autograd.grad(out, leaves, do))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("Tq,Tk,D", [(130, 77, 64), (64, 64, 32),
                                     (65, 200, 16)])
def test_attention_dq_kernel_forms_delta(cuda_device, Tq, Tk, D):
    """The dq kernel's prologue forms delta = sum(do * out, -1) for the
    dk/dv and dbias kernels, which take it as it is."""
    from aps_tpu_torch.ops.attention import (launch_backward_kernel,
                                             launch_forward)
    att, _, k_len = _att_args(4, 2, Tq, Tk, D)
    q, k, v = [t.to(cuda_device) for t in att]
    k_len = k_len.to(cuda_device)
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(4)).to(
        cuda_device)
    out, lse = launch_forward(q, k, v, None, k_len, D**-0.5, False, True)
    build.reset_launches()
    delta = torch.full_like(lse, float("nan"))
    run = lambda kernel: launch_backward_kernel(  # noqa: E731
        kernel, q, k, v, None, k_len, do, lse, out, delta, D**-0.5, False)
    dq = run("dq")
    assert build.LAUNCHES["flash_attention_dq"] == 1
    torch.testing.assert_close(delta, (do * out).sum(-1), atol=1e-5,
                               rtol=1e-5)
    want = mha_backward_reference(q, k, v, do, k_len=k_len)
    torch.testing.assert_close(dq, want[0], atol=GRAD_ATOL, rtol=0)
    dk, dv = run("dkv")
    torch.testing.assert_close(dk, want[1], atol=GRAD_ATOL, rtol=0)
    torch.testing.assert_close(dv, want[2], atol=GRAD_ATOL, rtol=0)


@pytest.mark.cuda
def test_attention_gradcheck_style(cuda_device):
    """Directional derivative by central differences (float64 plain
    version) against the kernels' gradients at a small ragged shape with a
    bias and Tq != Tk."""
    att, bias, k_len = _att_args(4, 2, 19, 27, 16)
    k_len = k_len.to(cuda_device)
    leaves = [t.to(cuda_device).requires_grad_() for t in att + [bias]]
    gen = torch.Generator().manual_seed(5)
    do = torch.randn(leaves[0].shape, generator=gen).to(cuda_device)
    grads = torch.autograd.grad(
        flash_attention(*leaves[:3], bias=leaves[3], k_len=k_len), leaves,
        do)
    dirs = [torch.randn(t.shape, generator=gen).to(cuda_device)
            for t in leaves]
    want = sum((g * d).sum().item() for g, d in zip(grads, dirs))
    eps = 1e-3

    def f64(sign):
        q, k, v, b = [(t.detach() + sign * eps * d).double()
                      for t, d in zip(leaves, dirs)]
        return (mha_reference(q, k, v, bias=b, k_len=k_len)
                * do.double()).sum().item()

    numeric = (f64(1) - f64(-1)) / (2 * eps)
    assert abs(numeric - want) <= 1e-3 * max(1.0, abs(numeric))


# K2 at heads that are not 16, 32, 64 or 128, launched unpadded in the
# tiles of the next of them: 8 (the tests' SepFormer) and 12 below the
# smallest, 40 (a multiple of 4: 16-byte copies), 50 (off the 16-byte grid:
# 4-byte copies), 96 and 70 (the tiles of 96, 70 off the grid) and 100
# (the tiles of 128)
NARROW_DIMS = [8, 12, 40, 50, 96, 70, 100]


@pytest.mark.cuda
@pytest.mark.parametrize("D", NARROW_DIMS)
def test_attention_kernels_at_narrow_heads(cuda_device, D):
    """K2's forward, dq, dk/dv and dbias at a head the kernels are not built
    for, at lengths across the 64-row tiles, causal, with a bias and k_len
    with a ragged, a one-key and a no-key entry: each == the plain version,
    one launch each, two runs bit-equal; and one forward call at such a
    head runs exactly one CUDA kernel, the forward's (no pad or copy)."""
    from torch.profiler import ProfilerActivity, profile
    Tq, Tk = 70, 130
    att, bias, k_len = _att_args(4, 2, Tq, Tk, D)
    leaves = [t.to(cuda_device).requires_grad_() for t in att]
    leaves.append(bias.to(cuda_device).requires_grad_())
    k_len = k_len.to(cuda_device)
    do = torch.randn(leaves[0].shape, generator=torch.Generator()
                     .manual_seed(D)).to(cuda_device)
    runs = []
    for _ in range(2):
        build.reset_launches()
        out = flash_attention(*leaves[:3], bias=leaves[3], k_len=k_len,
                              causal=True)
        runs.append((out.detach(), *torch.autograd.grad(out, leaves, do)))
        for name in ("", "_dq", "_dkv", "_dbias"):
            assert build.LAUNCHES["flash_attention" + name] == 1, name
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    plain = [t.detach() for t in leaves]
    want = mha_reference(*plain[:3], bias=plain[3], k_len=k_len, causal=True)
    torch.testing.assert_close(runs[0][0], want, atol=ATT_ATOL, rtol=0)
    grads = mha_backward_reference(*plain[:3], do, bias=plain[3],
                                   k_len=k_len, causal=True)
    for name, g, w in zip(ATT_GRAD_NAMES, runs[0][1:], grads):
        assert g.shape == w.shape and torch.isfinite(g).all(), name
        torch.testing.assert_close(g, w, atol=GRAD_ATOL, rtol=0, msg=name)
    assert torch.count_nonzero(runs[0][0][3]) == 0
    if D == 8:
        with torch.no_grad(), profile(activities=[
                ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            flash_attention(*plain[:3], k_len=k_len)
            torch.cuda.synchronize()
        kernels = [e.name for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        assert len(kernels) == 1 and "attn_fwd_kernel" in kernels[0], \
            kernels


WIDE_LENGTHS = [(63, 63), (64, 64), (65, 129), (129, 65), (300, 300)]


# 96 (K2 unpadded in its ragged tiles of 96, K3 zero-padded to 128), 128
# on the tensor cores; the wide kernels (csrc/wide_attention.cu) at 160,
# 256 and 1100 (K2 and K3 in five passes of 256 columns) and at the edges
# of their splits of the head between warps: 130 (off the 16-byte grid:
# 4-byte copies), 192, 257 (one column into a second pass) and 384
WIDE_DIMS = [96, 128, 160, 256, 1100, 130, 192, 257, 384]


@pytest.mark.cuda
@pytest.mark.parametrize("D", WIDE_DIMS)
@pytest.mark.parametrize("Tq,Tk", WIDE_LENGTHS)
def test_attention_kernels_at_wide_heads(cuda_device, D, Tq, Tk):
    """K2's forward, dq, dk/dv and dbias at heads of 96 (unpadded, in its
    ragged tiles of 96), 128 and the wide kernels' 160, 256 and 1100, at
    lengths around the 64-row tiles and over several blocks (T = 300),
    causal where Tq <=
    Tk, a bias, k_len including 1 and 0: each == the plain version, and two
    runs give the same bits."""
    att, bias, k_len = _att_args(4, 2, Tq, Tk, D)
    causal = Tq <= Tk
    leaves = [t.to(cuda_device).requires_grad_() for t in att]
    leaves.append(bias.to(cuda_device).requires_grad_())
    k_len = k_len.to(cuda_device)
    do = torch.randn(leaves[0].shape, generator=torch.Generator()
                     .manual_seed(D + Tq)).to(cuda_device)
    runs = []
    for _ in range(2):
        build.reset_launches()
        out = flash_attention(*leaves[:3], bias=leaves[3], k_len=k_len,
                              causal=causal)
        runs.append((out.detach(), *torch.autograd.grad(out, leaves, do)))
        for name in ("", "_dq", "_dkv", "_dbias"):
            assert build.LAUNCHES["flash_attention" + name] == 1, name
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    plain = [t.detach() for t in leaves]
    want = mha_reference(*plain[:3], bias=plain[3], k_len=k_len,
                         causal=causal)
    torch.testing.assert_close(runs[0][0], want, atol=ATT_ATOL, rtol=0)
    grads = mha_backward_reference(*plain[:3], do, bias=plain[3],
                                   k_len=k_len, causal=causal)
    for name, g, w in zip(ATT_GRAD_NAMES, runs[0][1:], grads):
        assert torch.isfinite(g).all(), name
        torch.testing.assert_close(g, w, atol=GRAD_ATOL, rtol=0, msg=name)
    assert torch.count_nonzero(runs[0][0][3]) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("D", WIDE_DIMS)
@pytest.mark.parametrize("T,Hp,causal", [(63, 2, False), (64, 1, True),
                                         (65, 2, True), (129, 1, False),
                                         (300, 2, True)])
def test_rel_attention_kernels_at_wide_heads(cuda_device, D, T, Hp, causal):
    """K3's forward (and its lse), dq, dk/dv and dpose at heads of 96
    (zero-padded to 128, table too), 128 and the wide kernels' 160, 256
    and 1100, at lengths around the tiles (64 query rows, 16 keys a
    forward and a dq tile at 128) and over several blocks: each == the
    plain version, and two runs give the same bits."""
    rel, k_len = _rel_args(4, 2, T, D, Hp)
    leaves = [t.to(cuda_device).requires_grad_() for t in rel]
    k_len = k_len.to(cuda_device)
    do = torch.randn(leaves[0].shape, generator=torch.Generator()
                     .manual_seed(D + T)).to(cuda_device)
    runs = []
    for _ in range(2):
        build.reset_launches()
        out = flash_attention_rel(*leaves, k_len=k_len, causal=causal)
        runs.append((out.detach(), *torch.autograd.grad(out, leaves, do)))
        for name in ("", "_dq", "_dkv", "_dpose"):
            assert build.LAUNCHES["flash_attention_rel" + name] == 1, name
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    plain = [t.detach() for t in leaves]
    want = rel_mha_reference(*plain, k_len=k_len, causal=causal)
    torch.testing.assert_close(runs[0][0], want, atol=ATT_ATOL, rtol=0)
    if D >= 128:
        _, lse = launch_forward(*plain, k_len, causal, True)
        torch.testing.assert_close(
            lse, rel_lse_reference(*plain[:3], plain[4], k_len=k_len,
                                   causal=causal), atol=ATT_ATOL, rtol=0)
    grads = rel_mha_backward_reference(*plain, do, k_len=k_len,
                                       causal=causal)
    for name, g, w in zip(GRAD_NAMES, runs[0][1:], grads):
        assert torch.isfinite(g).all(), name
        atol = GRAD_ATOL if name != "dpose" else \
            GRAD_ATOL + DPOSE_RTOL * w.abs().max().item()
        torch.testing.assert_close(g, w, atol=atol, rtol=0, msg=name)
    assert torch.count_nonzero(runs[0][0][3]) == 0


@pytest.mark.cuda
def test_wide_head_kernels_one_key_corner(cuda_device):
    """Heads of 128 where entries see one key under a long causal mask:
    K2's and K3's outputs and gradients against the plain versions, the
    errors printed."""
    T = 640
    k_len = torch.tensor([1, 1, T, 2], dtype=torch.int32, device=cuda_device)
    att, _, _ = _att_args(4, 2, T, T, 128)
    rel, _ = _rel_args(4, 2, T, 128, 2)
    for name, fn, ref, bwd, args in (
            ("K2", flash_attention, mha_reference, mha_backward_reference,
             att),
            ("K3", flash_attention_rel, rel_mha_reference,
             rel_mha_backward_reference, rel)):
        leaves = [t.to(cuda_device).requires_grad_() for t in args]
        out = fn(*leaves, k_len=k_len, causal=True)
        do = torch.ones_like(out)
        got = torch.autograd.grad(out, leaves, do)
        plain = [t.detach() for t in leaves]
        want = ref(*plain, k_len=k_len, causal=True)
        grads = bwd(*plain, do, k_len=k_len, causal=True)
        errs = [(out - want).abs().max().item()] + [
            (g - w).abs().max().item() for g, w in zip(got, grads)]
        print(f"{name} one-key corner at D = 128: max abs err out and each "
              f"gradient {['%.3e' % e for e in errs]}")
        torch.testing.assert_close(out, want, atol=ATT_ATOL, rtol=0)
        for g, w in zip(got, grads):
            torch.testing.assert_close(
                g, w, atol=GRAD_ATOL + DPOSE_RTOL * w.abs().max().item(),
                rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [160, 257])
def test_wide_attention_one_key_corner(cuda_device, D):
    """K2 on the wide tiles where entries see one key (and one sees all)
    under a long causal mask, over passes at 257: the output, its lse
    (kLseDead on no row: every row sees a key) and the gradients against
    the plain versions, the errors printed, and two runs bit-equal."""
    from aps_tpu_torch.ops.attention import launch_forward as k2_forward
    T = 640
    k_len = torch.tensor([1, 1, T, 2], dtype=torch.int32, device=cuda_device)
    att, _, _ = _att_args(4, 2, T, T, D)
    leaves = [t.to(cuda_device).requires_grad_() for t in att]
    do = torch.randn(leaves[0].shape, generator=torch.Generator()
                     .manual_seed(D)).to(cuda_device)
    runs = []
    for _ in range(2):
        out = flash_attention(*leaves, k_len=k_len, causal=True)
        runs.append((out.detach(), *torch.autograd.grad(out, leaves, do)))
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    plain = [t.detach() for t in leaves]
    want = mha_reference(*plain, k_len=k_len, causal=True)
    grads = mha_backward_reference(*plain, do, k_len=k_len, causal=True)
    errs = [(runs[0][0] - want).abs().max().item()] + [
        (g - w).abs().max().item() for g, w in zip(runs[0][1:], grads)]
    print(f"K2 one-key corner at D = {D}: max abs err out and each gradient "
          f"{['%.3e' % e for e in errs]}")
    torch.testing.assert_close(runs[0][0], want, atol=ATT_ATOL, rtol=0)
    for name, g, w in zip(ATT_GRAD_NAMES, runs[0][1:], grads):
        torch.testing.assert_close(g, w, atol=GRAD_ATOL, rtol=0, msg=name)
    _, lse = k2_forward(*plain, None, k_len, D**-0.5, True, True)
    scores = torch.einsum("bhqd,bhkd->bhqk", plain[0], plain[1]) * D**-0.5
    cols = torch.arange(T, device=cuda_device)
    mask = (cols[None, None, None, :] < k_len[:, None, None, None]) & \
        (cols[None, None, None, :] <= cols[None, None, :, None])
    want_lse = torch.logsumexp(scores.masked_fill(~mask, -torch.inf), -1)
    torch.testing.assert_close(lse, want_lse, atol=ATT_ATOL, rtol=0)


@pytest.mark.cuda
def test_aps_mha_on_cuda_takes_the_kernels_where_eligible(cuda_device):
    """ApsMultiheadAttention on the card: self-attention launches the flash
    kernels (forward, and dq and dk/dv in training with dropout 0; never
    dbias); cross-attention below 512 query frames, an attn_mask and active
    dropout take the dense path and launch nothing."""
    E, H, T = 64, 4, 50
    tmod = impl.ApsMultiheadAttention(E, H, dropout=0.0).train().to(
        cuda_device)
    x = torch.randn(2, T, E, device=cuda_device, requires_grad=True)
    mem = torch.randn(2, 70, E, device=cuda_device)
    pad = torch.arange(T, device=cuda_device)[None, :] >= torch.tensor(
        [T, 31], device=cuda_device)[:, None]
    build.reset_launches()
    out, weight = tmod(x, x, x, key_padding_mask=pad)
    out.sum().backward()
    assert weight is None
    want = {name: 0 for name in build.LAUNCHES}
    want.update(flash_attention=1, flash_attention_dq=1,
                flash_attention_dkv=1)
    assert dict(build.LAUNCHES) == want
    with torch.no_grad():
        dense, weight = tmod(x, x, x, key_padding_mask=pad,
                             attn_mask=torch.zeros(T, T, device=cuda_device))
    torch.testing.assert_close(dense, out, atol=ATT_ATOL, rtol=0)
    build.reset_launches()
    with torch.no_grad():
        _, weight = tmod(x, mem, mem)
        assert weight.shape == (2, T, 70)
        _, weight = impl.ApsMultiheadAttention(E, H, dropout=0.1).train().to(
            cuda_device)(x, x, x)
        assert weight.shape == (2, T, T)
    assert not any(build.LAUNCHES.values())
    long_q = torch.randn(2, 512, E, device=cuda_device)
    with torch.no_grad():
        _, weight = tmod(long_q, mem, mem)
    assert weight is None and build.LAUNCHES["flash_attention"] == 1


@pytest.mark.cuda
def test_xl_mha_on_cuda_takes_the_rel_kernels(cuda_device):
    """XlMultiheadAttention on the card runs flash_attention_rel with one
    table per head and agrees with its dense path."""
    E, H, T = 64, 4, 60
    tmod = impl.XlMultiheadAttention(E, H).eval().to(cuda_device)
    x = torch.randn(2, T, E, device=cuda_device)
    pose = torch.randn(2 * T - 1, E, device=cuda_device)
    build.reset_launches()
    with torch.no_grad():
        flash, weight = tmod(x, x, x, inj_pose=pose)
        dense, _ = tmod(x, x, x, inj_pose=pose,
                        attn_mask=torch.zeros(T, T, device=cuda_device))
    assert weight is None and build.LAUNCHES["flash_attention_rel"] == 1
    torch.testing.assert_close(flash, dense, atol=ATT_ATOL, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("N,T,B,H,dilation,causal", [
    (4, 3905, 256, 512, 1, False),
    (4, 3905, 256, 512, 16, True),
    (4, 3905, 256, 512, 32, False),
    (4, 3905, 256, 512, 128, False),
    (4, 3905, 256, 512, 128, True),
    (3, 50, 256, 512, 128, False),
    (3, 50, 256, 512, 64, True),
    (2, 333, 64, 128, 5, False),
    (2, 333, 64, 100, 20, True),
    (2, 97, 512, 256, 2, False),
    (1, 1, 256, 512, 1, False),
])
def test_tcn_block_kernel_matches_plain(cuda_device, N, T, B, H, dilation,
                                        causal):
    """csrc/tcn.cu == the plain version in float32: the full width at the
    frame count of a 4 s batch (ragged against the 32-row tile), both ways
    of staging the taps' rows (one contiguous run up to dilation 32, three
    runs above), T shorter than the dilation's reach, other widths (an H
    that is no multiple of the 64-channel pass, two output columns per
    thread at B = 512)."""
    args = [t.to(cuda_device) for t in _tcn_args(N, T, B, H)]
    build.reset_launches()
    got = tcn_block_fused(*args, dilation, causal=causal)
    assert build.LAUNCHES["tcn_block_fused"] == 1
    want = tcn_block_reference(*args, dilation, causal=causal)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    torch.testing.assert_close(got, want, atol=TCN_ATOL, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dilation,causal", [(1, False), (8, True),
                                             (64, False)])
def test_tcn_block_kernel_matches_plain_in_bfloat16(cuda_device, dilation,
                                                    causal):
    """The bfloat16 instance (activations and kernels bfloat16, pack and
    bias float32, float32 accumulation, y2 rounded before the second
    product) against the plain version, which rounds at the same places."""
    args = [t.to(cuda_device)
            for t in _tcn_args(4, 1000, 256, 512, torch.bfloat16)]
    got = tcn_block_fused(*args, dilation, causal=causal)
    want = tcn_block_reference(*args, dilation, causal=causal)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(),
                               atol=TCN_BF16_ATOL, rtol=TCN_BF16_RTOL)
    # and it is the same function as the float32 instance on these values
    wide = tcn_block_fused(*[a.float() for a in args], dilation,
                           causal=causal)
    torch.testing.assert_close(got.float(), wide, atol=TCN_BF16_ATOL,
                               rtol=TCN_BF16_RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
def test_tcn_block_kernel_at_every_dilation(cuda_device, dtype, causal):
    """Every dilation of a Conv-TasNet repeat (1 to 128: the contiguous
    64-row blocks below 16, the chains of four 16-row tiles from 16 on) at
    a T that is no multiple of the tiles, and T shorter than twice the
    largest dilations, in either type; two launches give the same bits."""
    dt = getattr(torch, dtype)
    for T in (411, 150):
        args = [t.to(cuda_device) for t in _tcn_args(2, T, 256, 512, dt)]
        for n in range(8):
            d = 2**n
            got = tcn_block_fused(*args, d, causal=causal)
            assert torch.equal(got, tcn_block_fused(*args, d, causal=causal))
            want = tcn_block_reference(*args, d, causal=causal)
            assert got.dtype == dt and torch.isfinite(got.float()).all()
            if dt == torch.float32:
                torch.testing.assert_close(got, want, atol=TCN_ATOL, rtol=0,
                                           msg=f"T={T} d={d}")
            else:
                torch.testing.assert_close(got.float(), want.float(),
                                           atol=TCN_BF16_ATOL,
                                           rtol=TCN_BF16_RTOL,
                                           msg=f"T={T} d={d}")


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,T,dilation,causal", [
    (12, 20, 77, 3, False),
    (12, 20, 77, 40, True),
    (20, 12, 5, 1, True),
    (300, 68, 70, 17, False),
    (512, 36, 130, 24, True),
])
def test_tcn_block_kernel_at_small_and_ragged_widths(cuda_device, B, H, T,
                                                     dilation, causal):
    """Widths the wrapper takes that are no multiple of the kernel's
    slices (B and H multiples of 4, down to 12), two column groups (B >
    256), dilations that are no multiple of 16, in either type."""
    for dt in (torch.float32, torch.bfloat16):
        args = [t.to(cuda_device) for t in _tcn_args(3, T, B, H, dt)]
        got = tcn_block_fused(*args, dilation, causal=causal)
        want = tcn_block_reference(*args, dilation, causal=causal)
        if dt == torch.float32:
            torch.testing.assert_close(got, want, atol=TCN_ATOL, rtol=0)
        else:
            torch.testing.assert_close(got.float(), want.float(),
                                       atol=TCN_BF16_ATOL, rtol=TCN_BF16_RTOL)


@pytest.mark.cuda
def test_tcn_block_kernel_rejects_bad_input(cuda_device):
    x, k1, pack, k2, b2 = [t.to(cuda_device)
                           for t in _tcn_args(2, 40, 64, 128)]
    with pytest.raises(ValueError, match="contiguous"):
        tcn_block_fused(x.transpose(0, 1).contiguous().transpose(0, 1), k1,
                        pack, k2, b2, 1)
    with pytest.raises(TypeError, match="dtype"):
        tcn_block_fused(x, k1.bfloat16(), pack, k2, b2, 1)
    with pytest.raises(TypeError, match="dtype"):
        tcn_block_fused(x.half(), k1.half(), pack, k2.half(), b2, 1)
    with pytest.raises(ValueError, match="kernel2"):
        tcn_block_fused(x, k1, pack, k2.t().contiguous(), b2, 1)
    with pytest.raises(ValueError, match="dilation"):
        tcn_block_fused(x, k1, pack, k2, b2, 0)
    with pytest.raises(ValueError, match="not CUDA"):
        tcn_block_fused(x, k1, pack.cpu(), k2, b2, 1)
    with pytest.raises(ValueError, match="multiples of 4"):
        tcn_block_fused(x[..., :62].contiguous(), k1[:62].contiguous(), pack,
                        k2[:, :62].contiguous(), b2[:, :62].contiguous(), 1)
