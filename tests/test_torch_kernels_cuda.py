#!/usr/bin/env python
"""PyTorch port: each hand-written CUDA kernel against its plain PyTorch
version, and the dispatch rule of the wrappers (CPU tensors take the plain
version and launch nothing; a CUDA tensor launches the kernel once).

This file imports no jax, so it also runs on a machine that has the card
but not the JAX stack:

    python -m pytest tests/test_torch_kernels_cuda.py --noconftest -q

Tests that need the card carry the `cuda` marker and skip without one."""

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
                                     fused_logmel_plain)
from aps_tpu_torch.ops.rel_attention import (  # noqa: E402
    flash_attention_rel, rel_mha_backward_reference, rel_mha_reference)
from aps_tpu_torch.ops.tcn import (PACK_ROWS, tcn_block_fused,  # noqa: E402
                                   tcn_block_reference)
from aps_tpu_torch.transform.utils import make_window, mel_filter  # noqa

# kernel vs plain version, both float32 on the card: log-mel features after
# 512-term DFT sums in another order; O(1) attention outputs; CTC values
# up to ~1e3 after 233 steps of the same recursion
LOGMEL_ATOL = 1e-3
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


def _ctc_args(T, L, G):
    rng = np.random.default_rng(L)
    f32 = np.float32
    p_c = (-1 - 3 * rng.random((T, L))).astype(f32)
    gnx = np.cumsum(-2 * rng.random((T, L)), 0).astype(f32)
    gbx = np.cumsum(-2 * rng.random((T, L)), 0).astype(f32)
    gnx[:, ::5] = MIN_F32
    gbx[:2] = MIN_F32
    pb = (-0.05 - 0.5 * rng.random((T, G))).astype(f32)
    rok = (rng.random((1, L)) > 0.25).astype(f32)
    eosm = (rng.random((1, L)) > 0.8).astype(f32)
    old = (-20 * rng.random((1, L))).astype(f32)
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
    torch.testing.assert_close(fused_logmel(*args, log_eps=EPSILON),
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


@pytest.mark.cuda
@pytest.mark.parametrize("with_mel", [True, False])
def test_fused_logmel_kernel_matches_plain(cuda_device, with_mel):
    """csrc/fbank.cu == the plain version on 8 s utterances padded to
    their duration bucket, as decode_batch gives them."""
    wav, *rest = _fbank_args(4, 149003, with_mel)
    wav = wav.to(cuda_device)
    build.reset_launches()
    got = fused_logmel(wav, *rest, log_eps=EPSILON)
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


@pytest.mark.cuda
@pytest.mark.parametrize("T,Hp,causal", [(233, 1, False), (233, 4, True),
                                         (700, 4, True)])
def test_rel_attention_kernel_matches_plain(cuda_device, T, Hp, causal):
    """csrc/rel_attention.cu == the plain version: ragged T, several key
    tiles, suffix k_len including 1 and 0 (a fully masked row gives 0)."""
    rel, k_len = _rel_args(8, 4, T, 64, Hp)
    rel = [t.to(cuda_device) for t in rel]
    k_len = k_len.to(cuda_device)
    build.reset_launches()
    got = flash_attention_rel(*rel, k_len=k_len, causal=causal)
    assert build.LAUNCHES["flash_attention_rel"] == 1
    want = rel_mha_reference(*rel, k_len=k_len, causal=causal)
    torch.testing.assert_close(got, want, atol=ATT_ATOL, rtol=0)
    assert torch.count_nonzero(got[3]) == 0


@pytest.mark.cuda
def test_rel_attention_kernel_rejects_bad_input(cuda_device):
    rel, _ = _rel_args(4, 2, 40, 16, 1)
    rel = [t.to(cuda_device) for t in rel]
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_rel(rel[0].transpose(2, 3).contiguous().transpose(
            2, 3), *rel[1:])
    with pytest.raises(ValueError, match="head dim"):
        wide = [torch.zeros((1, 1, 8, 48), device=cuda_device)] * 4
        flash_attention_rel(*wide, torch.zeros((1, 15, 48),
                                               device=cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("L,G", [(768, 8), (6144, 64)])
def test_ctc_score_step_kernel_matches_plain(cuda_device, L, G):
    """csrc/ctc_score.cu == the plain version at the encoder length of an
    8 s utterance, T = 233, both is_first."""
    ops = [t.to(cuda_device) for t in _ctc_args(233, L, G)]
    for is_first in (True, False):
        build.reset_launches()
        got = ctc_score_step(*ops, is_first)
        assert build.LAUNCHES["ctc_score_step"] == 1
        _assert_ctc_close(got, ctc_score_step_plain(*ops, is_first))


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
def test_rel_attention_backward_is_deterministic(cuda_device):
    """dpose sums per-(b, h) partial tables in a fixed order: two runs give
    the same bits."""
    rel, k_len = _rel_args(8, 4, 233, 64, 1)
    rel = [t.to(cuda_device).requires_grad_() for t in rel]
    do = torch.ones_like(rel[0])
    runs = []
    for _ in range(2):
        out = flash_attention_rel(*rel, k_len=k_len.to(cuda_device))
        runs.append(torch.autograd.grad(out, rel, do))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


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
    with pytest.raises(ValueError, match="head dim"):
        wide = [torch.zeros((1, 1, 8, 48), device=cuda_device)] * 3
        flash_attention(*wide)
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


@pytest.mark.cuda
def test_attention_dbias_is_deterministic(cuda_device):
    """dbias sums over the batch in order inside one block: two runs give
    the same bits."""
    att, bias, k_len = _att_args(8, 4, 233, 233, 64)
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
