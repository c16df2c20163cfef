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
from aps_tpu_torch.ops.ctc_score import (ctc_score_step,  # noqa: E402
                                         ctc_score_step_plain)
from aps_tpu_torch.ops.fbank import (fused_logmel,  # noqa: E402
                                     fused_logmel_plain)
from aps_tpu_torch.ops.rel_attention import (  # noqa: E402
    flash_attention_rel, rel_mha_backward_reference, rel_mha_reference)
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
    ctc = _ctc_args(20, 24, 2)
    for g, w in zip(ctc_score_step(*ctc, True),
                    ctc_score_step_plain(*ctc, True)):
        torch.testing.assert_close(g, w, atol=0, rtol=0)
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
    """RelMultiheadAttention on the card always launches the kernel; what
    needs the dense path raises instead of leaving the kernel."""
    E, H, T = 64, 4, 50
    tmod = impl.RelMultiheadAttention(E, H, dropout=0.1).eval().to(
        cuda_device)
    x = torch.randn(2, T, E, device=cuda_device)
    pose = torch.randn(2 * T - 1, E // H, device=cuda_device)
    build.reset_launches()
    with torch.no_grad():
        tmod(x, x, x, inj_pose=pose)
    assert build.LAUNCHES["flash_attention_rel"] == 1
    with torch.no_grad(), pytest.raises(NotImplementedError):
        tmod(x, x, x, inj_pose=pose,
             attn_mask=torch.zeros(T, T, device=cuda_device))
    with torch.no_grad(), pytest.raises(NotImplementedError):
        tmod.train()(x, x, x, inj_pose=pose)


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
    autograd Function (all four kernels launch); with dropout > 0 a CUDA
    call raises."""
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
    with pytest.raises(NotImplementedError):
        impl.RelMultiheadAttention(E, H, dropout=0.1).train().to(
            cuda_device)(x, x, x, inj_pose=pose)
