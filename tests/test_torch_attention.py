#!/usr/bin/env python
"""PyTorch port, scaled-dot-product flash attention: flash_attention (K2
forward and gradients, plain versions on the CPU) against aps_tpu's dense
reference and its Pallas kernel in interpret mode, then
ApsMultiheadAttention and XlMultiheadAttention on their flash and dense
paths against flax with converted weights."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from aps_tpu.asr.transformer import impl as jax_impl  # noqa: E402
from aps_tpu.ops.pallas import attention as jax_att  # noqa: E402
from aps_tpu_torch.asr.transformer import impl  # noqa: E402
from aps_tpu_torch.convert import to_state_dict  # noqa: E402
from aps_tpu_torch.ops import build  # noqa: E402
from aps_tpu_torch.ops.attention import (flash_attention,  # noqa: E402
                                         mha_backward_reference,
                                         mha_reference)

# attention outputs are O(1): float32 dot products and softmax sums in
# another order (aps_tpu holds its own kernel to its reference at 2e-5)
ATT_ATOL = 5e-5
# gradients of sum(o * do): dq/dk/dv entries are O(1) sums of T float32
# products; a dbias entry sums B of them (aps_tpu's own gradient test takes
# 5e-4)
GRAD_ATOL = 1e-4
# a projected module output, and a gradient through the projections
MOD_ATOL = 5e-5
MOD_GRAD_ATOL = 5e-4


def _inputs(seed, B, H, Tq, Tk, D, with_bias, dead):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    q = rng.standard_normal((B, H, Tq, D)).astype(f32)
    k, v = (rng.standard_normal((B, H, Tk, D)).astype(f32) for _ in range(2))
    bias = rng.standard_normal((H, Tq, Tk)).astype(f32) if with_bias else None
    k_len = np.array([Tk, Tk - 77 if Tk > 77 else Tk // 2 + 1]
                     + [Tk // 3] * (B - 2), dtype=np.int32)
    if dead:
        k_len[-1] = 0
    return q, k, v, bias, k_len


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


# the sizes of aps_tpu's own kernel tests (one or two of the TPU kernel's
# tiles, Tq != Tk, a bias), then shapes of several tiles that are ragged
# against them, with three batch entries (the bias is shared over the
# batch), a bias, causal with Tq != Tk, and a batch entry without any key
CASES = [
    (2, 256, 256, False, False, False),
    (2, 256, 256, True, False, False),
    (2, 200, 300, False, False, False),
    (2, 256, 256, False, True, False),
    (3, 300, 333, False, True, True),
    (3, 333, 300, True, True, False),
    (3, 300, 300, True, False, True),
]


@pytest.mark.parametrize("B,Tq,Tk,causal,with_bias,dead", CASES)
def test_attention_plain_matches_jax(B, Tq, Tk, causal, with_bias, dead):
    """mha_reference (what flash_attention runs on CPU tensors) == aps_tpu's
    mha_reference == the Pallas kernel in interpret mode."""
    H, D = 2, 32
    q, k, v, bias, k_len = _inputs(Tq + Tk, B, H, Tq, Tk, D, with_bias, dead)
    build.reset_launches()
    got = flash_attention(_t(q), _t(k), _t(v), bias=_t(bias),
                          k_len=_t(k_len), causal=causal)
    assert not any(build.LAUNCHES.values())
    kw = dict(bias=_j(bias), k_len=_j(k_len), causal=causal)
    ref = jax_att.mha_reference(_j(q), _j(k), _j(v), **kw)
    want = jax_att.flash_attention(_j(q), _j(k), _j(v), interpret=True, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATT_ATOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATT_ATOL)
    if dead:
        assert torch.count_nonzero(got[-1]) == 0
        assert torch.count_nonzero(got[0]) > 0


@pytest.mark.parametrize("D,causal,with_bias", [(8, True, False),
                                               (12, False, True),
                                               (40, True, True),
                                               (50, False, True),
                                               (96, True, False),
                                               (96, True, True),
                                               (128, False, True),
                                               (160, True, True),
                                               (256, False, False),
                                               (130, True, True),
                                               (192, False, True),
                                               (257, True, False),
                                               (384, False, True)])
def test_attention_wide_heads_match_jax(D, causal, with_bias):
    """Heads that are not 16, 32, 64 or 128, which the card launches
    unpadded in the tiles of the next width (8: the tests' SepFormer; 12;
    40; 50, whose rows leave the 16-byte grid; 96), 128, and 160, 256 and
    the edges of the split of a head between two warps, 130 (off the
    16-byte grid), 192, 257 (one column into a second pass of 256) and 384
    (the card's wide kernels): the plain version == aps_tpu's reference and
    its Pallas kernel in interpret mode, across 64-row tiles with ragged
    k_len and a batch entry without any key."""
    q, k, v, bias, k_len = _inputs(D, 3, 2, 70, 65, D, with_bias, True)
    got = flash_attention(_t(q), _t(k), _t(v), bias=_t(bias),
                          k_len=_t(k_len), causal=causal)
    kw = dict(bias=_j(bias), k_len=_j(k_len), causal=causal)
    ref = jax_att.mha_reference(_j(q), _j(k), _j(v), **kw)
    want = jax_att.flash_attention(_j(q), _j(k), _j(v), interpret=True, **kw)
    assert got.shape == (3, 2, 70, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATT_ATOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATT_ATOL)
    assert torch.count_nonzero(got[-1]) == 0


def test_attention_softmax_scale_and_defaults():
    """softmax_scale replaces D**-0.5; without k_len every key is visible."""
    q, k, v, _, _ = _inputs(1, 2, 2, 40, 50, 16, False, False)
    got = flash_attention(_t(q), _t(k), _t(v), softmax_scale=0.3)
    want = jax_att.mha_reference(_j(q), _j(k), _j(v), softmax_scale=0.3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATT_ATOL)
    got = flash_attention(_t(q), _t(k), _t(v), causal=True)
    want = jax_att.mha_reference(_j(q), _j(k), _j(v), causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATT_ATOL)


def test_attention_refuses_bad_shapes():
    q, k, v, bias, k_len = map(_t, _inputs(2, 2, 2, 20, 30, 16, True, False))
    with pytest.raises(ValueError, match="expected"):
        flash_attention(q, k, v[:, :, :-1])
    with pytest.raises(ValueError, match="bias"):
        flash_attention(q, k, v, bias=bias.transpose(1, 2))
    with pytest.raises(ValueError, match="k_len"):
        flash_attention(q, k, v, k_len=k_len[:1])
    with pytest.raises(ValueError, match="B x H x Tq x D"):
        flash_attention(q[0], k, v)


def _assert_grads_close(got, want, what):
    for name, g, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        if w is None:
            assert g is None, (what, name)
            continue
        g, w = np.asarray(g), np.asarray(w)
        assert np.isfinite(g).all(), (what, name)
        np.testing.assert_allclose(g, w, atol=GRAD_ATOL, rtol=0,
                                   err_msg=f"{what}: {name}")


# aps_tpu's own gradient sizes first (T = 128, D = 16), then several tiles,
# ragged, Tq != Tk, three batch entries and a batch entry without any key
GRAD_CASES = [
    (2, 128, 128, 16, False, False, False),
    (2, 128, 128, 16, True, False, False),
    (2, 128, 128, 16, False, True, False),
    (3, 300, 333, 32, False, True, True),
    (3, 333, 300, 32, True, True, False),
    (3, 300, 300, 32, True, False, True),
    # on either side of the 64-row tiles of the CUDA dq and dk/dv kernels,
    # with k_len inside a tile
    (3, 63, 63, 16, False, False, True),
    (3, 64, 65, 32, True, False, False),
    (3, 65, 129, 16, False, True, True),
    (3, 129, 64, 32, True, True, False),
    # heads of 96 (zero-padded to 128 on the card) and 128, and of 160 and
    # 256 (the card's wide kernels)
    (2, 65, 70, 96, True, False, True),
    (2, 70, 65, 128, False, True, False),
    (2, 63, 65, 160, True, True, True),
    (2, 65, 64, 256, False, False, False),
    # the card's dbias kernel (one for every width) at the edges of its
    # 64 x 64 tiles and its chunks of 32 head columns: a ragged last chunk
    # (40), five chunks (160), causal with Tq != Tk, a bias; the same
    # GRAD_ATOL (a dbias entry sums three batch entries here)
    (3, 65, 129, 40, True, True, True),
    (3, 65, 129, 160, True, True, False),
]


@pytest.mark.parametrize("B,Tq,Tk,D,causal,with_bias,dead", GRAD_CASES)
def test_attention_gradients_match_jax(B, Tq, Tk, D, causal, with_bias,
                                       dead):
    """mha_backward_reference and autograd through the plain forward ==
    jax.grad of the Pallas kernel (interpret mode) and of the dense JAX
    reference, for dq, dk, dv and dbias (which has no trailing scale)."""
    H = 2
    q, k, v, bias, k_len = _inputs(Tq + D, B, H, Tq, Tk, D, with_bias, dead)
    do = np.random.default_rng(Tk).standard_normal((B, H, Tq, D)).astype(
        np.float32)
    leaves = [torch.from_numpy(a).requires_grad_()
              for a in (q, k, v) + ((bias,) if with_bias else ())]
    t_bias = leaves[3] if with_bias else None
    out = flash_attention(*leaves[:3], bias=t_bias, k_len=_t(k_len),
                          causal=causal)
    auto = [g.numpy() for g in torch.autograd.grad(out, leaves, _t(do))]
    plain = mha_backward_reference(
        _t(q), _t(k), _t(v), _t(do), bias=_t(bias), k_len=_t(k_len),
        causal=causal)
    plain = [None if g is None else g.numpy() for g in plain]
    if not with_bias:
        auto.append(None)
    argnums = (0, 1, 2, 3) if with_bias else (0, 1, 2)

    def loss(fn, **kw):
        def run(q, k, v, bias=None):
            return jnp.sum(fn(q, k, v, bias=bias, k_len=_j(k_len),
                              causal=causal, **kw) * do)
        return run

    jargs = [_j(a) for a in (q, k, v) + ((bias,) if with_bias else ())]
    want_kernel = list(jax.grad(loss(jax_att.flash_attention,
                                     interpret=True), argnums)(*jargs))
    want_dense = list(jax.grad(loss(jax_att.mha_reference),
                               argnums)(*jargs))
    if not with_bias:
        want_kernel.append(None)
        want_dense.append(None)
    _assert_grads_close(plain, want_kernel, "plain backward vs Pallas")
    _assert_grads_close(plain, want_dense, "plain backward vs dense JAX")
    _assert_grads_close(auto, want_kernel, "autograd vs Pallas")
    _assert_grads_close(auto, plain, "autograd vs plain backward")
    if dead:
        for g in plain[:3] + auto[:3]:
            assert np.count_nonzero(g[-1]) == 0
    # keys past k_len get exactly zero dk and dv
    for g in (plain[1], plain[2], auto[1], auto[2]):
        assert np.count_nonzero(g[1, :, k_len[1]:]) == 0


def test_attention_bias_is_indexed_by_head_not_by_batch():
    """A bias that differs between the heads, on a batch of three: every
    batch entry of one head sees that head's bias (a layout that mixes the
    batch into the head index passes every test with B = 1)."""
    B, H, T, D = 3, 2, 24, 16
    q, k, v, bias, _ = _inputs(5, B, H, T, T, D, True, False)
    bias[1] += 3.0 * np.sign(bias[1])
    got = flash_attention(_t(q), _t(k), _t(v), bias=_t(bias))
    for b in range(B):
        one = flash_attention(_t(q[b:b + 1]), _t(k[b:b + 1]), _t(v[b:b + 1]),
                              bias=_t(bias))
        np.testing.assert_allclose(got[b].numpy(), one[0].numpy(),
                                   atol=ATT_ATOL)


def _suffix_mask(lens, T):
    return np.arange(T)[None, :] >= np.asarray(lens)[:, None]


def _converted(fmod, tmod, variables):
    variables = jax.tree_util.tree_map(np.asarray, dict(variables))
    tmod.load_state_dict(to_state_dict(variables, tmod))
    return tmod


def test_aps_mha_flash_path_matches_flax():
    """ApsMultiheadAttention, self-attention without attn_mask: the port
    takes flash_attention at any length (weight None), aps_tpu its dense
    path below 512 frames; outputs and gradients agree on valid frames."""
    E, H, N, T = 64, 4, 3, 70
    rng = np.random.default_rng(11)
    x = rng.standard_normal((N, T, E)).astype(np.float32)
    do = rng.standard_normal((N, T, E)).astype(np.float32)
    mask = _suffix_mask([T, 51, 33], T)
    fmod = jax_impl.ApsMultiheadAttention(E, H, dropout=0.1)
    variables = fmod.init(jax.random.PRNGKey(0), x, x, x,
                          key_padding_mask=mask)

    def loss(params, x):
        out, _ = fmod.apply({"params": params}, x, x, x,
                            key_padding_mask=mask)
        return jnp.sum(out * do)

    want, _ = fmod.apply(variables, x, x, x, key_padding_mask=mask)
    want_g = jax.grad(loss, argnums=(0, 1))(variables["params"],
                                            jnp.asarray(x))
    tmod = _converted(fmod, impl.ApsMultiheadAttention(E, H, dropout=0.1),
                      variables).eval()
    xt = torch.from_numpy(x).requires_grad_()
    got, weight = tmod(xt, xt, xt, key_padding_mask=torch.from_numpy(mask))
    assert weight is None  # the flash path ran
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=MOD_ATOL)
    (got * torch.from_numpy(do)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_g[1]),
                               atol=MOD_GRAD_ATOL)
    np.testing.assert_allclose(tmod.in_proj.weight.grad.numpy().T,
                               np.asarray(want_g[0]["in_proj"]["kernel"]),
                               atol=MOD_GRAD_ATOL)


def test_aps_mha_long_cross_attention_takes_flash_as_aps_tpu():
    """Cross-attention (L != S) takes the flash path from 512 query frames
    on, as in aps_tpu (whose flash falls back to its dense reference off
    the TPU), and the dense path below."""
    E, H, N = 32, 2, 2
    rng = np.random.default_rng(12)
    mem = rng.standard_normal((N, 90, E)).astype(np.float32)
    mask = _suffix_mask([90, 40], 90)
    fmod = jax_impl.ApsMultiheadAttention(E, H)
    variables = fmod.init(jax.random.PRNGKey(1), mem, mem, mem)
    tmod = _converted(fmod, impl.ApsMultiheadAttention(E, H),
                      variables).eval()
    for L, flash in ((512, True), (100, False)):
        x = rng.standard_normal((N, L, E)).astype(np.float32)
        want, want_w = fmod.apply(variables, x, mem, mem,
                                  key_padding_mask=mask)
        with torch.no_grad():
            got, weight = tmod(*map(torch.from_numpy, (x, mem, mem)),
                               key_padding_mask=torch.from_numpy(mask))
        assert (weight is None) == flash and (want_w is None) == flash
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=MOD_ATOL)


@pytest.mark.parametrize("why", ["attn_mask", "dropout"])
def test_aps_mha_dense_path_matches_flax(why):
    """An additive attn_mask, or attention dropout that is active in
    training, takes the dense path and returns (context, weight)."""
    E, H, N, T = 32, 2, 2, 40
    rng = np.random.default_rng(13)
    x = rng.standard_normal((N, T, E)).astype(np.float32)
    mask = _suffix_mask([T, 29], T)
    kw = dict(key_padding_mask=mask)
    if why == "attn_mask":
        kw["attn_mask"] = np.triu(np.full((T, T), -1e9, np.float32), 1)
    drop = 0.0 if why == "attn_mask" else 0.1
    fmod = jax_impl.ApsMultiheadAttention(E, H, dropout=drop)
    variables = fmod.init(jax.random.PRNGKey(2), x, x, x, **kw)
    want, want_w = fmod.apply(variables, x, x, x, **kw)
    tmod = _converted(fmod, impl.ApsMultiheadAttention(E, H, dropout=drop),
                      variables)
    tmod.train(why == "dropout")
    xt = torch.from_numpy(x)
    tkw = {key: torch.from_numpy(val) for key, val in kw.items()}
    with torch.no_grad():
        got, weight = tmod(xt, xt, xt, **tkw)
    assert weight is not None and weight.shape == (N, T, T)
    if why == "dropout":
        # the draw differs: the pair's shapes, finite values, and rows that
        # no longer sum to one show that the dropout was applied
        assert got.shape == (N, T, E) and torch.isfinite(got).all()
        assert (weight.sum(-1) - 1).abs().max() > 1e-3
        return
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=MOD_ATOL)
    np.testing.assert_allclose(weight.numpy(), np.asarray(want_w),
                               atol=MOD_ATOL)


def test_aps_mha_refuses_non_suffix_mask():
    """aps_tpu's flash path ignores a padding mask that is not a suffix;
    the port raises instead."""
    E, H, T = 32, 2, 12
    tmod = impl.ApsMultiheadAttention(E, H).eval()
    x = torch.randn(2, T, E)
    holes = torch.zeros(2, T, dtype=torch.bool)
    holes[1, 3] = True
    with torch.no_grad(), pytest.raises(ValueError, match="suffix"):
        tmod(x, x, x, key_padding_mask=holes)


@pytest.mark.parametrize("drop,training", [(0.0, True), (0.1, False),
                                           (0.1, True)])
def test_rel_mha_dense_and_flash_paths_agree(drop, training):
    """RelMultiheadAttention: the dense path (forced by a zero attn_mask)
    equals the flash path when no dropout is active; with att_dropout 0.1
    in training the forward runs and returns the dense path's pair."""
    E, H, N, T = 64, 4, 2, 50
    rng = np.random.default_rng(14)
    x = torch.from_numpy(rng.standard_normal((N, T, E)).astype(np.float32))
    pose = torch.from_numpy(
        (0.3 * rng.standard_normal((2 * T - 1, E // H))).astype(np.float32))
    mask = torch.from_numpy(_suffix_mask([T, 31], T))
    tmod = impl.RelMultiheadAttention(E, H, dropout=drop).train(training)
    kw = dict(inj_pose=pose, key_padding_mask=mask)
    with torch.no_grad():
        got, weight = tmod(x, x, x, **kw)
        dense, dense_w = tmod(x, x, x, attn_mask=torch.zeros(T, T), **kw)
    assert dense_w is not None and dense_w.shape == (N, T, T)
    assert torch.isfinite(got).all() and torch.isfinite(dense).all()
    if drop > 0 and training:
        assert weight is not None and weight.shape == (N, T, T)
        return
    assert weight is None  # the flash path ran
    valid = ~mask[:, :, None]
    np.testing.assert_allclose((got * valid).numpy(), (dense * valid).numpy(),
                               atol=MOD_ATOL)


@pytest.mark.parametrize("tie", [False, True])
def test_xl_mha_matches_flax(tie):
    """XlMultiheadAttention (rel_u / rel_v, own or shared, projected
    sinusoid table): flash path == dense path == flax, outputs and the
    gradients of the input, rel_u and rel_proj."""
    E, H, N, T = 64, 4, 2, 60
    rng = np.random.default_rng(15)
    x = rng.standard_normal((N, T, E)).astype(np.float32)
    pose = rng.standard_normal((2 * T - 1, E)).astype(np.float32)
    do = rng.standard_normal((N, T, E)).astype(np.float32)
    mask = _suffix_mask([T, 41], T)
    uv = tuple((0.3 * rng.standard_normal((H, E // H))).astype(np.float32)
               for _ in range(2))
    fmod = jax_impl.XlMultiheadAttention(
        E, H, tie_uv=tuple(map(jnp.asarray, uv)) if tie else None)
    kw = dict(inj_pose=pose, key_padding_mask=mask)
    variables = fmod.init(jax.random.PRNGKey(3), x, x, x, **kw)
    variables = jax.tree_util.tree_map(np.array, dict(variables))
    if not tie:
        variables["params"]["rel_u"], variables["params"]["rel_v"] = uv

    def loss(params, x):
        out, _ = fmod.apply({"params": params}, x, x, x, **kw)
        return jnp.sum(out * do)

    want, _ = fmod.apply(variables, x, x, x, **kw)
    want_g = jax.grad(loss, argnums=(0, 1))(variables["params"],
                                            jnp.asarray(x))
    t_uv = tuple(torch.nn.Parameter(torch.from_numpy(a)) for a in uv)
    tmod = impl.XlMultiheadAttention(E, H, tie_uv=t_uv if tie else None)
    tmod.load_state_dict(to_state_dict(variables, tmod))
    tmod.eval()
    tkw = dict(inj_pose=torch.from_numpy(pose),
               key_padding_mask=torch.from_numpy(mask))
    xt = torch.from_numpy(x).requires_grad_()
    got, weight = tmod(xt, xt, xt, **tkw)
    assert weight is None  # the flash path ran
    with torch.no_grad():
        dense, dense_w = tmod(xt, xt, xt, attn_mask=torch.zeros(T, T), **tkw)
    assert dense_w is not None
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=MOD_ATOL)
    np.testing.assert_allclose(dense.numpy(), np.asarray(want),
                               atol=MOD_ATOL)
    (got * torch.from_numpy(do)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_g[1]),
                               atol=MOD_GRAD_ATOL)
    np.testing.assert_allclose(tmod.rel_proj.weight.grad.numpy().T,
                               np.asarray(want_g[0]["rel_proj"]["kernel"]),
                               atol=MOD_GRAD_ATOL)
    if tie:
        assert "rel_u" not in dict(tmod.named_parameters())
        assert t_uv[0].grad is not None
    else:
        np.testing.assert_allclose(tmod.rel_u.grad.numpy(),
                                   np.asarray(want_g[0]["rel_u"]),
                                   atol=MOD_GRAD_ATOL)


def _fake_csrc(tmp_path, monkeypatch):
    """A kernel directory with one source and one header, a build directory
    beside it, and a compiler that writes its output file and counts."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "toy.cu").write_text('#include "toy_tiles.cuh"\n')
    (csrc / "toy_tiles.cuh").write_text("constexpr int kRows = 64;\n")
    calls = []

    def fake_compile(cmd):
        calls.append(cmd)
        out = cmd[cmd.index("-o") + 1]
        with open(out, "w") as fd:
            fd.write("built")
        import subprocess
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "nvcc_path", lambda: "nvcc")
    monkeypatch.setattr(build, "compile_source", fake_compile)
    return csrc, calls


def test_build_rebuilds_when_a_header_changes(tmp_path, monkeypatch):
    """The library's name carries a digest of the source, of every
    csrc/*.cuh and of the flags: an edited header gives a new library, an
    untouched tree the cached one."""
    csrc, calls = _fake_csrc(tmp_path, monkeypatch)
    first = build.build("toy")
    assert build.build("toy") == first and len(calls) == 1
    (csrc / "toy_tiles.cuh").write_text("constexpr int kRows = 32;\n")
    second = build.build("toy")
    assert second != first and second.is_file() and len(calls) == 2
    (csrc / "other.cuh").write_text("// a new header\n")
    assert build.build("toy") not in (first, second) and len(calls) == 3


def test_build_digest_covers_source_and_flags(tmp_path, monkeypatch):
    csrc, _ = _fake_csrc(tmp_path, monkeypatch)
    plain = build.source_digest("toy")
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ["-DTILE=64"])
    flagged = build.source_digest("toy")
    assert flagged != plain
    (csrc / "toy.cu").write_text("// edited\n")
    assert build.source_digest("toy") not in (plain, flagged)


def test_build_sources_lists_kernel_sources_only(tmp_path, monkeypatch):
    """A header is no kernel source: sources() (what build_all compiles)
    lists the .cu files; the package's own header sits beside them."""
    assert "attn_tiles" not in build.sources()
    assert "attention_bwd" in build.sources()
    assert (build.CSRC / "attn_tiles.cuh").is_file()
    _fake_csrc(tmp_path, monkeypatch)
    assert build.sources() == ["toy"]


def test_build_reports_a_failed_compile(tmp_path, monkeypatch):
    import subprocess
    _fake_csrc(tmp_path, monkeypatch)
    monkeypatch.setattr(
        build, "compile_source",
        lambda cmd: subprocess.CompletedProcess(cmd, 1, "", "toy.cu: bad"))
    with pytest.raises(RuntimeError, match="toy.cu: bad"):
        build.build("toy")
    assert not list((tmp_path / "build").glob("*.so"))


@pytest.mark.parametrize("D", [8, 40, 80])
def test_padded_heads_match_plain(D):
    """The card's route for a head width the kernels are not built for:
    q, k, v zero-padded to the next of 16, 32, 64 and 128, attention at the
    true scale D**-0.5, the output sliced back. Held here through the plain
    version, forward and gradients, against the plain version at D. A head
    over 128 is passed on unpadded (the wide kernels take every width)."""
    from aps_tpu_torch.ops.attention import with_padded_heads
    gen = torch.Generator().manual_seed(D)
    B, H, Tq, Tk = 3, 2, 33, 47
    leaves = [torch.randn((B, H, T, D), generator=gen).requires_grad_()
              for T in (Tq, Tk, Tk)]
    bias = torch.randn((H, Tq, Tk), generator=gen).requires_grad_()
    k_len = torch.tensor([Tk, 20, 1], dtype=torch.int32)
    do = torch.randn((B, H, Tq, D), generator=gen)
    kw = dict(k_len=k_len, causal=True)
    got = with_padded_heads(mha_reference, "mha_reference", leaves, bias,
                            softmax_scale=D**-0.5, **kw)
    want = mha_reference(*leaves, bias, **kw)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)
    for g, w in zip(torch.autograd.grad(got, leaves + [bias], do),
                    torch.autograd.grad(want, leaves + [bias], do)):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=0)
    wide = [torch.randn((1, 2, 5, 160), generator=gen) for _ in range(3)]
    seen = []
    got = with_padded_heads(lambda *t: seen.append(t[0].shape[-1]) or
                            mha_reference(*t), "mha_reference", wide)
    assert seen == [160]
    torch.testing.assert_close(got, mha_reference(*wide), atol=0, rtol=0)
