#!/usr/bin/env python
"""PyTorch port, relative-position attention: flash_attention_rel (K3
forward and gradients), RelMultiheadAttention and ApsConformerEncoderLayer
against aps_tpu on the same numpy inputs and converted weights."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from aps_tpu.asr.transformer import impl as jax_impl  # noqa: E402
from aps_tpu.ops.pallas import rel_attention as jax_rel  # noqa: E402
from aps_tpu_torch.asr.transformer import impl  # noqa: E402
from aps_tpu_torch.convert import to_state_dict  # noqa: E402
from aps_tpu_torch.ops.rel_attention import (  # noqa: E402
    flash_attention_rel, rel_mha_backward_reference)

# attention outputs are O(1): float32 dot products and softmax sums in
# another order (aps_tpu holds its own kernel to its reference at 2e-5)
ATT_ATOL = 5e-5
# gradients of sum(o * do): dq/dk/dv entries are O(1) sums of T float32
# products; a dpose row gathers up to T * B (* H) such terms, summed in
# another order on each side, so it gets a term relative to its largest
# entry
GRAD_ATOL = 1e-4
DPOSE_RTOL = 2e-5
# a whole conformer layer (FFNs, conv module, norms) in float32
LAYER_ATOL = 1e-4


def _inputs(seed, B, H, T, D, Hp):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    q_c, q_p, k, v = (rng.standard_normal((B, H, T, D)).astype(f32)
                      for _ in range(4))
    pose = (0.3 * rng.standard_normal((Hp, 2 * T - 1, D))).astype(f32)
    k_len = np.array([T, T - 77] + [T // 3] * (B - 2), dtype=np.int32)
    return q_c, q_p, k, v, pose, k_len


# T >= 256 spans several of the TPU kernel's tiles (the cross-tile band
# offsets); T = 300 is ragged against them
@pytest.mark.parametrize("Hp,T,causal", [(1, 256, False), (2, 300, False),
                                         (1, 300, True), (2, 256, True)])
def test_rel_attention_plain_matches_jax(Hp, T, causal):
    B, H, D = 2, 2, 32
    q_c, q_p, k, v, pose, k_len = _inputs(T + Hp, B, H, T, D, Hp)
    got = flash_attention_rel(*map(torch.from_numpy,
                                   (q_c, q_p, k, v, pose)),
                              k_len=torch.from_numpy(k_len), causal=causal)
    jargs = tuple(map(jnp.asarray, (q_c, q_p, k, v, pose)))
    want = jax_rel.flash_attention_rel(*jargs, k_len=jnp.asarray(k_len),
                                       causal=causal, interpret=True)
    ref = jax_rel.rel_mha_reference(*jargs, k_len=jnp.asarray(k_len),
                                    causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATT_ATOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATT_ATOL)


@pytest.mark.parametrize("D,Hp,causal", [(96, 2, True), (128, 1, False),
                                         (160, 2, False), (256, 1, True)])
def test_rel_attention_wide_heads_match_jax(D, Hp, causal):
    """Heads of 96 (the card zero-pads them, table too, to 128), 128, and
    160 and 256 (the card's wide kernels):
    the plain version's output, and its backward and autograd's gradients,
    == aps_tpu's Pallas kernel in interpret mode and its dense reference,
    over two 64-row tiles with ragged k_len."""
    B, H, T = 2, 2, 70
    q_c, q_p, k, v, pose, k_len = _inputs(T + D, B, H, T, D, Hp)
    k_len[1] = 1
    do = np.random.default_rng(D).standard_normal((B, H, T, D)).astype(
        np.float32)
    targs = [torch.from_numpy(a).requires_grad_()
             for a in (q_c, q_p, k, v, pose)]
    klen_t = torch.from_numpy(k_len)
    out = flash_attention_rel(*targs, k_len=klen_t, causal=causal)
    auto = [g.numpy() for g in
            torch.autograd.grad(out, targs, torch.from_numpy(do))]
    plain = [g.numpy() for g in rel_mha_backward_reference(
        *[a.detach() for a in targs], torch.from_numpy(do), k_len=klen_t,
        causal=causal)]
    jargs = tuple(map(jnp.asarray, (q_c, q_p, k, v, pose)))
    kw = dict(k_len=jnp.asarray(k_len), causal=causal)
    want = jax_rel.flash_attention_rel(*jargs, interpret=True, **kw)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               atol=ATT_ATOL)
    np.testing.assert_allclose(
        out.detach().numpy(),
        np.asarray(jax_rel.rel_mha_reference(*jargs, **kw)), atol=ATT_ATOL)

    def loss(fn, **extra):
        return lambda *a: jnp.sum(fn(*a, **kw, **extra) * do)

    want_kernel = jax.grad(loss(jax_rel.flash_attention_rel, interpret=True),
                           argnums=(0, 1, 2, 3, 4))(*jargs)
    want_dense = jax.grad(loss(jax_rel.rel_mha_reference),
                          argnums=(0, 1, 2, 3, 4))(*jargs)
    _assert_grads_close(plain, want_kernel, "plain backward vs Pallas")
    _assert_grads_close(plain, want_dense, "plain backward vs dense JAX")
    _assert_grads_close(auto, plain, "autograd vs plain backward")


def test_rel_attention_fully_masked_rows_are_zero():
    q_c, q_p, k, v, pose, _ = _inputs(0, 2, 2, 40, 16, 1)
    out = flash_attention_rel(*map(torch.from_numpy, (q_c, q_p, k, v, pose)),
                              k_len=torch.tensor([40, 0]))
    assert torch.count_nonzero(out[1]) == 0
    assert torch.count_nonzero(out[0]) > 0


def _assert_grads_close(got, want, what):
    names = ("dq_c", "dq_p", "dk", "dv", "dpose")
    for name, g, w in zip(names, got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert np.isfinite(g).all(), (what, name)
        atol = GRAD_ATOL + (DPOSE_RTOL * np.abs(w).max()
                            if name == "dpose" else 0.0)
        np.testing.assert_allclose(g, w, atol=atol, rtol=0,
                                   err_msg=f"{what}: {name}")


# T >= 256 spans several of the TPU kernel's tiles in the backward too (the
# JAX package's own gradient test covers one tile); T = 300 is ragged
@pytest.mark.parametrize("Hp,T,causal", [(1, 256, False), (2, 300, False),
                                         (1, 300, True), (2, 256, True)])
def test_rel_attention_gradients_match_jax(Hp, T, causal):
    """rel_mha_backward_reference and autograd through the plain forward ==
    jax.grad of the Pallas kernel (interpret mode) and of the dense JAX
    reference, for dq_c, dq_p, dk, dv, dpose."""
    B, H, D = 2, 2, 32
    q_c, q_p, k, v, pose, k_len = _inputs(T + Hp, B, H, T, D, Hp)
    do = np.random.default_rng(T).standard_normal((B, H, T, D)).astype(
        np.float32)
    targs = [torch.from_numpy(a).requires_grad_()
             for a in (q_c, q_p, k, v, pose)]
    klen_t = torch.from_numpy(k_len)
    out = flash_attention_rel(*targs, k_len=klen_t, causal=causal)
    auto = [g.numpy() for g in
            torch.autograd.grad(out, targs, torch.from_numpy(do))]
    plain = [g.numpy() for g in rel_mha_backward_reference(
        *[a.detach() for a in targs], torch.from_numpy(do), k_len=klen_t,
        causal=causal)]
    jargs = tuple(map(jnp.asarray, (q_c, q_p, k, v, pose)))

    def loss(fn, **kw):
        return lambda *a: jnp.sum(fn(*a, k_len=jnp.asarray(k_len),
                                     causal=causal, **kw) * do)

    want_kernel = jax.grad(loss(jax_rel.flash_attention_rel, interpret=True),
                           argnums=(0, 1, 2, 3, 4))(*jargs)
    want_dense = jax.grad(loss(jax_rel.rel_mha_reference),
                          argnums=(0, 1, 2, 3, 4))(*jargs)
    _assert_grads_close(plain, want_kernel, "plain backward vs Pallas")
    _assert_grads_close(plain, want_dense, "plain backward vs dense JAX")
    _assert_grads_close(auto, want_kernel, "autograd vs Pallas")
    _assert_grads_close(auto, plain, "autograd vs plain backward")


def test_rel_attention_gradients_of_fully_masked_rows_are_zero():
    """A batch entry with k_len 0 has no valid key: zero output, zero
    gradients and no NaN, on both the autograd and the explicit path."""
    q_c, q_p, k, v, pose, _ = _inputs(0, 2, 2, 40, 16, 1)
    targs = [torch.from_numpy(a).requires_grad_()
             for a in (q_c, q_p, k, v, pose)]
    k_len = torch.tensor([33, 0])
    do = torch.ones((2, 2, 40, 16))
    out = flash_attention_rel(*targs, k_len=k_len)
    auto = torch.autograd.grad(out, targs, do)
    plain = rel_mha_backward_reference(*[a.detach() for a in targs], do,
                                       k_len=k_len)
    for grads in (auto, plain):
        for g in grads:
            assert torch.isfinite(g).all()
        for g in grads[:4]:
            assert torch.count_nonzero(g[1]) == 0
        # keys past k_len get exactly zero dk, dv
        assert torch.count_nonzero(grads[2][0, :, 33:]) == 0
        assert torch.count_nonzero(grads[3][0, :, 33:]) == 0
        assert torch.count_nonzero(grads[4]) > 0


def test_rel_mha_module_gradients_match_flax():
    """RelMultiheadAttention in training mode with dropout 0 (the
    configuration that takes the kernel on the card): output and the
    gradients of the input, the pose table and the in_proj kernel against
    flax."""
    E, H, N, T = 64, 4, 2, 70
    rng = np.random.default_rng(8)
    x = rng.standard_normal((N, T, E)).astype(np.float32)
    pose = (0.3 * rng.standard_normal((2 * T - 1, E // H))).astype(np.float32)
    do = rng.standard_normal((N, T, E)).astype(np.float32)
    mask = _suffix_mask([T, 51], T)
    fmod = jax_impl.RelMultiheadAttention(E, H, dropout=0.0)
    variables = fmod.init(jax.random.PRNGKey(0), x, x, x, inj_pose=pose,
                          key_padding_mask=mask)

    def loss(params, x, pose):
        out, _ = fmod.apply({"params": params}, x, x, x, inj_pose=pose,
                            key_padding_mask=mask, training=True)
        return jnp.sum(out * do)

    want = jax.grad(loss, argnums=(0, 1, 2))(variables["params"],
                                             jnp.asarray(x),
                                             jnp.asarray(pose))
    tmod = impl.RelMultiheadAttention(E, H, dropout=0.0).train()
    tmod.load_state_dict(
        to_state_dict(jax.tree_util.tree_map(np.asarray, dict(variables)),
                      tmod))
    xt = torch.from_numpy(x).requires_grad_()
    pt = torch.from_numpy(pose).requires_grad_()
    out, weight = tmod(xt, xt, xt, inj_pose=pt,
                       key_padding_mask=torch.from_numpy(mask))
    assert weight is None  # the flash path ran
    (out * torch.from_numpy(do)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want[1]),
                               atol=GRAD_ATOL)
    np.testing.assert_allclose(pt.grad.numpy(), np.asarray(want[2]),
                               atol=GRAD_ATOL)
    np.testing.assert_allclose(tmod.in_proj.weight.grad.numpy().T,
                               np.asarray(want[0]["in_proj"]["kernel"]),
                               atol=5 * GRAD_ATOL)


def _suffix_mask(lens, T):
    return np.arange(T)[None, :] >= np.asarray(lens)[:, None]


def test_rel_mha_module_matches_flax():
    """RelMultiheadAttention with converted weights == the flax module
    (which takes its dense path below T = 512)."""
    E, H, N, T = 64, 4, 2, 70
    rng = np.random.default_rng(3)
    x = rng.standard_normal((N, T, E)).astype(np.float32)
    pose = (0.3 * rng.standard_normal((2 * T - 1, E // H))).astype(np.float32)
    mask = _suffix_mask([T, 51], T)
    fmod = jax_impl.RelMultiheadAttention(E, H, dropout=0.1)
    variables = fmod.init(jax.random.PRNGKey(0), x, x, x, inj_pose=pose,
                          key_padding_mask=mask)
    want, _ = fmod.apply(variables, x, x, x, inj_pose=pose,
                         key_padding_mask=mask)
    tmod = impl.RelMultiheadAttention(E, H, dropout=0.1).eval()
    tmod.load_state_dict(
        to_state_dict(jax.tree_util.tree_map(np.asarray, dict(variables)),
                      tmod))
    xt = torch.from_numpy(x)
    with torch.no_grad():
        got, weight = tmod(xt, xt, xt, inj_pose=torch.from_numpy(pose),
                           key_padding_mask=torch.from_numpy(mask))
    assert weight is None  # the flash path ran
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATT_ATOL)


def test_rel_mha_refuses_non_suffix_mask():
    """aps_tpu's rel flash path silently ignores a padding mask that is not
    a suffix; the port raises instead."""
    E, H, T = 32, 2, 12
    tmod = impl.RelMultiheadAttention(E, H).eval()
    x = torch.randn(2, T, E)
    pose = torch.randn(2 * T - 1, E // H)
    holes = torch.zeros(2, T, dtype=torch.bool)
    holes[1, 3] = True
    with torch.no_grad(), pytest.raises(ValueError, match="suffix"):
        tmod(x, x, x, inj_pose=pose, key_padding_mask=holes)
    with torch.no_grad():
        tmod(x, x, x, inj_pose=pose,
             key_padding_mask=torch.from_numpy(_suffix_mask([T, 5], T)))


def test_rel_mha_dense_path_matches_flax():
    """With an additive attn_mask the rel attention takes the dense path
    (einsum + digit_shift, CPU tensors only) on both sides."""
    E, H, N, T = 32, 2, 2, 40
    rng = np.random.default_rng(5)
    x = rng.standard_normal((N, T, E)).astype(np.float32)
    pose = (0.3 * rng.standard_normal((2 * T - 1, E // H))).astype(np.float32)
    mask = _suffix_mask([T, 29], T)
    causal = np.triu(np.full((T, T), -1e9, np.float32), 1)
    fmod = jax_impl.RelMultiheadAttention(E, H)
    kw = dict(inj_pose=pose, key_padding_mask=mask, attn_mask=causal)
    variables = fmod.init(jax.random.PRNGKey(2), x, x, x, **kw)
    want, want_w = fmod.apply(variables, x, x, x, **kw)
    tmod = impl.RelMultiheadAttention(E, H).eval()
    tmod.load_state_dict(
        to_state_dict(jax.tree_util.tree_map(np.asarray, dict(variables)),
                      tmod))
    xt = torch.from_numpy(x)
    with torch.no_grad():
        got, weight = tmod(xt, xt, xt, inj_pose=torch.from_numpy(pose),
                           key_padding_mask=torch.from_numpy(mask),
                           attn_mask=torch.from_numpy(causal))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATT_ATOL)
    np.testing.assert_allclose(weight.numpy(), np.asarray(want_w),
                               atol=ATT_ATOL)


def test_rel_mha_refuses_cross_attention():
    """The rel scores need self-attention and a (2L-1)-row pose table."""
    E, H = 32, 2
    tmod = impl.RelMultiheadAttention(E, H).eval()
    q, kv = torch.randn(2, 10, E), torch.randn(2, 12, E)
    with torch.no_grad(), pytest.raises(ValueError, match="2L-1"):
        tmod(q, kv, kv, inj_pose=torch.randn(19, E // H))
    with torch.no_grad(), pytest.raises(ValueError, match="2L-1"):
        tmod(q, q, q, inj_pose=torch.randn(21, E // H))


@pytest.mark.parametrize("pre_norm,macaron,casual_conv1d",
                         [(True, True, False), (False, True, False),
                          (True, False, True)])
def test_conformer_layer_matches_flax(pre_norm, macaron, casual_conv1d):
    """ApsConformerEncoderLayer (macaron FFNs, rel MHSA, GLU + depthwise
    conv + BN) with converted weights and BN statistics == flax."""
    E, H, N, T = 64, 4, 2, 60
    rng = np.random.default_rng(4)
    x = rng.standard_normal((N, T, E)).astype(np.float32)
    pose = (0.3 * rng.standard_normal((2 * T - 1, E // H))).astype(np.float32)
    mask = _suffix_mask([T, 37], T)
    kw = dict(feedforward_dim=4 * E, kernel_size=15, pre_norm=pre_norm,
              macaron=macaron, casual_conv1d=casual_conv1d)
    fmod = jax_impl.ApsConformerEncoderLayer(
        E, jax_impl.RelMultiheadAttention(E, H), **kw)
    variables = fmod.init(jax.random.PRNGKey(1), x, inj_pose=pose,
                          src_key_padding_mask=mask)
    variables = jax.tree_util.tree_map(np.asarray, dict(variables))
    bn = variables["batch_stats"]["bn"]
    bn["mean"] = (0.1 * rng.standard_normal(E)).astype(np.float32)
    bn["var"] = (1 + 0.2 * rng.random(E)).astype(np.float32)
    want = fmod.apply(variables, x, inj_pose=pose, src_key_padding_mask=mask)
    tmod = impl.ApsConformerEncoderLayer(
        E, impl.RelMultiheadAttention(E, H), **kw).eval()
    tmod.load_state_dict(to_state_dict(variables, tmod))
    with torch.no_grad():
        got = tmod(torch.from_numpy(x), inj_pose=torch.from_numpy(pose),
                   src_key_padding_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LAYER_ATOL)


@pytest.mark.parametrize("D,Hp", [(8, 1), (40, 2), (96, 2)])
def test_padded_heads_match_plain(D, Hp):
    """The card's route for a head width K3 is not built for: q_c, q_p, k,
    v and the pose table zero-padded to the next of 16, 32, 64 and 128, scores
    at the true scale D**-0.5, the output sliced back. Held here through
    the plain version, forward and gradients (the table's too), against
    the plain version at D."""
    from aps_tpu_torch.ops.attention import with_padded_heads
    from aps_tpu_torch.ops.rel_attention import rel_mha_reference
    gen = torch.Generator().manual_seed(D)
    B, H, T = 3, 2, 37
    leaves = [torch.randn((B, H, T, D), generator=gen).requires_grad_()
              for _ in range(4)]
    leaves.append((0.3 * torch.randn((Hp, 2 * T - 1, D), generator=gen)
                   ).requires_grad_())
    k_len = torch.tensor([T, 20, 1], dtype=torch.int32)
    do = torch.randn((B, H, T, D), generator=gen)
    got = with_padded_heads(rel_mha_reference, "rel_mha_reference", leaves,
                            k_len, True, softmax_scale=D**-0.5)
    want = rel_mha_reference(*leaves, k_len=k_len, causal=True)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)
    for g, w in zip(torch.autograd.grad(got, leaves, do),
                    torch.autograd.grad(want, leaves, do)):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=0)
