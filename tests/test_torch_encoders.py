#!/usr/bin/env python
"""PyTorch port, the encoder kinds: ApsTransformerEncoderLayer, the linear
and conv1d projections, the xl and conv1d poses, prep_context_mask and
TransformerEncoder for the six layer names (with output_proj, lctx/rctx and
the encoders of two example recipes) against flax with converted weights.
The small long-form model as a whole is in test_torch_long_form.py."""

from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import yaml  # noqa: E402

from aps_tpu.asr.transformer import encoder as jax_encoder  # noqa: E402
from aps_tpu.asr.transformer import impl as jax_impl  # noqa: E402
from aps_tpu.asr.transformer import pose as jax_pose  # noqa: E402
from aps_tpu.asr.transformer import proj as jax_proj  # noqa: E402
from aps_tpu.asr.transformer import utils as jax_utils  # noqa: E402
from aps_tpu_torch.asr.transformer import impl, pose, proj, utils  # noqa
from aps_tpu_torch.asr.transformer.encoder import TransformerEncoder  # noqa
from aps_tpu_torch.convert import to_gradients, to_state_dict  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
# one layer or projection in float32: the same sums in another order
LAYER_ATOL = 1e-4
# a stack of layers behind a conv2d front end (measured ~1e-5)
ENC_ATOL = 2e-4
# a gradient leaf sums its contributions in another order; its bound is
# relative to the leaf's largest entry (at least 1)
GRAD_RTOL = 2e-4
# sin/cos of positions up to a few hundred in float32: jnp and torch agree
# to ~1e-6 there
POSE_ATOL = 5e-6


def _suffix_mask(lens, T):
    return np.arange(T)[None, :] >= np.asarray(lens)[:, None]


def _leaves(tree, prefix=""):
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(val, dict):
            yield from _leaves(val, path)
        else:
            yield path, np.asarray(val)


def assert_trees_close(got, want, rtol=0.0, atol=0.0):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        bound = atol + rtol * max(1.0, np.abs(w).max())
        np.testing.assert_allclose(got[path], w, atol=bound, rtol=0,
                                   err_msg=path)


def _numpy_variables(variables, seed=5):
    """flax variables as writable numpy, batch statistics moved off their
    initial (0, 1) so that the norms are not the identity."""
    variables = jax.tree_util.tree_map(np.array, dict(variables))
    rng = np.random.default_rng(seed)
    for path, val in _leaves(variables.get("batch_stats", {})):
        val[...] = 0.1 * rng.standard_normal(val.shape) \
            if path.endswith("mean") else 1 + 0.2 * rng.random(val.shape)
    return variables


@pytest.mark.parametrize("pre_norm", [False, True])
def test_transformer_layer_matches_flax(pre_norm):
    """ApsTransformerEncoderLayer (abs attention, FFN, two norms) with
    converted weights == flax: the output and every parameter gradient."""
    E, H, N, T = 64, 4, 2, 50
    rng = np.random.default_rng(1)
    x = rng.standard_normal((N, T, E)).astype(np.float32)
    do = rng.standard_normal((N, T, E)).astype(np.float32)
    mask = _suffix_mask([T, 33], T)
    kw = dict(feedforward_dim=128, pre_norm=pre_norm, activation="gelu")
    fmod = jax_impl.ApsTransformerEncoderLayer(
        E, jax_impl.ApsMultiheadAttention(E, H), **kw)
    variables = _numpy_variables(fmod.init(jax.random.PRNGKey(1), x,
                                           src_key_padding_mask=mask))
    want = fmod.apply(variables, x, src_key_padding_mask=mask)
    want_g = jax.grad(lambda p: jnp.sum(fmod.apply(
        {"params": p}, x, src_key_padding_mask=mask) * do))(
            variables["params"])
    tmod = impl.ApsTransformerEncoderLayer(
        E, impl.ApsMultiheadAttention(E, H), **kw).eval()
    tmod.load_state_dict(to_state_dict(variables, tmod))
    got = tmod(torch.from_numpy(x),
               src_key_padding_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=LAYER_ATOL)
    (got * torch.from_numpy(do)).sum().backward()
    assert_trees_close(to_gradients(tmod), want_g, rtol=GRAD_RTOL)


@pytest.mark.parametrize("norm", ["LN", "BN"])
def test_linear_proj_matches_flax(norm):
    N, T, F, E = 2, 30, 40, 32
    rng = np.random.default_rng(2)
    x = rng.standard_normal((N, T, F)).astype(np.float32)
    lens = np.array([T, 21])
    fmod = jax_proj.LinearProj(F, E, norm=norm)
    variables = _numpy_variables(fmod.init(jax.random.PRNGKey(2), x, lens))
    want, want_len = fmod.apply(variables, x, lens)
    tmod = proj.get_xfmr_proj("linear", F, E, norm=norm).eval()
    tmod.load_state_dict(to_state_dict(variables, tmod))
    with torch.no_grad():
        got, got_len = tmod(torch.from_numpy(x), torch.from_numpy(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LAYER_ATOL)
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    assert tmod.num_frames(7) == fmod.num_frames(7) == 7


@pytest.mark.parametrize("norm,four_d", [("BN", False), ("LN", True)])
def test_conv1d_proj_matches_flax(norm, four_d):
    """Conv1dProj (two strided TDNN layers) on N x T x F and on a front
    end's N x C x T x F; frame counts as aps_tpu computes them."""
    N, T, F, E = 2, 61, 40, 32
    rng = np.random.default_rng(3)
    x = rng.standard_normal((N, 2, T, F // 2) if four_d
                            else (N, T, F)).astype(np.float32)
    lens = np.array([T, 44])
    kw = dict(norm=norm, dim=48, kernel=[3, 5], stride=[2, 2])
    fmod = jax_proj.Conv1dProj(F, E, **kw)
    variables = _numpy_variables(fmod.init(jax.random.PRNGKey(3), x, lens))
    want, want_len = fmod.apply(variables, x, lens)
    tmod = proj.get_xfmr_proj("conv1d", F, E, **kw).eval()
    tmod.load_state_dict(to_state_dict(variables, tmod))
    with torch.no_grad():
        got, got_len = tmod(torch.from_numpy(x), torch.from_numpy(lens))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LAYER_ATOL)
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    np.testing.assert_array_equal(
        tmod.num_frames(torch.from_numpy(lens)).numpy(),
        np.asarray(want_len))


def test_xl_pose_matches_flax():
    """The "xl" pose: sinusoids of the positions 0 .. 2T-2."""
    T, E = 300, 64
    position = np.arange(0, 2 * T - 1, dtype=np.float32)
    fmod = jax_pose.get_xfmr_pose("xl", E, dropout=0.2)
    want = fmod.apply({}, jnp.asarray(position))
    tmod = pose.get_xfmr_pose("xl", E, dropout=0.2).eval()
    assert not list(tmod.parameters())
    got = tmod(torch.from_numpy(position))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=POSE_ATOL)


def test_abs_pose_matches_flax_at_long_positions():
    """The input sinusoids at the positions a 24 s utterance reaches."""
    N, T, E = 1, 640, 64
    x = np.zeros((N, T, E), dtype=np.float32)
    want = jax_pose.get_xfmr_pose("abs", E).apply({}, jnp.asarray(x))
    got = pose.get_xfmr_pose("abs", E).eval()(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=20 * POSE_ATOL)


def test_conv1d_pose_matches_flax():
    """Conv1dPosEncoding: a grouped conv and flax's gelu, which is the tanh
    approximation."""
    N, T, E = 2, 50, 64
    rng = np.random.default_rng(4)
    x = (3 * rng.standard_normal((N, T, E))).astype(np.float32)
    fmod = jax_pose.get_xfmr_pose("conv1d", E, kernel=9, groups=16)
    variables = _numpy_variables(fmod.init(jax.random.PRNGKey(4), x))
    variables["params"]["Conv_0"]["kernel"] *= 4.0  # reach gelu's bend
    want = fmod.apply(variables, x)
    tmod = pose.get_xfmr_pose("conv1d", E, kernel=9, groups=16).eval()
    tmod.load_state_dict(to_state_dict(variables, tmod))
    with torch.no_grad():
        xt = torch.from_numpy(x)
        got = tmod(xt)
        exact = torch.nn.functional.gelu(
            tmod.conv(xt.transpose(1, 2)).transpose(1, 2)) + xt
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LAYER_ATOL)
    # the exact gelu is a different function at this tolerance
    assert (exact - got).abs().max().item() > 3 * LAYER_ATOL


@pytest.mark.parametrize("T,chunk,lctx,rctx", [(17, 1, 3, 0), (20, 4, 1, 1),
                                               (20, 4, -1, 0), (9, 2, 0, -1),
                                               (12, 5, 2, 2)])
def test_prep_context_mask_matches_jax(T, chunk, lctx, rctx):
    want = jax_utils.prep_context_mask(T, chunk, lctx=lctx, rctx=rctx)
    got = utils.prep_context_mask(T, chunk, lctx=lctx, rctx=rctx)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _encoder_pair(arch, seed, x, lens, **enc_kwargs):
    fmod = jax_encoder.TransformerEncoder(arch=arch, **enc_kwargs)
    variables = _numpy_variables(
        fmod.init(jax.random.PRNGKey(seed), x, lens), seed)
    tmod = TransformerEncoder(arch=arch, **enc_kwargs).eval()
    tmod.load_state_dict(to_state_dict(variables, tmod))
    return fmod, variables, tmod


def _assert_encoder_matches(fmod, variables, tmod, x, lens, grads=True):
    want, want_len = fmod.apply(variables, x, lens)
    valid = ~_suffix_mask(np.asarray(want_len), want.shape[1])[..., None]
    rng = np.random.default_rng(0)
    do = rng.standard_normal(want.shape).astype(np.float32) * valid
    got, got_len = tmod(torch.from_numpy(x), torch.from_numpy(lens))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy() * valid,
                               np.asarray(want) * valid, atol=ENC_ATOL)
    if not grads:
        return
    stats = {k: v for k, v in variables.items() if k != "params"}
    want_g = jax.grad(lambda p: jnp.sum(fmod.apply(
        dict(stats, params=p), x, lens)[0] * do))(variables["params"])
    (got * torch.from_numpy(do)).sum().backward()
    assert_trees_close(to_gradients(tmod), want_g, rtol=GRAD_RTOL)


SMALL_ARCH = dict(att_dim=64, nhead=4, feedforward_dim=128)
SMALL_PROJ = dict(conv_channels=8, num_layers=2)


@pytest.mark.parametrize("arch,pose_name,extra", [
    ("xfmr", "abs", {}),
    ("xfmr", "rel", {"pose_kwargs": {"lradius": 20, "rradius": 30}}),
    ("xfmr", "xl", {}),
    ("cfmr", "abs", {}),
    ("cfmr", "rel", {}),
    ("cfmr", "xl", {}),
    ("xfmr", "xl", {"tie": True}),
    ("xfmr", "abs", {"output_proj": 24}),
    ("cfmr", "rel", {"lctx": 2, "rctx": 1, "chunk_size": 4}),
    ("xfmr", "abs", {"lctx": 3, "rctx": 0}),
    ("xfmr", "conv1d", {"pose_kwargs": {"kernel": 9, "groups": 8}}),
    ("xfmr", "abs", {"proj": "none", "input_size": 64}),
    ("cfmr", "xl", {"proj": "linear", "proj_kwargs": {"norm": "BN"}}),
    ("xfmr", "rel", {"proj": "conv1d",
                     "proj_kwargs": {"dim": 48, "num_layers": 2}}),
])
def test_transformer_encoder_matches_flax(arch, pose_name, extra):
    """TransformerEncoder for the six layer names and its options, weights
    and batch statistics converted from flax: the output on valid frames,
    the lengths and every parameter gradient. lctx/rctx give an attn_mask
    and so the dense attention path on both sides."""
    extra = dict(extra)
    arch_kwargs = dict(SMALL_ARCH)
    if arch == "cfmr":
        arch_kwargs["kernel_size"] = 7
    if extra.pop("tie", False):
        arch_kwargs["tie"] = True
    F = extra.pop("input_size", 40)
    kwargs = dict(input_size=F, num_layers=2, proj="conv2d", pose=pose_name,
                  arch_kwargs=arch_kwargs)
    kwargs.update(extra)
    if kwargs["proj"] == "conv2d":
        kwargs["proj_kwargs"] = SMALL_PROJ
    N, T = 2, 90
    rng = np.random.default_rng(6)
    x = rng.standard_normal((N, T, F)).astype(np.float32)
    lens = np.array([T, 61])
    fmod, variables, tmod = _encoder_pair(arch, 6, x, lens, **kwargs)
    if arch_kwargs.get("tie"):
        assert sorted(k for k in tmod.state_dict() if "rel_" in k
                      and "rel_proj" not in k) == [
            "encoder.rel_u", "encoder.rel_v"]
    _assert_encoder_matches(fmod, variables, tmod, x, lens)


@pytest.mark.parametrize("recipe,arch,pose_name", [
    ("examples/asr/librispeech/conf/1a.yaml", "cfmr", "xl"),
    ("examples/asr/aishell_v2/conf/1c.yaml", "xfmr", "rel"),
])
def test_example_recipe_encoders_match_flax(recipe, arch, pose_name):
    """The encoders of two example recipes, built from their enc_kwargs at
    the recipe's widths and a reduced depth of two layers."""
    conf = yaml.safe_load((REPO / recipe).read_text())["nnet_conf"]
    assert conf["enc_type"] == arch and conf["enc_kwargs"]["pose"] == \
        pose_name
    kwargs = dict(conf["enc_kwargs"], num_layers=2,
                  input_size=conf["input_size"])
    N, T = 2, 64
    rng = np.random.default_rng(7)
    x = rng.standard_normal((N, T, conf["input_size"])).astype(np.float32)
    lens = np.array([T, 49])
    fmod, variables, tmod = _encoder_pair(arch, 7, x, lens, **kwargs)
    _assert_encoder_matches(fmod, variables, tmod, x, lens, grads=False)


def test_encoder_refuses_unknown_kinds():
    with pytest.raises(ValueError, match="pose"):
        TransformerEncoder("xfmr", 40, pose="rope", arch_kwargs=SMALL_ARCH)
    with pytest.raises(ValueError, match="projection"):
        TransformerEncoder("xfmr", 40, proj="conv3d", arch_kwargs=SMALL_ARCH)
    with pytest.raises(ValueError, match="encoders"):
        TransformerEncoder("rnn", 40, arch_kwargs=SMALL_ARCH)
