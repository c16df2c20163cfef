#!/usr/bin/env python
"""PyTorch port, Conv-TasNet: the fused TCN block's plain version against
aps_tpu's Pallas kernel (interpret mode) and the unfused block math; the
folded forward and the canonical module against aps_tpu's make_fused_eval
and nnet.apply on the same converted weights; the weight converter's round
trip for every layer kind of the model."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from aps_tpu.ops.pallas.tcn import tcn_block_fused as pallas_block  # noqa
from aps_tpu.sse.bss import tcn as jax_tcn  # noqa: E402
from aps_tpu_torch.convert import to_state_dict, to_variables  # noqa: E402
from aps_tpu_torch.libs import aps_sse_nnet  # noqa: E402
from aps_tpu_torch.ops import build  # noqa: E402
from aps_tpu_torch.ops.tcn import (PACK_ROWS, tcn_block_fused,  # noqa: E402
                                   tcn_block_reference)
from aps_tpu_torch.sse.bss.tcn import _fold_eval_block  # noqa: E402

# float32: two products of depth 16 and 32 on O(1) values, sums in another
# order
BLOCK_ATOL = 1e-5
# bfloat16: both sides accumulate the same bfloat16 products in float32 and
# round y2 and the output at the same places; a sum that lands within
# float32 rounding of a bfloat16 tie may round the other way (one ulp of an
# O(4) output: 2^-6)
BLOCK_BF16_ATOL = 2**-6
# the model: separated waveforms of magnitude ~0.2 after 6 blocks, float32
MODEL_ATOL = 1e-5


def _block_args(rng, N, T, B, H):
    x = rng.standard_normal((N, T, B))
    k1 = rng.standard_normal((B, H)) / np.sqrt(B)
    k2 = rng.standard_normal((H, B)) / np.sqrt(H)
    pack = 0.5 * rng.standard_normal((PACK_ROWS, H))
    b2 = 0.1 * rng.standard_normal((1, B))
    return [np.asarray(a, dtype=np.float32) for a in (x, k1, pack, k2, b2)]


def _unfused_math(x, k1, pack, k2, b2, d, causal):
    """The block as plain numpy (float64), the math of aps_tpu's own kernel
    test."""
    x, k1, pack, k2, b2 = (np.asarray(a, np.float64)
                           for a in (x, k1, pack, k2, b2))
    T = x.shape[1]
    c1, g1, h1, w0, w1, w2, cb, g2, h2, a1, a2 = pack
    y = x @ k1 + c1
    y = np.where(y >= 0, y, a1 * y) * g1 + h1
    pl_, pr = (2 * d, 0) if causal else (d, d)
    yp = np.pad(y, ((0, 0), (pl_, pr), (0, 0)))
    y2 = w0 * yp[:, :T] + w1 * yp[:, d:T + d] + w2 * yp[:, 2 * d:2 * d + T] \
        + cb
    y2 = np.where(y2 >= 0, y2, a2 * y2) * g2 + h2
    return y2 @ k2 + b2[0] + x


@pytest.mark.parametrize("T,dilation,causal", [
    (72, 4, False), (72, 4, True), (50, 1, False), (37, 32, False),
    (37, 32, True), (101, 8, True), (17, 16, False),
])
def test_tcn_block_plain_matches_pallas_kernel(T, dilation, causal):
    """tcn_block_reference == aps_tpu's tcn_block_fused in interpret mode
    and the unfused math: symmetric and causal, ragged T, T < 2 * dilation
    (every tap but the centre falls in the padding for some rows)."""
    rng = np.random.default_rng(T + dilation)
    args = _block_args(rng, 2, T, 16, 32)
    build.reset_launches()
    got = tcn_block_fused(*[torch.from_numpy(a) for a in args], dilation,
                          causal=causal)
    assert build.LAUNCHES["tcn_block_fused"] == 0  # CPU: the plain version
    want = pallas_block(*[jnp.asarray(a) for a in args], dilation=dilation,
                        causal=causal, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=BLOCK_ATOL, rtol=0)
    np.testing.assert_allclose(
        got.numpy(), _unfused_math(*args, dilation, causal),
        atol=BLOCK_ATOL, rtol=0)


@pytest.mark.parametrize("T,dilation,causal", [(72, 4, False), (50, 2, True),
                                               (37, 32, False)])
def test_tcn_block_plain_matches_pallas_kernel_bfloat16(T, dilation, causal):
    """bfloat16 activations and kernels, float32 pack and bias: the plain
    version rounds where the TPU kernel rounds (float32 accumulation, y2 to
    bfloat16 before the second product, float32 residual)."""
    rng = np.random.default_rng(T)
    x, k1, pack, k2, b2 = _block_args(rng, 2, T, 16, 32)
    bf = lambda a: torch.from_numpy(a).bfloat16()  # noqa: E731
    got = tcn_block_reference(bf(x), bf(k1), torch.from_numpy(pack), bf(k2),
                              torch.from_numpy(b2), dilation, causal=causal)
    assert got.dtype == torch.bfloat16
    jbf = lambda a: jnp.asarray(a).astype(jnp.bfloat16)  # noqa: E731
    want = pallas_block(jbf(x), jbf(k1), jnp.asarray(pack), jbf(k2),
                        jnp.asarray(b2), dilation=dilation, causal=causal,
                        interpret=True)
    assert want.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=BLOCK_BF16_ATOL, rtol=0)


def test_tcn_block_checks_its_arguments():
    rng = np.random.default_rng(0)
    x, k1, pack, k2, b2 = [torch.from_numpy(a)
                           for a in _block_args(rng, 1, 9, 8, 12)]
    with pytest.raises(ValueError, match="kernel1"):
        tcn_block_fused(x, k1[:4], pack, k2, b2, 1)
    with pytest.raises(ValueError, match="pack"):
        tcn_block_fused(x, k1, pack[:10], k2, b2, 1)
    with pytest.raises(ValueError, match="bias2"):
        tcn_block_fused(x, k1, pack, k2, b2[0], 1)
    with pytest.raises(ValueError, match="dilation"):
        tcn_block_fused(x, k1, pack, k2, b2, 0)
    with pytest.raises(ValueError, match="N x T x B"):
        tcn_block_fused(x[0], k1, pack, k2, b2, 1)


def _leaves(tree, prefix=""):
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(val, dict):
            yield from _leaves(val, path)
        else:
            yield path, np.asarray(val)


SMALL = dict(L=20, N=64, X=3, R=2, B=64, H=128)


def make_pair(seed=0, **kwargs):
    """(flax model, its variables as numpy with every leaf moved off its
    initial value, the port's model with the same weights in eval mode, a
    mixture of 2 x 2010 samples)."""
    conf = dict(SMALL, **kwargs)
    jnet = jax_tcn.TimeConvTasNet(**conf)
    rng = np.random.default_rng(seed)
    mix = (0.1 * rng.standard_normal((2, 20 + 10 * 199))).astype(np.float32)
    variables = jnet.init(jax.random.PRNGKey(seed), jnp.asarray(mix),
                          training=False)
    variables = jax.tree_util.tree_map(np.array, dict(variables))
    for path, val in _leaves(variables.get("batch_stats", {})):
        val[...] = 0.1 * rng.standard_normal(val.shape) \
            if path.endswith("mean") else 1 + 0.2 * rng.random(val.shape)
    for path, val in _leaves(variables["params"]):
        # slopes, output scales, biases and norm gains start at constants
        if not path.endswith("kernel"):
            val[...] += 0.1 * rng.standard_normal(val.shape)
    tnet = aps_sse_nnet("sse@time_tcn")(**conf)
    tnet.load_state_dict(to_state_dict(variables, tnet))
    return jnet, variables, tnet.eval(), mix


def _assert_all_close(got, want, atol):
    got = got if isinstance(got, (list, tuple)) else [got]
    want = want if isinstance(want, (list, tuple)) else [want]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        assert np.abs(w).max() > 1e-2  # not a comparison of zeros
        np.testing.assert_allclose(g.detach().numpy(), w, atol=atol, rtol=0)


@pytest.mark.parametrize("mc", ["none", "fix", "mag", "learn"])
def test_fused_forward_matches_jax(mc):
    """The folded forward (plain block on the CPU) == aps_tpu's
    make_fused_eval(impl="xla") == nnet.apply, with shifted running
    statistics, in every mixture-consistency mode."""
    jnet, variables, tnet, mix = make_pair(
        3, mixture_consistency=mc,
        non_linear="softmax" if mc == "learn" else "relu")
    forward = tnet.make_fused_eval()
    assert forward is not None
    build.reset_launches()
    with torch.no_grad():
        got = forward(torch.from_numpy(mix))
        canon = tnet(torch.from_numpy(mix))
    assert build.LAUNCHES["tcn_block_fused"] == 0
    with jax.default_matmul_precision("highest"):
        want = jnet.make_fused_eval(variables, impl="xla")(jnp.asarray(mix))
        applied = jnet.apply(variables, jnp.asarray(mix), training=False)
    _assert_all_close(got, want, MODEL_ATOL)
    _assert_all_close(got, applied, MODEL_ATOL)
    _assert_all_close(canon, applied, MODEL_ATOL)


def test_fold_eval_block_matches_jax():
    """_fold_eval_block gives aps_tpu's folded (kernel1, pack, kernel2,
    bias2) for a block with shifted statistics, slopes and scales."""
    _, variables, tnet, _ = make_pair(4)
    for name in ("block_0_0", "block_1_2"):
        want = jax_tcn._fold_eval_block(
            variables["params"]["conv"][name],
            variables["batch_stats"]["conv"][name])
        got = _fold_eval_block(getattr(tnet.tcn, name))
        for g, w in zip(got, want):
            assert tuple(g.shape) == np.asarray(w).shape
            assert g.dtype == torch.float32 and g.is_contiguous()
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6,
                                       rtol=1e-6)


@pytest.mark.parametrize("kwargs", [
    dict(norm="BN", causal=True),
    dict(norm="IN", scaling_param=True, non_linear="sigmoid"),
    dict(norm="gLN", skip_residual=True),
    dict(norm="cLN", skip_residual=True, causal=True, num_spks=1,
         mixture_consistency="none"),
    dict(norm="BN", num_spks=3, non_linear="softmax",
         mixture_consistency="learn"),
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_canonical_module_matches_jax(kwargs):
    """The module as it trains, in eval mode == nnet.apply: every norm,
    skip residuals, blocks without an output scale, causal padding, one and
    three speakers."""
    jnet, variables, tnet, mix = make_pair(5, **kwargs)
    with torch.no_grad():
        got = tnet(torch.from_numpy(mix))
        one = tnet.infer(torch.from_numpy(mix[0]))
    with jax.default_matmul_precision("highest"):
        want = jnet.apply(variables, jnp.asarray(mix), training=False)
        want_one = jnet.apply(variables, jnp.asarray(mix[0]), method="infer")
    _assert_all_close(got, want, MODEL_ATOL)
    _assert_all_close(one, want_one, MODEL_ATOL)
    # what cannot be folded gives None in both packages
    foldable = kwargs["norm"] == "BN"
    assert (tnet.make_fused_eval() is not None) == foldable
    if not kwargs.get("scaling_param"):
        assert (jnet.make_fused_eval(variables) is not None) == foldable


def test_fused_forward_folds_a_block_without_scale():
    """scaling_param leaves the ScaleLinear scales out; the fold takes them
    as 1 and still equals the module."""
    _, _, tnet, mix = make_pair(6, scaling_param=True)
    assert tnet.tcn.block_0_0.linear_in.scale is None
    with torch.no_grad():
        got = tnet.make_fused_eval()(torch.from_numpy(mix))
        want = tnet(torch.from_numpy(mix))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=MODEL_ATOL, rtol=0)


def test_training_mode_batch_stats_match_jax():
    """One training-mode forward: outputs from batch statistics and the
    running statistics after it (biased variance, momentum 0.9)."""
    jnet, variables, tnet, mix = make_pair(7)
    tnet.train()
    got = tnet(torch.from_numpy(mix))
    want, state = jnet.apply(variables, jnp.asarray(mix), training=True,
                             mutable=["batch_stats"])
    _assert_all_close(got, want, MODEL_ATOL)
    after = dict(_leaves(to_variables(tnet)["batch_stats"]))
    for path, w in _leaves(state["batch_stats"]):
        np.testing.assert_allclose(after[path], w, atol=1e-5 * max(
            1.0, np.abs(w).max()), rtol=0, err_msg=path)


@pytest.mark.parametrize("kwargs", [
    dict(norm="BN", mixture_consistency="learn"),
    dict(norm="gLN", skip_residual=True, scaling_param=True),
], ids=["BN-learn", "gLN-skip-noscale"])
def test_converter_round_trip(kwargs):
    """aps_tpu variables -> state_dict -> variables is exact, leaf for leaf;
    a left-over or a missing leaf raises."""
    _, variables, tnet, _ = make_pair(8, **kwargs)
    back = to_variables(tnet)
    want, got = dict(_leaves(variables)), dict(_leaves(back))
    assert sorted(want) == sorted(got)
    for path, w in want.items():
        assert got[path].shape == w.shape and got[path].dtype == w.dtype
        np.testing.assert_array_equal(got[path], w, err_msg=path)
    kinds = {p.rsplit("/", 1)[-1] for p in want}
    assert {"kernel", "bias", "negative_slope", "gamma", "beta"} <= kinds
    assert ("scale" in kinds) == (not kwargs.get("scaling_param")
                                  or kwargs.get("skip_residual", False))
    extra = {"params": dict(variables["params"], stray={"kernel": np.ones(1)})}
    extra.update({k: v for k, v in variables.items() if k != "params"})
    with pytest.raises(KeyError, match="left unmapped"):
        to_state_dict(extra, tnet)
    less = {"params": {k: v for k, v in variables["params"].items()
                       if k != "decoder"}}
    less.update({k: v for k, v in variables.items() if k != "params"})
    with pytest.raises(KeyError, match="missing"):
        to_state_dict(less, tnet)


def test_conv_transpose_kernel_is_stored_flipped():
    """flax's ConvTranspose applies its kernel unflipped where PyTorch's
    scatters it: the converter reverses the tap axis."""
    _, variables, tnet, _ = make_pair(9)
    kernel = variables["params"]["decoder"]["kernel"]  # (W, I, O)
    weight = tnet.decoder.weight.detach().numpy()  # (I, O, W)
    assert kernel.shape == (20, 64, 1) and weight.shape == (64, 1, 20)
    np.testing.assert_array_equal(weight[:, 0, ::-1].T, kernel[:, :, 0])
    assert tnet.mask_prelu.weight.shape == (1,)
    assert variables["params"]["mask_prelu"]["negative_slope"].shape == ()
