#!/usr/bin/env python
"""PyTorch port, the training front end of the asr@xfmr recipes: the int16
rescale, the speed perturbation's filter bank, resampler, branches and
lengths, SpecAugment's masks, and the whole perturb-fbank-log-cmvn-aug
transform in training mode, against aps_tpu on the CPU with aps_tpu's own
draws fed into the port; then the statistics of the port's own draws."""

import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from aps_tpu.transform import asr as jax_asr  # noqa: E402
from aps_tpu.transform import augment as jax_augment  # noqa: E402
from aps_tpu.transform.utils import \
    speed_perturb_filter as jax_filter  # noqa: E402
from aps_tpu_torch.transform import augment  # noqa: E402
from aps_tpu_torch.transform.asr import (AsrTransform,  # noqa: E402
                                         RescaleTransform, SpecAugTransform,
                                         SpeedPerturbTransform)
from aps_tpu_torch.transform.utils import speed_perturb_filter  # noqa: E402

# the whole transform: the port's plain log-mel against aps_tpu's layered
# STFT path (tests/test_torch_frontend.py's bound), then CMVN and the masks
LOGMEL_ATOL = 1e-3
# the resampler: the same K-tap float32 correlation on both sides
PERTURB_RTOL = 1e-6
FACTORS = "0.9,1.0,1.1"
# the recipes' front end (examples/asr/librispeech/conf/1a.yaml)
RECIPE = dict(feats="perturb-fbank-log-cmvn-aug", frame_len=400,
              frame_hop=160, window="hamm", stft_mode="kaldi",
              round_pow_of_two=True, audio_norm=False, pre_emphasis=0.97,
              sr=16000, num_mels=80, log_lower_bound=1, norm_mean=True,
              norm_var=True, aug_prob=1, aug_mask_zero=False,
              aug_adaptive_args=(0.05, 0.05), aug_time_args=(100, 20),
              aug_freq_args=(20, 2))


def ragged_batch(seed, lens=(16000, 12000, 9100), scale=0.1):
    rng = np.random.default_rng(seed)
    wav = np.zeros((len(lens), max(lens)), dtype=np.float32)
    for i, n in enumerate(lens):
        wav[i, :n] = scale * rng.standard_normal(n)
    return wav, np.asarray(lens)


@contextlib.contextmanager
def jax_draws(monkeypatch, branch=None):
    """aps_tpu's transform with its perturbation branch forced to `branch`
    and its SpecAugment draws recorded: yields {"masks": [...], "coins":
    [...]}, each tf_mask result and each (N,) uniform drawn after it."""
    seen = {"masks": [], "coins": []}
    randint, uniform = jax.random.randint, jax.random.uniform
    tf_mask = jax_asr.tf_mask
    inside = []

    def forced_randint(key, shape, *args, **kwargs):
        if shape == () and branch is not None:
            return jnp.asarray(branch, dtype=jnp.int32)
        return randint(key, shape, *args, **kwargs)

    def recorded_uniform(key, shape=(), *args, **kwargs):
        out = uniform(key, shape, *args, **kwargs)
        if not inside and len(shape) == 1:
            seen["coins"].append(np.array(out))
        return out

    def recorded_mask(*args, **kwargs):
        inside.append(1)
        try:
            out = tf_mask(*args, **kwargs)
        finally:
            inside.pop()
        seen["masks"].append(np.array(out))
        return out

    monkeypatch.setattr(jax.random, "randint", forced_randint)
    monkeypatch.setattr(jax.random, "uniform", recorded_uniform)
    monkeypatch.setattr(jax_asr, "tf_mask", recorded_mask)
    yield seen


def test_rescale_is_bit_equal():
    """round(wav * 32767) with half to even, on random samples and on
    samples whose product lands on a half."""
    rng = np.random.default_rng(0)
    halves = (np.arange(-40, 40) + 0.5).astype(np.float32) / np.float32(
        32767)
    wav = np.concatenate([rng.uniform(-1, 1, 4000).astype(np.float32),
                          halves, np.float32([-1, 0, 1])])[None]
    want = np.asarray(jax_asr.RescaleTransform().apply({}, jnp.asarray(wav)))
    got = RescaleTransform()(torch.from_numpy(wav)).numpy()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    # some products sit on a half, so the rounding rule is exercised
    prod = wav * np.float32(32767)
    assert np.any(np.abs(prod - np.trunc(prod)) == 0.5)


@pytest.mark.parametrize("src,dst", [(16000, 14400), (16000, 17600),
                                     (8000, 7200), (8000, 8800)])
def test_speed_perturb_filter_equals_aps_tpus(src, dst):
    got = speed_perturb_filter(src, dst)
    want = jax_filter(src, dst)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("branch", [0, 1, 2])
def test_perturb_speed_matches_aps_tpu(monkeypatch, branch):
    """SpeedPerturbTransform on one waveform in each branch (0.9, 1.1 and
    the identity): the same S-sample buffer, zero-padded or cut."""
    wav, _ = ragged_batch(1, scale=3000.0)
    layer = jax_asr.SpeedPerturbTransform(sr=16000, perturb=FACTORS)
    with jax_draws(monkeypatch, branch):
        want, choice = layer.apply({}, jnp.asarray(wav), training=True,
                                   rngs={"aug": jax.random.PRNGKey(0)})
    assert np.asarray(choice).tolist() == [branch] * wav.shape[0]
    got = SpeedPerturbTransform(sr=16000, perturb=FACTORS)(
        torch.from_numpy(wav), branch)
    want = np.asarray(want)
    assert got.shape == want.shape == wav.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=PERTURB_RTOL * np.abs(want).max())
    if branch == 0:  # 0.9 of the samples: zero-padded to S
        assert np.all(want[:, -1000:] == 0)
    if branch == 1:  # 1.1 times the samples: cut at S
        assert np.abs(want[0, -1000:]).max() > 0


@pytest.mark.parametrize("branch", [0, 1, 2])
def test_perturbed_lengths_match_aps_tpu(branch):
    """output_length ((len // src) * dst) and the transform's frame counts
    for each branch."""
    lens = np.array([16000, 12345, 9100, 401, 7])
    layer = jax_asr.SpeedPerturbTransform(sr=16000, perturb=FACTORS).bind({})
    choice = jnp.full((len(lens),), branch, dtype=jnp.int32)
    want = np.asarray(layer.output_length(jnp.asarray(lens), choice))
    got = SpeedPerturbTransform(sr=16000, perturb=FACTORS).output_length(
        torch.from_numpy(lens), branch)
    np.testing.assert_array_equal(got.numpy(), want)
    jtf = jax_asr.FeatureTransform(**RECIPE).bind({})
    want = np.asarray(jtf._num_frames(jnp.asarray(lens[:3]), choice[:3]))
    got = AsrTransform(**RECIPE)._num_frames(torch.from_numpy(lens[:3]),
                                             branch)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("max_steps,num_masks", [(20, 2), (100, 20), (1, 3),
                                                 (150, 4)])
def test_random_mask_matches_aps_tpu_on_its_draws(max_steps, num_masks):
    """random_mask on aps_tpu's own durations and starts (the draws of
    augment.random_mask under the same key): bit-equal, a span that cannot
    fit skipped."""
    batch, length = 6, 80
    key = jax.random.PRNGKey(max_steps)
    want = np.asarray(jax_augment.random_mask(key, batch, length, max_steps,
                                              num_masks))
    spans = None
    if min(max_steps, length) > 1:
        kd, kb = jax.random.split(key)
        dur = jax.random.randint(kd, (batch, num_masks), 1,
                                 min(max_steps, length))
        start = jax.random.uniform(kb, (batch, num_masks))
        spans = (torch.from_numpy(np.array(dur)),
                 torch.from_numpy(np.array(start)))
    got = augment.random_mask(batch, length, spans)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mask_zero", [True, False])
@pytest.mark.parametrize("p", [1.0, 0.5])
def test_specaug_matches_aps_tpu_on_its_mask(monkeypatch, mask_zero, p):
    """SpecAugTransform with aps_tpu's mask (augment.tf_mask through
    jax.random) and coin fed in, zero fill and mean fill (the mean of the
    whole padded batch)."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((8, 120, 80)).astype(np.float32) + 0.3
    kw = dict(p=p, adaptive_args=(0.05, 0.05), time_args=(100, 20),
              freq_args=(20, 2), maxp_time=1.0, mask_zero=mask_zero)
    with jax_draws(monkeypatch) as seen:
        want = jax_asr.SpecAugTransform(**kw).apply(
            {}, jnp.asarray(x), training=True,
            rngs={"aug": jax.random.PRNGKey(7)})
    (mask,), (coin,) = seen["masks"], seen["coins"]
    assert mask.shape == x.shape and 0 < mask.mean() < 1
    coin = torch.from_numpy(coin < p)
    if p < 1:
        assert 0 < int(coin.sum()) < len(coin)
    got = SpecAugTransform(**kw)(torch.from_numpy(x),
                                 (torch.from_numpy(mask), coin))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("branch", [0, 1, 2])
def test_recipe_transform_in_training_matches_aps_tpu(monkeypatch, branch):
    """perturb-fbank-log-cmvn-aug with int16 rescale and the recipe's
    SpecAugment in training mode, with aps_tpu's branch and masks fed into
    the port: features and frame counts."""
    wav, lens = ragged_batch(4)
    jtf = jax_asr.FeatureTransform(**RECIPE)
    with jax_draws(monkeypatch, branch) as seen:
        want, want_nf = jtf.apply({}, jnp.asarray(wav), jnp.asarray(lens),
                                  training=True,
                                  rngs={"aug": jax.random.PRNGKey(2)})
    (mask,), (coin,) = seen["masks"], seen["coins"]
    tf = AsrTransform(**RECIPE)
    tf.perturb.draw = lambda generator: branch
    tf.specaug.draw = lambda x, generator: (torch.from_numpy(mask),
                                            torch.from_numpy(coin < 1))
    got, got_nf = tf(torch.from_numpy(wav), torch.from_numpy(lens),
                     training=True)
    np.testing.assert_array_equal(got_nf.numpy(), np.asarray(want_nf))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LOGMEL_ATOL)
    # the fill is the batch's mean, not 0 (aug_mask_zero: false)
    filled = mask == 0
    assert filled.any() and np.all(np.asarray(want)[filled] ==
                                   np.asarray(want)[filled][0])


def test_port_draws_statistics():
    """The port's own draws over many batches: durations in [1, max_steps),
    at most the capped number of spans, each branch a third of the
    batches within 5 points, the coin at its rate."""
    gen = torch.Generator().manual_seed(11)
    T, F = 300, 80
    max_bands, max_frame, num_time = augment.mask_limits(
        (T, F), pm=0.05, ps=0.05, max_bands=30, max_frame=100,
        num_time_masks=20)
    assert (max_bands, max_frame, num_time) == (30, 15, 15)
    dur, start = augment.draw_spans(4000, T, max_frame, num_time, gen)
    assert dur.shape == (4000, num_time)
    assert int(dur.min()) == 1 and int(dur.max()) == max_frame - 1
    assert float(start.min()) >= 0 and float(start.max()) < 1
    counts = torch.bincount(dur.flatten(), minlength=max_frame)[1:]
    assert float(counts.min()) > 0.8 * float(counts.float().mean())
    # each utterance's time mask: at most num_time spans of < max_frame
    tmask = augment.random_mask(4000, T, (dur, start))
    zeros = (tmask == 0).sum(-1)
    assert int(zeros.max()) <= num_time * (max_frame - 1)
    runs = ((tmask[:, 1:] == 0) & (tmask[:, :-1] == 1)).sum(-1) + \
        (tmask[:, 0] == 0)
    assert int(runs.max()) <= num_time and int(runs.min()) >= 1
    # the branch: uniform over the two factors and the identity
    layer = SpeedPerturbTransform(sr=16000, perturb=FACTORS)
    branches = torch.tensor([layer.draw(gen) for _ in range(3000)])
    shares = torch.bincount(branches, minlength=3).float() / 3000
    assert torch.all((shares - 1 / 3).abs() < 0.05), shares
    # the coin of each utterance
    aug = SpecAugTransform(p=0.3, time_args=(40, 2), freq_args=(20, 2))
    x = torch.zeros((2000, T, F))
    mask, coin = aug.draw(x, gen)
    assert abs(coin.float().mean().item() - 0.3) < 0.05
    assert mask.shape == (2000, T, F)
