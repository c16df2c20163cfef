#!/usr/bin/env python
"""PyTorch port, the feature grammar of aps_tpu_torch/transform/asr.py
against aps_tpu's FeatureTransform on JAX's CPU: every token (spectrogram,
fbank, mfcc, emph, trans, pow, mel, log, abs, dct, cmvn, splice, delta,
perturb at inference) and the options center, stft_normalized, stft_mode,
use_power, log_lower_bound, lifter, num_ceps, subsampling_factor,
mel_matrix, requires_grad (the filterbank's gradient too) and gcmvn from a
.npy and a Kaldi .ark. The output, num_frames and dim() are held, and a
padded batch against each utterance alone. The converter carries a
learnable filterbank and the global statistics both ways."""

import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from aps_tpu.transform import AsrTransform as JaxAsrTransform  # noqa: E402
from aps_tpu_torch import convert  # noqa: E402
from aps_tpu_torch.loader import kaldi_io  # noqa: E402
from aps_tpu_torch.transform.asr import AsrTransform  # noqa: E402

# float32 features of both packages after an STFT of 512 terms summed in
# another order (and, for mfcc, a DCT over the bands): log-domain values
# of O(1-10) agree to ~1e-4; the tolerance leaves a factor of ten
ATOL, RTOL = 1e-3, 1e-4
# a learnable filterbank's gradient sums over every frame and utterance
GRAD_RTOL = 1e-4
S = 6000
LENS = np.array([S, S - 700, S - 1900], dtype=np.int32)

CASES = [
    ("spectrogram-log", {}),
    ("spectrogram-log", {"center": True}),
    ("spectrogram-log-cmvn", {"stft_normalized": True, "stft_mode": "kaldi",
                              "use_power": True}),
    ("fbank-log-cmvn", {"center": True}),
    ("fbank-log", {"log_lower_bound": 1.0, "num_mels": 40}),
    ("mfcc", {"lifter": 22}),
    ("mfcc-cmvn", {"num_ceps": 20, "num_mels": 40, "norm_per_band": False}),
    ("mfcc-cmvn-splice", {"lctx": 2, "rctx": 2, "subsampling_factor": 3}),
    ("perturb-mfcc-cmvn-splice", {"subsampling_factor": 1}),
    ("emph-fbank-log-cmvn", {"pre_emphasis": 0.9}),
    ("spectrogram-pow-mel-log-dct-delta", {"num_mels": 40}),
    ("spectrogram-trans-trans-abs-log-cmvn", {"norm_var": False}),
    ("fbank-log-cmvn-splice-delta", {"lctx": 1, "rctx": 1,
                                     "num_mels": 40}),
]


def _wave(seed: int = 3, lens=LENS) -> np.ndarray:
    rng = np.random.default_rng(seed)
    wav = np.zeros((len(lens), int(max(lens))), dtype=np.float32)
    for i, n in enumerate(lens):
        wav[i, :n] = 0.1 * rng.standard_normal(n)
    return wav


def _jax(kw, wav, lens, variables=None):
    """aps_tpu's output, frame counts, dim() and variables."""
    jtf = JaxAsrTransform(**kw)
    if variables is None:
        variables = jtf.init({"params": jax.random.PRNGKey(0)},
                             jnp.asarray(wav), jnp.asarray(lens))
    out, nf = jtf.apply(variables, jnp.asarray(wav), jnp.asarray(lens))
    return np.asarray(out), np.asarray(nf), jtf.bind(variables).dim(), \
        variables


def _margin(feats: str, kw: dict) -> int:
    """Output frames at the end of an utterance that see its padding in a
    batch: the splice's and the deltas' right context (edges clamped at
    the batch's end, not the utterance's)."""
    toks = feats.split("-")
    frames = kw.get("rctx", 1) if "splice" in toks else 0
    if "delta" in toks:
        frames += 2 * 2
    return -(-frames // kw.get("subsampling_factor", 1))


@pytest.mark.parametrize("feats,opts", CASES)
def test_feature_pipeline_matches_jax(feats, opts):
    """Output, num_frames and dim() == aps_tpu's on a padded batch; each
    utterance alone == its row of the batch over its valid frames (but
    the ones that see the batch's padding through a splice or delta, and
    a centred STFT's, whose reflection differs)."""
    kw = dict(feats=feats, **opts)
    wav = _wave()
    want, want_nf, want_dim, _ = _jax(kw, wav, LENS)
    tf = AsrTransform(**kw)
    got, got_nf = tf(torch.from_numpy(wav), torch.from_numpy(LENS))
    assert tf.dim() == want_dim == got.shape[-1]
    assert tf.accept_raw
    np.testing.assert_array_equal(got_nf.numpy(), want_nf)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL,
                               err_msg=feats)
    if opts.get("center"):
        return
    margin = _margin(feats, opts)
    for i, n in enumerate(LENS):
        solo, solo_nf = tf(torch.from_numpy(wav[i:i + 1, :n]),
                           torch.from_numpy(LENS[i:i + 1]))
        keep = int(solo_nf[0]) - margin
        assert int(solo_nf[0]) == int(got_nf[i])
        np.testing.assert_allclose(solo[0, :keep].numpy(),
                                   got[i, :keep].numpy(), atol=1e-5,
                                   rtol=1e-5, err_msg=f"{feats} [{i}]")


def _mel_matrix(path, num_mels: int = 40, bins: int = 257) -> str:
    rng = np.random.default_rng(5)
    mel = np.abs(rng.standard_normal((num_mels, bins))).astype(np.float32)
    np.save(path, mel * (rng.random((num_mels, bins)) < 0.1))
    return str(path)


def test_mel_matrix_from_npy(tmp_path):
    """mel_matrix: the filterbank of a .npy (num_mels x F) in the layered
    fbank and the mel token after a spectrum."""
    mel = _mel_matrix(tmp_path / "mel.npy")
    wav = _wave(4)
    for feats in ("fbank-log-cmvn", "spectrogram-mel-log"):
        kw = dict(feats=feats, mel_matrix=mel, num_mels=40)
        want, want_nf, want_dim, _ = _jax(kw, wav, LENS)
        tf = AsrTransform(**kw)
        assert tf.fused is None
        got, got_nf = tf(torch.from_numpy(wav), torch.from_numpy(LENS))
        assert tf.dim() == want_dim
        np.testing.assert_array_equal(got_nf.numpy(), want_nf)
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def test_learnable_filterbank_matches_jax():
    """requires_grad (with center): the filterbank is a parameter named
    filters at aps_tpu's path (asr_transform's layers_4 here), moved from
    its initial value, carried to aps_tpu by the converter; the output
    and the filterbank's gradient of sum(out * w) == aps_tpu's."""
    kw = dict(feats="fbank-log-cmvn", requires_grad=True, center=True,
              num_mels=40)
    wav = _wave(6)
    tf = AsrTransform(**kw)
    assert [k for k, _ in tf.named_parameters()] == ["layers_4.filters"]
    with torch.no_grad():
        gen = torch.Generator().manual_seed(0)
        tf.layers_4.filters.mul_(
            1 + 0.2 * torch.rand(tf.layers_4.filters.shape, generator=gen))
    variables = convert.to_variables(tf)
    assert set(variables) == {"params"}
    want, want_nf, _, _ = _jax(kw, wav, LENS, variables)
    got, got_nf = tf(torch.from_numpy(wav), torch.from_numpy(LENS))
    np.testing.assert_array_equal(got_nf.numpy(), want_nf)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=ATOL,
                               rtol=RTOL)
    w = np.random.default_rng(7).standard_normal(want.shape).astype(
        np.float32)
    (got * torch.from_numpy(w)).sum().backward()
    jtf = JaxAsrTransform(**kw)

    def loss(params):
        out, _ = jtf.apply({"params": params}, jnp.asarray(wav),
                           jnp.asarray(LENS))
        return jnp.sum(out * w)

    want_grad = np.asarray(jax.grad(loss)(
        jax.tree_util.tree_map(jnp.asarray, variables["params"]))
        ["layers_4"]["filters"])
    got_grad = tf.layers_4.filters.grad.numpy()
    assert np.abs(want_grad).max() > 0
    np.testing.assert_allclose(
        got_grad, want_grad, rtol=0,
        atol=GRAD_RTOL * np.abs(want_grad).max() * 10)


def _write_stats(tmp_path, kind: str, dim: int = 40) -> str:
    rng = np.random.default_rng(8)
    if kind == "npy":
        path = tmp_path / "gcmvn.npy"
        np.save(path, np.stack([rng.standard_normal(dim),
                                0.5 + rng.random(dim)]).astype(np.float32))
        return str(path)
    # Kaldi's CMVN statistics: sums and squares over `cnt` frames, the count
    # in the last column of the first row
    cnt = 500.0
    mean = rng.standard_normal(dim)
    sqr = (mean**2 + (0.5 + rng.random(dim))**2) * cnt
    stats = np.zeros((2, dim + 1))
    stats[0, :-1], stats[0, -1], stats[1, :-1] = mean * cnt, cnt, sqr
    path = tmp_path / "cmvn.ark"
    with open(path, "wb") as fd:
        fd.write(b"global ")
        kaldi_io.write_binary_mat(fd, stats)
    return str(path)


@pytest.mark.parametrize("kind", ["npy", "ark"])
def test_global_cmvn_matches_jax(tmp_path, kind):
    """gcmvn from a (2, D) .npy of [mean; std] or a Kaldi .ark of sums,
    squares and the count: == aps_tpu's output, with norm_var off too;
    the statistics are buffers of the state, so a transform built where
    the file is missing (zeros and ones, with a warning) gets them back
    from a state_dict."""
    stats = _write_stats(tmp_path, kind)
    wav = _wave(9)
    for norm_var in (True, False):
        kw = dict(feats="fbank-log-cmvn", num_mels=40, gcmvn=stats,
                  norm_var=norm_var)
        want, want_nf, _, _ = _jax(kw, wav, LENS)
        tf = AsrTransform(**kw)
        got, got_nf = tf(torch.from_numpy(wav), torch.from_numpy(LENS))
        np.testing.assert_array_equal(got_nf.numpy(), want_nf)
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    state = tf.state_dict()
    assert sorted(state) == ["layers_6.gmean", "layers_6.gstd"]
    with pytest.warns(UserWarning, match="not found"):
        blank = AsrTransform(**dict(kw, gcmvn=str(tmp_path / "none.npy")))
    blank.load_state_dict(state)
    torch.testing.assert_close(
        blank(torch.from_numpy(wav), torch.from_numpy(LENS))[0], got,
        atol=0, rtol=0)


def test_converter_carries_filters_and_global_statistics(tmp_path):
    """to_variables -> to_state_dict round trip of a learnable filterbank
    (params) and a global CMVN (the "constants" collection); a tree
    without the statistics (aps_tpu's) keeps the model's own; aps_tpu's
    apply takes the port's tree, constants included, and gives the port's
    output."""
    stats = _write_stats(tmp_path, "npy")
    kw = dict(feats="fbank-log-cmvn", num_mels=40, requires_grad=True,
              gcmvn=stats)
    tf = AsrTransform(**kw)
    with torch.no_grad():
        tf.layers_4.filters.mul_(1.5)
    variables = convert.to_variables(tf)
    assert sorted(variables) == ["constants", "params"]
    assert sorted(variables["constants"]["layers_6"]) == ["gmean", "gstd"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        other = AsrTransform(**dict(kw, gcmvn=str(tmp_path / "none.npy")))
    other.load_state_dict(convert.to_state_dict(variables, other))
    for key, val in tf.state_dict().items():
        assert torch.equal(other.state_dict()[key], val), key
    own = AsrTransform(**kw)
    own.load_state_dict(convert.to_state_dict(
        {"params": variables["params"]}, own))
    assert torch.equal(own.layers_6.gmean, tf.layers_6.gmean)
    wav = _wave(10)
    want, _, _, _ = _jax(kw, wav, LENS, variables)
    got, _ = tf(torch.from_numpy(wav), torch.from_numpy(LENS))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("feats", ["fbank-log-cmvn", "mfcc-cmvn",
                                   "spectrogram-log-cmvn"])
def test_skip_stft_takes_the_layered_chain(feats):
    """skip_stft (the enh transform's route): an STFT the caller made goes
    through the steps after the STFT, the fbank-log pair too (layered, not
    K1), and equals the waveform's features (cmvn over every frame both
    ways); inp_len comes back as it is."""
    from aps_tpu_torch.transform.utils import forward_stft
    wav = torch.from_numpy(_wave(12, lens=[S, S]))
    tf = AsrTransform(feats=feats)
    stft = forward_stft(wav, 400, 160, window="hamm", pre_emphasis=0.97)
    got, lens = tf(stft, "lengths", skip_stft=True)
    assert lens == "lengths"
    want, _ = tf(wav, None)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)
    with pytest.raises(ValueError, match="skip_stft"):
        AsrTransform(feats="abs-mel-log")(stft.abs(), None, skip_stft=True)
