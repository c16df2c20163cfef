#!/usr/bin/env python
"""PyTorch port, front end: the fused log-mel (K1) and the fbank-log-cmvn
transform against aps_tpu on the same numpy inputs."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from aps_tpu.const import EPSILON  # noqa: E402
from aps_tpu.ops.pallas import fbank as jax_fbank  # noqa: E402
from aps_tpu.transform import AsrTransform as JaxAsrTransform  # noqa: E402
from aps_tpu.transform import utils as jax_utils  # noqa: E402
from aps_tpu_torch.ops import fbank  # noqa: E402
from aps_tpu_torch.transform import utils as port_utils  # noqa: E402
from aps_tpu_torch.transform.asr import AsrTransform  # noqa: E402

# log-mel features: float32 512-term DFT sums taken in another order than
# XLA's, then a log (the bound the JAX package holds its own fused kernel
# to against the layered path)
LOGMEL_ATOL = 1e-3
# log-spectrogram (no mel averaging): the log of a single DFT bin near a
# spectral zero magnifies the rounding of its sum; aps_tpu's own interpret
# kernel and plain reference differ by 2.9e-3 on these inputs
LOGSPEC_ATOL = 5e-3


def _geometry(mode, frame_len):
    fft_size = jax_utils.fft_size_of(frame_len, True)
    win = jax_utils.make_window("hamm", frame_len, True, mode)
    mel = jax_utils.mel_filter(frame_len, round_pow_of_two=True, sr=16000,
                               num_mels=40).T
    return fft_size, win, mel


@pytest.mark.parametrize("mode,frame_len,frame_hop", [("librosa", 400, 160),
                                                      ("kaldi", 400, 160),
                                                      ("librosa", 512, 256)])
def test_dsp_helpers_match_jax(mode, frame_len, frame_hop):
    """Window, mel matrix and frame counts are the same numbers."""
    np.testing.assert_array_equal(
        port_utils.make_window("hamm", frame_len, True, mode),
        jax_utils.make_window("hamm", frame_len, True, mode))
    np.testing.assert_array_equal(
        port_utils.mel_filter(frame_len, num_mels=40, fmin=20, fmax=7600),
        jax_utils.mel_filter(frame_len, num_mels=40, fmin=20, fmax=7600))
    for n in (16000, 12345):
        assert port_utils.num_frames(n, frame_len, frame_hop, True, mode) \
            == jax_utils.num_frames(n, frame_len, frame_hop, True, mode)


@pytest.mark.parametrize(
    "mode,with_mel,pre_emphasis,normalized,use_power,log_lower_bound", [
        ("librosa", True, 0.97, False, False, 0.0),
        ("librosa", False, 0.97, False, False, 0.0),
        ("kaldi", True, 0.0, False, False, 0.0),
        ("kaldi", True, 0.97, True, True, 1.0),
    ])
def test_fused_logmel_plain_matches_jax(mode, with_mel, pre_emphasis,
                                        normalized, use_power,
                                        log_lower_bound):
    """The port's fused_logmel (plain version on CPU) == aps_tpu's Pallas
    kernel in interpret mode and its plain _reference."""
    rng = np.random.default_rng(11)
    wav = (0.1 * rng.standard_normal((2, 9000))).astype(np.float32)
    fft_size, win, mel = _geometry(mode, 400)
    mel = mel if with_mel else None
    kw = dict(pre_emphasis=pre_emphasis, use_power=use_power,
              log_lower_bound=log_lower_bound, log_eps=EPSILON)
    got = fbank.fused_logmel(torch.from_numpy(wav),
                             fbank.operands(win, fft_size, mel, normalized),
                             160, **kw)
    want = jax_fbank.fused_logmel(jnp.asarray(wav), win, fft_size, 160,
                                  mel=mel, normalized=normalized,
                                  interpret=True, **kw)
    ref = jax_fbank._reference(jnp.asarray(wav), win, fft_size, 160, mel,
                               pre_emphasis, normalized, use_power, 0.0,
                               log_lower_bound, EPSILON)
    atol = LOGMEL_ATOL if with_mel else LOGSPEC_ATOL
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=atol)


@pytest.mark.parametrize("norm_mean,norm_var,norm_per_band",
                         [(True, True, True), (True, True, False),
                          (False, True, True)])
def test_fbank_log_cmvn_transform_matches_jax(norm_mean, norm_var,
                                              norm_per_band):
    """fbank-log-cmvn on a zero-padded batch with ragged lengths: the port
    (fused path) == aps_tpu's layered transform, frames and frame counts,
    with the masked CMVN statistics."""
    rng = np.random.default_rng(12)
    lens = np.array([16000, 12000, 9100])
    wav = np.zeros((3, 16000), dtype=np.float32)
    for i, n in enumerate(lens):
        wav[i, :n] = 0.1 * rng.standard_normal(n)
    kw = dict(feats="fbank-log-cmvn", frame_len=400, frame_hop=160,
              window="hamm", norm_mean=norm_mean, norm_var=norm_var,
              norm_per_band=norm_per_band)
    jtf = JaxAsrTransform(**kw)
    variables = jtf.init({"params": jax.random.PRNGKey(0)},
                         jnp.asarray(wav), jnp.asarray(lens))
    want, want_nf = jtf.apply(variables, jnp.asarray(wav), jnp.asarray(lens))
    got, got_nf = AsrTransform(**kw)(torch.from_numpy(wav),
                                     torch.from_numpy(lens))
    np.testing.assert_array_equal(got_nf.numpy(), np.asarray(want_nf))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LOGMEL_ATOL)


def test_transform_refuses_what_is_not_ported():
    """Every pipeline the port once refused now builds and equals
    aps_tpu's on the same waveforms (LOGMEL_ATOL; mfcc's DCT mixes the
    bands, splice repeats them); a missing gcmvn file warns and normalises
    by zeros and ones, as in aps_tpu; an unknown token raises as there."""
    rng = np.random.default_rng(11)
    wav = (0.1 * rng.standard_normal((2, 4000))).astype(np.float32)
    lens = np.array([4000, 3100], dtype=np.int32)
    for feats in ("spectrogram-mel-log", "fbank-log-splice", "mfcc",
                  "fbank-cmvn", "emph-spectrogram-trans-trans-pow-log"):
        jtf = JaxAsrTransform(feats=feats)
        variables = jtf.init({"params": jax.random.PRNGKey(0)},
                             jnp.asarray(wav), jnp.asarray(lens))
        want, want_nf = jtf.apply(variables, jnp.asarray(wav),
                                  jnp.asarray(lens))
        tf = AsrTransform(feats=feats)
        got, got_nf = tf(torch.from_numpy(wav), torch.from_numpy(lens))
        assert tf.dim() == jtf.bind(variables).dim() == got.shape[-1]
        np.testing.assert_array_equal(got_nf.numpy(), np.asarray(want_nf))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=LOGMEL_ATOL, err_msg=feats)
    with pytest.warns(UserWarning, match="gcmvn.npy not found"):
        tf = AsrTransform(feats="fbank-log-cmvn", gcmvn="gcmvn.npy")
    assert torch.equal(tf.cmvn.gmean, torch.zeros(80))
    assert torch.equal(tf.cmvn.gstd, torch.ones(80))
    with pytest.raises(RuntimeError, match="Unknown token"):
        AsrTransform(feats="fbank-log-cepstrum")
    # perturb and aug are identities at inference and run in training
    tf = AsrTransform(feats="perturb-fbank-log-cmvn-aug")
    wav = torch.zeros((1, 4000))
    feats, _ = tf(wav, torch.tensor([4000]))
    assert feats.shape == (1, (4000 - 512) // 160 + 1, 80)
    feats, _ = tf(wav, torch.tensor([4000]), training=True)
    assert feats.shape == (1, (4000 - 512) // 160 + 1, 80)


def test_fused_logmel_caches_its_device_operands(monkeypatch):
    """The transform makes K1's operands (the window, the mel matrix, its
    bands and the twiddle table) once for a device and hands the same ones
    to every call, so a repeated call copies nothing from the host; the
    bands hold each filter's nonzero coefficients in the kernel's layout."""
    tf = AsrTransform(feats="fbank-log", frame_len=400, frame_hop=160,
                      window="hamm")
    made = []
    real = fbank.operands

    def counted(*args, **kwargs):
        made.append(real(*args, **kwargs))
        return made[-1]

    cpu = torch.device("cpu")
    wav = torch.from_numpy(
        (0.1 * np.random.default_rng(4).standard_normal((2, 4000))).astype(
            np.float32))
    monkeypatch.setattr(fbank, "operands", counted)
    first, _ = tf(wav)
    again, _ = tf(wav)
    assert len(made) == 1
    assert tf.fbank_operands(cpu) is made[0]
    torch.testing.assert_close(first, again, atol=0, rtol=0)
    mel = np.asarray(tf.mel, np.float32)
    vals, bands = fbank.band_tables(mel)
    lo, hi = fbank.mel_bands(mel)
    np.testing.assert_array_equal(bands, np.stack(
        [lo, hi, np.concatenate([[0], np.cumsum(hi - lo)[:-1]])], -1))
    for m, (a, b, off) in enumerate(bands):
        np.testing.assert_array_equal(vals[off:off + b - a], mel[a:b, m])
        assert not mel[:a, m].any() and not mel[b:, m].any()
