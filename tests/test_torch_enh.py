#!/usr/bin/env python
"""PyTorch port, the frequency-domain front end: forward_stft and
inverse_stft (complex64) against aps_tpu's packed pairs, the enh
transform's STFT and features, and StackedRNN (the mask estimator of
sse@base_rnn) on converted weights, with its dropout held by statistics."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from aps_tpu import libs as jax_libs  # noqa: E402
from aps_tpu.asr.base.rnn import StackedRNN as JaxStackedRNN  # noqa: E402
from aps_tpu.transform import utils as jax_utils  # noqa: E402
from aps_tpu_torch.asr.base.rnn import StackedRNN  # noqa: E402
from aps_tpu_torch.const import EPSILON  # noqa: E402
from aps_tpu_torch.convert import to_state_dict, to_variables  # noqa: E402
from aps_tpu_torch.libs import aps_transform  # noqa: E402
from aps_tpu_torch.transform import utils  # noqa: E402

# the STFT: float32 sums of up to 512 products in another order (an FFT
# against aps_tpu's DFT products), relative to the largest entry
STFT_RTOL = 1e-5
# features: a log of those magnitudes, then normalised over time; relative
# to the largest entry where that is above 1 (an unnormalised power
# spectrogram)
FEATS_ATOL = 1e-4
# the stacked RNN: O(1) outputs through two layers of float32 recurrences
RNN_ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this file runs: oneDNN's CPU LSTM, which
    torch takes for nn.LSTM, spins its threads and slows down 100-fold
    when other processes load the cores (as the suite's other workers
    do): 8 s a pass against 0.01 s with one thread, measured so."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _signal(seed, shape):
    rng = np.random.default_rng(seed)
    t = np.arange(shape[-1]) / 16000
    tone = 0.5 * np.sin(2 * np.pi * 440 * t) * np.sin(2 * np.pi * 3 * t)
    return (tone + 0.1 * rng.standard_normal(shape)).astype(np.float32)


def _close(got, want, rtol, what):
    scale = np.abs(want).max()
    assert scale > 0, what
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale,
                               err_msg=what)


def _ola_window(window, frame_len, hop, frames, mode, center):
    """The overlap-added squared window that inverse_stft divides by,
    in numpy."""
    win = jax_utils.make_window(window, frame_len, True, mode).astype(
        np.float64)
    W = win.size
    out = np.zeros((frames - 1) * hop + W)
    for t in range(frames):
        out[t * hop:t * hop + W] += win**2
    if center:
        out = out[W // 2:-(W // 2)]
    return out


STFT_CASES = [
    # (mode, center, window, normalized, onesided, frame_len, pre_emphasis)
    (mode, center, window, False, True, 512, 0.0)
    for mode in ("librosa", "kaldi") for center in (False, True)
    for window in ("sqrthann", "hann")
] + [
    ("librosa", True, "sqrthann", True, True, 512, 0.0),
    ("librosa", False, "hann", False, False, 512, 0.0),
    ("kaldi", False, "hamm", True, False, 400, 0.97),
    ("librosa", False, "hamm", False, True, 400, 0.97),
]


@pytest.mark.parametrize("mode,center,window,normalized,onesided,frame_len,"
                         "pre_emphasis", STFT_CASES)
def test_stft_and_istft_match_jax(mode, center, window, normalized, onesided,
                                  frame_len, pre_emphasis):
    """forward_stft through view_as_real against aps_tpu's packed pair, and
    inverse_stft of the same spectrum: the overlap-added frames (the
    quotient's numerator) everywhere, the waveform where the squared
    window's sum is not ill-conditioned (uncentred hann frames start with
    a window of ~1e-5, whose square over itself amplifies rounding)."""
    hop = 160
    wav = _signal(0, (2, 3, 4000))
    kw = dict(window=window, center=center, mode=mode, normalized=normalized,
              onesided=onesided)
    want = np.asarray(jax_utils.forward_stft(
        jnp.asarray(wav), frame_len, hop, pre_emphasis=pre_emphasis, **kw))
    got = utils.forward_stft(torch.from_numpy(wav), frame_len, hop,
                             pre_emphasis=pre_emphasis, **kw)
    assert got.dtype == torch.complex64
    assert got.shape == want.shape[:-1]
    _close(torch.view_as_real(got).numpy(), want, STFT_RTOL, "stft")

    spec = want[0]
    want = np.asarray(jax_utils.inverse_stft(jnp.asarray(spec), frame_len,
                                             hop, **kw))
    got = utils.inverse_stft(torch.view_as_complex(torch.tensor(spec)),
                             frame_len, hop, **kw).numpy()
    assert got.shape == want.shape
    denorm = _ola_window(window, frame_len, hop, spec.shape[-2], mode,
                         center)
    assert denorm.shape[-1] == want.shape[-1]
    _close(got * (denorm + EPSILON), want * (denorm + EPSILON), STFT_RTOL,
           "istft numerator")
    ok = denorm > 1e-2
    _close(got[..., ok], want[..., ok], STFT_RTOL, "istft")


def test_polar_stft_round_trip():
    """return_polar: the magnitude (with eps) as aps_tpu's, the phase as
    the same point on the circle (a DC bin may read pi on one side and -pi
    on the other), and the inverse of the polar pair."""
    wav = _signal(1, (2, 4000))
    kw = dict(window="sqrthann", center=True, return_polar=True)
    want = np.array(jax_utils.forward_stft(jnp.asarray(wav), 512, 256, **kw))
    got = utils.forward_stft(torch.from_numpy(wav), 512, 256, **kw).numpy()
    _close(got[..., 0], want[..., 0], STFT_RTOL, "magnitude")
    for fn in (np.cos, np.sin):
        _close(got[..., 0] * fn(got[..., 1]), want[..., 0] * fn(want[..., 1]),
               STFT_RTOL, f"{fn.__name__} of the phase")
    back = utils.inverse_stft(torch.tensor(want), 512, 256, **kw)
    ref = np.asarray(jax_utils.inverse_stft(jnp.asarray(want), 512, 256,
                                            **kw))
    _close(back.numpy(), ref, STFT_RTOL, "polar istft")
    # the centred round trip gives the signal back away from its ends
    inner = slice(512, 3584)
    _close(back.numpy()[:, inner], wav[:, inner], STFT_RTOL, "round trip")


def test_frame_signal_and_overlap_add_match_jax():
    x = _signal(2, (3, 1000))
    frames = utils.frame_signal(torch.from_numpy(x), 64, 24)
    want = np.asarray(jax_utils.frame_signal(jnp.asarray(x), 64, 24))
    np.testing.assert_array_equal(frames.numpy(), want)
    np.testing.assert_allclose(
        utils.overlap_add(frames, 24).numpy(),
        np.asarray(jax_utils.overlap_add(jnp.asarray(want), 24)),
        atol=1e-6)


ENH_CASES = [
    dict(feats="spectrogram-log-cmvn", frame_len=512, frame_hop=256,
         center=True),
    dict(feats="spectrogram-log-cmvn", frame_len=400, frame_hop=160,
         window="hann", stft_mode="kaldi", norm_per_band=False),
    dict(feats="spectrogram", frame_len=256, frame_hop=64, use_power=True),
    dict(feats="spectrogram-log", frame_len=256, frame_hop=128,
         log_lower_bound=1.0, stft_normalized=True),
    dict(feats="spectrogram-log-cmvn", frame_len=256, frame_hop=128,
         ref_channel=1, center=True),
]


@pytest.mark.parametrize("conf", ENH_CASES)
def test_enh_transform_matches_jax(conf):
    """encode (the complex STFT), the features of the reference channel,
    decode, the frame count and the dimension against aps_tpu's enh
    transform."""
    wav = _signal(3, (2, 2, 6000) if "ref_channel" in conf else (2, 6000))
    jtr = jax_libs.aps_transform("enh")(**conf)
    ttr = aps_transform("enh")(**conf)

    def jax_call(method, *args):
        return jtr.apply({}, *args, method=method)

    want_stft, want_nf = jax_call(jtr.encode, jnp.asarray(wav),
                                  jnp.asarray([6000, 5000]))
    got_stft, got_nf = ttr.encode(torch.from_numpy(wav),
                                  torch.tensor([6000, 5000]))
    _close(torch.view_as_real(got_stft).numpy(), np.asarray(want_stft),
           STFT_RTOL, "encode")
    np.testing.assert_array_equal(got_nf.numpy(), np.asarray(want_nf))
    want = np.asarray(jax_call(jtr.__call__, want_stft))
    got = ttr(torch.view_as_complex(torch.tensor(np.asarray(want_stft))))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=FEATS_ATOL * max(1, np.abs(want).max()))
    assert ttr.dim() == jax_call(jtr.dim) == want.shape[-1]
    if "ref_channel" in conf:
        return
    want = jax_call(jtr.decode, [want_stft[0]])[0]
    got = ttr.decode([torch.view_as_complex(torch.tensor(
        np.asarray(want_stft[0])))])[0]
    assert got.shape == want.shape
    if conf.get("window") != "hann":  # see test_stft_and_istft_match_jax
        _close(got.numpy(), np.asarray(want), STFT_RTOL, "decode")
    ctx = ttr.ctx("inverse_stft")
    assert ctx.num_bins == want_stft.shape[-3]
    assert ttr.num_frames(6000) == jax_call(jtr.num_frames, 6000)


def test_enh_transform_refuses_the_multi_channel_front_end(tmp_path):
    """The multi-channel front end is ported (tests/test_torch_multichannel.py
    holds it against aps_tpu); what aps_tpu refuses of it, the port
    refuses: IPD features of one channel, an array geometry other than
    "7@", a beam bank whose file holds another number of beams; and an
    unknown task context."""
    from aps_tpu_torch.transform import enh
    ipd = aps_transform("enh")(feats="spectrogram-log-cmvn-ipd",
                               ipd_index="1,0")
    with pytest.raises(ValueError, match="channel"):
        ipd(torch.zeros((2, 1, 257, 4), dtype=torch.complex64))
    with pytest.raises(RuntimeError, match="geometric"):
        enh.DfTransform(geometric="4@")
    np.save(tmp_path / "w.npy", np.zeros((2, 3, 4, 257), np.float32))
    with pytest.raises(RuntimeError, match="Beam number mismatch"):
        enh.FixedBeamformer(5, 4, 257, weight=str(tmp_path / "w.npy"))
    with pytest.raises(ValueError, match="Unknown task context"):
        aps_transform("enh")().ctx("mvdr")


RNN_CASES = [
    # (rnn_type, bidirectional, input_proj, hidden_proj, layer_norm)
    ("lstm", True, -1, -1, False),
    ("lstm", False, -1, -1, False),
    ("lstm", True, 12, 10, True),
    ("gru", True, -1, 6, False),
    ("rnn", False, 12, -1, True),
]


@pytest.mark.parametrize("rnn_type,bidirectional,input_proj,hidden_proj,"
                         "layer_norm", RNN_CASES)
def test_stacked_rnn_matches_jax(rnn_type, bidirectional, input_proj,
                                 hidden_proj, layer_norm):
    """StackedRNN of two layers at eval (dropout set, so inert) against
    aps_tpu's on converted weights, and the converter's round trip."""
    conf = dict(num_layers=2, rnn_type=rnn_type, bidirectional=bidirectional,
                dropout=0.3, input_proj=input_proj, hidden_proj=hidden_proj,
                layer_norm=layer_norm)
    x = np.random.default_rng(4).standard_normal((3, 17, 9)).astype(
        np.float32)
    jnet = JaxStackedRNN(8, **conf)
    variables = jax.tree_util.tree_map(
        np.array, dict(jnet.init(jax.random.PRNGKey(0), jnp.asarray(x))))
    # non-zero biases everywhere (flax starts them at zero)
    rng = np.random.default_rng(5)
    for leaf in jax.tree_util.tree_leaves(variables):
        leaf += 0.1 * rng.standard_normal(leaf.shape).astype(leaf.dtype)
    net = StackedRNN(9, 8, **conf)
    net.load_state_dict(to_state_dict(variables, net))
    net.eval()
    want = np.asarray(jnet.apply(variables, jnp.asarray(x), training=False))
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=RNN_ATOL)
    back = to_variables(net)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(variables)
    for (path, a), (_, b) in zip(
            sorted(jax.tree_util.tree_leaves_with_path(back), key=str),
            sorted(jax.tree_util.tree_leaves_with_path(variables),
                   key=str)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-7,
                                   err_msg=str(path))


def test_stacked_rnn_dropout_by_statistics():
    """Dropout (no torch draw can equal jax's) runs on every layer's output
    but the last, after the projection and the layer norm: about p of the
    entries are 0 and the others scaled by 1 / (1 - p); none at eval."""
    p, layers = 0.3, 3
    net = StackedRNN(9, 16, num_layers=layers, bidirectional=True,
                     dropout=p, hidden_proj=12, layer_norm=True)
    seen = []
    net.drop.register_forward_hook(
        lambda mod, inp, out: seen.append((inp[0].detach(), out.detach())))
    x = torch.randn(8, 50, 9, generator=torch.Generator().manual_seed(0))
    net.train()
    net(x)
    assert len(seen) == layers - 1
    for inp, out in seen:
        assert inp.shape[-1] == 12
        zero = (out == 0).double().mean().item()
        n = out.numel()
        assert abs(zero - p) < 4 * np.sqrt(p * (1 - p) / n), zero
        kept = out != 0
        torch.testing.assert_close(out[kept], inp[kept] / (1 - p))
    seen.clear()
    net.eval()
    with torch.no_grad():
        net(x)
    assert all(torch.equal(a, b) for a, b in seen)
