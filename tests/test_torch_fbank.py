#!/usr/bin/env python
"""PyTorch port, K1 (csrc/fbank.cu): a numpy emulation of the kernel's
algorithm (the same packing of a frame into half as many complex points, the
same Stockham stages in the order the wrapper passes them (`radices`), the
twiddle table and the mel bands the wrapper builds, the split step and the
mel product over each filter's band) against the port's plain version and
aps_tpu's fused_logmel, at the flagship's front end and at other sizes whose
prime factors are 2, 3 and 5; the bands of every mel filterbank the recipes
use; the sizes the kernel refuses. The kernel itself runs only on the card
(tests/test_torch_kernels_cuda.py)."""

from pathlib import Path

import numpy as np
import pytest
import yaml

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from aps_tpu.const import EPSILON  # noqa: E402
from aps_tpu.ops.pallas import fbank as jax_fbank  # noqa: E402
from aps_tpu_torch.ops import fbank  # noqa: E402
from aps_tpu_torch.transform.asr import AsrTransform  # noqa: E402
from aps_tpu_torch.transform.utils import make_window, mel_filter  # noqa

# log-mel features: float32 sums in another order than the dense DFT's,
# then a log (the bound of tests/test_torch_frontend.py)
LOGMEL_ATOL = 1e-3
# without a mel matrix: magnitudes against each frame's peak, as the card
# test holds the kernel (a log-spectrogram bin near a spectral zero is
# ill-conditioned in the log domain)
PEAK_RTOL = 1e-5
# one complex FFT of up to 512 points in float64 against numpy's, relative
# to the largest output
FFT_RTOL = 1e-12

_F32 = np.float32


def _butterfly(v, R):
    """The kernel's radix-R butterflies, y_k = sum_r v_r exp(-2 pi i r k /
    R), written as csrc/fbank.cu writes them."""
    if R == 2:
        return [v[0] + v[1], v[0] - v[1]]
    if R == 4:
        a0, a1 = v[0] + v[2], v[0] - v[2]
        a2, a3 = v[1] + v[3], -1j * (v[1] - v[3])
        return [a0 + a2, a1 + a3, a0 - a2, a1 - a3]
    if R == 3:
        s = np.sin(2 * np.pi / 3)
        t, d = v[1] + v[2], v[1] - v[2]
        m = v[0] - 0.5 * t
        e = -1j * s * d
        return [v[0] + t, m + e, m - e]
    c1, c2 = np.cos(2 * np.pi / 5), np.cos(4 * np.pi / 5)
    s1, s2 = np.sin(2 * np.pi / 5), np.sin(4 * np.pi / 5)
    t1, t2, d1, d2 = v[1] + v[4], v[2] + v[3], v[1] - v[4], v[2] - v[3]
    a1, a2 = v[0] + c1 * t1 + c2 * t2, v[0] + c2 * t1 + c1 * t2
    b1, b2 = s1 * d1 + s2 * d2, s2 * d1 - s1 * d2
    return [v[0] + t1 + t2, a1 - 1j * b1, a2 - 1j * b2, a2 + 1j * b2,
            a1 + 1j * b1]


def _table(n):
    """The wrapper's twiddle table as complex numbers."""
    table = fbank._twiddles(n).numpy()
    return table[:, 0] + 1j * table[:, 1]


def _stockham(z, n, dtype=np.complex128):
    """The kernel's complex FFT of the n/2 points of each row of z: the
    stages the wrapper passes it (fbank.radices(n), read 3 bits a stage as
    the kernel reads them), the twiddles of the wrapper's table, in dtype
    (the kernel's float64 by default)."""
    tw = _table(n).astype(dtype)
    nh = n // 2
    x, Ns = z.astype(dtype), 1
    plan = fbank.radices(n)
    while plan:
        R, plan = plan & 7, plan >> 3
        nb = nh // R
        j = np.arange(nb)
        k = j % Ns
        v = [x[..., j + r * nb] for r in range(R)]
        v = [v[0]] + [v[r] * tw[k * r * (n // (Ns * R))]
                      for r in range(1, R)]
        y = [y.astype(dtype) for y in _butterfly(v, R)]
        out = np.empty_like(x)
        for r in range(R):
            out[..., (j - k) * R + k + r * Ns] = y[r]
        x, Ns = out, Ns * R
    return x


def _emulate(wav, window, fft_size, hop, mel, pre_emphasis, normalized,
             use_power, log_lower_bound, log_eps, mag_eps=0.0,
             dtype=np.complex128):
    """K1 in numpy: frames with the per-frame pre-emphasis head rule and the
    window in float32, zeros to fft_size, packed as fft_size/2 complex
    points, the Stockham FFT and the split step to F bins in dtype (the
    kernel's float64 by default), the power rounded to float32 (or the
    magnitude from it), the mel product over each filter's band [lo, hi),
    the floored log. The bands are the wrapper's own (band_tables)."""
    W = len(window)
    T = (wav.shape[1] - W) // hop + 1
    idx = np.arange(T)[:, None] * hop + np.arange(W)[None, :]
    frames = wav[:, idx].astype(_F32)
    if pre_emphasis > 0:
        p = _F32(pre_emphasis)
        frames = np.concatenate([frames[..., :1] * (1 - p),
                                 frames[..., 1:] - p * frames[..., :-1]], -1)
    win = np.asarray(window, _F32)
    if normalized:
        win = (torch.from_numpy(win) / np.sqrt(fft_size)).numpy()
    x = np.zeros(frames.shape[:-1] + (fft_size,), _F32)
    x[..., :W] = frames * win
    Z = _stockham(x[..., 0::2] + 1j * x[..., 1::2], fft_size, dtype)
    nh = fft_size // 2
    k = np.arange(nh + 1)
    zk, zc = Z[..., k % nh], np.conj(Z[..., (nh - k) % nh])
    w = _table(fft_size)[:nh + 1].astype(dtype)
    X = (0.5 * (zk + zc) + w * (-0.5j * (zk - zc))).astype(dtype)
    power = (X.real * X.real + X.imag * X.imag).astype(_F32)
    feat = power if use_power else np.sqrt(power + _F32(mag_eps))
    if mel is not None:
        vals, bands = fbank.band_tables(mel)
        feat = np.stack([feat[..., lo:hi] @ vals[off:off + hi - lo]
                         for lo, hi, off in bands], -1).astype(_F32)
    if log_lower_bound > 0:
        return np.log(_F32(log_lower_bound) + feat)
    return np.log(np.maximum(feat, _F32(log_eps)))


@pytest.mark.parametrize("fft_size", [256, 320, 400, 480, 512, 1024])
def test_stockham_stages_give_the_dft(fft_size):
    """The stages the wrapper passes the kernel, on its twiddle table,
    compute the complex DFT of fft_size/2 points."""
    rng = np.random.default_rng(fft_size)
    z = rng.standard_normal((3, fft_size // 2)) + \
        1j * rng.standard_normal((3, fft_size // 2))
    got = _stockham(z, fft_size)
    want = np.fft.fft(z, axis=-1)
    assert np.abs(got - want).max() <= FFT_RTOL * np.abs(want).max()


def _front_end(mode, frame_len, round_pow_of_two):
    fft_size = frame_len if not round_pow_of_two else \
        2**int(np.ceil(np.log2(frame_len)))
    win = make_window("hamm", frame_len, round_pow_of_two, mode)
    mel = mel_filter(frame_len, round_pow_of_two=round_pow_of_two,
                     num_mels=40).T
    return fft_size, win, mel


# (stft mode, frame_len, round_pow_of_two): the flagship's front end (a 512
# point FFT of a 400-sample frame centred in a 512-sample window), kaldi's
# (the 400-sample window itself, W < fft_size), and frames of 16, 20, 25,
# 30 and 64 ms at 16 kHz without rounding (fft_size = W)
SIZES = [("librosa", 400, True), ("kaldi", 400, True), ("librosa", 256, False),
         ("librosa", 320, False), ("librosa", 400, False),
         ("librosa", 480, False), ("librosa", 1024, False)]


@pytest.mark.parametrize("mode,frame_len,round_pow_of_two", SIZES)
def test_fft_emulation_matches_plain_and_jax(mode, frame_len,
                                             round_pow_of_two):
    """The emulated kernel == fused_logmel_plain (dense DFT) == aps_tpu's
    fused_logmel in interpret mode and its plain _reference, with a mel
    matrix; without one, magnitudes within PEAK_RTOL of each frame's
    peak."""
    fft_size, win, mel = _front_end(mode, frame_len, round_pow_of_two)
    rng = np.random.default_rng(frame_len)
    wav = (0.1 * rng.standard_normal((2, 6000))).astype(_F32)
    kw = dict(pre_emphasis=0.97, normalized=False, use_power=False,
              log_lower_bound=0.0, log_eps=EPSILON)
    got = _emulate(wav, win, fft_size, 160, mel, **kw)
    plain = fbank.fused_logmel_plain(torch.from_numpy(wav), win, fft_size,
                                     160, mel=mel, **kw).numpy()
    interp = jax_fbank.fused_logmel(jnp.asarray(wav), win, fft_size, 160,
                                    mel=mel, interpret=True, **kw)
    ref = jax_fbank._reference(jnp.asarray(wav), win, fft_size, 160, mel,
                               0.97, False, False, 0.0, 0.0, EPSILON)
    assert got.shape == plain.shape == interp.shape
    for want in (plain, np.asarray(interp), np.asarray(ref)):
        np.testing.assert_allclose(got, want, atol=LOGMEL_ATOL, rtol=0)
    mag = np.exp(_emulate(wav, win, fft_size, 160, None, **kw))
    ref = np.exp(fbank.fused_logmel_plain(torch.from_numpy(wav), win,
                                          fft_size, 160, **kw).numpy())
    peak = ref.max(-1, keepdims=True)
    assert (np.abs(mag - ref) / peak).max() <= PEAK_RTOL


@pytest.mark.parametrize(
    "pre_emphasis,normalized,use_power,log_lower_bound",
    [(0.0, False, False, 0.0), (0.97, True, True, 1.0),
     (0.96, False, True, 0.0)])
def test_fft_emulation_options(pre_emphasis, normalized, use_power,
                               log_lower_bound):
    """The emulated kernel with pre-emphasis off, a normalized window,
    power and the log's lower bound == the plain version."""
    fft_size, win, mel = _front_end("kaldi", 400, True)
    rng = np.random.default_rng(3)
    wav = (0.1 * rng.standard_normal((2, 5000))).astype(_F32)
    kw = dict(pre_emphasis=pre_emphasis, normalized=normalized,
              use_power=use_power, log_lower_bound=log_lower_bound,
              log_eps=EPSILON)
    got = _emulate(wav, win, fft_size, 160, mel, **kw)
    want = fbank.fused_logmel_plain(torch.from_numpy(wav), win, fft_size,
                                    160, mel=mel, **kw).numpy()
    np.testing.assert_allclose(got, want, atol=LOGMEL_ATOL, rtol=0)


def _recipe_front_ends():
    """The asr_transform of every recipe under examples/ with an fbank."""
    root = Path(__file__).resolve().parents[1] / "examples"
    confs = {}
    for path in sorted(root.glob("**/*.yaml")):
        conf = (yaml.safe_load(path.read_text()) or {}).get("asr_transform")
        if isinstance(conf, dict) and "fbank" in conf.get("feats", ""):
            confs[str(path.relative_to(root))] = conf
    return confs


def test_mel_bands_hold_every_nonzero_of_the_recipes_filterbanks():
    """For the mel filterbank of every recipe's front end, [lo_m, hi_m)
    holds every nonzero of column m, and the band product equals the dense
    product bit for bit (the same terms in the same order, minus zeros)."""
    confs = _recipe_front_ends()
    assert len(confs) >= 20
    seen = set()
    for name, conf in confs.items():
        keys = ("frame_len", "frame_hop", "window", "round_pow_of_two",
                "stft_mode", "sr", "num_mels", "min_freq", "max_freq",
                "mel_coeff_norm")
        kw = {k: conf[k] for k in keys if k in conf}
        tf = AsrTransform(feats="fbank-log", **kw)
        mel = np.asarray(tf.mel, dtype=_F32)
        if mel.tobytes() in seen:
            continue
        seen.add(mel.tobytes())
        lo, hi = fbank.mel_bands(mel)
        rows = np.arange(mel.shape[0])[:, None]
        inside = (rows >= lo[None, :]) & (rows < hi[None, :])
        assert not np.any((mel != 0) & ~inside), name
        assert np.all(lo < hi), name  # no empty filter in a recipe
        fbank.fft_plan(tf.fft_size)
        spec = np.random.default_rng(0).random((4, mel.shape[0]), _F32)
        dense = np.zeros((4, mel.shape[1]), _F32)
        band = np.zeros((4, mel.shape[1]), _F32)
        for k in range(mel.shape[0]):
            dense += spec[:, k:k + 1] * mel[k]
            on = (k >= lo) & (k < hi)
            band[:, on] += spec[:, k:k + 1] * mel[k, on]
        np.testing.assert_array_equal(band, dense, err_msg=name)
    assert len(seen) >= 2


@pytest.mark.parametrize("fft_size", [375, 402, 2 * 7 * 32, 8192, 1])
def test_kernel_refuses_other_fft_sizes(fft_size):
    """The kernel's operands for a CUDA device refuse an fft_size that is
    odd, has a prime factor above 5 or exceeds MAX_FFT_SIZE with a
    ValueError naming the size, before anything reaches the device (so it
    shows on a machine without one); the CPU's take it, for the plain
    version."""
    win = np.ones(min(fft_size, 400), _F32)
    with pytest.raises(ValueError, match=f"fft_size {fft_size} "):
        fbank.operands(win, fft_size, device="cuda")
    assert fbank.operands(win, fft_size).twiddle is None


def test_float64_stages_keep_deep_bands_within_the_tolerance():
    """Why the kernel's FFT runs in float64: on white noise with
    pre-emphasis 0.96 and power (the card test's long-form step batch, 8 x
    441576 samples, utterance 5, frames 1380-1459) the lowest mel bands lie
    four orders of magnitude below the frame's level. There the emulation
    with float32 stages is 1.6e-3 from the float64 function in the log,
    beyond LOGMEL_ATOL; with the kernel's float64 stages it is within it."""
    gen = torch.Generator().manual_seed(8 + 441576)
    wav = (0.1 * torch.randn((8, 441576), generator=gen))[5].numpy()
    seg = wav[None, 1380 * 160:1459 * 160 + 512]
    win = make_window("hamm", 400, True, "librosa")
    mel = mel_filter(400, num_mels=80).T
    kw = dict(pre_emphasis=0.96, normalized=False, use_power=True,
              log_lower_bound=0.0, log_eps=EPSILON)
    idx = np.arange(80)[:, None] * 160 + np.arange(512)[None, :]
    frames = seg[0, idx].astype(np.float64)
    frames = np.concatenate([frames[:, :1] * (1 - 0.96),
                             frames[:, 1:] - 0.96 * frames[:, :-1]], -1)
    spec = np.fft.rfft(frames * win.astype(np.float64), axis=-1)
    power = spec.real**2 + spec.imag**2
    want = np.log(np.maximum(power @ mel.astype(np.float64), EPSILON))
    errs = {dtype: np.abs(_emulate(seg, win, 512, 160, mel, dtype=dtype,
                                   **kw)[0] - want).max()
            for dtype in (np.complex64, np.complex128)}
    assert errs[np.complex128] <= LOGMEL_ATOL < errs[np.complex64], errs


def test_plain_version_runs_in_the_waveform_dtype():
    """fused_logmel_plain computes in the waveform's dtype (a float64 pass
    of the model on the CPU is a referee for float32 passes): in float64
    it stays within 1e-6 of numpy's float64 function (its DFT tables are
    rounded to float32 first), and float32 within LOGMEL_ATOL of it."""
    rng = np.random.default_rng(64)
    wav = 0.1 * rng.standard_normal((2, 8000))
    win = make_window("hamm", 400, True, "librosa")
    mel = mel_filter(400, num_mels=80).T
    kw = dict(pre_emphasis=0.97, normalized=False, use_power=True,
              log_lower_bound=1.0, log_eps=EPSILON)
    got = {dtype: fbank.fused_logmel_plain(torch.from_numpy(wav).to(dtype),
                                           win, 512, 160, mel=mel, **kw)
           for dtype in (torch.float32, torch.float64)}
    assert got[torch.float64].dtype == torch.float64
    T = (wav.shape[1] - len(win)) // 160 + 1
    idx = np.arange(T)[:, None] * 160 + np.arange(len(win))[None, :]
    frames = wav[:, idx]
    frames = np.concatenate([frames[..., :1] * (1 - 0.97),
                             frames[..., 1:] - 0.97 * frames[..., :-1]], -1)
    spec = np.fft.rfft(frames * win.astype(np.float64), axis=-1)
    want = np.log(1.0 + (spec.real**2 + spec.imag**2) @ mel.astype(
        np.float64))
    np.testing.assert_allclose(got[torch.float64].numpy(), want, atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(got[torch.float32].numpy(), want,
                               atol=LOGMEL_ATOL, rtol=0)
