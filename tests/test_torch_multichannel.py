#!/usr/bin/env python
"""PyTorch port, the multi-channel front ends module by module against
aps_tpu on JAX's CPU: the Hermitian solve and log-determinant (the clamped
corners included), the IPD features (cos, sin and raw, zero bins
included), the directional features and the fixed beamformer, StackedRNN
and PyTorchRNNEncoder with lengths, the learned beamformers (time_invar,
time_invar_att, time_variant, google_clp and the two filter-and-sum
beamformers) and the mask-based MVDR, each on weights carried across by
aps_tpu_torch.convert (round trip exact)."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from aps_tpu.asr.base.encoder import PyTorchRNNEncoder as JaxRNNEncoder  # noqa
from aps_tpu.asr.base.rnn import StackedRNN as JaxStackedRNN  # noqa: E402
from aps_tpu.asr.filter import conv as jax_conv  # noqa: E402
from aps_tpu.asr.filter import google as jax_google  # noqa: E402
from aps_tpu.asr.filter import mvdr as jax_mvdr  # noqa: E402
from aps_tpu.ops import cplx_pair as cp  # noqa: E402
from aps_tpu.transform import enh as jax_enh  # noqa: E402
from aps_tpu_torch import cplx  # noqa: E402
from aps_tpu_torch.asr.base.encoder import BaseEncoder  # noqa: E402
from aps_tpu_torch.asr.base.rnn import StackedRNN  # noqa: E402
from aps_tpu_torch.asr.filter import conv, google, mvdr  # noqa: E402
from aps_tpu_torch.convert import to_state_dict, to_variables  # noqa: E402
from aps_tpu_torch.transform import enh  # noqa: E402

# features of one float32 pass (IPD, directional features, a beamformer
# bank): relative to the largest entry
FEAT_RTOL = 1e-5
# a front end's output (complex products, a projection, a log, a batch
# norm; an RNN for the attention filter): relative to the largest entry
FILTER_RTOL = 1e-4
# the MVDR's weights and output on well-conditioned covariances
MVDR_RTOL = 1e-4
# the solve's gap to float64 on a near-rank-1 matrix, as a multiple of
# aps_tpu's own gap (both factorize in float32; the gap is the matrix's
# conditioning, not either code)
REFEREE_FACTOR = 3.0


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this file runs: oneDNN's CPU LSTM slows
    down 100-fold when the suite's other workers load the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(got, want, rtol, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= rtol, f"{what}: {err:.3g} > {rtol:.3g}"


def _packed(stft: np.ndarray) -> jnp.ndarray:
    """complex -> aps_tpu's packed real pair (... x 2)"""
    return jnp.asarray(np.stack([stft.real, stft.imag], -1).astype(
        np.float32))


def _cplx(pair) -> np.ndarray:
    return np.asarray(pair[0]) + 1j * np.asarray(pair[1])


def _spectra(seed, N=2, C=3, F=17, T=12, delayed=False):
    """N x C x F x T complex64: random, or delayed copies of one source
    (near rank 1 across the channels) with a little noise."""
    rng = np.random.default_rng(seed)
    if delayed:
        src = rng.standard_normal((N, 1, F, T)) + \
            1j * rng.standard_normal((N, 1, F, T))
        phase = np.exp(-1j * np.pi * np.arange(C)[:, None, None] *
                       np.linspace(0, 1, F)[None, :, None] / 2)
        x = src * phase + 1e-3 * (rng.standard_normal((N, C, F, T)) +
                                  1j * rng.standard_normal((N, C, F, T)))
    else:
        x = rng.standard_normal((N, C, F, T)) + \
            1j * rng.standard_normal((N, C, F, T))
    return x.astype(np.complex64)


def _apply(module, variables, *args, **kwargs):
    """module.apply, compiled: eager flax dispatches op by op, which the
    suite's other workers slow down 10-fold (an RNN of 512 took 79 s)."""
    return jax.jit(functools.partial(module.apply, **kwargs))(variables,
                                                              *args)


def _init(module, *args, seed=0, **kwargs):
    """flax module -> its variables as numpy, every bias moved off 0 and
    the batch statistics off their initial values."""
    init = jax.jit(functools.partial(module.init, **kwargs))
    variables = jax.tree_util.tree_map(np.array, dict(init(
        {"params": jax.random.PRNGKey(seed),
         "dropout": jax.random.PRNGKey(seed + 1)}, *args)))
    rng = np.random.default_rng(seed + 7)
    for path, leaf in jax.tree_util.tree_leaves_with_path(variables):
        name = jax.tree_util.keystr(path)
        if "batch_stats" in name:
            leaf[...] = 0.1 * rng.standard_normal(leaf.shape) \
                if "mean" in name else 1 + 0.2 * rng.random(leaf.shape)
        elif "bias" in name:
            leaf += 0.05 * rng.standard_normal(leaf.shape).astype(leaf.dtype)
    return variables


def _port(net, variables):
    """Load the variables into the port's module and check the converter's
    round trip (exact)."""
    net.load_state_dict(to_state_dict(variables, net))
    back = to_variables(net)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(variables)
    for (path, a), (_, b) in zip(
            sorted(jax.tree_util.tree_leaves_with_path(back), key=str),
            sorted(jax.tree_util.tree_leaves_with_path(variables), key=str)):
        np.testing.assert_array_equal(a, b, err_msg=str(path))
    return net.eval()


# -- item 1: Hermitian solve, log-determinant, trace --------------------


def _hermitian(seed, N=3, F=5, C=4, rank=None, load=1e-2):
    rng = np.random.default_rng(seed)
    K = rank or C + 2
    A = rng.standard_normal((N, F, C, K)) + \
        1j * rng.standard_normal((N, F, C, K))
    R = A @ A.conj().swapaxes(-1, -2) / K + load * np.eye(C)
    B = rng.standard_normal((N, F, C, 3)) + \
        1j * rng.standard_normal((N, F, C, 3))
    return R.astype(np.complex64), B.astype(np.complex64)


def _jax_solve(R, B, eps):
    return _cplx(cp.chol_solve_hermitian(
        (jnp.asarray(R.real), jnp.asarray(R.imag)),
        (jnp.asarray(B.real), jnp.asarray(B.imag)), eps=eps))


def _jax_logdet(R, eps):
    return np.asarray(cp.logdet_hermitian(
        (jnp.asarray(R.real), jnp.asarray(R.imag)), eps=eps))


@pytest.mark.parametrize("eps", [1e-10, 1.1920929e-07])
def test_hermitian_solve_and_logdet_match_jax(eps):
    """Well-conditioned matrices, and the all-zero corner (an all-zero mask
    over a bin: eps I after the loading, every pivot clamped)."""
    R, B = _hermitian(0)
    got = cplx.solve_hermitian(torch.from_numpy(R), torch.from_numpy(B),
                               eps=eps).numpy()
    _close(got, _jax_solve(R, B, eps), 1e-5, "solve")
    _close(got, np.linalg.solve(R.astype(np.complex128), B), 1e-5,
           "solve vs float64")
    _close(cplx.logdet_hermitian(torch.from_numpy(R), eps=eps).numpy(),
           _jax_logdet(R, eps), 1e-5, "logdet")
    _close(cplx.trace(torch.from_numpy(R)).numpy(),
           np.trace(R, axis1=-2, axis2=-1), 1e-6, "trace")
    # zero matrix: aps_tpu and the port clamp every pivot at eps
    Z = np.zeros_like(R)
    np.testing.assert_allclose(
        cplx.logdet_hermitian(torch.from_numpy(Z), eps=eps).numpy(),
        _jax_logdet(Z, eps), rtol=1e-6)
    Zi = (Z + eps * np.eye(4)).astype(np.complex64)
    _close(cplx.solve_hermitian(torch.from_numpy(Zi), torch.from_numpy(B),
                                eps=eps).numpy(),
           _jax_solve(Zi, B, eps), 1e-5, "solve eps I")
    # unloaded, the zero matrix's clamped factor has a zero diagonal (v / sqrt
    # eps with v = 0) and the solve divides by it, in both packages; every
    # caller loads the diagonal first
    assert not np.isfinite(cplx.solve_hermitian(
        torch.from_numpy(Z), torch.from_numpy(B), eps=eps).numpy()).any()
    assert not np.isfinite(_jax_solve(Z, B, eps)).any()


def test_hermitian_solve_near_rank_one_corner():
    """Channels that are delayed copies of one source make a near-rank-1
    covariance (as tests/test_cli.py's corpus does): the float32 solve
    departs from float64 by the conditioning in both packages; the port's
    gap may be at most REFEREE_FACTOR times aps_tpu's, and in complex128
    the port's algorithm is exact to float64 rounding."""
    R, B = _hermitian(3, rank=1, load=1e-5)
    want = np.linalg.solve(R.astype(np.complex128), B.astype(np.complex128))
    got = cplx.solve_hermitian(torch.from_numpy(R), torch.from_numpy(B))
    ref = _jax_solve(R, B, 1e-10)
    scale = np.abs(want).max()
    port_gap = np.abs(got.numpy() - want).max() / scale
    jax_gap = np.abs(ref - want).max() / scale
    assert port_gap <= REFEREE_FACTOR * jax_gap + 1e-6, (port_gap, jax_gap)
    got64 = cplx.solve_hermitian(torch.from_numpy(R).to(torch.complex128),
                                 torch.from_numpy(B).to(torch.complex128))
    _close(got64.numpy(), want, 1e-8, "complex128")
    # a matrix that is not positive definite in float32 never fails
    S = R - 1e-5 * np.eye(4, dtype=np.complex64) * 1.5
    out = cplx.solve_hermitian(torch.from_numpy(S), torch.from_numpy(B))
    assert torch.isfinite(out).all()


def test_hermitian_solve_gradients_match_jax():
    """Gradients through the clamped Cholesky and the triangular solves."""
    R, B = _hermitian(1)
    w = np.random.default_rng(2).standard_normal(B.shape).astype(np.float32)

    def jax_loss(rr, ri, br, bi):
        x = cp.chol_solve_hermitian((rr, ri), (br, bi))
        ld = cp.logdet_hermitian((rr, ri))
        return jnp.sum(x[0] * w) - jnp.sum(x[1] * w) + jnp.sum(ld)

    args = [jnp.asarray(a) for a in (R.real, R.imag, B.real, B.imag)]
    want = jax.jit(jax.grad(jax_loss, argnums=(0, 1, 2, 3)))(*args)
    parts = [torch.tensor(np.asarray(a), requires_grad=True) for a in args]
    Rt = torch.complex(parts[0], parts[1])
    Bt = torch.complex(parts[2], parts[3])
    x = cplx.solve_hermitian(Rt, Bt)
    wt = torch.from_numpy(w)
    loss = (x.real * wt).sum() - (x.imag * wt).sum() + \
        cplx.logdet_hermitian(Rt).sum()
    loss.backward()
    # the R gradient: aps_tpu differentiates every entry of the real
    # embedding, the port the Hermitian matrix through its lower half; held
    # on the Hermitian part of both
    for i in (2, 3):
        _close(parts[i].grad.numpy(), want[i], 1e-4, f"grad {i}")
    g_j = np.asarray(want[0]) + 1j * np.asarray(want[1])
    g_t = parts[0].grad.numpy() + 1j * parts[1].grad.numpy()
    herm = lambda g: (g + g.conj().swapaxes(-1, -2)) / 2
    _close(herm(g_t), herm(g_j), 1e-4, "grad R")


# -- item 2: the multi-channel parts of the enh transform -----------------


IPD_CASES = [
    # (ipd_index, cos_ipd, sin_ipd)
    ("1,0;2,0", True, False),
    ("0,1;0,2;1,2", True, True),
    ("1,0;2,1", False, False),
]


@pytest.mark.parametrize("ipd_index,cos_ipd,sin_ipd", IPD_CASES)
def test_ipd_features_match_jax(ipd_index, cos_ipd, sin_ipd):
    """spectrogram-log-cmvn-ipd on the same STFT in both packages (so the
    raw phases are those of the same numbers); channel 2 is zero over a
    band and some frames, where cos and sin come out 0 in both."""
    stft = _spectra(11, C=3, F=33, T=20)
    stft[:, 2, 5:9] = 0
    stft[:, 2, :, 3:6] = 0
    conf = dict(feats="spectrogram-log-cmvn-ipd", frame_len=64, frame_hop=32,
                ipd_index=ipd_index, cos_ipd=cos_ipd, sin_ipd=sin_ipd)
    jtr = jax_enh.FeatureTransform(**conf)
    want = np.asarray(jtr.apply({}, _packed(stft)))
    ttr = enh.FeatureTransform(**conf)
    got = ttr(torch.from_numpy(stft)).numpy()
    assert ttr.dim() == jtr.apply({}, method=lambda m: m.dim()) == \
        want.shape[-1]
    _close(got, want, FEAT_RTOL, "features")
    nbins = 33 * len(ipd_index.split(";")) * (2 if cos_ipd and sin_ipd
                                              else 1)
    ipd = got[..., -nbins:]
    if cos_ipd:
        # the zero bins of channel 2: 0, not cos(0) = 1
        zero = np.abs(stft[:, 2]).T == 0  # T x F of utterance 0
        pairs = [tuple(map(int, p.split(","))) for p in ipd_index.split(";")]
        for k, (l, r) in enumerate(pairs):
            if 2 in (l, r):
                block = ipd[0, :, k * 33:(k + 1) * 33]
                assert np.all(block[zero[..., 0] if zero.ndim == 3
                                    else zero] == 0)


def test_ipd_alone_and_the_ref_channel():
    """feats "ipd" alone (no magnitude), ref_channel and RefChannelTransform
    against aps_tpu."""
    stft = _spectra(12, C=4, F=17, T=9)
    conf = dict(feats="ipd", frame_len=32, frame_hop=16, ipd_index="1,0;3,2")
    want = np.asarray(jax_enh.FeatureTransform(**conf).apply(
        {}, _packed(stft)))
    got = enh.FeatureTransform(**conf)(torch.from_numpy(stft)).numpy()
    _close(got, want, FEAT_RTOL, "ipd alone")
    conf = dict(feats="spectrogram-log-ipd", frame_len=32, frame_hop=16,
                ipd_index="1,0", ref_channel=2)
    want = np.asarray(jax_enh.FeatureTransform(**conf).apply(
        {}, _packed(stft)))
    got = enh.FeatureTransform(**conf)(torch.from_numpy(stft)).numpy()
    _close(got, want, FEAT_RTOL, "ref channel 2")
    mag = np.abs(stft).astype(np.float32)
    for ref, dim in ((1, 4), (-1, 4), (1, 3)):
        want = np.asarray(jax_enh.RefChannelTransform(ref, dim).apply(
            {}, jnp.asarray(mag)))
        got = enh.RefChannelTransform(ref, dim)(torch.from_numpy(mag))
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("num_doas", [1, 4])
def test_df_transform_matches_jax(num_doas):
    """The "7@" array's directional features from the phases, a known
    direction per utterance (also a list of them: one a speaker) or
    num_doas spread directions."""
    rng = np.random.default_rng(13)
    p = rng.uniform(-np.pi, np.pi, (2, 7, 6, 257)).astype(np.float32)
    doa = rng.uniform(0, 2 * np.pi, 2).astype(np.float32)
    jdf = jax_enh.DfTransform(num_doas=num_doas)
    tdf = enh.DfTransform(num_doas=num_doas)
    want = np.asarray(jdf.apply({}, jnp.asarray(p), jnp.asarray(doa)))
    got = tdf(torch.from_numpy(p), torch.from_numpy(doa)).numpy()
    _close(got, want, FEAT_RTOL, "df")
    if num_doas == 1:
        doas = [doa, doa[::-1].copy()]
        want = np.asarray(jdf.apply({}, jnp.asarray(p),
                                    [jnp.asarray(d) for d in doas]))
        got = tdf(torch.from_numpy(p),
                  [torch.from_numpy(d) for d in doas]).numpy()
        _close(got, want, FEAT_RTOL, "df per speaker")


def test_fixed_beamformer_matches_jax(tmp_path):
    """The trainable bank (parameter "weight", converted), a bank read from
    a .npy file, one beam an utterance, squeeze and trans; the frozen bank
    without a file takes aps_tpu's draw assigned to it."""
    x = _spectra(14, N=2, C=3, F=9, T=7)
    xr, xi = jnp.asarray(x.real), jnp.asarray(x.imag)
    jbf = jax_enh.FixedBeamformer(4, 3, 9, requires_grad=True)
    variables = _init(jbf, xr, xi)
    tbf = _port(enh.FixedBeamformer(4, 3, 9, requires_grad=True), variables)
    xt = torch.from_numpy(x)
    beam = np.array([3, 1])
    for kwargs in ({}, {"trans": True}, {"beam": beam},
                   {"beam": beam, "squeeze": True}):
        want = _cplx(jbf.apply(variables, xr, xi, **kwargs))
        tk = dict(kwargs)
        if "beam" in tk:
            tk["beam"] = torch.from_numpy(beam)
        got = tbf(xt, **tk).detach().numpy()
        _close(got, want, FEAT_RTOL, str(kwargs))
    w = np.random.default_rng(15).standard_normal((2, 4, 3, 9)).astype(
        np.float32)
    np.save(tmp_path / "w.npy", w)
    jfile = jax_enh.FixedBeamformer(4, 3, 9, weight=str(tmp_path / "w.npy"))
    tfile = enh.FixedBeamformer(4, 3, 9, weight=str(tmp_path / "w.npy"))
    assert not list(tfile.parameters()) and not tfile.state_dict()
    _close(tfile(xt).numpy(), _cplx(jfile.apply({}, xr, xi)), FEAT_RTOL,
           "from file")
    frozen = enh.FixedBeamformer(4, 3, 9)
    frozen.weight = torch.from_numpy(np.array(jax_enh.FixedBeamformer(
        4, 3, 9).apply({}, method=lambda m: m.w)))
    _close(frozen(xt).numpy(),
           _cplx(jax_enh.FixedBeamformer(4, 3, 9).apply({}, xr, xi)),
           FEAT_RTOL, "frozen")


# -- items 3 and 4: lengths in StackedRNN, the RNN encoder ----------------


def _valid(x, lens):
    return [x[i, :n] for i, n in enumerate(lens)]


@pytest.mark.parametrize("rnn_type,bidirectional", [("lstm", True),
                                                    ("gru", False)])
def test_stacked_rnn_with_lengths_matches_jax(rnn_type, bidirectional):
    """Valid frames of a two-layer StackedRNN with lengths (the reverse
    direction starts at each last valid frame) against aps_tpu's with
    seq_lengths; frames past a length differ by design (flax carries,
    packing gives zeros)."""
    lens = np.array([13, 7, 10])
    x = np.random.default_rng(16).standard_normal((3, 13, 6)).astype(
        np.float32)
    conf = dict(num_layers=2, rnn_type=rnn_type, bidirectional=bidirectional)
    jnet = JaxStackedRNN(5, **conf)
    variables = _init(jnet, jnp.asarray(x), inp_len=jnp.asarray(lens))
    net = _port(StackedRNN(6, 5, **conf), variables)
    want = np.asarray(_apply(jnet, variables, jnp.asarray(x),
                                 inp_len=jnp.asarray(lens)))
    with torch.no_grad():
        got = net(torch.from_numpy(x), torch.from_numpy(lens)).numpy()
        free = net(torch.from_numpy(x)).numpy()
    for g, w in zip(_valid(got, lens), _valid(want, lens)):
        _close(g, w, 1e-5, "valid frames")
    assert np.all(got[1, 7:] == 0)
    # the full-length utterance is the same with and without lengths
    _close(got[0], free[0], 1e-6, "full length")
    # with lengths the reverse direction of a shorter one differs from the
    # length-free call's, which reads the padding
    if bidirectional:
        assert not np.allclose(got[1, :7], free[1, :7], atol=1e-4)


@pytest.mark.parametrize("kwargs", [
    dict(non_linear="sigmoid", bidirectional=True, input_proj=8),
    dict(non_linear="relu", hidden_proj=6, use_ln=True, rnn="gru"),
    dict(non_linear="tanh", out_features=-1, num_layers=1),
    dict(non_linear="none", rnn="rnn", bidirectional=True),
])
def test_rnn_encoder_matches_jax(kwargs):
    """PyTorchRNNEncoder ("pytorch_rnn" and its alias "rnn") with lengths:
    input_proj with ReLU, hidden_proj, use_ln, outp and each output
    non-linearity, on valid frames."""
    kwargs = dict(dict(inp_features=7, out_features=9, num_layers=2,
                       hidden=5, dropout=0.0), **kwargs)
    lens = np.array([11, 6])
    x = np.random.default_rng(17).standard_normal((2, 11, 7)).astype(
        np.float32)
    jnet = JaxRNNEncoder(**kwargs)
    variables = _init(jnet, jnp.asarray(x), jnp.asarray(lens))
    assert BaseEncoder["rnn"] is BaseEncoder["pytorch_rnn"]
    net = _port(BaseEncoder["pytorch_rnn"](**kwargs), variables)
    want, want_len = _apply(jnet, variables, jnp.asarray(x),
                            jnp.asarray(lens))
    with torch.no_grad():
        got, got_len = net(torch.from_numpy(x), torch.from_numpy(lens))
    assert net.output_dim() == jnet.output_dim() == want.shape[-1]
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    for g, w in zip(_valid(got.numpy(), lens), _valid(np.asarray(want),
                                                       lens)):
        _close(g, w, 1e-5, "encoder")


# -- items 5 and 6: the learned beamformers -------------------------------


FILTERS = {
    "time_invar": dict(num_bins=17, num_channels=3, spatial_filters=4,
                       spectra_filters=6),
    "time_invar_mel": dict(num_bins=17, num_channels=3, spatial_filters=4,
                           spectra_filters=6, spectra_init="mel",
                           apply_log=False),
    "time_invar_att": dict(num_bins=17, num_channels=3, spatial_filters=4,
                           spectra_filters=6, query_type="conv"),
    "time_invar_att_rnn": dict(num_bins=17, num_channels=3,
                               spatial_filters=4, spectra_filters=6),
    "time_variant": dict(num_bins=17, num_channels=3, spatial_filters=4,
                         spectra_filters=6, time_reception=5),
    "google_clp": dict(num_bins=17, num_channels=3, spatial_filters=4,
                       spectra_filters=6),
    "google_clp_real": dict(num_bins=17, num_channels=3, spatial_filters=4,
                            spectra_filters=6, spectra_complex=False,
                            spectra_init="mel"),
}


def _filter_name(case: str) -> str:
    for name in ("time_invar_att", "time_variant", "time_invar",
                 "google_clp"):
        if case.startswith(name):
            return name


@pytest.mark.parametrize("case", sorted(FILTERS))
def test_learned_beamformers_match_jax(case):
    """Each registered front end on converted weights: eval (running
    statistics), then a training pass (batch statistics) whose updated
    statistics match flax's."""
    name = _filter_name(case)
    kwargs = FILTERS[case]
    x = _spectra(18, N=2, C=3, F=17, T=10)
    jnet = jax_conv.EnhFrontEnds[name](**kwargs)
    variables = _init(jnet, _packed(x))
    net = _port(conv.EnhFrontEnds[name](**kwargs), variables)
    want = np.asarray(_apply(jnet, variables, _packed(x), training=False))
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    _close(got, want, FILTER_RTOL, f"{case} eval")
    if "batch_stats" not in variables or case == "time_invar_att_rnn":
        # (the query RNN's dropout: no torch draw equals flax's)
        return
    want, stats = _apply(jnet, variables, _packed(x), training=True,
                         mutable=["batch_stats"])
    net.train()
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    _close(got, np.asarray(want), FILTER_RTOL, f"{case} train")
    back = to_variables(net)["batch_stats"]
    for path, leaf in jax.tree_util.tree_leaves_with_path(
            jax.tree_util.tree_map(np.asarray, dict(stats))["batch_stats"]):
        node = back
        for key in path:
            node = node[key.key]
        _close(node, leaf, 1e-5, f"{case} {jax.tree_util.keystr(path)}")


def test_filter_and_sum_beamformers_match_jax():
    """The raw-waveform filter-and-sum beamformers of google.py."""
    wav = np.random.default_rng(19).standard_normal((2, 3, 700)).astype(
        np.float32)
    for jcls, tcls, kwargs in (
            (jax_google.UnfactedFsBeamformer, google.UnfactedFsBeamformer,
             dict(num_taps=40, win_size=56, num_channels=3, num_filters=8)),
            (jax_google.FactedFsBeamformer, google.FactedFsBeamformer,
             dict(num_taps=9, win_size=56, num_channels=3,
                  spatial_filters=2, spectra_filters=5,
                  spectra_kernels=40))):
        jnet = jcls(**kwargs)
        variables = _init(jnet, jnp.asarray(wav))
        net = _port(tcls(**kwargs), variables)
        want = np.asarray(_apply(jnet, variables, jnp.asarray(wav)))
        with torch.no_grad():
            got = net(torch.from_numpy(wav)).numpy()
        _close(got, want, FILTER_RTOL, jcls.__name__)


# -- item 7: the MVDR ------------------------------------------------------


def _mvdr_case(seed, delayed=False, zero_bin=True):
    x = _spectra(seed, N=2, C=4, F=17, T=15, delayed=delayed)
    rng = np.random.default_rng(seed + 1)
    mask_s = rng.uniform(0.05, 1, (2, 15, 17)).astype(np.float32)
    mask_n = rng.uniform(0.05, 1, (2, 15, 17)).astype(np.float32)
    if zero_bin:
        # an all-zero speech mask over bin 4 of utterance 0
        mask_s[0, :, 4] = 0
    return x, mask_s, mask_n


@pytest.mark.parametrize("with_noise_mask", [True, False])
def test_mvdr_beamformer_matches_jax(with_noise_mask):
    """MvdrBeamformer's weights (Rn^-1 Rs u / (tr + eps)) and output, with
    an all-zero speech mask over one bin and a length that zeroes the
    masks past it."""
    x, mask_s, mask_n = _mvdr_case(20)
    lens = np.array([15, 11])
    jnet = jax_mvdr.MvdrBeamformer(17, att_dim=8)
    args = (jnp.asarray(mask_s), _packed(x))
    kwargs = dict(mask_n=jnp.asarray(mask_n) if with_noise_mask else None,
                  x_len=jnp.asarray(lens))
    variables = _init(jnet, *args, **kwargs)
    net = _port(mvdr.MvdrBeamformer(17, att_dim=8), variables)
    want = _cplx(cp.from_packed(_apply(jnet, variables, *args, **kwargs)))
    targs = (torch.from_numpy(mask_s), torch.from_numpy(x))
    tkwargs = dict(mask_n=torch.from_numpy(mask_n) if with_noise_mask
                   else None, x_len=torch.from_numpy(lens))
    with torch.no_grad():
        got = net(*targs, **tkwargs).numpy()
    _close(got, want, MVDR_RTOL, "mvdr output")

    # the weights alone, through the same masks and covariances
    xp = cp.from_packed(args[1])
    ms = jnet._process_mask(args[0], kwargs["x_len"])
    mn = jnet._process_mask(kwargs["mask_n"], kwargs["x_len"])
    Rs_j = jax_mvdr.estimate_covar(ms, xp)
    Rn_j = jax_mvdr.estimate_covar(1 - ms if mn is None else mn, xp)
    u_j = jax_mvdr.ChannelAttention(17, 8).apply(
        {"params": variables["params"]["ref"]}, Rs_j)
    w_j = jnet._derive_weight(Rs_j, Rn_j, u_j, eps=jnet.eps)
    with torch.no_grad():
        ms = net._process_mask(targs[0], tkwargs["x_len"])
        mn = net._process_mask(tkwargs["mask_n"], tkwargs["x_len"])
        Rs = mvdr.estimate_covar(ms, targs[1])
        Rn = mvdr.estimate_covar(1 - ms if mn is None else mn, targs[1])
        u = net.ref(Rs)
        w = net._derive_weight(Rs, Rn, u, eps=net.eps)
    _close(Rs.numpy(), _cplx(Rs_j), 1e-5, "speech covariance")
    _close(u.numpy(), np.asarray(u_j), 1e-5, "reference vector")
    _close(w.numpy(), _cplx(w_j), MVDR_RTOL, "mvdr weights")
    # the all-zero speech mask's bin: weights 0 in both
    assert np.abs(w.numpy()[0, 4]).max() == 0
    assert np.abs(_cplx(w_j)[0, 4]).max() == 0


def test_mvdr_near_rank_one_corner():
    """Delayed copies of one source (near-rank-1 noise covariance): the
    output's gap to a float64 evaluation of the same formula may be at
    most REFEREE_FACTOR times aps_tpu's gap."""
    x, mask_s, mask_n = _mvdr_case(21, delayed=True)
    jnet = jax_mvdr.MvdrBeamformer(17, att_dim=8)
    args = (jnp.asarray(mask_s), _packed(x))
    variables = _init(jnet, *args, mask_n=jnp.asarray(mask_n))
    net = _port(mvdr.MvdrBeamformer(17, att_dim=8), variables)
    want = _cplx(cp.from_packed(_apply(jnet, variables, *args,
                                           mask_n=jnp.asarray(mask_n))))
    with torch.no_grad():
        got = net(torch.from_numpy(mask_s), torch.from_numpy(x),
                  mask_n=torch.from_numpy(mask_n)).numpy()
        net64 = net.double()
        ref = net64(torch.from_numpy(mask_s).double(),
                    torch.from_numpy(x).to(torch.complex128),
                    mask_n=torch.from_numpy(mask_n).double()).numpy()
    scale = np.abs(ref).max()
    port_gap = np.abs(got - ref).max() / scale
    jax_gap = np.abs(want - ref).max() / scale
    assert np.all(np.isfinite(got))
    assert port_gap <= REFEREE_FACTOR * jax_gap + 1e-5, (port_gap, jax_gap)


def test_rnn_mask_mvdr_with_lengths_matches_jax():
    """RNNMaskMvdr ("rnn_mask_mvdr": the BLSTM mask network with lengths,
    split speech and noise masks, the MVDR) on valid frames."""
    x = _spectra(22, N=2, C=3, F=17, T=14)
    lens = np.array([14, 9])
    feats = np.random.default_rng(23).standard_normal((2, 14, 17)).astype(
        np.float32)
    kwargs = dict(enh_input_size=17, num_bins=17, num_layers=2,
                  hidden_size=6, mvdr_att_dim=8)
    jnet = jax_conv.EnhFrontEnds["rnn_mask_mvdr"](**kwargs)
    args = (jnp.asarray(feats), _packed(x))
    variables = _init(jnet, *args, inp_len=jnp.asarray(lens))
    net = _port(conv.EnhFrontEnds["rnn_mask_mvdr"](**kwargs), variables)
    want = _cplx(cp.from_packed(_apply(jnet, variables, *args,
                                           inp_len=jnp.asarray(lens))))
    with torch.no_grad():
        got = net(torch.from_numpy(feats), torch.from_numpy(x),
                  inp_len=torch.from_numpy(lens)).numpy()
    for g, w in zip(_valid(got, lens), _valid(want, lens)):
        _close(g, w, MVDR_RTOL, "rnn_mask_mvdr")
