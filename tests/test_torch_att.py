#!/usr/bin/env python
"""PyTorch port, the RNN attention AED (asr@att) against aps_tpu on JAX's
CPU, module by module at toy widths on the same numpy inputs and converted
weights: the delta features in both layouts, every BaseEncoder name with
lengths, the six decoder attentions, the RNN decoder's teacher-forced loop
(at ssr 0 and with aps_tpu's schedule-sampling coins fed in), an asr@att
step under asr@ctc_xent (loss, gradients, batch statistics), CtcASR under
asr@ctc, EnhAttASR's forward, and WSJ 1a's delta channels (aps_tpu's
channel-last conv2d reads the three orders as time)."""

import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from aps_tpu import libs as jax_libs  # noqa: E402
from aps_tpu.asr.base import attention as jax_att  # noqa: E402
from aps_tpu.asr.base import encoder as jax_enc  # noqa: E402
from aps_tpu.asr.base.decoder import TorchRNNDecoder as JaxDecoder  # noqa
from aps_tpu.transform import AsrTransform as JaxTransform  # noqa: E402
from aps_tpu.transform.asr import DeltaTransform as JaxDelta  # noqa: E402
from aps_tpu_torch.asr.base.attention import AsrAtt  # noqa: E402
from aps_tpu_torch.asr.base.decoder import TorchRNNDecoder  # noqa: E402
from aps_tpu_torch.asr.base.encoder import (BaseEncoder,  # noqa: E402
                                            encoder_instance)
from aps_tpu_torch.conf import load_yaml  # noqa: E402
from aps_tpu_torch.convert import (to_gradients, to_state_dict,  # noqa: E402
                                   to_variables)
from aps_tpu_torch.libs import aps_asr_nnet, aps_task, aps_transform  # noqa
from aps_tpu_torch.transform.asr import DeltaTransform  # noqa: E402

from test_torch_chime4 import ENH, _leaves, _multichannel  # noqa: E402
from test_torch_train import assert_trees_close  # noqa: E402

VOCAB = 12
SOS, EOS = VOCAB - 3, VOCAB - 2
# float32 outputs of a few small layers in another summation order,
# relative to the largest entry
OUT_RTOL = 1e-5
# the loss relative to itself; each gradient leaf relative to its own
# largest entry (a leaf whose float64 gradient is 0 is held to ZERO_F32 of
# the model's largest entry instead). The attention's enc_proj bias sums
# its frames' gradients with cancellation: against a float64 pass of the
# port the float32 passes land 2.3e-4 (port) and 2.3e-5 (aps_tpu) of its
# largest entry away, the other leaves within 2e-5
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-3
# delta features: sums of 5 float32 products a order, on log-mel
# features of up to |x| ~ 30
DELTA_ATOL = 1e-5
# the whole transform: aps_tpu's layered log-mel against the port's fused
# plain version (test_torch_frontend.py's LOGMEL_ATOL), through the deltas
LOGMEL_ATOL = 2e-3
# the decoder's output layer scaled so that the argmax fed back under
# schedule sampling stands apart from the runner-up (no near-ties)
PEAKY = 4.0
KEY = jax.random.PRNGKey(0)


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
    err = float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                1e-30)
    assert err <= rtol, f"{what}: {err:.3g} > {rtol:.3g}"


def _np(tree):
    return jax.tree_util.tree_map(np.array, dict(tree))


def _init(module, *args, rngs=None, **kwargs):
    """module.init, jitted (eager flax is slow beside other workers), as a
    tree of numpy arrays."""
    rngs = rngs or {"params": KEY}
    return _np(jax.jit(lambda *a: module.init(rngs, *a, **kwargs))(*args))


def _port_variables(module, seed=0):
    """The port module's seeded weights as aps_tpu's variables tree (batch
    statistics off their initial values): the JAX side then compiles its
    apply alone."""
    gen = torch.Generator().manual_seed(seed)
    for p in module.parameters():
        if p.requires_grad:
            fan_in = p[0].numel() if p.dim() > 1 else 1
            with torch.no_grad():
                p.copy_(torch.randn(p.shape, generator=gen) *
                        (fan_in**-0.5 if p.dim() > 1 else 0.1))
    variables = _random_stats(to_variables(module))
    _load(module, variables)
    return variables


def _apply(module, variables, *args, **kwargs):
    """module.apply, jitted; args are arrays (or None)."""
    return jax.jit(lambda v, *a: module.apply(v, *a, **kwargs))(variables,
                                                                *args)


def _random_stats(variables, seed=5):
    """batch_stats off their initial values (so eval mode reads them)."""
    rng = np.random.default_rng(seed)
    for path, val in _leaves(variables.get("batch_stats", {})):
        val[...] = 0.1 * rng.standard_normal(val.shape) \
            if path.endswith("mean") else 1 + 0.2 * rng.random(val.shape)
    return variables


def _load(module, variables):
    module.load_state_dict(to_state_dict(variables, module))
    return module


def _feats(seed, N=3, T=21, F=16, lens=(21, 17, 12)):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, T, F)).astype(np.float32)
    return x, np.array(lens[:N])


def _valid(x, lens):
    """The frames of each utterance inside its length, concatenated."""
    return np.concatenate([np.asarray(x)[i, :n] for i, n in enumerate(lens)])


# ---------------------------------------------------------------------------
# the delta features
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("as_channel", [False, True])
@pytest.mark.parametrize("ctx,order", [(2, 2), (1, 3)])
def test_delta_transform_matches_jax(as_channel, ctx, order):
    x, _ = _feats(1, T=9)
    jdelta = JaxDelta(ctx=ctx, order=order, delta_as_channel=as_channel)
    want = jdelta.apply({}, jnp.asarray(x))
    got = DeltaTransform(ctx=ctx, order=order,
                         delta_as_channel=as_channel)(torch.from_numpy(x))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=DELTA_ATOL, rtol=0)


@pytest.mark.parametrize("feats,as_channel", [
    ("fbank-log-cmvn-delta", False),
    ("perturb-fbank-log-aug-delta", True),
])
def test_delta_pipelines_match_jax(feats, as_channel):
    """TIMIT 1a's and WSJ 1a's pipelines at inference (perturb and aug are
    identities there) on a ragged batch: features, frame counts and the
    feature dimension (x (order + 1) in both layouts, as in aps_tpu)."""
    rng = np.random.default_rng(3)
    lens = np.array([16000, 11000])
    wav = np.zeros((2, 16000), dtype=np.float32)
    for i, n in enumerate(lens):
        wav[i, :n] = 0.1 * rng.standard_normal(n)
    kw = dict(feats=feats, frame_len=400, frame_hop=160, window="hamm",
              num_mels=40, delta_as_channel=as_channel, audio_norm=False)
    jtf = JaxTransform(**kw)
    variables = _init(jtf, jnp.asarray(wav), jnp.asarray(lens))
    want, want_nf = _apply(jtf, variables, jnp.asarray(wav),
                           jnp.asarray(lens))
    tf = aps_transform("asr")(**kw)
    got, got_nf = tf(torch.from_numpy(wav), torch.from_numpy(lens))
    assert tf.dim() == jtf.apply(variables, method=lambda m: m.feats_dim) \
        == 120
    np.testing.assert_array_equal(got_nf.numpy(), np.asarray(want_nf))
    assert got.shape == want.shape == ((2, 3, 97, 40) if as_channel else
                                       (2, 97, 120))
    # int16-scaled log-mel: the layered and the fused float32 paths part
    # by ~1e-4 of values ~20; cmvn brings them to unit scale
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LOGMEL_ATOL, rtol=0)


# ---------------------------------------------------------------------------
# the encoders
# ---------------------------------------------------------------------------
ENCODERS = {
    "conv1d": dict(dim=10, num_layers=2, kernel=[3, 5], stride=[2, 1],
                   dilation=[1, 2]),
    "conv2d": dict(channel=[4, 3], num_layers=2),
    "conv2d_in": dict(channel=4, num_layers=2, norm="IN"),
    "pytorch_rnn": dict(bidirectional=True, hidden=8, num_layers=2,
                        input_proj=10, dropout=0.0),
    "jit_lstm": dict(hidden=8, num_layers=2, hidden_proj=6, dropout=0.0),
    "variant_rnn": dict(hidden=8, num_layers=3, project=10, norm="LN"),
    "variant_rnn_pyramid": dict(hidden=8, num_layers=3, norm="BN",
                                pyramid_stack=True),
    "variant_rnn_sum": dict(hidden=8, num_layers=2, add_forward_backward=True,
                            non_linear="relu", rnn="gru"),
    # a dilation above 1 shrinks the context conv's output in both
    # packages, which then fail to add it to the projection
    "fsmn": dict(dim=12, project=6, num_layers=3, lctx=[2, 1, 3],
                 rctx=[1, 2, 0]),
    "concat": {"conv2d": dict(channel=4, num_layers=2),
               "pytorch_rnn": dict(bidirectional=True, hidden=8,
                                   num_layers=2, dropout=0.0)},
}


@pytest.mark.parametrize("name,out_features", [
    (name, out) for name in sorted(ENCODERS) for out in (-1, 14)
    # FSMNEncoder's last layer needs out_features, in both packages
    if not (name == "fsmn" and out < 0)])
def test_encoder_matches_jax(name, out_features):
    """Each encoder (eval mode, batch statistics off their initial values)
    on a ragged batch: output lengths, output_dim() and the valid frames
    (a recurrent layer's padded frames differ: packed zeros against flax's
    carried state)."""
    enc_type = name.split("_")[0] if name.startswith("conv2d") else \
        ("variant_rnn" if name.startswith("variant_rnn") else name)
    x, lens = _feats(7)
    kwargs = copy.deepcopy(ENCODERS[name])
    jnnet = jax_enc.encoder_instance(enc_type, 16, out_features, kwargs,
                                     jax_enc.BaseEncoder)
    enc = encoder_instance(enc_type, 16, out_features, kwargs, BaseEncoder)
    variables = _port_variables(enc.eval())
    want, want_len = _apply(jnnet, variables, jnp.asarray(x),
                            jnp.asarray(lens))
    with torch.no_grad():
        got, got_len = enc(torch.from_numpy(x), torch.from_numpy(lens))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    assert enc.output_dim() == jnnet.output_dim() == got.shape[-1]
    assert got.shape == want.shape
    _close(_valid(got, got_len), _valid(want, want_len), OUT_RTOL, name)
    # and back: the converter's tree is aps_tpu's
    back = to_variables(enc)
    assert sorted(p for p, _ in _leaves(back)) == \
        sorted(p for p, _ in _leaves(variables))


def test_fsmn_streaming_matches_jax():
    """for_streaming: no padding, proj and the memory trimmed to the frames
    the context conv keeps."""
    x, lens = _feats(8)
    kwargs = dict(dim=12, project=6, num_layers=2, lctx=2, rctx=1,
                  for_streaming=True)
    jnnet = jax_enc.encoder_instance("fsmn", 16, 14, kwargs,
                                     jax_enc.BaseEncoder)
    variables = _random_stats(_init(jnnet, jnp.asarray(x), None))
    want, _ = _apply(jnnet, variables, jnp.asarray(x), None)
    enc = _load(encoder_instance("fsmn", 16, 14, kwargs, BaseEncoder),
                variables).eval()
    with torch.no_grad():
        got, _ = enc(torch.from_numpy(x), None)
    assert got.shape == want.shape == (3, 21 - 2 * 3, 14)
    _close(got, want, OUT_RTOL)


# ---------------------------------------------------------------------------
# the decoder attentions
# ---------------------------------------------------------------------------
ATTENTIONS = {
    "dot": dict(att_dim=8),
    "ctx": dict(att_dim=8),
    "loc": dict(att_dim=8, conv_channels=3, loc_context=2),
    "mhdot": dict(att_dim=6, att_head=2),
    "mhctx": dict(att_dim=6, att_head=3),
    "mhloc": dict(att_dim=6, att_head=2, conv_channels=3, loc_context=3),
}


@pytest.mark.parametrize("name", sorted(ATTENTIONS))
def test_attention_matches_jax(name):
    """Three steps over a ragged encoder output, each step's alignment fed
    to the next (the first from init_ali): alignments (0 on the padded
    frames) and contexts."""
    rng = np.random.default_rng(len(name))
    enc = rng.standard_normal((3, 11, 10)).astype(np.float32)
    enc_len = np.array([11, 7, 4])
    decs = rng.standard_normal((3, 3, 5)).astype(np.float32)
    jatt = jax_att.att_instance(name, 10, 5, **ATTENTIONS[name])
    att = AsrAtt[name](enc_dim=10, dec_dim=5, **ATTENTIONS[name])
    variables = _port_variables(att)
    ali_j = jatt.apply(variables, 3, 11, jnp.asarray(enc_len),
                       method="init_ali")
    ali_t = att.init_ali(3, 11, torch.from_numpy(enc_len))
    _close(ali_t, ali_j, 1e-7, "init_ali")
    cache = att.prep(torch.from_numpy(enc))
    for step in range(3):
        ali_j, ctx_j = _apply(jatt, variables, jnp.asarray(enc),
                                  jnp.asarray(enc_len),
                                  jnp.asarray(decs[step]), ali_j)
        with torch.no_grad():
            ali_t, ctx_t = att(torch.from_numpy(enc),
                               torch.from_numpy(enc_len),
                               torch.from_numpy(decs[step]), ali_t,
                               cache=cache)
        _close(ali_t, ali_j, OUT_RTOL, f"ali step {step}")
        _close(ctx_t, ctx_j, OUT_RTOL, f"ctx step {step}")
        assert float(ali_t[1, ..., 7:].abs().max()) == 0.0


# ---------------------------------------------------------------------------
# the decoder
# ---------------------------------------------------------------------------
DECODER = dict(att_type="loc",
               att_kwargs=dict(att_dim=8, conv_channels=3, loc_context=2),
               num_layers=2, hidden=8, input_feeding=True, add_ln=True,
               proj_size=6)


def _decoder_pair(seed=2, **kwargs):
    conf = dict(DECODER, **kwargs)
    rng = np.random.default_rng(seed)
    enc = rng.standard_normal((3, 9, 10)).astype(np.float32)
    enc_len = np.array([9, 6, 4])
    tgt = rng.integers(0, VOCAB - 1, (3, 6))
    jdec = JaxDecoder(10, VOCAB - 1, **conf)
    dec = TorchRNNDecoder(10, VOCAB - 1, **conf)
    variables = _port_variables(dec, seed)
    variables["params"]["pred"]["kernel"] *= PEAKY
    _load(dec, variables)
    return jdec, variables, dec, enc, enc_len, tgt


@pytest.mark.parametrize("kwargs", [
    {}, dict(att_type="mhctx", att_kwargs=dict(att_dim=4, att_head=2),
             input_feeding=False, add_ln=False, proj_size=-1),
    dict(onehot_embed=True, rnn="gru")])
def test_decoder_teacher_forcing_matches_jax(kwargs):
    jdec, variables, dec, enc, enc_len, tgt = _decoder_pair(**kwargs)
    want, want_ali = _apply(jdec, variables, jnp.asarray(enc),
                                jnp.asarray(enc_len), jnp.asarray(tgt))
    with torch.no_grad():
        got, got_ali = dec(torch.from_numpy(enc), torch.from_numpy(enc_len),
                           torch.from_numpy(tgt))
    _close(got, want, OUT_RTOL, "logits")
    _close(got_ali, want_ali, OUT_RTOL, "alignments")


def test_decoder_schedule_sampling_with_jax_coins(monkeypatch):
    """aps_tpu draws one coin a step for the batch and feeds the argmax of
    the previous logits where coin < ssr and t > 0. Its coins, recorded
    from jax.random.uniform inside the scan, fed to the port give the same
    logits; some steps take the prediction, and it differs from the
    target there."""
    jdec, variables, dec, enc, enc_len, tgt = _decoder_pair(seed=4)
    coins = []
    uniform = jax.random.uniform

    def record(key, shape=(), *args, **kwargs):
        val = uniform(key, shape, *args, **kwargs)
        jax.debug.callback(lambda v: coins.append(float(v)), val)
        return val

    monkeypatch.setattr(jax.random, "uniform", record)
    ssr = 0.5
    want, _ = _apply(jdec, variables, jnp.asarray(enc), jnp.asarray(enc_len),
                     jnp.asarray(tgt), schedule_sampling=jnp.float32(ssr),
                     rngs={"ss": jax.random.PRNGKey(3)})
    jax.effects_barrier()
    monkeypatch.setattr(jax.random, "uniform", uniform)
    assert len(coins) == tgt.shape[1]
    sampled = [t for t, c in enumerate(coins) if t > 0 and c < ssr]
    assert sampled and len(sampled) < tgt.shape[1] - 1, coins
    with torch.no_grad():
        got, _ = dec(torch.from_numpy(enc), torch.from_numpy(enc_len),
                     torch.from_numpy(tgt), schedule_sampling=ssr,
                     coins=torch.tensor(coins))
        forced, _ = dec(torch.from_numpy(enc), torch.from_numpy(enc_len),
                        torch.from_numpy(tgt))
    _close(got, want, OUT_RTOL, "logits")
    prev = forced.argmax(-1)
    t = sampled[0]
    # the first sampled step reads the teacher-forced prediction of t - 1
    assert bool((got[:, :t] == forced[:, :t]).all())
    assert bool((prev[:, t - 1] != torch.from_numpy(tgt[:, t])).any())
    assert not torch.allclose(got[:, t], forced[:, t])


def test_decoder_draws_coins_from_its_generator():
    """The port's own coins: one uniform draw a step from the decoder's
    generator (the trainer's), none at ssr 0; over many draws the share
    of sampled steps is ssr."""
    _, _, dec, enc, enc_len, tgt = _decoder_pair()
    gen = torch.Generator().manual_seed(0)
    dec.generator = gen
    state = gen.get_state()
    with torch.no_grad():
        dec(torch.from_numpy(enc), torch.from_numpy(enc_len),
            torch.from_numpy(tgt))
    assert torch.equal(gen.get_state(), state)
    coins = dec.draw_coins(20000)
    assert abs(float((coins < 0.3).float().mean()) - 0.3) < 0.01
    assert float(coins.min()) >= 0 and float(coins.max()) < 1


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------
# WSJ 1a's structure (concat of conv2d and a BLSTM, ctx attention, input
# feeding) at toy widths, every dropout off
ATT_NNET = dict(
    input_size=16, enc_type="concat", enc_proj=12,
    enc_kwargs={"conv2d": dict(channel=4, num_layers=2),
                "pytorch_rnn": dict(bidirectional=True, hidden=8,
                                    num_layers=2, dropout=0.0)},
    att_type="ctx", att_kwargs=dict(att_dim=8),
    dec_kwargs=dict(num_layers=2, hidden=8, input_feeding=True),
    vocab_size=VOCAB, sos=SOS, eos=EOS, ctc=True)
TASK_CONF = dict(ctc_weight=0.2, blank=VOCAB - 1, lsm_factor=0.1)


def _labels(seed, N=3, L=5, lens=(5, 3, 4)):
    rng = np.random.default_rng(seed)
    tgt = rng.integers(0, VOCAB - 3, (N, L))
    for i, n in enumerate(lens[:N]):
        tgt[i, n:] = -1
    return tgt, np.array(lens[:N])


def _step_pair(nnet_name, nnet_conf, task_name, task_conf):
    """(aps_tpu task, its numpy variables, the port's task with the same
    weights)."""
    jtask = jax_libs.aps_task(task_name,
                              jax_libs.aps_asr_nnet(nnet_name)(**nnet_conf),
                              **task_conf)
    task = aps_task(task_name, aps_asr_nnet(nnet_name)(**nnet_conf),
                    **task_conf)
    variables = {col: {"nnet": tree}
                 for col, tree in _port_variables(task.nnet).items()}
    return jtask, variables, task


def _jax_step(jtask, variables, egs):
    jegs = {k: jnp.asarray(v) for k, v in egs.items()}
    mutable = [k for k in variables if k != "params"]

    def loss_fn(params):
        out, state = jtask.apply(
            {"params": params, **{k: variables[k] for k in mutable}}, jegs,
            training=True, mutable=mutable,
            rngs={"dropout": KEY, "aug": KEY, "ss": KEY})
        return out["loss"], (out, state)

    (_, (out, state)), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables["params"])
    return out, state, grads["nnet"]


def _port_step(task, egs, dtype=torch.float32):
    task = task.to(dtype).train()
    tegs = {k: torch.from_numpy(v) for k, v in egs.items()}
    tegs["src_pad"] = tegs["src_pad"].to(dtype)
    task.zero_grad()
    out = task(tegs)
    out["loss"].backward()
    return out, to_gradients(task.nnet)


def _check_step(jtask, variables, task, egs, zeros):
    out, state, grads = _jax_step(jtask, variables, egs)
    exact = copy.deepcopy(task)
    got, got_grads = _port_step(task, egs)
    _close(got["loss"].item(), out["loss"], LOSS_RTOL, "loss")
    for key in ("accu", "@ctc", "xent"):
        if key in out:
            _close(got[key].item(), out[key], LOSS_RTOL, key)
    _, exact_grads = _port_step(exact, egs, torch.float64)
    assert assert_trees_close(got_grads, grads, GRAD_RTOL,
                        exact=exact_grads) == zeros
    if "batch_stats" in state:
        assert_trees_close(to_variables(task.nnet)["batch_stats"],
                     state["batch_stats"]["nnet"], 1e-5)


def test_att_ctc_xent_step_matches_jax():
    """An asr@att + asr@ctc_xent training pass on features N x T x F with
    ragged lengths: loss, accu, @ctc, xent, every gradient leaf and the
    batch statistics after it."""
    x, lens = _feats(11, T=29, lens=(29, 22, 17))
    tgt, tgt_len = _labels(12)
    egs = {"src_pad": x, "src_len": lens, "tgt_pad": tgt, "tgt_len": tgt_len}
    jtask, variables, task = _step_pair("asr@att", ATT_NNET, "asr@ctc_xent",
                                        TASK_CONF)
    # a sharper alignment: with the seeded weights' near-flat one the
    # attention's gradients sit at 1e-6 of the model's largest, where
    # float32 rounding is 1e-3 of them
    variables["params"]["nnet"]["decoder"]["att_net"]["w"]["kernel"] *= 10
    _load(task.nnet, {col: tree["nnet"] for col, tree in variables.items()})
    # the conv biases before a batch norm in training mode
    _check_step(jtask, variables, task, egs, [
        "encoder/enc_list_0/conv_0/Conv_0/bias",
        "encoder/enc_list_0/conv_1/Conv_0/bias"])


@pytest.mark.parametrize("enc_type,enc_kwargs", [
    ("pytorch_rnn", dict(bidirectional=True, hidden=8, num_layers=2,
                         dropout=0.0)),
    ("xfmr", dict(num_layers=1, proj="linear",
                  arch_kwargs=dict(att_dim=8, nhead=2, feedforward_dim=16,
                                   att_dropout=0.0, ffn_dropout=0.0),
                  pose_kwargs=dict(dropout=0.0))),
])
def test_ctc_asr_step_matches_jax(enc_type, enc_kwargs):
    """CtcASR ("asr@ctc") under the asr@ctc task: the encoder's own output
    layer gives the vocab_size logits (no head); loss and gradients."""
    x, lens = _feats(13, T=19, lens=(19, 14, 9))
    tgt, tgt_len = _labels(14, lens=(4, 2, 3))
    egs = {"src_pad": x, "src_len": lens, "tgt_pad": tgt, "tgt_len": tgt_len}
    conf = dict(input_size=16, vocab_size=VOCAB, enc_type=enc_type,
                enc_kwargs=enc_kwargs)
    jtask, variables, task = _step_pair("asr@ctc", conf, "asr@ctc",
                                        dict(blank=VOCAB - 1))
    assert task.nnet.ctc_head is None
    assert "ctc_head" not in variables["params"]["nnet"]
    with torch.no_grad():
        logits, n = task.nnet.eval().ctc_logits(torch.from_numpy(x),
                                                torch.from_numpy(lens))
    want, want_n = _apply(jax_libs.aps_asr_nnet("asr@ctc")(**conf),
                          {"params": variables["params"]["nnet"]},
                          jnp.asarray(x), jnp.asarray(lens),
                          method="ctc_logits")
    assert logits.shape[-1] == VOCAB
    _close(_valid(logits, n), _valid(want, want_n), OUT_RTOL, "ctc_logits")
    _check_step(jtask, variables, task, egs, [])


def test_enh_att_forward_matches_jax():
    """EnhAttASR ("asr@enh_att"): the MVDR front end of chime4 1b at toy
    widths, a BLSTM encoder, mhloc attention; the forward in eval mode on
    3-channel recordings."""
    lens = (6000, 5000)
    x = _multichannel(2, lens)
    tgt, tgt_len = _labels(15, N=2, lens=(4, 3))
    y = np.where(tgt < 0, EOS, tgt)
    y = np.concatenate([np.full((2, 1), SOS), y], 1)
    conf = dict(
        input_size=20, enh_input_size=129, enh_type="rnn_mask_mvdr",
        enh_kwargs=dict(num_bins=129, num_layers=1, hidden_size=8,
                        mvdr_att_dim=8),
        enc_type="pytorch_rnn", enc_proj=12,
        enc_kwargs=dict(bidirectional=True, hidden=8, num_layers=1,
                        dropout=0.0),
        att_type="mhloc", att_kwargs=dict(att_dim=4, att_head=2,
                                          conv_channels=3, loc_context=2),
        dec_kwargs=dict(num_layers=1, hidden=8),
        vocab_size=VOCAB, sos=SOS, eos=EOS, ctc=True)
    asr = dict(feats="abs-mel-log-cmvn", frame_len=256, frame_hop=128,
               window="hann", sr=16000, num_mels=20)
    jnnet = jax_libs.aps_asr_nnet("asr@enh_att")(
        asr_transform=JaxTransform(**asr),
        enh_transform=jax_libs.aps_transform("enh")(**ENH), **conf)
    args = (jnp.asarray(x), jnp.asarray(lens), jnp.asarray(y),
            jnp.asarray(tgt_len + 1))
    variables = _init(jnnet, *args)
    want, want_ctc, want_len = _apply(jnnet, variables, *args)
    nnet = aps_asr_nnet("asr@enh_att")(
        asr_transform=aps_transform("asr")(**asr),
        enh_transform=aps_transform("enh")(**ENH), **conf)
    _load(nnet, variables).eval()
    with torch.no_grad():
        got, got_ctc, got_len = nnet(
            torch.from_numpy(x), torch.from_numpy(np.array(lens)),
            torch.from_numpy(y), torch.from_numpy(tgt_len + 1))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    _close(got, want, 1e-4, "dec_out")
    _close(_valid(got_ctc, got_len), _valid(want_ctc, want_len), 1e-4,
           "ctc logits")


# ---------------------------------------------------------------------------
# WSJ 1a's delta channels
# ---------------------------------------------------------------------------
def _wsj_conf(hidden=16, channel=4):
    """examples/asr/wsj/conf/1a.yaml's nnet_conf with only widths cut."""
    from pathlib import Path
    conf = load_yaml(str(Path(__file__).resolve().parents[1] /
                         "examples/asr/wsj/conf/1a.yaml"))
    nnet = conf["nnet_conf"]
    nnet["enc_kwargs"]["conv2d"]["channel"] = channel
    nnet["enc_kwargs"]["pytorch_rnn"].update(hidden=hidden, dropout=0.0)
    nnet["enc_proj"] = hidden
    nnet["dec_kwargs"].update(hidden=hidden, dropout=0.0)
    nnet["att_kwargs"]["att_dim"] = hidden
    nnet.update(vocab_size=VOCAB, sos=SOS, eos=EOS, ctc=True)
    return conf


def _wsj_wav(secs=(2.0, 1.5)):
    rng = np.random.default_rng(9)
    lens = np.array([int(s * 16000) for s in secs])
    wav = np.zeros((2, lens.max()), dtype=np.float32)
    for i, n in enumerate(lens):
        wav[i, :n] = 0.1 * rng.standard_normal(n)
    return wav, lens


def test_wsj_1a_delta_channels_give_aps_tpu_one_frame():
    """aps_tpu's WSJ 1a: the transform stacks the three delta orders on
    axis 1 (N x 3 x T x F) and its channel-last conv2d takes that as
    N x T x F x C: 3 "frames" of T "bins" and 80 channels, so two
    utterances of 2 s and 1.5 s leave the encoder with one frame, while
    enc_len says 50 and 37."""
    conf = _wsj_conf()
    jnnet = jax_libs.aps_asr_nnet("asr@att")(
        asr_transform=JaxTransform(**conf["asr_transform"]),
        **conf["nnet_conf"])
    wav, lens = _wsj_wav()
    variables = _init(jnnet, jnp.asarray(wav), jnp.asarray(lens),
                      method="decode_enc")
    kernel = variables["params"]["encoder"]["enc_list_0"]["conv_0"][
        "Conv_0"]["kernel"]
    assert kernel.shape == (3, 3, 80, 4)
    enc_out, enc_len, _ = _apply(jnnet, variables, jnp.asarray(wav),
                                 jnp.asarray(lens), method="decode_enc")
    assert enc_out.shape[:2] == (2, 1)
    assert np.asarray(enc_len).tolist() == [50, 37]


def test_wsj_1a_delta_channels_reach_conv2d_as_channels():
    """The port feeds the three orders to conv2d as its in_channels 3
    (N x 3 x T x F, channel-first) and matches aps_tpu's encoder fed the
    channel-last N x T x F x 3 it is written for (moveaxis inside apply,
    its variables initialised the same way)."""
    conf = _wsj_conf()
    jnnet = jax_libs.aps_asr_nnet("asr@att")(
        asr_transform=JaxTransform(**conf["asr_transform"]),
        **conf["nnet_conf"])
    wav, lens = _wsj_wav()

    def channel_last(mdl, wav, lens):
        feats, nf = mdl.asr_transform(wav, lens)
        return mdl.encoder(jnp.moveaxis(feats, 1, -1), nf)

    variables = _random_stats(_init(jnnet, jnp.asarray(wav),
                                    jnp.asarray(lens), method=channel_last))
    enc = variables["params"]["encoder"]
    assert enc["enc_list_0"]["conv_0"]["Conv_0"]["kernel"].shape == \
        (3, 3, 3, 4)
    want, want_len = _apply(jnnet, variables, jnp.asarray(wav),
                            jnp.asarray(lens), method=channel_last)
    nnet = aps_asr_nnet("asr@att")(
        asr_transform=aps_transform("asr")(**conf["asr_transform"]),
        **conf["nnet_conf"]).eval()
    encoder = {"params": enc, "batch_stats":
               variables["batch_stats"]["encoder"]}
    _load(nnet.encoder, encoder)
    with torch.no_grad():
        got, got_len = nnet._decoding_prep(torch.from_numpy(wav),
                                           torch.from_numpy(lens))
    assert got_len.tolist() == np.asarray(want_len).tolist() == [50, 37]
    assert got.shape == want.shape == (2, 50, 16)
    # log-mel of int16-scaled audio through the deltas and a BLSTM
    _close(_valid(got, got_len), _valid(want, want_len), 1e-4)
