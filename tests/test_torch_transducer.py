#!/usr/bin/env python
"""PyTorch port, the transducer (asr@transducer, asr@xfmr_transducer, the
asr@transducer task and rnnt_loss) against aps_tpu on JAX's CPU at toy
widths, on the same numpy inputs and converted weights: the joint network
and both models' forward; rnnt_loss at ragged T and U (U = 0 included)
against aps_tpu's and a brute-force path sum, its gradient (exactly 0 past
each length); the task's loss and gradients; greedy, beam and batched
searches with the RNN and the transformer prediction nets; RNN LM fusion;
the LM of the AM's dictionary, which aps_tpu fuses into NaN and the port
refuses; the converter's round trip; and the decode and decode_batch
commands with --device cpu on both checkpoints. The searches run on a
joint output layer scaled up (PEAKY), so that no near-tie of random
weights parts the two packages' rankings."""

import copy
import importlib.util
import json
import math
import pickle
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from aps_tpu import libs as jax_libs  # noqa: E402
from aps_tpu.asr.beam_search import lm as jax_lm  # noqa: E402
from aps_tpu.asr.beam_search import transducer as jax_search  # noqa: E402
from aps_tpu.ops.rnnt import rnnt_loss as jax_rnnt  # noqa: E402
from aps_tpu.transform import AsrTransform as JaxTransform  # noqa: E402
from aps_tpu_torch.asr.beam_search import transducer as search  # noqa
from aps_tpu_torch.asr.beam_search.lm import lm_adapter  # noqa: E402
from aps_tpu_torch.cmd import decode, decode_batch  # noqa: E402
from aps_tpu_torch.convert import (to_gradients, to_state_dict,  # noqa: E402
                                   to_variables)
from aps_tpu_torch.io import write_audio  # noqa: E402
from aps_tpu_torch.libs import aps_asr_nnet, aps_task, aps_transform  # noqa
from aps_tpu_torch.ops.rnnt import rnnt_loss  # noqa: E402

from test_torch_train import _leaves, assert_trees_close  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
VOCAB = 20
BLANK = VOCAB - 1
# the loss relative to itself (sums of a few hundred float32 log-probs)
LOSS_RTOL = 1e-5
# each gradient leaf relative to its own largest entry
GRAD_RTOL = 2e-3
# forward outputs relative to their largest entry
OUT_RTOL = 1e-5
# beam scores: length-normalised sums of float32 log-probs over the frames
SCORE_ATOL = 1e-4
# the joint's output layer and the LM's scaled so that candidates stand
# apart
PEAKY = 4.0
TRANSFORM = dict(feats="fbank-log-cmvn", frame_len=400, frame_hop=160,
                 window="hamm", num_mels=16)
# aishell_v1/1f's structure (conformer, rel pose, conv2d front end) at toy
# widths
ENC = dict(num_layers=1, proj="conv2d",
           proj_kwargs=dict(conv_channels=4, num_layers=2), pose="rel",
           pose_kwargs=dict(dropout=0.0, lradius=8, rradius=8),
           arch_kwargs=dict(att_dim=16, nhead=2, feedforward_dim=32,
                            att_dropout=0.0, ffn_dropout=0.0, kernel_size=3,
                            pre_norm=True))
NNETS = {
    "rnn": ("asr@transducer", dict(
        input_size=16, vocab_size=VOCAB, enc_type="cfmr", enc_kwargs=ENC,
        dec_kwargs=dict(embed_size=8, jot_dim=24, hidden=16, num_layers=2,
                        add_ln=True, dropout=0.0))),
    "xfmr": ("asr@xfmr_transducer", dict(
        input_size=16, vocab_size=VOCAB, enc_type="cfmr", enc_kwargs=ENC,
        dec_kwargs=dict(att_dim=16, jot_dim=24, num_layers=1,
                        arch_kwargs=dict(att_dim=16, nhead=2,
                                         feedforward_dim=32,
                                         att_dropout=0.0,
                                         ffn_dropout=0.0)))),
}
LM_CONF = dict(embed_size=8, rnn="lstm", num_layers=1, hidden_size=8,
               dropout=0.0)
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


def _seeded(module, seed):
    """module's weights seeded (scaled by fan-in), batch statistics off
    their initial values -> aps_tpu's variables tree of them."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            if p.requires_grad:
                fan_in = p[0].numel() if p.dim() > 1 else 1
                p.copy_(torch.randn(p.shape, generator=gen) *
                        (fan_in**-0.5 if p.dim() > 1 else 0.1))
        for name, b in module.named_buffers():
            if name.endswith("running_var"):
                b.copy_(1 + 0.2 * torch.rand(b.shape, generator=gen))
            elif name.endswith("running_mean"):
                b.copy_(0.1 * torch.randn(b.shape, generator=gen))
    return to_variables(module)


def _scale(module, variables, path, factor):
    node = variables["params"]
    for seg in path.split("/"):
        node = node[seg]
    node *= factor
    module.load_state_dict(to_state_dict(variables, module))
    return variables


def _wavs(seed, lens):
    rng = np.random.default_rng(seed)
    return [0.1 * rng.standard_normal(n).astype(np.float32) for n in lens]


def _pad(wavs):
    lens = np.array([len(w) for w in wavs])
    x = np.zeros((len(wavs), lens.max()), dtype=np.float32)
    for i, w in enumerate(wavs):
        x[i, :len(w)] = w
    return x, lens


def _models(kind, seed=1):
    """(flax model, numpy variables, port model in eval mode) with the
    fbank transform."""
    name, conf = NNETS[kind]
    port = aps_asr_nnet(name)(asr_transform=aps_transform("asr")(
        **TRANSFORM), **conf).eval()
    variables = _seeded(port, seed)
    variables = _scale(port, variables, "decoder/output/kernel", PEAKY)
    jnnet = jax_libs.aps_asr_nnet(name)(asr_transform=JaxTransform(
        **TRANSFORM), **conf)
    return jnnet, variables, port


@pytest.fixture(scope="module", params=sorted(NNETS))
def am(request):
    return (request.param,) + _models(request.param)


def _lm(vocab, seed=2):
    """(flax RNN LM, numpy variables, port LM) of `vocab` ids."""
    port = aps_asr_nnet("asr@rnn_lm")(vocab_size=vocab, **LM_CONF).eval()
    variables = _scale(port, _seeded(port, seed), "dist/kernel", PEAKY)
    return (jax_libs.aps_asr_nnet("asr@rnn_lm")(vocab_size=vocab,
                                                **LM_CONF),
            variables, port)


def _labels(seed, lens, U=None):
    rng = np.random.default_rng(seed)
    U = max(lens) if U is None else U
    tgt = rng.integers(0, BLANK, (len(lens), U))
    for i, n in enumerate(lens):
        tgt[i, n:] = -1
    return tgt, np.array(lens)


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------
def test_forward_matches_jax(am):
    """Both models' forward in eval mode on a ragged batch: the encoder
    output, its lengths and the joint's N x Ti x To+1 x V logits (the
    transformer prediction net with its padding mask)."""
    kind, jnnet, variables, port = am
    x, lens = _pad(_wavs(3, (8000, 6400, 5200)))
    tgt, tgt_len = _labels(4, (4, 2, 3))
    y = np.concatenate([np.full((3, 1), BLANK), np.where(tgt < 0, BLANK,
                                                         tgt)], 1)
    want = jax.jit(lambda v, *a: jnnet.apply(v, *a))(
        variables, jnp.asarray(x), jnp.asarray(lens), jnp.asarray(y),
        jnp.asarray(tgt_len + 1))
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(lens),
                   torch.from_numpy(y), torch.from_numpy(tgt_len + 1))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    _close(got[0].numpy(), want[0], OUT_RTOL, "enc_out")
    assert got[1].shape == (3, want[1].shape[1], 5, VOCAB)
    for i, n in enumerate(np.asarray(want[2])):
        _close(got[1][i, :n].numpy(), np.asarray(want[1])[i, :n], OUT_RTOL,
               "dec_out")


def test_joint_and_pred_steps_match_jax(am):
    """decode_joint on N x D frames, and a prediction-net step: the RNN's
    decode_pred from the zero state, the transformer's decode_pred_fixed
    over a blank-prefixed buffer read at ragged lengths and its stateful
    decode_pred over a prefix, which the buffer read at the prefix's end
    equals."""
    kind, jnnet, variables, port = am
    rng = np.random.default_rng(5)
    enc = rng.standard_normal((4, 16)).astype(np.float32)
    tok = rng.integers(0, VOCAB, (4, 6))
    tok[:, 0] = BLANK
    apply = lambda method, *a: jax.jit(lambda v, *b: jnnet.apply(
        v, *b, method=method))(variables, *a)
    with torch.no_grad():
        if kind == "rnn":
            state = port.decoder.init_state(4)
            got, _ = port.decode_pred(torch.from_numpy(tok[:, :1]), state)
            jstate = tuple((jnp.zeros((4, 16)), jnp.zeros((4, 16)))
                           for _ in range(2))
            want, _ = apply("decode_pred", jnp.asarray(tok[:, :1]), jstate)
        else:
            lens = np.array([0, 2, 5, 3])
            got = port.decode_pred_fixed(torch.from_numpy(tok),
                                         torch.from_numpy(lens))
            want = apply("decode_pred_fixed", jnp.asarray(tok),
                         jnp.asarray(lens))
            # the stateful step over the same prefix, token by token
            hidden, jhidden = None, None
            for t in range(3):
                step, hidden = port.decode_pred(
                    torch.from_numpy(tok[:, t:t + 1]), hidden)
                jstep, jhidden = jax.jit(lambda v, x, h: jnnet.apply(
                    v, x, h, method="decode_pred"))(
                        variables, jnp.asarray(tok[:, t:t + 1]), jhidden)
                _close(step.numpy(), jstep, OUT_RTOL, f"pred step {t}")
            fixed = port.decode_pred_fixed(
                torch.from_numpy(tok), torch.full((4,), 2))
            _close(step.numpy(), fixed.numpy(), OUT_RTOL, "pred vs fixed")
        _close(got.numpy(), want, OUT_RTOL, "pred")
        logits = port.decode_joint(torch.from_numpy(enc), got)
    _close(logits.numpy(), apply("decode_joint", jnp.asarray(enc), want),
           OUT_RTOL, "joint")


def test_converter_round_trip(am):
    """to_variables of the loaded port model gives back aps_tpu's tree,
    leaf for leaf (LSTM gates, embeddings, the prediction net's
    attention)."""
    kind, jnnet, variables, port = am
    shapes = jax.eval_shape(lambda: jnnet.init(
        {"params": KEY}, jnp.zeros((1, 8000)), jnp.asarray([8000]),
        jnp.zeros((1, 3), jnp.int32), jnp.asarray([3])))
    back = to_variables(port)
    for col in ("params", "batch_stats"):
        want = dict(_leaves(jax.tree_util.tree_map(
            lambda s: np.zeros(s.shape), shapes[col])))
        got = dict(_leaves(back[col]))
        assert sorted(got) == sorted(want)
        assert all(got[k].shape == want[k].shape for k in want)
        for k, v in _leaves(variables[col]):
            np.testing.assert_array_equal(got[k], v)


# ---------------------------------------------------------------------------
# rnnt_loss
# ---------------------------------------------------------------------------
def _brute_force(lp, lab, Tn, Un, blank):
    """The transducer NLL by a plain dynamic programme over one utterance's
    lattice (float64 on the host)."""
    alpha = np.full((Tn, Un + 1), -np.inf)
    alpha[0, 0] = 0.0
    for t in range(Tn):
        for u in range(Un + 1):
            if t == 0 and u == 0:
                continue
            cands = []
            if t > 0:
                cands.append(alpha[t - 1, u] + lp[t - 1, u, blank])
            if u > 0:
                cands.append(alpha[t, u - 1] + lp[t, u - 1, lab[u - 1]])
            alpha[t, u] = np.logaddexp.reduce(cands)
    return -(alpha[Tn - 1, Un] + lp[Tn - 1, Un, blank])


RNNT_CASES = {
    # N, T, U, V, frame lengths, label lengths
    "ragged": (3, 7, 4, 6, (7, 5, 3), (4, 2, 0)),
    "long": (4, 40, 24, 12, (40, 33, 17, 9), (24, 11, 0, 6)),
    "full": (2, 12, 5, 8, (12, 12), (5, 5)),
}


@pytest.mark.parametrize("case", sorted(RNNT_CASES))
@pytest.mark.parametrize("reduction", ["none", "sum", "mean"])
def test_rnnt_loss_matches_jax(case, reduction):
    """The loss against aps_tpu's (and against a brute-force path sum),
    and its gradient: each utterance's within GRAD_RTOL of its largest
    entry, and exactly 0 past its frames and past its labels, as
    jax.grad's is."""
    N, T, U, V, tls, lls = RNNT_CASES[case]
    rng = np.random.default_rng(len(case))
    logits = (2 * rng.standard_normal((N, T, U + 1, V))).astype(np.float32)
    labels, ll = _labels(7, lls, U=U)
    labels = np.where(labels < 0, V - 1, labels % (V - 1))
    tl = np.array(tls)
    blank = V - 1
    fn = lambda x: jax_rnnt(x, jnp.asarray(labels), jnp.asarray(tl),
                            jnp.asarray(ll), blank=blank,
                            reduction=reduction)
    want = np.asarray(fn(jnp.asarray(logits)))
    want_grad = np.asarray(jax.grad(lambda x: jnp.sum(fn(x)))(
        jnp.asarray(logits)))
    x = torch.from_numpy(logits).requires_grad_()
    got = rnnt_loss(x, torch.from_numpy(labels), torch.from_numpy(tl),
                    torch.from_numpy(ll), blank=blank, reduction=reduction)
    got.sum().backward()
    _close(got.detach().numpy(), want, LOSS_RTOL, "loss")
    grad = x.grad.numpy()
    assert np.isfinite(grad).all()
    for n in range(N):
        _close(grad[n], want_grad[n], GRAD_RTOL, f"grad {n}")
        assert not grad[n, tl[n]:].any() and not want_grad[n, tl[n]:].any()
        assert not grad[n, :, ll[n] + 1:].any()
        assert not want_grad[n, :, ll[n] + 1:].any()
    if ll.min() == 0:
        # U = 0: only the u = 0 column carries gradient
        n = int(np.argmin(ll))
        assert grad[n, :tl[n], 0].any()
    if reduction == "none":
        lp = torch.log_softmax(torch.from_numpy(logits).double(),
                               -1).numpy()
        ref = [_brute_force(lp[n], labels[n], tl[n], ll[n], blank)
               for n in range(N)]
        np.testing.assert_allclose(got.detach().numpy(), ref, rtol=1e-5)


# ---------------------------------------------------------------------------
# the task
# ---------------------------------------------------------------------------
def _jax_step(jtask, variables, egs):
    jegs = {k: jnp.asarray(v) for k, v in egs.items()}
    mutable = [k for k in variables if k != "params"]

    def loss_fn(params):
        out, state = jtask.apply(
            {"params": params, **{k: variables[k] for k in mutable}}, jegs,
            training=True, mutable=mutable,
            rngs={"dropout": KEY, "aug": KEY})
        return out["loss"], out

    (_, out), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])
    return out, grads["nnet"]


def _port_step(task, egs, dtype=torch.float32):
    task = task.to(dtype).train()
    tegs = {k: torch.from_numpy(v) for k, v in egs.items()}
    tegs["src_pad"] = tegs["src_pad"].to(dtype)
    task.zero_grad()
    out = task(tegs)
    out["loss"].backward()
    return out, to_gradients(task.nnet)


@pytest.mark.parametrize("reduction", ["batchmean", "mean"])
def test_task_matches_jax(am, reduction):
    """An asr@transducer training pass (the conformer's batch norm on the
    batch) on a ragged batch, one target sequence empty: the loss and
    every gradient leaf, each within GRAD_RTOL of its own largest entry."""
    kind, jnnet, variables, port = am
    x, lens = _pad(_wavs(8, (8000, 7200, 5600)))
    tgt, tgt_len = _labels(9, (5, 0, 3))
    egs = {"src_pad": x, "src_len": lens, "tgt_pad": tgt, "tgt_len": tgt_len}
    conf = dict(blank=BLANK, reduction=reduction)
    jtask = jax_libs.aps_task("asr@transducer", jnnet, **conf)
    task = aps_task("asr@transducer", copy.deepcopy(port), **conf)
    jvars = {col: {"nnet": tree} for col, tree in variables.items()}
    out, grads = _jax_step(jtask, jvars, egs)
    exact = copy.deepcopy(task)
    got, got_grads = _port_step(task, egs)
    _close(got["loss"].item(), out["loss"], LOSS_RTOL, "loss")
    _, exact_grads = _port_step(exact, egs, torch.float64)
    assert_trees_close(got_grads, grads, GRAD_RTOL, exact=exact_grads)


# ---------------------------------------------------------------------------
# the searches
# ---------------------------------------------------------------------------
def _same_nbest(got, want, atol=SCORE_ATOL):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert [h["trans"] for h in g] == [h["trans"] for h in w]
        for a, b in zip(g, w):
            assert abs(a["score"] - b["score"]) <= atol, (a, b)


@pytest.mark.parametrize("fn,kw", [
    ("greedy_search", dict()),
    ("beam_search", dict(beam_size=4, nbest=3)),
    ("beam_search", dict(beam_size=3, nbest=2, len_norm=False)),
])
def test_search_matches_jax(am, fn, kw):
    """greedy_search and beam_search on one utterance (aps_tpu pads its
    encoder frames to a bucket and freezes them; the port runs them as
    they are): the same n-best lists, scores within SCORE_ATOL, and some
    tokens emitted."""
    kind, jnnet, variables, port = am
    wav = _wavs(10, (12000,))[0]
    want = getattr(jax_search, fn)(jnnet, variables, jnp.asarray(wav), **kw)
    got = getattr(search, fn)(port, wav, **kw)
    _same_nbest([got], [want])
    assert len(got[0]["trans"]) > 2
    assert got[0]["trans"][0] == got[0]["trans"][-1] == BLANK


def test_search_batch_matches_jax(am):
    """beam_search_batch on three utterances of unequal lengths padded to
    a bucket: each utterance's lanes frozen past its frames."""
    kind, jnnet, variables, port = am
    batch = _wavs(11, (12000, 9000, 10400))
    kw = dict(beam_size=4, nbest=3, pad_to=12800)
    want = jax_search.beam_search_batch(jnnet, variables, batch, **kw)
    got = search.beam_search_batch(port, batch, **kw)
    _same_nbest(got, want)


@pytest.mark.parametrize("batched", [False, True])
def test_lm_fusion_matches_jax(am, batched):
    """Shallow fusion with an RNN LM of the AM's vocabulary V (so it holds
    the blank it starts from), weight 0.3: the same n-best lists."""
    kind, jnnet, variables, port = am
    jlm, lm_vars, port_lm = _lm(VOCAB)
    kw = dict(beam_size=4, nbest=3, lm_weight=0.3)
    jadapter = jax_lm.lm_adapter(jlm, lm_vars)
    adapter = lm_adapter(port_lm)
    if batched:
        batch = _wavs(12, (11000, 8000))
        want = jax_search.beam_search_batch(jnnet, variables, batch,
                                            lm=jadapter, **kw)
        got = search.beam_search_batch(port, batch, lm=adapter, **kw)
    else:
        wav = _wavs(13, (11000,))[0]
        want = [jax_search.beam_search(jnnet, variables, jnp.asarray(wav),
                                       lm=jadapter, **kw)]
        got = [search.beam_search(port, wav, lm=adapter, **kw)]
    _same_nbest(got, want)
    plain = search.beam_search_batch(port, [_wavs(13, (11000,))[0]],
                                     beam_size=4, nbest=3)
    if not batched:
        assert plain[0][0]["score"] != got[0][0]["score"]


def test_lm_without_the_blank_raises(am):
    """An LM of the AM's dictionary (vocabulary V - 1) cannot take the
    blank id V - 1 it would be started from: aps_tpu's flax embedding then
    gives NaN log-probs, and its fused search emits nothing; the port
    raises a ValueError that names both vocabularies, in its searches and
    in its commands' check, before any frame."""
    kind, jnnet, variables, port = am
    jlm, lm_vars, port_lm = _lm(VOCAB - 1)
    jadapter = jax_lm.lm_adapter(jlm, lm_vars)
    logp, _ = jadapter.step(jadapter.init_state(2),
                            jnp.full((2,), BLANK, jnp.int32), 0)
    assert np.isnan(np.asarray(logp)).all()
    wav = _wavs(14, (11000,))[0]
    fused = jax_search.beam_search(jnnet, variables, jnp.asarray(wav),
                                   lm=jadapter, lm_weight=0.3, beam_size=4)
    plain = jax_search.beam_search(jnnet, variables, jnp.asarray(wav),
                                   beam_size=4)
    assert fused[0]["trans"] == [BLANK, BLANK]
    assert len(plain[0]["trans"]) > 2
    adapter = lm_adapter(port_lm)
    for call in (lambda: search.beam_search(port, wav, lm=adapter,
                                            lm_weight=0.3),
                 lambda: search.beam_search_batch(port, [wav], lm=adapter,
                                                  lm_weight=0.3),
                 lambda: search.check_lm(port, adapter, 0.3)):
        with pytest.raises(ValueError, match=f"{VOCAB}.*{VOCAB - 1}"):
            call()
    # without the weight the LM is not used, in either package
    assert search.check_lm(port, adapter, 0) is False


# ---------------------------------------------------------------------------
# the commands
# ---------------------------------------------------------------------------
def jax_command(name: str):
    spec = importlib.util.spec_from_file_location(f"jax_cmd_{name}",
                                                  REPO / "cmd" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _write_dict(path: Path, vocab: int) -> None:
    with open(path, "w") as fd:
        fd.write("<unk> 0\n")
        for i in range(1, vocab):
            fd.write(f"w{i} {i}\n")


def _checkpoint(root: Path, name: str, nnet_conf, variables, task: str):
    root.mkdir()
    conf = {"nnet": name, "nnet_conf": nnet_conf, "task": task,
            "task_conf": {"blank": nnet_conf["vocab_size"] - 1},
            "data_conf": {}, "trainer_conf": {}}
    if task != "asr@lm":
        conf["asr_transform"] = TRANSFORM
    (root / "train.yaml").write_text(json.dumps(conf))
    with open(root / "best.ckpt", "wb") as fd:
        pickle.dump({"params": {"nnet": variables["params"]},
                     "mstate": {"batch_stats": variables.get(
                         "batch_stats", {})}, "epoch": 2}, fd)
    return str(root)


@pytest.fixture(scope="module")
def workspace(am, tmp_path_factory):
    """The AM's checkpoint directory, an RNN LM checkpoint of vocabulary V
    and one of V - 1, the dict (V - 1 ids: the blank is the AM's last) and
    a wav.scp of three waveforms."""
    kind, _, variables, port = am
    root = tmp_path_factory.mktemp(f"transducer_cmds_{kind}")
    name, conf = NNETS[kind]
    out = {"am": _checkpoint(root / "am", name, conf, variables,
                             "asr@transducer")}
    for tag, vocab in (("lm", VOCAB), ("lm_dict", VOCAB - 1)):
        _, lm_vars, _ = _lm(vocab)
        out[tag] = _checkpoint(root / tag, "asr@rnn_lm",
                               dict(LM_CONF, vocab_size=vocab), lm_vars,
                               "asr@lm")
    _write_dict(root / "dict", VOCAB - 1)
    with open(root / "wav.scp", "w") as scp:
        for i, wav in enumerate(_wavs(15, (12000, 10000, 11200))):
            write_audio(str(root / f"u{i}.wav"), wav)
            scp.write(f"u{i} {root / f'u{i}.wav'}\n")
    out.update(dict=str(root / "dict"), scp=str(root / "wav.scp"),
               variables=variables)
    return out


@pytest.mark.parametrize("command,extra", [
    ("decode", ["--function", "beam_search"]),
    ("decode", ["--function", "greedy_search", "--nbest", "1"]),
    ("decode_batch", ["--batch-size", "3"]),
])
def test_commands_match_jax(workspace, tmp_path, monkeypatch, command,
                            extra):
    """decode (beam and greedy) and decode_batch --device cpu on the
    transducer checkpoint against aps_tpu's cmd/decode.py and
    cmd/decode_batch.py with the same arguments: the same transcripts."""
    argv = ["--am", workspace["am"], "--dict", workspace["dict"],
            "--beam-size", "4", "--device", "cpu"] + extra
    port = decode if command == "decode" else decode_batch
    monkeypatch.syspath_prepend(str(REPO / "cmd"))
    outs = []
    for name, run in (("port", port.run),
                      ("jax", jax_command(command).run)):
        best = tmp_path / f"best.{name}"
        args = port.make_parser().parse_args([workspace["scp"], str(best)] +
                                             argv)
        args.data_parallel = False
        run(args)
        outs.append(sorted(best.read_text().splitlines()))
    assert outs[0] == outs[1] and len(outs[0]) == 3


def test_command_lm_fusion(am, workspace, tmp_path):
    """decode_batch and decode --lm (an RNN LM of vocabulary V) fuse it:
    the transcripts of aps_tpu's searches called with the LM (aps_tpu's
    commands drop it: decode_batch's --lm altogether, decode's lm_weight
    for a transducer). An LM of the dictionary (V - 1) raises the
    ValueError before the first utterance."""
    kind, jnnet, variables, port = am
    jlm, lm_vars, _ = _lm(VOCAB)
    jadapter = jax_lm.lm_adapter(jlm, lm_vars)
    keys = ["u0", "u1", "u2"]
    wavs = _wavs(15, (12000, 10000, 11200))
    vocab = {i: f"w{i}" for i in range(1, VOCAB - 1)}
    for command in (decode, decode_batch):
        best = tmp_path / f"best.{command.__name__}"
        argv = [workspace["scp"], str(best), "--am", workspace["am"],
                "--dict", workspace["dict"], "--beam-size", "4",
                "--lm", workspace["lm"], "--lm-weight", "0.3",
                "--device", "cpu"]
        if command is decode_batch:
            argv += ["--batch-size", "3"]
        command.run(command.make_parser().parse_args(argv))
        got = dict(line.split("\t") for line in
                   best.read_text().splitlines())
        for key, wav in zip(keys, wavs):
            hyp = jax_search.beam_search(jnnet, variables, jnp.asarray(wav),
                                         lm=jadapter, lm_weight=0.3,
                                         beam_size=4, nbest=1)
            want = " ".join(vocab[t] for t in hyp[0]["trans"][1:-1])
            assert got[key] == want
        argv[argv.index(workspace["lm"])] = workspace["lm_dict"]
        best.unlink()
        with pytest.raises(ValueError, match="blank"):
            command.run(command.make_parser().parse_args(argv))
        assert not best.exists()

