#!/usr/bin/env python
"""PyTorch port, language models against aps_tpu at toy width with
converted weights: asr@rnn_lm (lstm, gru with proj_size and add_ln, tanh
rnn) and asr@xfmr_lm, their search adapters, shallow fusion in
beam_search_batch and beam_search, the ARPA n-gram, the decode,
decode_batch and lm_rescore commands, the lm@utt and lm@bptt loaders,
the asr@lm task, the train_lm command and the trainer's OOM skip."""

import copy
import importlib.util
import json
import pickle
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from __graft_entry__ import _build_flagship  # noqa: E402
from aps_tpu import libs as jax_libs  # noqa: E402
from aps_tpu.asr.beam_search import lm as jax_lm  # noqa: E402
from aps_tpu.asr.beam_search import transformer as jax_search  # noqa
from aps_tpu.asr.lm import ngram as jax_ngram  # noqa: E402
from aps_tpu.io import write_audio  # noqa: E402
from aps_tpu_torch.asr.beam_search import transformer as search  # noqa
from aps_tpu_torch.asr.beam_search.lm import lm_adapter  # noqa: E402
from aps_tpu_torch.asr.lm import ngram  # noqa: E402
from aps_tpu_torch.cmd import (decode, decode_batch, lm_rescore,  # noqa
                               train_lm)
from aps_tpu_torch.convert import (to_gradients, to_state_dict,  # noqa
                                   to_variables)
from aps_tpu_torch.flagship import build_flagship, flagship_conf  # noqa
from aps_tpu_torch.libs import aps_asr_nnet, aps_dataloader, aps_task  # noqa
from aps_tpu_torch.trainer.dp import DataParallelTrainer  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
VOCAB = 64  # the AM's, with the CTC blank; the dict and the LMs: VOCAB - 1
SOS, EOS = VOCAB - 3, VOCAB - 2
LM_VOCAB = VOCAB - 1
# logits and states of a width <= 64 LM in float32: the same math in
# another summation order
LM_ATOL = 1e-5
# beam scores are length-normalised sums of ~30 fused log-probs
SCORE_ATOL = 1e-3
# output layers are scaled on both sides so candidates are well apart and
# near-ties cannot flip the ranking (random weights)
PEAKY = 4.0
LM_PEAKY = 3.0
LM_CONFS = {
    "lstm": dict(embed_size=16, vocab_size=LM_VOCAB, rnn="lstm",
                 num_layers=2, hidden_size=32, dropout=0.0),
    "gru": dict(embed_size=16, vocab_size=LM_VOCAB, rnn="gru", num_layers=2,
                hidden_size=32, proj_size=24, add_ln=True, dropout=0.0),
    "rnn": dict(embed_size=LM_VOCAB, vocab_size=LM_VOCAB, rnn="rnn",
                num_layers=2, hidden_size=32, dropout=0.0),
    "xfmr": dict(vocab_size=LM_VOCAB, num_layers=2,
                 arch_kwargs=dict(att_dim=32, nhead=2, feedforward_dim=64,
                                  att_dropout=0.0, ffn_dropout=0.0)),
}
LM_NAMES = {"xfmr": "asr@xfmr_lm"}
# the task's loss, @ppl and accu, and each gradient relative to its largest
# entry, port vs flax at one step
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4


def lm_name(kind: str) -> str:
    return LM_NAMES.get(kind, "asr@rnn_lm")


def jax_lm_pair(kind: str, seed: int = 0):
    """(flax LM, its variables as numpy, the port's LM with the same
    weights, eval mode)."""
    conf = LM_CONFS[kind]
    jnnet = jax_libs.aps_asr_nnet(lm_name(kind))(**conf)
    variables = jnnet.init(jax.random.PRNGKey(seed),
                           jnp.zeros((2, 5), jnp.int32))
    variables = jax.tree_util.tree_map(np.array, dict(variables))
    variables["params"]["dist"]["kernel"] *= LM_PEAKY
    port = aps_asr_nnet(lm_name(kind))(**conf).eval()
    port.load_state_dict(to_state_dict(variables, port))
    return jnnet, variables, port


@pytest.fixture(scope="module")
def lms():
    return {kind: jax_lm_pair(kind, seed=i)
            for i, kind in enumerate(("lstm", "gru", "xfmr"))}


@pytest.fixture(scope="module")
def am():
    """(flax AM, numpy variables, port AM, waveforms, lengths): the toy
    flagship of test_torch_asr_decode.py."""
    rng = np.random.default_rng(21)
    lens = np.array([32000, 26000])
    wav = np.zeros((2, 32000), dtype=np.float32)
    for i, n in enumerate(lens):
        wav[i, :n] = 0.1 * rng.standard_normal(n)
    nnet = _build_flagship(vocab_size=VOCAB, small=True)
    variables = nnet.init({"params": jax.random.PRNGKey(0)},
                          jnp.asarray(wav), jnp.asarray(lens),
                          jnp.zeros((2, 4), jnp.int32),
                          jnp.asarray([4, 4]), training=False)
    variables = jax.tree_util.tree_map(np.array, dict(variables))
    variables["params"]["decoder"]["output"]["kernel"] *= PEAKY
    variables["params"]["ctc_head"]["kernel"] *= PEAKY
    model = build_flagship(flagship_conf(VOCAB, small=True)).eval()
    model.load_state_dict(to_state_dict(variables, model))
    return nnet, variables, model, wav, lens


def _flat_state(state):
    if isinstance(state, (tuple, list)):
        return [x for s in state for x in _flat_state(s)]
    return [np.asarray(state)]


# ---------------------------------------------------------------------------
# the models and the converter
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["lstm", "gru", "rnn", "xfmr"])
def test_lm_matches_jax_whole_and_token_by_token(kind):
    """Logits and carried state of a whole sequence, then of the same
    tokens fed one at a time with the state carried (the Transformer LM's
    state is the embedded prefix)."""
    jnnet, variables, port = jax_lm_pair(kind, seed=3)
    rng = np.random.default_rng(4)
    tok = rng.integers(0, LM_VOCAB, (3, 4))
    want, want_state = jnnet.apply(variables, jnp.asarray(tok))
    with torch.no_grad():
        got, got_state = port(torch.from_numpy(tok))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LM_ATOL)
    for g, w in zip(_flat_state(got_state), _flat_state(want_state)):
        np.testing.assert_allclose(g, w, atol=LM_ATOL)
    state_j = state_p = None
    for t in range(tok.shape[1]):
        step_w, state_j = jnnet.apply(variables, jnp.asarray(tok[:, t:t + 1]),
                                      state_j)
        with torch.no_grad():
            step_g, state_p = port(torch.from_numpy(tok[:, t:t + 1]),
                                   state_p)
        np.testing.assert_allclose(step_g[:, -1].numpy(),
                                   np.asarray(step_w)[:, -1], atol=LM_ATOL)
        np.testing.assert_allclose(step_g[:, -1].numpy(), want[:, t],
                                   atol=LM_ATOL)
    for g, w in zip(_flat_state(state_p), _flat_state(state_j)):
        np.testing.assert_allclose(g, w, atol=LM_ATOL)


@pytest.mark.parametrize("kind", ["lstm", "gru", "rnn", "xfmr"])
def test_lm_weights_round_trip(kind):
    """flax -> port -> flax is exact, also after the GRU's r and z
    hidden-side biases (which flax folds into its input-side ones) moved;
    the LSTM's input-side and the RNN's hidden-side biases stay frozen at
    0; tie_weights changes nothing, as in aps_tpu."""
    _, variables, port = jax_lm_pair(kind)
    back = to_variables(port)
    flat_a = jax.tree_util.tree_leaves_with_path(variables)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, val in flat_a:
        np.testing.assert_array_equal(flat_b[path], val)
    frozen = [k for k, p in port.named_parameters() if not p.requires_grad]
    want = {"lstm": ["bias_ih_l0"], "rnn": ["bias_hh_l0"]}.get(kind, [])
    assert sorted({k.split(".")[-1] for k in frozen}) == want
    if kind == "gru":
        moved = copy.deepcopy(port)
        cell = moved.pred.GRUCell_0
        with torch.no_grad():
            cell.bias_hh_l0[:32] += 0.25
            cell.bias_ih_l0[:32] -= 0.25
        for path, val in jax.tree_util.tree_leaves_with_path(
                to_variables(moved)):
            np.testing.assert_allclose(val, flat_b[path], atol=1e-6)
    if kind != "xfmr":
        tied = aps_asr_nnet("asr@rnn_lm")(**LM_CONFS[kind], tie_weights=True)
        assert sorted(tied.state_dict()) == sorted(port.state_dict())


@pytest.mark.parametrize("kind", ["lstm", "xfmr"])
def test_lm_adapters_match_jax(kind, lms):
    """Three adapter steps over 2 utterances x 3 beams, the state
    reordered between them: log-probs and states equal."""
    jnnet, variables, port = lms[kind]
    lanes, max_len = 6, 8
    ja = jax_lm.lm_adapter(jnnet, variables, max_len=max_len, sos=SOS)
    pa = lm_adapter(port, max_len=max_len, sos=SOS)
    state_j, state_p = ja.init_state(lanes), pa.init_state(lanes)
    rng = np.random.default_rng(7)
    with torch.no_grad():
        for t in range(3):
            tok = rng.integers(0, LM_VOCAB, lanes)
            want, state_j = ja.step(state_j, jnp.asarray(tok), t)
            got, state_p = pa.step(state_p, torch.from_numpy(tok), t)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=LM_ATOL)
            beam_idx = np.array([0, 0, 2, 4, 3, 3])
            state_j = ja.reorder(state_j, jnp.asarray(beam_idx))
            state_p = pa.reorder(state_p, torch.from_numpy(beam_idx))
            for g, w in zip(_flat_state(state_p), _flat_state(state_j)):
                np.testing.assert_allclose(g, w, atol=LM_ATOL)


# ---------------------------------------------------------------------------
# shallow fusion in the search
# ---------------------------------------------------------------------------
def _assert_nbest_equal(got, want, some=True):
    assert len(got) == len(want) and (want or not some)
    for g, w in zip(got, want):
        assert g["trans"] == w["trans"]
        assert abs(g["score"] - w["score"]) <= SCORE_ATOL


@pytest.mark.parametrize("kind", ["lstm", "xfmr"])
@pytest.mark.parametrize("lm_weight,ctc_weight", [(0.2, 0.4), (0.5, 0.4),
                                                  (0.2, 0.0), (0.5, 0.0)])
def test_beam_search_batch_with_lm_matches_jax(am, lms, kind, lm_weight,
                                               ctc_weight):
    """beam_search_batch with the LM's adapter against aps_tpu's
    beam_search_batch(..., lm=lm_adapter(...)): the same n-best tokens,
    scores within 1e-3."""
    nnet, variables, model, wav, lens = am
    jlm, lm_vars, port_lm = lms[kind]
    batch = [wav[i, :n] for i, n in enumerate(lens)]
    max_len = 16
    kw = dict(sos=SOS, eos=EOS, beam_size=4, nbest=3, max_len=max_len,
              ctc_weight=ctc_weight, lm_weight=lm_weight,
              allow_partial=True)
    want = jax_search.beam_search_batch(
        nnet, variables, batch,
        lm=jax_lm.lm_adapter(jlm, lm_vars, max_len=max_len, sos=SOS), **kw)
    got = search.beam_search_batch(
        model, batch, lm=lm_adapter(port_lm, max_len=max_len, sos=SOS), **kw)
    plain = search.beam_search_batch(model, batch, **kw)
    assert len(got) == len(want) == 2
    for hyps_g, hyps_w in zip(got, want):
        _assert_nbest_equal(hyps_g, hyps_w)
    # the LM moved the scores
    assert any(abs(g[0]["score"] - p[0]["score"]) > 1e-3
               for g, p in zip(got, plain))


@pytest.mark.parametrize("kind,ctc_weight", [("lstm", 0.4), ("xfmr", 0.0)])
def test_beam_search_batch_end_detect_with_lm_matches_jax(am, lms, kind,
                                                          ctc_weight):
    """End detection with the eos logit boosted, so that utterances stop
    at different steps and the LM state of a stopped one is kept."""
    nnet, variables, _, wav, lens = am
    jlm, lm_vars, port_lm = lms[kind]
    boosted = jax.tree_util.tree_map(np.array, variables)
    boosted["params"]["decoder"]["output"]["kernel"][:, EOS] *= 3.0
    model = build_flagship(flagship_conf(VOCAB, small=True)).eval()
    model.load_state_dict(to_state_dict(boosted, model))
    lm_vars = jax.tree_util.tree_map(np.array, lm_vars)
    lm_vars["params"]["dist"]["bias"][EOS] += 4.0
    port_lm = copy.deepcopy(port_lm)
    port_lm.load_state_dict(to_state_dict(lm_vars, port_lm))
    batch = [wav[i, :n] for i, n in enumerate(lens)]
    kw = dict(sos=SOS, eos=EOS, beam_size=4, nbest=2, max_len=32,
              ctc_weight=ctc_weight, lm_weight=0.3, end_detect=True)
    want = jax_search.beam_search_batch(
        nnet, boosted, batch,
        lm=jax_lm.lm_adapter(jlm, lm_vars, max_len=32, sos=SOS), **kw)
    got = search.beam_search_batch(
        model, batch, lm=lm_adapter(port_lm, max_len=32, sos=SOS), **kw)
    assert any(len(h) for h in want)
    for hyps_g, hyps_w in zip(got, want):
        _assert_nbest_equal(hyps_g, hyps_w, some=False)
        assert all(h["trans"][-1] == EOS for h in hyps_g)


@pytest.mark.parametrize("kind,lm_weight,ctc_weight", [
    ("lstm", 0.5, 0.4), ("lstm", 0.2, 0.0), ("xfmr", 0.2, 0.4),
    ("xfmr", 0.5, 0.0)])
def test_beam_search_with_lm_matches_jax(am, lms, kind, lm_weight,
                                         ctc_weight):
    """The single-utterance beam_search with an LM (aps_tpu pads the
    encoder output to a frame bucket; the port does not)."""
    nnet, variables, model, wav, lens = am
    jlm, lm_vars, port_lm = lms[kind]
    x = wav[1, :lens[1]]
    kw = dict(sos=SOS, eos=EOS, beam_size=4, nbest=3, max_len=12,
              ctc_weight=ctc_weight, lm_weight=lm_weight,
              allow_partial=True)
    want = jax_search.beam_search(
        nnet, variables, jnp.asarray(x),
        lm=jax_lm.lm_adapter(jlm, lm_vars, max_len=12, sos=SOS), **kw)
    got = search.beam_search(model, x,
                             lm=lm_adapter(port_lm, max_len=12, sos=SOS),
                             **kw)
    _assert_nbest_equal(got, want)
    greedy = search.greedy_search(model, x, **kw)
    want = jax_search.greedy_search(nnet, variables, jnp.asarray(x), **kw)
    _assert_nbest_equal(greedy, want)


# ---------------------------------------------------------------------------
# the n-gram
# ---------------------------------------------------------------------------
ARPA = """\\data\\
ngram 1=6
ngram 2=4
ngram 3=2

\\1-grams:
-0.8\t<s>\t-0.3
-0.6\tw1\t-0.2
-0.9\tw2\t-0.4
-1.2\tw3\t-0.1
-0.7\t</s>
-3.0\t<unk>

\\2-grams:
-0.2\t<s> w1\t-0.1
-0.3\tw1 w2\t-0.2
-0.4\tw2 w3
-0.1\tw3 </s>

\\3-grams:
-0.05\t<s> w1 w2
-0.02\tw1 w2 w3

\\end\\
"""


def _lm_dict(path: Path) -> str:
    """The dict of the toy AM and LMs: <unk>, w1.., <sos>, <eos>."""
    with open(path, "w") as fd:
        fd.write("<unk> 0\n")
        for i in range(1, SOS):
            fd.write(f"w{i} {i}\n")
        fd.write(f"<sos> {SOS}\n<eos> {EOS}\n")
    return str(path)


@pytest.fixture(scope="module")
def lm_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("lm_files")
    (root / "lm.arpa").write_text(ARPA)
    return str(root / "lm.arpa"), _lm_dict(root / "dict")


def test_ngram_scores_match_jax(lm_files):
    arpa, dict_path = lm_files
    port, ref = ngram.ArpaModel(arpa), jax_ngram.ArpaModel(arpa)
    assert port.order == ref.order == 3
    for sent in ("w1 w2 w3", "w3 w2 w1", "w1 w9", "", "w2 w2 w2 w2"):
        for bos in (True, False):
            for eos in (True, False):
                assert port.score(sent, bos=bos, eos=eos) == \
                    ref.score(sent, bos=bos, eos=eos)
    from aps_tpu_torch.conf import load_dict
    vocab = load_dict(dict_path)
    lm, jlm = ngram.NgramLM(arpa, vocab), jax_ngram.NgramLM(arpa, vocab)
    for hyp in ([1, 2, 3], [3, 1], [0, 5], []):
        assert lm.score(hyp) == jlm.score(hyp)
    binary = Path(arpa).with_suffix(".bin")
    binary.write_bytes(b"mmap lm binary")
    with pytest.raises(ImportError, match="kenlm"):
        ngram.NgramLM(str(binary), vocab)
    with pytest.raises(ImportError, match="kenlm"):
        jax_ngram.NgramLM(str(binary), vocab)


# ---------------------------------------------------------------------------
# the commands
# ---------------------------------------------------------------------------
def jax_command(name: str):
    spec = importlib.util.spec_from_file_location(f"jax_cmd_{name}",
                                                  REPO / "cmd" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def write_lm_checkpoint(root: Path, kind: str, variables) -> str:
    """An LM checkpoint directory as train_lm writes it: train.yaml (sos
    and eos at the top level, task_conf empty) and best.ckpt."""
    root.mkdir(parents=True, exist_ok=True)
    conf = {"nnet": lm_name(kind), "nnet_conf": LM_CONFS[kind],
            "task": "asr@lm", "task_conf": {}, "data_conf": {},
            "trainer_conf": {}, "sos": SOS, "eos": EOS}
    (root / "train.yaml").write_text(json.dumps(conf))
    with open(root / "best.ckpt", "wb") as fd:
        pickle.dump({"params": variables["params"], "epoch": 1}, fd)
    return str(root)


@pytest.fixture(scope="module")
def workspace(am, lms, lm_files, tmp_path_factory):
    """An AM checkpoint, LM checkpoints, a wav.scp of the two waveforms,
    the dict and the ARPA file."""
    _, _, model, wav, lens = am
    root = tmp_path_factory.mktemp("lm_cmds")
    cpt = root / "am"
    cpt.mkdir()
    conf = dict(flagship_conf(VOCAB, small=True), task="asr@ctc_xent",
                task_conf={}, data_conf={}, trainer_conf={})
    (cpt / "train.yaml").write_text(json.dumps(conf))
    variables = to_variables(model)
    with open(cpt / "best.ckpt", "wb") as fd:
        pickle.dump({"params": {"nnet": variables["params"]},
                     "mstate": {"batch_stats": variables["batch_stats"]},
                     "epoch": 2}, fd)
    with open(root / "wav.scp", "w") as scp:
        for i, n in enumerate(lens):
            write_audio(str(root / f"u{i}.wav"), wav[i, :n])
            scp.write(f"u{i} {root / f'u{i}.wav'}\n")
    arpa, dict_path = lm_files
    lm_dirs = {kind: write_lm_checkpoint(root / f"lm_{kind}", kind,
                                         lms[kind][1])
               for kind in ("lstm", "xfmr")}
    return {"root": root, "am": str(cpt), "scp": str(root / "wav.scp"),
            "dict": dict_path, "arpa": arpa, **lm_dirs}


def _read_nbest(path: Path):
    lines = path.read_text().splitlines()
    out, i = {}, 1
    n = int(lines[0])
    while i < len(lines):
        key = lines[i]
        out[key] = [ln.split("\t") for ln in lines[i + 1:i + 1 + n]]
        i += 1 + n
    return n, out


def _assert_nbest_files_equal(got: Path, want: Path):
    n_g, got = _read_nbest(got)
    n_w, want = _read_nbest(want)
    assert n_g == n_w and sorted(got) == sorted(want)
    for key in want:
        assert len(got[key]) == len(want[key])
        for (sg, ng, tg), (sw, nw, tw) in zip(got[key], want[key]):
            assert (ng, tg) == (nw, tw)
            assert abs(float(sg) - float(sw)) <= 2e-3


@pytest.mark.parametrize("lm", ["lstm", "xfmr", "arpa", "greedy",
                                "segment"])
def test_decode_command_matches_jax(workspace, tmp_path, lm):
    """aps_tpu_torch.cmd.decode against aps_tpu's cmd/decode.py run with
    the same arguments: best transcripts equal, the dumped nbest equal in
    tokens, scores within the file's rounding."""
    argv = ["--am", workspace["am"], "--dict", workspace["dict"],
            "--beam-size", "4", "--nbest", "3", "--ctc-weight", "0.4",
            "--max-len", "12", "--device", "cpu"]
    if lm == "greedy":
        argv += ["--function", "greedy_search", "--nbest", "1"]
    elif lm == "segment":
        segments = tmp_path / "segments"
        segments.write_text("s0 u0 0.10 1.60\ns1 u0 0.50 2.00\n"
                            "s2 u1 0.00 1.20\ns3 u9 0.00 1.00\n")
        argv += ["--segment", str(segments)]
    else:
        argv += ["--lm", workspace[lm], "--lm-weight", "0.3"]
    outs = []
    for name, run in (("port", decode.run),
                      ("jax", jax_command("decode").run)):
        best, nbest = tmp_path / f"best.{name}", tmp_path / f"nbest.{name}"
        args = decode.make_parser().parse_args(
            [workspace["scp"], str(best), "--dump-nbest", str(nbest)] + argv)
        run(args)
        outs.append((best, nbest))
    assert outs[0][0].read_text() == outs[1][0].read_text()
    assert len(outs[0][0].read_text().splitlines()) == \
        (3 if lm == "segment" else 2)
    _assert_nbest_files_equal(outs[0][1], outs[1][1])


def test_decode_batch_with_lm_matches_jax(am, lms, workspace, tmp_path):
    """decode_batch --lm fuses the LM: the transcripts and scores of
    aps_tpu's beam_search_batch(..., lm=lm_adapter(...)) called directly
    (aps_tpu's own command drops --lm)."""
    nnet, variables, _, wav, lens = am
    jlm, lm_vars, _ = lms["lstm"]
    best = tmp_path / "best.txt"
    argv = [workspace["scp"], str(best), "--am", workspace["am"], "--dict",
            workspace["dict"], "--beam-size", "4", "--ctc-weight", "0.4",
            "--lm", workspace["lstm"], "--lm-weight", "0.5", "--max-len",
            "16", "--batch-size", "2", "--device", "cpu"]
    stats = decode_batch.main(argv)
    batch = [wav[i, :n] for i, n in enumerate(lens)]
    # the command's search arguments; it pads the batch to its duration
    # bucket
    kw = decode.search_kwargs(decode_batch.make_parser().parse_args(argv))
    pad_to = decode_batch.quantize_dur(int(max(lens)))
    want = jax_search.beam_search_batch(
        nnet, variables, batch,
        lm=jax_lm.lm_adapter(jlm, lm_vars, max_len=16, sos=SOS), sos=SOS,
        eos=EOS, pad_to=pad_to, **kw)
    lines = dict(ln.split("\t") for ln in best.read_text().splitlines())
    from aps_tpu_torch.conf import load_dict
    units = load_dict(workspace["dict"], reverse=True)
    for i, hyps in enumerate(want):
        toks = [units[t] for t in hyps[0]["trans"][1:-1]]
        assert lines[f"u{i}"] == " ".join(toks)
        assert abs(stats["scores"][f"u{i}"] - hyps[0]["score"]) <= SCORE_ATOL


def test_decode_commands_refuse_an_ngram_batch_and_features(workspace,
                                                            tmp_path):
    """decode_batch has no batched n-gram path (it names decode and
    lm_rescore); decode reads a feats.scp for a checkpoint that takes
    features, and writes what the search gives on those features (the
    comparison with aps_tpu's command is tests/test_torch_kaldi.py's)."""
    with pytest.raises(NotImplementedError, match="lm_rescore"):
        decode_batch.main([workspace["scp"], str(tmp_path / "best"), "--am",
                           workspace["am"], "--lm", workspace["arpa"],
                           "--device", "cpu"])
    conf = dict(flagship_conf(VOCAB, small=True), task="asr@ctc_xent",
                task_conf={}, data_conf={}, trainer_conf={})
    del conf["asr_transform"]  # a model fed with features
    cpt = tmp_path / "feats_am"
    cpt.mkdir()
    (cpt / "train.yaml").write_text(json.dumps(conf))
    feats_model = build_flagship(flagship_conf(VOCAB, small=True))
    feats_model.asr_transform = None
    variables = to_variables(feats_model)
    with open(cpt / "best.ckpt", "wb") as fd:
        pickle.dump({"params": variables["params"],
                     "mstate": {"batch_stats": variables["batch_stats"]}},
                    fd)
    from aps_tpu_torch.loader.kaldi_io import ArchiveWriter
    rng = np.random.default_rng(4)
    feats = {f"f{i}": rng.standard_normal((70 + 30 * i, 80)).astype(
        np.float32) for i in range(2)}
    with ArchiveWriter(str(tmp_path / "feats.ark"),
                       str(tmp_path / "feats.scp")) as writer:
        for key, mat in feats.items():
            writer.write(key, mat)
    argv = [str(tmp_path / "feats.scp"), str(tmp_path / "best"), "--am",
            str(cpt), "--beam-size", "3", "--max-len", "6",
            "--allow-partial", "true", "--device", "cpu"]
    stats = decode.main(argv)
    assert stats["utts"] == 2
    feats_model.eval()
    lines = dict(ln.split("\t") for ln in
                 (tmp_path / "best").read_text().splitlines())
    kwargs = decode.search_kwargs(decode.make_parser().parse_args(argv))
    for key, mat in feats.items():
        hyps = search.beam_search(feats_model, mat, sos=SOS, eos=EOS,
                                  **kwargs)
        assert stats["scores"][key] == pytest.approx(hyps[0]["score"],
                                                     abs=1e-5)
        assert len(lines[key].split()) == len(hyps[0]["trans"]) - 2


@pytest.mark.parametrize("lm,len_norm", [("lstm", None), ("xfmr", "false"),
                                         ("arpa", ""), ("arpa", None)])
def test_lm_rescore_matches_jax(workspace, tmp_path, lm, len_norm):
    """lm_rescore on an nbest file, against aps_tpu's command: the same
    best lines. The NN LMs score with sos 0 and eos 1 in both (train.yaml
    keeps them outside task_conf); --len-norm "false" is true and ""
    false (type=bool)."""
    nbest = tmp_path / "in.nbest"
    rng = np.random.default_rng(3)
    lines = ["4"]
    for u in range(3):
        lines.append(f"utt{u}")
        for _ in range(4):
            toks = rng.integers(1, SOS, rng.integers(1, 6))
            lines.append(f"{-rng.random() * 3:.3f}\t{len(toks)}\t"
                         + " ".join(f"w{t}" for t in toks))
    nbest.write_text("\n".join(lines) + "\n")
    argv = [str(nbest), "", "--lm", workspace[lm], "--dict",
            workspace["dict"], "--lm-weight", "0.8"]
    if len_norm is not None:
        argv += ["--len-norm", len_norm]
    outs = []
    for name, run in (("port", lm_rescore.run),
                      ("jax", jax_command("lm_rescore").run)):
        argv[1] = str(tmp_path / f"best.{name}")
        args = lm_rescore.make_parser().parse_args(
            argv + (["--device", "cpu"] if name == "port" else []))
        assert args.len_norm is (len_norm != "")
        run(args)
        outs.append(Path(argv[1]).read_text())
    assert outs[0] == outs[1] and len(outs[0].splitlines()) == 3


def test_lm_rescore_nn_score_uses_the_fallback_ids(lms):
    """nn_lm_score with the ids aps_tpu falls back to (0 and 1) equals a
    plain sum of the LM's log-probabilities along the sequence."""
    _, _, port = lms["lstm"]
    hyp = [5, 9, 2]
    got = lm_rescore.nn_lm_score(port, hyp, 0, 1)
    with torch.no_grad():
        out, _ = port(torch.tensor([[0] + hyp]))
        logp = torch.log_softmax(out[0], -1)
    want = sum(logp[n, w].item() for n, w in enumerate(hyp + [1]))
    assert abs(got - want) < 1e-5


# ---------------------------------------------------------------------------
# loaders, task, trainer
# ---------------------------------------------------------------------------
def _write_text(path: Path, num: int, kaldi: bool, seed: int = 0,
                min_len: int = 1) -> str:
    rng = np.random.default_rng(seed)
    with open(path, "w") as fd:
        for n in range(num):
            toks = " ".join(f"w{t}" for t in rng.integers(
                1, SOS, rng.integers(min_len, 14)))
            fd.write(f"utt{n} {toks}\n" if kaldi else f"{toks}\n")
    return str(path)


def _batches_as_sets(loader):
    return sorted((tuple(map(tuple, b["src"])), tuple(map(tuple, b["tgt"])),
                   tuple(b["len"]), b["#utt"], b["#tok"]) for b in loader)


@pytest.mark.parametrize("fmt,kwargs", [
    ("lm@utt", dict(min_token_num=2, max_token_num=10, min_batch_size=2,
                    max_batch_size=5, adapt_token_num=4,
                    chunk_size_for_sort=12)),
    ("lm@utt", dict(kaldi_format=False, max_batch_size=4, min_batch_size=1)),
    ("lm@bptt", dict(bptt_size=6, max_batch_size=3)),
    ("lm@bptt", dict(bptt_size=4, max_batch_size=2, kaldi_format=False,
                     min_token_num=3)),
])
@pytest.mark.parametrize("train", [True, False])
def test_lm_loaders_match_jax(fmt, kwargs, train, lm_files, tmp_path):
    """The same batches as aps_tpu's loader, compared as sets (the order of
    a shuffled epoch is the loader's own); a second epoch reorders them.
    lm@bptt's windows depend on the utterance order, so a shuffled epoch is
    held to the epoch's own stream."""
    from aps_tpu_torch.conf import load_dict
    text = _write_text(tmp_path / "text", 30,
                       kwargs.get("kaldi_format", True))
    vocab = load_dict(lm_files[1])
    conf = dict(text=text, vocab_dict=vocab, sos=SOS, eos=EOS, train=train,
                **kwargs)
    port = aps_dataloader(fmt=fmt, **conf)
    ref = jax_libs.aps_dataloader(fmt=fmt, **conf)
    for epoch in (0, 1):
        port.set_epoch(epoch)
        ref.set_epoch(epoch)
        got, want = _batches_as_sets(port), _batches_as_sets(ref)
        if fmt == "lm@utt" or not train:
            assert got == want and got
        else:
            rows = {r for b in got for r in b[0]}
            assert len(got) == len(want) and rows
    batches = list(port)
    for b in batches:
        assert b["src"].dtype == np.int64
        if fmt == "lm@bptt":
            assert b["src"].shape == (kwargs["max_batch_size"],
                                      kwargs["bptt_size"])
            np.testing.assert_array_equal(b["src"][:, 1:], b["tgt"][:, :-1])


def _lm_egs(kind, seed=1):
    rng = np.random.default_rng(seed)
    lens = np.array([7, 4, 6])
    src = np.full((3, 8), EOS, dtype=np.int64)
    tgt = np.full((3, 8), -1, dtype=np.int64)
    for i, n in enumerate(lens):
        toks = rng.integers(1, SOS, n - 1)
        src[i, :n] = [SOS] + list(toks)
        tgt[i, :n] = list(toks) + [EOS]
    return {"src": src, "tgt": tgt, "len": lens}


@pytest.mark.parametrize("kind,reduction", [("lstm", "batchmean"),
                                            ("gru", "mean"),
                                            ("xfmr", "batchmean")])
def test_lm_task_matches_jax(kind, reduction):
    """asr@lm at one training-mode step (dropouts 0): loss, accu, @ppl and
    every gradient."""
    jnnet, variables, port = jax_lm_pair(kind, seed=5)
    egs = _lm_egs(kind)
    jtask = jax_libs.aps_task("asr@lm", jnnet, reduction=reduction)
    task = aps_task("asr@lm", copy.deepcopy(port), reduction=reduction)
    task.train()
    stats = task({k: torch.from_numpy(v) for k, v in egs.items()})
    stats["loss"].backward()
    jegs = {k: jnp.asarray(v) for k, v in egs.items()}

    def loss_fn(params):
        out = jtask.apply({"params": {"nnet": params}}, jegs, training=True)
        return out["loss"], out

    (_, want), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        variables["params"])
    assert sorted(stats) == sorted(want) == ["@ppl", "accu", "loss"]
    for key in want:
        np.testing.assert_allclose(stats[key].item(), float(want[key]),
                                   rtol=LOSS_RTOL, err_msg=key)
    got = dict(jax.tree_util.tree_leaves_with_path(to_gradients(task.nnet)))
    flat = jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(np.asarray, grads))
    assert len(got) == len(flat)
    for path, val in flat:
        scale = max(np.abs(val).max(), 1e-8)
        assert np.abs(got[path] - val).max() <= GRAD_RTOL * scale, path


def test_lm_task_bptt_mode_carries_no_state():
    """bptt_mode reads egs["hidden"], which no loader sets: the loss of a
    window equals the loss without bptt_mode."""
    _, _, port = jax_lm_pair("lstm", seed=6)
    egs = {k: torch.from_numpy(v) for k, v in _lm_egs("lstm").items()}
    plain = aps_task("asr@lm", port)(egs)["loss"]
    bptt = aps_task("asr@lm", port, bptt_mode=True)(egs)["loss"]
    assert torch.equal(plain, bptt)


def _nnlm_recipe(root: Path, yaml: str, dict_path: str,
                 layers: int = 1) -> str:
    """The recipe's YAML as written, with the data paths pointed at a toy
    corpus and the number of layers cut to `layers`."""
    import yaml as pyyaml
    conf = pyyaml.safe_load((REPO / yaml).read_text())
    conf["nnet_conf"]["num_layers"] = layers
    fmt = conf["data_conf"]["fmt"]
    kaldi = conf["data_conf"]["loader"].get("kaldi_format", True)
    for split, seed in (("train", 0), ("valid", 1)):
        conf["data_conf"][split] = {"text": _write_text(
            root / f"{split}.txt", 40, kaldi, seed, min_len=2)}
    if fmt == "lm@utt":
        conf["data_conf"]["loader"].update(min_batch_size=2)
    path = root / "nnlm.yaml"
    path.write_text(json.dumps(conf))
    return str(path)


def test_train_lm_takes_steps_from_the_aishell_recipe(lm_files, tmp_path):
    """aishell_v1/conf/nnlm/1a.yaml as written (embed 512, lstm 650,
    dropout 0.2, adam, reduce_lr, '@ppl') at depth 1 on a toy corpus:
    train_lm takes two steps, writes a checkpoint that the port's
    evaluator and aps_tpu's load, and the dict."""
    conf = _nnlm_recipe(tmp_path, "examples/asr/aishell_v1/conf/nnlm/1a.yaml",
                        lm_files[1])
    cpt = tmp_path / "cpt"
    trainer = train_lm.main(["--conf", conf, "--dict", lm_files[1],
                             "--checkpoint", str(cpt), "--batch-size", "16",
                             "--epochs", "1", "--device", "cpu"])
    assert trainer.cur_step == 2
    log = (cpt / "trainer.log").read_text()
    assert re.search(r"Epoch 01/valid: loss/@ppl", log)
    for name in ("best.ckpt", "train.yaml", "dict"):
        assert (cpt / name).is_file()
    from aps_tpu.eval.wrapper import load_checkpoint as jax_load
    from aps_tpu_torch.eval.wrapper import load_checkpoint
    loaded = load_checkpoint(str(cpt))["nnet"]
    assert type(loaded).__name__ == "TorchRNNLM"
    ref = jax_load(str(cpt))
    tok = np.array([[SOS, 3, 4, 5]])
    want, _ = ref["nnet"].apply(ref["variables"], jnp.asarray(tok))
    with torch.no_grad():
        got, _ = loaded(torch.from_numpy(tok))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("yaml,batch", [
    ("examples/asr/chime4/conf/nnlm/1a.yaml", 16),
    ("examples/asr/wsj/conf/nnlm/1a.yaml", 16),
    ("examples/asr/gigaspeech/conf/nnlm/1a.yaml", 2),
    ("examples/asr/librispeech/conf/nnlm/1a.yaml", 2),
    ("examples/asr/multi_cn/conf/lm/1a.yaml", 16),
])
def test_rnn_lm_recipes_take_steps_as_written(yaml, batch, lm_files,
                                              tmp_path):
    """The other RNN LM recipes as written (lm@utt, or lm@bptt with
    bptt_mode and windows of 128 tokens; adam or adamw; tie_weights) at
    depth 1 on a toy corpus: train_lm takes steps with finite losses."""
    conf = _nnlm_recipe(tmp_path, yaml, lm_files[1])
    trainer = train_lm.main(["--conf", conf, "--dict", lm_files[1],
                             "--checkpoint", str(tmp_path / "cpt"),
                             "--batch-size", str(batch), "--epochs", "1",
                             "--device", "cpu"])
    assert trainer.cur_step >= 1
    losses = [float(v) for v in trainer.reporter.stats["loss"]]
    assert losses and all(np.isfinite(losses))


def test_librispeech_xfmr_lm_recipe_raises_as_in_jax(lm_files, tmp_path):
    """librispeech/nnlm/1b passes transformer_dim to warmup_noam_lr: the
    same TypeError in both packages."""
    conf = _nnlm_recipe(tmp_path, "examples/asr/librispeech/conf/nnlm/1b.yaml",
                        lm_files[1])
    with pytest.raises(TypeError, match="transformer_dim") as port:
        train_lm.main(["--conf", conf, "--dict", lm_files[1],
                       "--checkpoint", str(tmp_path / "cpt"),
                       "--device", "cpu"])
    from aps_tpu.trainer.lr import NoamLR
    with pytest.raises(TypeError, match="transformer_dim") as ref:
        NoamLR(lr=0.0, transformer_dim=512, peak_lr=-1, warmup=20000)
    assert str(port.value) == str(ref.value)


def test_trainer_skips_a_batch_on_device_oom(tmp_path):
    """An out-of-memory error in the step skips the batch: parameters,
    optimizer state and statistics stay, the log names the batch's shapes,
    and the next batch trains."""
    _, _, port = jax_lm_pair("lstm", seed=8)
    task = aps_task("asr@lm", port)
    trainer = DataParallelTrainer(task, device="cpu", checkpoint=tmp_path,
                                  optimizer="adam",
                                  optimizer_kwargs={"lr": 1e-3})
    before = copy.deepcopy(trainer.task.state_dict())
    real = task.nnet.forward

    def oom(*args, **kwargs):
        real(*args, **kwargs)
        raise torch.cuda.OutOfMemoryError("CUDA out of memory (test)")

    task.nnet.forward = oom
    egs = _lm_egs("lstm")
    assert trainer.train_one_step(egs) is False
    for key, val in trainer.task.state_dict().items():
        assert torch.equal(val, before[key]), key
    assert len(trainer.optimizer.state) == 0
    assert all(p.grad is None for p in trainer.params)
    log = (tmp_path / "trainer.log").read_text()
    assert "Step 0: device OOM on batch [(3, 8), (3, 8), (3,)], skipped" \
        in log
    task.nnet.forward = real
    assert trainer.train_one_step(egs) is True
