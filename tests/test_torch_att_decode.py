#!/usr/bin/env python
"""PyTorch port, decoding and training the RNN attention AED (asr@att)
against aps_tpu on JAX's CPU: beam_search, greedy_search and
beam_search_batch with and without CTC, with the RNN LM, with end
detection and with the coverage penalty (v1, v2, and aps_tpu's coverage
summed from the alignments before the beams are gathered, on a search whose
beams reorder); decoder_rescore; the four schedule-sampling schedulers and
the trainer's rate across epochs and a resume; one CPU step of WSJ 1a and
TIMIT 1a from their YAML with only sizes patched; the three recipes whose
decoder_kwargs name emb_dropout, which both packages refuse; and the
decode and decode_batch commands with --device cpu on an asr@att
checkpoint. The searches run on output layers scaled up (PEAKY), so that
no near-tie of random weights can part the two packages' rankings."""

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
from aps_tpu.asr.beam_search import att as jax_search  # noqa: E402
from aps_tpu.asr.beam_search import lm as jax_lm  # noqa: E402
from aps_tpu.asr.beam_search.utils import \
    BeamSearchParam as JaxParam  # noqa: E402
from aps_tpu.trainer.base import Trainer as JaxTrainerBase  # noqa: E402
from aps_tpu.trainer.ss import SsScheduler as JaxSsScheduler  # noqa: E402
from aps_tpu.transform import AsrTransform as JaxTransform  # noqa: E402
from aps_tpu_torch.asr.beam_search import att as search  # noqa: E402
from aps_tpu_torch.asr.beam_search import transformer  # noqa: E402
from aps_tpu_torch.asr.beam_search.lm import lm_adapter  # noqa: E402
from aps_tpu_torch.asr.beam_search.utils import \
    BeamSearchParam  # noqa: E402
from aps_tpu_torch.cmd import decode, decode_batch, train_am  # noqa: E402
from aps_tpu_torch.conf import load_am_conf  # noqa: E402
from aps_tpu_torch.convert import to_state_dict, to_variables  # noqa: E402
from aps_tpu_torch.io import write_audio  # noqa: E402
from aps_tpu_torch.libs import (aps_asr_nnet, aps_task,  # noqa: E402
                                aps_trainer, aps_transform)
from aps_tpu_torch.trainer.ss import SsScheduler  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
VOCAB = 12
SOS, EOS = VOCAB - 3, VOCAB - 2
# beam scores: length-normalised sums of float32 log-probs over a few
# steps, against aps_tpu's
SCORE_ATOL = 1e-4
# the decoder's output layer, the CTC head and the LM's output layer
# scaled so that candidates stand well apart
PEAKY = 4.0
# the decoder's eos logit raised: hypotheses of 1 to 3 tokens end without
# CTC
EOS_BIAS = 0.5
ATT_SHARP = 10.0
TRANSFORM = dict(feats="fbank-log-cmvn", frame_len=400, frame_hop=160,
                 window="hamm", num_mels=16)
# TIMIT 1a's structure (variant_rnn, loc attention, input feeding) at toy
# widths, with a CTC head
NNET = dict(input_size=16, enc_type="variant_rnn", enc_proj=12,
            enc_kwargs=dict(hidden=8, num_layers=2, project=10,
                            pyramid_stack=True),
            att_type="loc", att_kwargs=dict(att_dim=8, conv_channels=3,
                                            loc_context=4),
            dec_kwargs=dict(num_layers=1, hidden=8, input_feeding=True),
            vocab_size=VOCAB, sos=SOS, eos=EOS, ctc=True)
LM_CONF = dict(embed_size=8, vocab_size=VOCAB - 1, rnn="lstm", num_layers=1,
               hidden_size=8, dropout=0.0)
KEY = jax.random.PRNGKey(0)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this file runs: oneDNN's CPU LSTM slows
    down 100-fold when the suite's other workers load the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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


def _peaky(module, variables, leaves):
    for path in leaves:
        node = variables["params"]
        for seg in path.split("/"):
            node = node[seg]
        node *= PEAKY
    module.load_state_dict(to_state_dict(variables, module))
    return variables


@pytest.fixture(scope="module")
def am():
    """(flax AM, numpy variables, port AM in eval mode, waveforms)."""
    model = aps_asr_nnet("asr@att")(
        asr_transform=aps_transform("asr")(**TRANSFORM), **NNET).eval()
    variables = _seeded(model, 1)
    # eos likelier, so that some hypotheses end inside max_len
    variables["params"]["decoder"]["pred"]["bias"][EOS] += EOS_BIAS
    # sharper alignments than the seeded weights' near-flat ones
    variables["params"]["decoder"]["att_net"]["w"]["kernel"] *= ATT_SHARP
    variables = _peaky(model, variables,
                       ("decoder/pred/kernel", "ctc_head/kernel"))
    jnnet = jax_libs.aps_asr_nnet("asr@att")(
        asr_transform=JaxTransform(**TRANSFORM), **NNET)
    rng = np.random.default_rng(21)
    wavs = [0.1 * rng.standard_normal(n).astype(np.float32)
            for n in (32000, 26000, 32000)]
    return jnnet, variables, model, wavs


@pytest.fixture(scope="module")
def lm():
    """(flax RNN LM, numpy variables, port LM)."""
    port = aps_asr_nnet("asr@rnn_lm")(**LM_CONF).eval()
    variables = _peaky(port, _seeded(port, 2), ("dist/kernel",))
    return jax_libs.aps_asr_nnet("asr@rnn_lm")(**LM_CONF), variables, port


def _same_nbest(got, want, atol=SCORE_ATOL):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert [h["trans"] for h in g] == [h["trans"] for h in w]
        for a, b in zip(g, w):
            if math.isinf(b["score"]):
                assert a["score"] == b["score"]
            else:
                assert abs(a["score"] - b["score"]) <= atol, (a, b)


SEARCHES = {
    "plain": dict(),
    "ctc": dict(ctc_weight=0.4),
    "ctc_lm_end": dict(ctc_weight=0.4, lm_weight=0.3, end_detect=True),
    "cov_v1": dict(ctc_weight=0.4, cov_penalty=0.5, cov_threshold=0.05),
    "cov_v2_eos": dict(cov_penalty=0.2, cov_method="v2", cov_threshold=0.3,
                       eos_threshold=0.5),
}


@pytest.mark.parametrize("name", sorted(SEARCHES))
def test_beam_search_batch_matches_jax(am, lm, name):
    """The batched search on two utterances of 2 s and one of 1.6 s:
    the same n-best token lists, scores within SCORE_ATOL. Under coverage
    v2 the padded frames of the shorter utterance, which no step attends
    to, give log 0 in both packages."""
    jnnet, variables, model, wavs = am
    kw = dict(SEARCHES[name], beam_size=4, nbest=3, max_len=8, sos=SOS,
              eos=EOS, allow_partial=True)
    batch = [wavs[0], wavs[2], wavs[1]]
    jlm = port_lm = None
    if "lm_weight" in kw:
        jlm = jax_lm.lm_adapter(lm[0], lm[1], sos=SOS)
        port_lm = lm_adapter(lm[2], sos=SOS)
    want = jax_search.beam_search_batch(jnnet, variables, batch, lm=jlm,
                                        **kw)
    got = search.beam_search_batch(model, batch, lm=port_lm, **kw)
    _same_nbest(got, want)
    assert all(len(n) == 3 for n in got)
    # with CTC no hypothesis ends inside max_len: the n-best lists are
    # the unfinished ones (allow_partial)


@pytest.mark.parametrize("name,kw", [
    ("ctc_lm", dict(ctc_weight=0.4, lm_weight=0.3, beam_size=4, nbest=2)),
    ("cov_v1", dict(cov_penalty=0.5, cov_threshold=0.05, beam_size=3,
                    nbest=3)),
    ("greedy", dict(ctc_weight=0.4)),
])
def test_beam_search_matches_jax(am, lm, name, kw):
    """The single-utterance search (aps_tpu pads the encoder frames to its
    bucket of 32 with masked rows and blank-certain CTC rows; the port runs
    them as they are) and greedy_search."""
    jnnet, variables, model, wavs = am
    kw = dict(kw, max_len=8, sos=SOS, eos=EOS, allow_partial=True)
    jlm = port_lm = None
    if "lm_weight" in kw:
        jlm = jax_lm.lm_adapter(lm[0], lm[1], sos=SOS)
        port_lm = lm_adapter(lm[2], sos=SOS)
    fn = "greedy_search" if name == "greedy" else "beam_search"
    want = getattr(jax_search, fn)(jnnet, variables, jnp.asarray(wavs[1]),
                                   lm=jlm, **kw)
    got = getattr(search, fn)(model, wavs[1], lm=port_lm, **kw)
    _same_nbest([got], [want])


def test_coverage_sums_alignments_before_the_gather(am):
    """aps_tpu's search adds a step's alignment of lane i to the coverage
    of lane i's parent beam_idx[i], before the carry (and with it the
    alignments) follows the parents: the final coverage of both searches
    is equal, and it differs from the coverage summed with the alignments
    gathered to their parents, which a search whose beams reorder
    shows."""
    jnnet, variables, model, wavs = am
    kw = dict(beam_size=4, sos=SOS, eos=EOS, ctc_weight=0.4,
              cov_penalty=0.5, cov_threshold=0.05)
    param = BeamSearchParam(**kw)
    steps = []
    real = search._RnnSteps.reorder

    def record(self, beam_idx):
        steps.append((self.alignment().clone(), beam_idx.clone()))
        real(self, beam_idx)

    with torch.inference_mode():
        x = torch.from_numpy(wavs[1])[None]
        enc, enc_len, ctc = model.decode_enc(x, torch.tensor([len(wavs[1])]))
        search._RnnSteps.reorder = record
        try:
            final = transformer._search_core(
                search._RnnSteps(model, enc, enc_len, 4), 1, enc.shape[1],
                ctc, param, 8)
        finally:
            search._RnnSteps.reorder = real
    jparam = JaxParam(**kw)
    jfinal = jax_search._search_core(
        jnnet, variables, jnp.asarray(enc.numpy()),
        jnp.asarray(enc_len.numpy()), jnp.asarray(ctc.numpy()), None,
        jparam, 8)
    np.testing.assert_array_equal(final.tokens.numpy(),
                                  np.asarray(jfinal.tokens))
    np.testing.assert_allclose(final.coverage.numpy(),
                               np.asarray(jfinal.coverage), atol=1e-5)
    # replay: the same alignments and parents, with the alignments
    # gathered to the parents first
    gathered = torch.zeros_like(final.coverage)
    done = torch.zeros(4, dtype=torch.bool)
    reordered = False
    for t, (ali, beam_idx) in enumerate(steps):
        reordered |= bool((beam_idx != torch.arange(4)).any()) and t > 0
        prev_done = done[beam_idx]
        gathered = gathered[beam_idx] + torch.where(
            prev_done[:, None], 0.0, ali[beam_idx])
        done = prev_done | (final.tokens[:, t + 1] == EOS)
    assert reordered
    assert float((gathered - final.coverage).abs().max()) > 1e-3


def test_decoder_rescore_matches_jax(am):
    """decoder_rescore of a CTC n-best list of unequal lengths."""
    jnnet, variables, model, wavs = am
    nbest = [{"score": -3.0, "trans": [SOS, 1, 2, 3, EOS]},
             {"score": -4.5, "trans": [SOS, 4, EOS]},
             {"score": -5.0, "trans": [SOS, 2, 2, 6, 7, 1, EOS]}]
    with torch.inference_mode():
        enc, _, _ = model.decode_enc(torch.from_numpy(wavs[0])[None])
    for ctc_weight, len_norm in ((0.3, True), (0.0, False)):
        want = jax_search.decoder_rescore(nbest, jnnet, variables,
                                          jnp.asarray(enc.numpy()),
                                          ctc_weight=ctc_weight,
                                          len_norm=len_norm)
        got = search.decoder_rescore(nbest, model, enc,
                                     ctc_weight=ctc_weight,
                                     len_norm=len_norm)
        _same_nbest([got], [want], atol=1e-5)


# ---------------------------------------------------------------------------
# schedule sampling
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name,kwargs", [
    ("const", dict(ssr=0.3)),
    ("epoch", dict(ssr=0.3, epochs=[2, 4])),
    ("trigger", dict(ssr=0.3, trigger=60)),
    ("linear", dict(ssr=0.2, epochs=[10, 26], update_interval=4)),
    ("linear", dict(ssr=0.2, epochs=[0, 2], update_interval=4)),
])
def test_ss_schedulers_match_jax(name, kwargs):
    """Each scheduler's rate over epochs 0..30 and accuracies either side
    of the trigger; the linear one is not capped inside its window (0.4
    at epoch 1 for ssr 0.2 with epochs [0, 2] and update_interval 4)."""
    ours, theirs = SsScheduler[name](**kwargs), JaxSsScheduler[name](**kwargs)
    for epoch in range(31):
        for accu in (10.0, 75.0):
            assert ours.step(epoch, accu) == theirs.step(epoch, accu)
    if kwargs.get("epochs") == [0, 2]:
        assert ours.step(1, 0) == pytest.approx(0.4)


def _toy_conf(root: Path, ss_kwargs, epochs=2):
    """A toy asr@att recipe over a corpus of 10 seeded 1 s utterances."""
    rng = np.random.default_rng(0)
    with open(root / "wav.scp", "w") as scp, \
            open(root / "text", "w") as text, \
            open(root / "utt2dur", "w") as dur:
        for i in range(10):
            path = root / f"u{i}.wav"
            write_audio(str(path), 0.1 * rng.standard_normal(16000))
            scp.write(f"u{i} {path}\n")
            text.write(f"u{i} " + " ".join(
                f"w{t}" for t in rng.integers(1, SOS, 4)) + "\n")
            dur.write(f"u{i} 1.00\n")
    _write_dict(root / "dict")
    data = {"wav_scp": str(root / "wav.scp"), "text": str(root / "text"),
            "utt2dur": str(root / "utt2dur")}
    nnet = {k: v for k, v in NNET.items()
            if k not in ("vocab_size", "sos", "eos", "ctc")}
    conf = {"nnet": "asr@att", "nnet_conf": nnet, "task": "asr@ctc_xent",
            "task_conf": {"ctc_weight": 0.2, "lsm_factor": 0.1},
            "asr_transform": TRANSFORM,
            "trainer_conf": {"optimizer": "adam",
                             "optimizer_kwargs": {"lr": 1e-3},
                             "lr_scheduler": "reduce_lr",
                             "report_metrics": ["loss", "accu"],
                             "stop_criterion": "accu",
                             "ss_scheduler": "linear",
                             "ss_scheduler_kwargs": ss_kwargs},
            "data_conf": {"fmt": "am@raw", "loader": {"max_dur": 30},
                          "train": data, "valid": data}}
    (root / "train.yaml").write_text(json.dumps(conf))
    return ["--conf", str(root / "train.yaml"), "--dict", str(root / "dict"),
            "--checkpoint", str(root / "exp"), "--batch-size", "5",
            "--epochs", str(epochs), "--device", "cpu"]


def _write_dict(path: Path) -> None:
    with open(path, "w") as fd:
        fd.write("<unk> 0\n")
        for i in range(1, SOS):
            fd.write(f"w{i} {i}\n")
        fd.write(f"<sos> {SOS}\n<eos> {EOS}\n")


def test_trainer_ssr_across_epochs_and_a_resume(tmp_path, monkeypatch):
    """train_am with ss_scheduler linear (epochs [0, 2], interval 4): the
    steps of epoch 1 run at ssr 0, after its validation the rate is the
    scheduler's at epoch 1 (0.4, above ssr 0.2), after epoch 2 ssr 0.2;
    the task reads it as egs["#ssr"] in training only and the decoder
    draws its coins from the trainer's generator. A resumed run starts
    again at 0 until its first validation, as aps_tpu's does (its rate is
    kept in no checkpoint)."""
    from aps_tpu_torch.task.asr import CtcXentHybridTask
    seen = []
    forward = CtcXentHybridTask.forward

    def record(self, egs):
        seen.append((self.training, egs.get("#ssr")))
        return forward(self, egs)

    monkeypatch.setattr(CtcXentHybridTask, "forward", record)
    argv = _toy_conf(tmp_path, {"ssr": 0.2, "epochs": [0, 2],
                                "update_interval": 4})
    trainer = train_am.main(argv)
    assert trainer.task.nnet.decoder.generator is trainer.generator
    train = [ssr for training, ssr in seen if training]
    assert train == [0, 0, pytest.approx(0.4), pytest.approx(0.4)]
    assert all(ssr is None for training, ssr in seen if not training)
    assert trainer.ssr == pytest.approx(0.2)
    seen.clear()
    resumed = train_am.main(argv[:-3] + ["3", "--device", "cpu"])
    assert resumed.cur_epoch == 3
    assert [ssr for training, ssr in seen if training] == [0, 0]
    assert resumed.ssr == pytest.approx(0.2)


@pytest.mark.parametrize("case", ["unknown", "no_accu"])
def test_trainer_ss_checks_match_jax(tmp_path, case):
    """An unknown scheduler name and schedule sampling without accu in
    report_metrics raise in both packages' trainers, with one message."""
    kw = dict(ss_scheduler="linear", ss_scheduler_kwargs={"ssr": 0.1},
              report_metrics=["loss", "accu"], stop_criterion="loss")
    if case == "unknown":
        kw["ss_scheduler"] = "cosine"
    else:
        kw["report_metrics"] = ["loss"]
    task = aps_task("asr@ctc_xent", aps_asr_nnet("asr@att")(**NNET))
    with pytest.raises(ValueError) as ours:
        aps_trainer("dp")(task, device="cpu", checkpoint=tmp_path / "port",
                          **kw)
    with pytest.raises(ValueError) as theirs:
        JaxTrainerBase(None, checkpoint=tmp_path / "jax", **kw)
    assert str(ours.value) == str(theirs.value)


# ---------------------------------------------------------------------------
# the recipes
# ---------------------------------------------------------------------------
RECIPES = ["wsj/1a", "timit/1a"]
RAISES_IN_BOTH = ["aishell_v1/1e", "aishell_v2/1d", "librispeech/1b"]


def _recipe_conf(recipe, root):
    """The recipe's YAML as written, its dictionary a small one, and only
    sizes patched: widths 16, conv channels 4."""
    _write_dict(root / "dict")
    path = REPO / "examples" / "asr" / recipe.replace("/", "/conf/")
    conf, _ = load_am_conf(f"{path}.yaml", str(root / "dict"))
    assert conf["nnet"] == "asr@att"
    nnet = conf["nnet_conf"]
    enc = nnet["enc_kwargs"]
    for kwargs in (enc.values() if nnet["enc_type"] == "concat" else [enc]):
        for key, value in (("hidden", 16), ("channel", 4), ("project", 16)):
            if key in kwargs:
                kwargs[key] = value
    nnet["enc_proj"] = 16
    nnet["dec_kwargs"]["hidden"] = 16
    nnet["att_kwargs"]["att_dim"] = 16
    return conf


def test_the_five_att_recipes():
    from aps_tpu_torch.conf import load_yaml
    found = sorted(
        f"{p.parents[1].name}/{p.stem}"
        for p in (REPO / "examples" / "asr").glob("*/conf/*.yaml")
        if load_yaml(p).get("nnet") == "asr@att")
    assert found == sorted(RECIPES + RAISES_IN_BOTH)


@pytest.mark.parametrize("recipe", RECIPES)
def test_att_recipe_trains_as_written(recipe, tmp_path):
    """Transform, model, task and the dp trainer from the recipe's YAML,
    then one training step on the CPU through perturb, aug (WSJ) and the
    deltas (WSJ's as conv2d's three input channels), with the recipe's
    optimizer, clip and precision, and TIMIT's schedule sampling."""
    conf = _recipe_conf(recipe, tmp_path)
    transform = aps_transform("asr")(**conf["asr_transform"])
    nnet = aps_asr_nnet(conf["nnet"])(asr_transform=transform,
                                      **conf["nnet_conf"])
    task = aps_task(conf["task"], nnet, **conf["task_conf"])
    trainer = aps_trainer("dp")(task, device="cpu",
                                checkpoint=tmp_path / "exp",
                                **conf["trainer_conf"])
    assert transform.generator is trainer.generator
    assert transform.delta is not None and transform.rescale is not None
    assert (trainer.ss_scheduler is not None) == (recipe == "timit/1a")
    rng = np.random.default_rng(len(recipe))
    lens = np.array([16000, 13000])
    wav = np.zeros((2, 16000), dtype=np.float32)
    for i, n in enumerate(lens):
        wav[i, :n] = 0.1 * rng.standard_normal(n)
    tgt = rng.integers(1, SOS, (2, 6))
    tgt[1, 4:] = -1
    egs = {"src_pad": wav, "src_len": lens, "tgt_pad": tgt,
           "tgt_len": np.array([6, 4]), "#utt": 2, "#tok": 10}
    trainer.ssr = 0.5
    assert trainer.train_one_step(egs)
    assert math.isfinite(float(trainer.reporter.stats["loss"][-1]))
    with torch.no_grad():
        feats, _ = transform(torch.from_numpy(wav), torch.from_numpy(lens))
    assert feats.shape[1:] == ((3, 97, 80) if recipe == "wsj/1a" else
                               (97, 240))


@pytest.mark.parametrize("recipe", RAISES_IN_BOTH)
def test_emb_dropout_recipes_raise_in_both(recipe, tmp_path):
    """aishell_v1/1e, aishell_v2/1d and librispeech/1b hand the RNN decoder
    an emb_dropout that neither package's TorchRNNDecoder takes: the same
    TypeError."""
    _write_dict(tmp_path / "dict")
    path = REPO / "examples" / "asr" / recipe.replace("/", "/conf/")
    conf, _ = load_am_conf(f"{path}.yaml", str(tmp_path / "dict"))
    assert "emb_dropout" in conf["nnet_conf"]["dec_kwargs"]
    kwargs = dict(conf["nnet_conf"])
    with pytest.raises(TypeError) as ours:
        aps_asr_nnet("asr@att")(**kwargs)
    jnnet = jax_libs.aps_asr_nnet("asr@att")(**kwargs)
    with pytest.raises(TypeError) as theirs:
        jax.eval_shape(lambda: jnnet.init(
            KEY, jnp.zeros((1, 16000)), jnp.asarray([16000]),
            jnp.zeros((1, 3), jnp.int32), jnp.asarray([3])))
    assert "emb_dropout" in str(ours.value)
    assert str(ours.value) == str(theirs.value)


# ---------------------------------------------------------------------------
# the commands
# ---------------------------------------------------------------------------
def jax_command(name: str):
    spec = importlib.util.spec_from_file_location(f"jax_cmd_{name}",
                                                  REPO / "cmd" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def workspace(am, tmp_path_factory):
    """An asr@att checkpoint directory (train.yaml + best.ckpt), the dict
    and a wav.scp of the three waveforms."""
    _, variables, _, wavs = am
    root = tmp_path_factory.mktemp("att_cmds")
    cpt = root / "am"
    cpt.mkdir()
    conf = {"nnet": "asr@att", "nnet_conf": NNET,
            "asr_transform": TRANSFORM, "task": "asr@ctc_xent",
            "task_conf": {}, "data_conf": {}, "trainer_conf": {}}
    (cpt / "train.yaml").write_text(json.dumps(conf))
    with open(cpt / "best.ckpt", "wb") as fd:
        pickle.dump({"params": {"nnet": variables["params"]},
                     "mstate": {"batch_stats": variables.get(
                         "batch_stats", {})}, "epoch": 2}, fd)
    _write_dict(root / "dict")
    with open(root / "wav.scp", "w") as scp:
        for i, wav in enumerate(wavs):
            write_audio(str(root / f"u{i}.wav"), wav)
            scp.write(f"u{i} {root / f'u{i}.wav'}\n")
    return {"am": str(cpt), "dict": str(root / "dict"),
            "scp": str(root / "wav.scp")}


@pytest.mark.parametrize("command,extra", [
    ("decode", ["--function", "beam_search"]),
    ("decode", ["--function", "greedy_search", "--nbest", "1"]),
    ("decode_batch", ["--batch-size", "3"]),
])
def test_att_commands_match_jax(workspace, tmp_path, monkeypatch, command,
                                extra):
    """decode (beam and greedy) and decode_batch --device cpu on the
    asr@att checkpoint against aps_tpu's cmd/decode.py and
    cmd/decode_batch.py run with the same arguments: the same
    transcripts."""
    argv = ["--am", workspace["am"], "--dict", workspace["dict"],
            "--beam-size", "4", "--ctc-weight", "0.4", "--max-len", "8",
            "--device", "cpu"] + extra
    port = decode if command == "decode" else decode_batch
    # aps_tpu's decode_batch imports its sibling as "decode"
    monkeypatch.syspath_prepend(str(REPO / "cmd"))
    outs = []
    for name, run in (("port", port.run),
                      ("jax", jax_command(command).run)):
        best = tmp_path / f"best.{name}"
        args = port.make_parser().parse_args([workspace["scp"], str(best)] +
                                             argv)
        # aps_tpu's decode_batch also reads its mesh option
        args.data_parallel = False
        run(args)
        outs.append(sorted(best.read_text().splitlines()))
    assert outs[0] == outs[1] and len(outs[0]) == 3
