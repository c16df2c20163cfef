#!/usr/bin/env python
"""PyTorch port, the seven RNN-T recipes (aishell_v1 1c, 1d, 1f, 1g;
aishell_v2 1b, 1c; timit 1b) from their YAML with only depth, widths and
the vocabulary cut: each builds in both packages; the port's dp trainer
takes one training step as written (perturb, SpecAugment, dropout, the
recipe's optimizer, clip and precision); and an evaluation-mode pass
(no draws) gives aps_tpu's loss and gradients on the same converted
weights. Then train_am runs a toy transducer recipe end to end."""

import copy
import json
import math
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from aps_tpu import libs as jax_libs  # noqa: E402
from aps_tpu.transform import AsrTransform as JaxTransform  # noqa: E402
from aps_tpu_torch.cmd import train_am  # noqa: E402
from aps_tpu_torch.conf import load_am_conf, load_yaml  # noqa: E402
from aps_tpu_torch.convert import to_gradients  # noqa: E402
from aps_tpu_torch.io import write_audio  # noqa: E402
from aps_tpu_torch.libs import (aps_asr_nnet, aps_task,  # noqa: E402
                                aps_trainer, aps_transform)

from test_torch_train import assert_trees_close  # noqa: E402
from test_torch_transducer import _seeded  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
RECIPES = ["aishell_v1/1c", "aishell_v1/1d", "aishell_v1/1f",
           "aishell_v1/1g", "aishell_v2/1b", "aishell_v2/1c", "timit/1b"]
# the dictionary: 17 tokens; the blank is id 17 of the model's 18
DICT_SIZE = 17
LOSS_RTOL = 1e-5
GRAD_RTOL = 2e-3
KEY = jax.random.PRNGKey(0)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this file runs: oneDNN's CPU LSTM slows
    down 100-fold when the suite's other workers load the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _write_dict(path: Path) -> None:
    with open(path, "w") as fd:
        fd.write("<unk> 0\n")
        for i in range(1, DICT_SIZE):
            fd.write(f"w{i} {i}\n")


def _cut(conf):
    """Depth 1, widths 16 (32 feed-forward, 4 conv channels), embedding
    8; everything else as the recipe writes it."""
    nnet = conf["nnet_conf"]
    enc = nnet["enc_kwargs"]
    if nnet["enc_type"] in ("xfmr", "cfmr"):
        enc["num_layers"] = 1
        enc["arch_kwargs"].update(att_dim=16, feedforward_dim=32)
        enc["proj_kwargs"]["conv_channels"] = 4
    else:
        parts = enc.values() if nnet["enc_type"] == "concat" else [enc]
        for kwargs in parts:
            for key, value in (("hidden", 16), ("channel", 4),
                               ("project", 16), ("num_layers", 1)):
                if key in kwargs:
                    kwargs[key] = value
        nnet["enc_proj"] = 16
    dec = nnet["dec_kwargs"]
    dec.update(jot_dim=16, num_layers=1)
    if conf["nnet"] == "asr@xfmr_transducer":
        dec["att_dim"] = 16
        dec["arch_kwargs"].update(att_dim=16, feedforward_dim=32)
    else:
        dec.update(embed_size=8, hidden=16)
    return conf


def _recipe_conf(recipe, root):
    _write_dict(root / "dict")
    path = REPO / "examples" / "asr" / recipe.replace("/", "/conf/")
    conf, _ = load_am_conf(f"{path}.yaml", str(root / "dict"))
    assert conf["task"] == "asr@transducer"
    assert conf["task_conf"]["blank"] == DICT_SIZE
    assert conf["nnet_conf"]["vocab_size"] == DICT_SIZE + 1
    return _cut(conf)


def _batch(seed):
    rng = np.random.default_rng(seed)
    lens = np.array([16000, 13000])
    wav = np.zeros((2, 16000), dtype=np.float32)
    for i, n in enumerate(lens):
        wav[i, :n] = 0.1 * rng.standard_normal(n)
    tgt = rng.integers(1, DICT_SIZE, (2, 6))
    tgt[1, 4:] = -1
    return {"src_pad": wav, "src_len": lens, "tgt_pad": tgt,
            "tgt_len": np.array([6, 4])}


def test_the_seven_transducer_recipes():
    found = sorted(
        f"{p.parents[1].name}/{p.stem}"
        for p in (REPO / "examples" / "asr").glob("*/conf/*.yaml")
        if "transducer" in load_yaml(p).get("nnet", ""))
    assert found == RECIPES


@pytest.mark.parametrize("recipe", RECIPES)
def test_transducer_recipe_matches_jax(recipe, tmp_path):
    """The recipe's transform, model, task and dp trainer: one training
    step as written on the CPU (a finite loss), then an evaluation-mode
    pass of the same weights in both packages: the loss within LOSS_RTOL,
    every gradient leaf within GRAD_RTOL of its own largest entry."""
    conf = _recipe_conf(recipe, tmp_path)
    transform = aps_transform("asr")(**conf["asr_transform"])
    nnet = aps_asr_nnet(conf["nnet"])(asr_transform=transform,
                                      **conf["nnet_conf"])
    variables = _seeded(nnet, len(recipe))
    task = aps_task(conf["task"], nnet, **conf["task_conf"])
    jtask = jax_libs.aps_task(
        conf["task"], jax_libs.aps_asr_nnet(conf["nnet"])(
            asr_transform=JaxTransform(**conf["asr_transform"]),
            **conf["nnet_conf"]), **conf["task_conf"])
    egs = _batch(len(recipe))
    # the evaluation-mode pass first: the trainer's step moves the weights
    exact = copy.deepcopy(task).eval()
    task.eval()
    task.zero_grad()
    tegs = {k: torch.from_numpy(v) for k, v in egs.items()}
    loss = task(tegs)["loss"]
    loss.backward()
    got_grads = to_gradients(task.nnet)
    jegs = {k: jnp.asarray(v) for k, v in egs.items()}
    jvars = {col: {"nnet": tree} for col, tree in variables.items()}

    def loss_fn(params):
        return jtask.apply({**jvars, "params": params}, jegs,
                           training=False)["loss"]

    want, grads = jax.jit(jax.value_and_grad(loss_fn))(jvars["params"])
    assert abs(loss.item() - float(want)) <= LOSS_RTOL * abs(float(want))
    exact.double()
    exact.zero_grad()
    exact({k: v.double() if v.dtype == torch.float32 else v
           for k, v in tegs.items()})["loss"].backward()
    assert_trees_close(got_grads, grads["nnet"], GRAD_RTOL,
                       exact=to_gradients(exact.nnet))
    # one step as written
    trainer = aps_trainer("dp")(task.train(), device="cpu",
                                checkpoint=tmp_path / "exp",
                                **conf["trainer_conf"])
    assert transform.generator is trainer.generator
    assert trainer.train_one_step(dict(egs, **{"#utt": 2, "#tok": 10}))
    assert math.isfinite(float(trainer.reporter.stats["loss"][-1]))


def _toy_corpus(root: Path):
    """A toy aishell_v1/1f-shaped recipe over 10 seeded 1 s utterances."""
    rng = np.random.default_rng(0)
    with open(root / "wav.scp", "w") as scp, \
            open(root / "text", "w") as text, \
            open(root / "utt2dur", "w") as dur:
        for i in range(10):
            path = root / f"u{i}.wav"
            write_audio(str(path), 0.1 * rng.standard_normal(16000))
            scp.write(f"u{i} {path}\n")
            text.write(f"u{i} " + " ".join(
                f"w{t}" for t in rng.integers(1, DICT_SIZE, 4)) + "\n")
            dur.write(f"u{i} 1.00\n")
    conf = load_yaml(REPO / "examples/asr/aishell_v1/conf/1f.yaml")
    conf = _cut(conf)
    data = {"wav_scp": str(root / "wav.scp"), "text": str(root / "text"),
            "utt2dur": str(root / "utt2dur")}
    conf["data_conf"] = {"fmt": "am@raw", "loader": {"max_dur": 30},
                         "train": data, "valid": data}
    conf["trainer_conf"]["lr_scheduler_kwargs"]["time_stamps"] = [2, 2, 8]
    _write_dict(root / "dict")
    (root / "train.yaml").write_text(json.dumps(conf))
    return ["--conf", str(root / "train.yaml"), "--dict", str(root / "dict"),
            "--checkpoint", str(root / "exp"), "--batch-size", "5",
            "--epochs", "2", "--device", "cpu"]


def test_train_am_takes_the_transducer_task(tmp_path):
    """train_am runs the transducer task unchanged: two epochs of two steps
    with validation, a finite best loss, the checkpoints and train.yaml
    with the blank injected."""
    trainer = train_am.main(_toy_corpus(tmp_path))
    assert trainer.cur_epoch == 2
    exp = tmp_path / "exp"
    assert (exp / "best.ckpt").exists() and (exp / "last.ckpt").exists()
    conf = load_yaml(exp / "train.yaml")
    assert conf["task_conf"]["blank"] == DICT_SIZE
    assert conf["nnet_conf"]["vocab_size"] == DICT_SIZE + 1
    log = (exp / "trainer.log").read_text()
    best = float(log.split("best = ")[-1].split(",")[0])
    assert math.isfinite(best) and best > 0
