#!/usr/bin/env python
"""PyTorch port, teacher-student SSE (sse@ts): the task's loss and the
student's gradients against aps_tpu's SseFreqTsTask (jax.value_and_grad)
with the same teacher checkpoint and converted student weights, L1 and
L2, with and without permutation; the teacher frozen; and train_ss with
sse@ts on se@simu_cmd mixtures."""

import copy
import json
import pickle
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from aps_tpu import libs as jax_libs  # noqa: E402
from aps_tpu_torch.convert import to_gradients, to_variables  # noqa: E402
from aps_tpu_torch.libs import aps_task  # noqa: E402
from test_torch_sse_time import (leaves, mixtures,  # noqa: E402,F401
                                 one_thread, zoo_pair)
from test_torch_sse_zoo import ENH, MODELS  # noqa: E402
from test_torch_train import assert_trees_close  # noqa: E402

NAME, CONF = MODELS["freq_xfmr"]
# the loss (a sum of float32 distances over the bins and frames) and each
# gradient leaf within this share of its own largest entry
LOSS_RTOL = 1e-5
GRAD_RTOL = 2e-3


def write_checkpoint(root: Path, name: str, conf, variables,
                     tag: str = "best") -> Path:
    """A checkpoint directory as the trainers write it: train.yaml with
    the model and its enh_transform, <tag>.ckpt with the parameters."""
    root.mkdir(parents=True, exist_ok=True)
    (root / "train.yaml").write_text(json.dumps(dict(
        nnet=name, nnet_conf=conf, enh_transform=ENH, task="sse@sisnr",
        task_conf={}, data_conf={}, trainer_conf={})))
    with open(root / f"{tag}.ckpt", "wb") as fd:
        pickle.dump({"params": {"nnet": variables["params"]},
                     "epoch": 3}, fd)
    return root


@pytest.fixture(scope="module")
def teacher(tmp_path_factory):
    _, variables, _ = zoo_pair(NAME, CONF, enh=ENH, seed=3)
    return str(write_checkpoint(tmp_path_factory.mktemp("ts") / "teacher",
                                NAME, CONF, variables))


@pytest.mark.parametrize("objf,permute", [("L1", True), ("L2", True),
                                          ("L1", False)])
def test_ts_loss_and_gradients_match_jax(teacher, objf, permute):
    """sse@ts: the teacher's eval-mode masks as the references, the
    student's training-mode masks, hybrid_permu_objf of the L1 or L2
    distance: the loss and every gradient leaf of the student against
    aps_tpu's task."""
    jnet, variables, net = zoo_pair(NAME, CONF, enh=ENH, seed=5)
    conf = dict(teacher=teacher, objf_name=objf, permute=permute,
                num_spks=2)
    jtask = jax_libs.aps_task("sse@ts", jnet, **copy.deepcopy(conf))
    task = aps_task("sse@ts", net, **copy.deepcopy(conf))
    egs = mixtures(7)

    def loss_fn(params):
        out = jtask.apply({"params": params}, {"mix": jnp.asarray(
            egs["mix"])}, training=True)
        return out["loss"]

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(
        {"nnet": variables["params"]})
    task.train()
    out = task({"mix": torch.from_numpy(egs["mix"])})
    assert sorted(out) == ["loss"]
    out["loss"].backward()
    np.testing.assert_allclose(out["loss"].item(), float(loss),
                               rtol=LOSS_RTOL)
    assert_trees_close(to_gradients(net), grads["nnet"], rtol=GRAD_RTOL)
    # the teacher: frozen, in eval mode whatever the task's mode, and no
    # part of the student's parameters or checkpoint
    assert not task.teacher_nnet.training
    assert all(not p.requires_grad for p in task.teacher_nnet.parameters())
    assert all(p.grad is None for p in task.teacher_nnet.parameters())
    student = {id(p) for p in net.parameters()}
    trainable = [p for p in task.parameters() if p.requires_grad]
    assert {id(p) for p in trainable} == student
    assert sorted(to_variables(task.nnet)["params"]) == \
        sorted(variables["params"])


def test_ts_trains_on_simulated_mixtures(teacher, tmp_path):
    """train_ss with sse@ts (the teacher from its checkpoint) on
    se@simu_cmd mixtures (speakers and a noise as wavs, a room response):
    two epochs, the loss falls, the checkpoint holds the student alone."""
    from aps_tpu_torch.cmd import train_ss
    from aps_tpu_torch.io import write_audio
    rng = np.random.default_rng(9)
    sr = 8000
    paths = {}
    for name, S in (("a", 9000), ("b", 8000), ("n", 4000)):
        paths[name] = tmp_path / f"{name}.wav"
        write_audio(str(paths[name]),
                    0.3 * rng.standard_normal(S).astype(np.float32), sr=sr)
    rir = np.exp(-np.arange(300) / 40.0) * rng.standard_normal(300) * 0.2
    rir[5] += 1.0
    paths["rir"] = tmp_path / "rir.wav"
    write_audio(str(paths["rir"]), rir[None].astype(np.float32), sr=sr)
    with open(tmp_path / "simu.cfg", "w") as fd:
        for i in range(4):
            fd.write(f"m{i} --sr {sr} --src-spk {paths['a']},{paths['b']} "
                     f"--src-sdr {i - 1} --src-rir {paths['rir']},"
                     f"{paths['rir']} --point-noise {paths['n']} "
                     f"--point-noise-snr {5 + i} --point-noise-repeat true\n")
    data = dict(simu_cfg=str(tmp_path / "simu.cfg"))
    conf = dict(nnet=NAME, nnet_conf=CONF, enh_transform=ENH,
                task="sse@ts",
                task_conf=dict(teacher=teacher, objf_name="L2"),
                data_conf=dict(fmt="se@simu_cmd",
                               loader=dict(sr=sr, chunk_size=4000),
                               train=data, valid=data),
                trainer_conf=dict(optimizer="adam",
                                  optimizer_kwargs={"lr": 3e-3},
                                  lr_scheduler="reduce_lr",
                                  lr_scheduler_kwargs={}, clip_gradient=5,
                                  no_impr=4))
    (tmp_path / "ts.yaml").write_text(json.dumps(conf))
    cpt = tmp_path / "exp"
    train_ss.main(["--conf", str(tmp_path / "ts.yaml"), "--checkpoint",
                   str(cpt), "--batch-size", "2", "--epochs", "2",
                   "--device", "cpu", "--num-workers", "0", "--seed", "3"])
    log = (cpt / "trainer.log").read_text()
    losses = [float(line.split(") = ")[1].split("(")[0])
              for line in log.splitlines() if "/valid:" in line]
    assert len(losses) == 3 and losses[-1] < losses[0], losses
    with open(cpt / "last.ckpt", "rb") as fd:
        params = pickle.load(fd)["params"]["nnet"]
    _, variables, _ = zoo_pair(NAME, CONF, enh=ENH, seed=0)
    assert sorted(p for p, _ in leaves(params)) == \
        sorted(p for p, _ in leaves(variables["params"]))
