#!/usr/bin/env python
"""PyTorch port, what the asr@xfmr recipes ask of the trainer: the eight
optimizers against optax, gradient accumulation (acmu_gradient) against
aps_tpu's trainer (optax.MultiSteps) on the small flagship, with a
non-finite mini-step and a resume between mini-steps, matmul_precision,
epoch checkpoints and their averaging against aps_tpu's command,
--eval-interval, --init, and one CPU step of each of the nine asr@xfmr
recipes from its YAML as written, with only sizes patched."""

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
from aps_tpu.eval.wrapper import load_checkpoint as jax_load  # noqa: E402
from aps_tpu.trainer.dp import OPTIMIZERS as JAX_OPTIMIZERS  # noqa: E402
from aps_tpu.trainer.dp import DataParallelTrainer as JaxTrainer  # noqa
from aps_tpu.transform import AsrTransform as JaxTransform  # noqa: E402
from aps_tpu_torch.conf import load_am_conf, load_yaml  # noqa: E402
from aps_tpu_torch.convert import _to_tree, to_variables  # noqa: E402
from aps_tpu_torch.eval.wrapper import load_checkpoint  # noqa: E402
from aps_tpu_torch.flagship import build_flagship  # noqa: E402
from aps_tpu_torch.libs import (aps_asr_nnet, aps_task,  # noqa: E402
                                aps_trainer, aps_transform)
from aps_tpu_torch.trainer import base as port_base  # noqa: E402
from aps_tpu_torch.trainer.dp import make_optimizer  # noqa: E402

from test_torch_train import (STATS_RTOL, STEP_ATOL, TASK_CONF,  # noqa: E402
                              _leaves, _train_conf, _write_corpus,
                              assert_trees_close, make_batch,
                              no_dropout_conf)

REPO = Path(__file__).resolve().parents[1]
# two optimizer steps on the same float32 gradients and rates: the
# updates differ only in rounding (rsqrt against 1 / sqrt and the like),
# plus, for the Adam family, optax's bias corrections 1 - b ** t formed in
# float32 (1 - 0.999 is off by 1.3e-5 of itself there; torch forms them in
# float64), a relative error of the update of up to 1e-5
OPT_ATOL, BIAS_RTOL = 1e-6, 2e-5
# the asr@xfmr recipes (examples/asr/*/conf), two of which hand NoamLR a
# key that neither package's scheduler takes
RECIPES = ["aishell_v1/1a", "aishell_v1/1b", "aishell_v2/1a", "chime4/1a",
           "gigaspeech/1a", "librispeech/1a", "librispeech/1c",
           "librispeech/2a", "multi_cn/1a"]
RAISES_IN_BOTH = ("librispeech/1c", "librispeech/2a")
ACMU_CONF = dict(
    optimizer="adamw",
    # eps well above the gradients' rounding noise (test_torch_train.py's
    # TRAINER_CONF says why)
    optimizer_kwargs={"lr": 1e-3, "eps": 1e-3, "weight_decay": 1e-2},
    lr_scheduler="warmup_noam_lr",
    lr_scheduler_period="step",
    lr_scheduler_kwargs={"peak_lr": 2e-3, "warmup": 2},
    clip_gradient=5.0,
    acmu_gradient=2,
    report_metrics=["loss", "accu", "@ctc", "xent"],
)


# ---------------------------------------------------------------------------
# the optimizers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name,kwargs", [
    ("adamw", {}),
    ("adamw", {"weight_decay": 1e-3, "beta2": 0.98}),
    ("sgd", {}),
    ("sgd", {"momentum": 0.9, "nesterov": True}),
    ("noam_adam", {}),
    ("adadelta", {"rho": 0.8}),
    ("rmsprop", {}),
    ("rmsprop", {"momentum": 0.5, "alpha": 0.9}),
    ("adam", {"eps": 1e-6}),
    ("adamax", {}),
    ("adagrad", {}),
])
def test_optimizer_matches_optax(name, kwargs):
    """Two steps of the port's optimizer on the same gradients and rates
    as aps_tpu's optax transformation at rate 1, its update scaled by the
    rate."""
    rng = np.random.default_rng(len(name) + len(kwargs))
    params = {"w": rng.standard_normal((6, 5)).astype(np.float32),
              "b": rng.standard_normal(5).astype(np.float32)}
    grads = [{k: (0.3 * rng.standard_normal(v.shape)).astype(np.float32)
              for k, v in params.items()} for _ in range(2)]
    rates = [0.5, 0.2]
    tx = JAX_OPTIMIZERS[name](kwargs)
    want, state = params, tx.init(params)
    ours = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
            for k, v in params.items()}
    opt = make_optimizer(name, list(ours.values()), dict(kwargs, lr=0))
    for grad, rate in zip(grads, rates):
        updates, state = tx.update(grad, state, want)
        want = jax.tree_util.tree_map(lambda p, u: p + rate * u, want,
                                      updates)
        for key, p in ours.items():
            p.grad = torch.from_numpy(grad[key])
        for group in opt.param_groups:
            group["lr"] = rate
        opt.step()
    for key, p in ours.items():
        moved = np.abs(np.asarray(want[key]) - params[key]).max()
        assert moved > 100 * OPT_ATOL, key
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want[key]),
                                   rtol=0, atol=OPT_ATOL + BIAS_RTOL * moved,
                                   err_msg=key)


def test_optimizer_names_the_keys_it_ignores():
    logged = []
    p = [torch.nn.Parameter(torch.zeros(3))]
    make_optimizer("adamax", p, {"lr": 1, "beta1": 0.5}, log=logged.append)
    make_optimizer("adamw", p, {"lr": 1, "weight_decay": 1e-3},
                   log=logged.append)
    assert logged == ["optimizer_kwargs beta1 have no effect: adamax reads "
                      "no key only, as in aps_tpu"]


# ---------------------------------------------------------------------------
# gradient accumulation against aps_tpu's trainer
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def acmu_pair(tmp_path_factory):
    """(the port's task, aps_tpu's task, an init checkpoint holding the
    port's weights) for the small flagship with every dropout off."""
    root = tmp_path_factory.mktemp("acmu")
    conf = no_dropout_conf()
    torch.manual_seed(3)
    task = aps_task("asr@ctc_xent", build_flagship(conf), **TASK_CONF)
    seed = aps_trainer("dp")(copy.deepcopy(task), device="cpu",
                             checkpoint=root / "seed", **ACMU_CONF)
    seed.save_checkpoint(0, best=False)
    jnnet = jax_libs.aps_asr_nnet(conf["nnet"])(
        asr_transform=JaxTransform(**conf["asr_transform"]),
        **conf["nnet_conf"])
    jtask = jax_libs.aps_task("asr@ctc_xent", jnnet, **TASK_CONF)
    return task, jtask, root / "seed" / "last.ckpt"


def _train_both(acmu_pair, tmp_path, batches):
    """The port's and aps_tpu's trainers from the same weights over the
    same mini-batches -> (port trainer, aps_tpu trainer, each step's
    results, whether each step moved the parameters in each package)."""
    task, jtask, init = acmu_pair
    ours = aps_trainer("dp")(copy.deepcopy(task), device="cpu",
                             checkpoint=tmp_path / "port", init=str(init),
                             **ACMU_CONF)
    theirs = JaxTrainer(jtask, checkpoint=tmp_path / "jax", init=str(init),
                        pipeline_depth=0, **ACMU_CONF)
    theirs.init_state(dict(batches[0]))
    results, moved = [], []
    for egs in batches:
        before = (copy.deepcopy(ours.task.nnet.state_dict()),
                  jax.tree_util.tree_map(np.asarray, theirs.params))
        results.append((ours.train_one_step(dict(egs)),
                        theirs.train_one_step(dict(egs))[0]))
        for trainer in (ours, theirs):
            trainer.cur_step += 1
            trainer.lr_scheduler.step()
        moved.append((
            any(not torch.equal(v, before[0][k]) for k, v in
                ours.task.nnet.state_dict().items() if "running" not in k),
            any(np.any(a != np.asarray(b)) for a, b in zip(
                jax.tree_util.tree_leaves(before[1]),
                jax.tree_util.tree_leaves(theirs.params)))))
    return ours, theirs, results, moved


def _assert_states_match(ours, theirs):
    """Parameters, Adam's moments and the batch statistics."""
    got = to_variables(ours.task.nnet)
    assert_trees_close(got["params"], theirs.params["nnet"], atol=STEP_ATOL)
    assert_trees_close(got["batch_stats"],
                       theirs.mstate["batch_stats"]["nnet"],
                       rtol=STATS_RTOL)
    adam = next(st for st in jax.tree_util.tree_leaves(
        theirs.opt_state.inner_opt_state, is_leaf=lambda x: hasattr(x, "mu"))
        if hasattr(st, "mu"))
    named = list(ours.task.nnet.named_parameters())
    for key, want in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
        tree = _to_tree(ours.task.nnet, [
            (name, ours.optimizer.state[p][key]) for name, p in named])
        assert_trees_close(tree["params"], want["nnet"], atol=STEP_ATOL)
    assert int(adam.count) == int(ours.optimizer.state[named[0][1]]["step"])
    assert ours.mini_step == int(theirs.opt_state.mini_step)


def test_accumulation_matches_aps_tpus_trainer(acmu_pair, tmp_path):
    """acmu_gradient 2 over 4 mini-steps with clip and adamw: the
    parameters stay put after mini-steps 1 and 3 and move after 2 and 4
    in both packages, the reported norm is each mini-batch's own, and
    parameters, optimizer state and batch statistics agree."""
    batches = [make_batch(60 + i) for i in range(4)]
    ours, theirs, results, moved = _train_both(acmu_pair, tmp_path, batches)
    assert results == [(True, True)] * 4
    assert moved == [(False, False), (True, True)] * 2
    norms = [float(v) for v in ours.reporter.stats["norm"]]
    np.testing.assert_allclose(norms, [float(v) for v in
                                       theirs.reporter.stats["norm"]],
                               rtol=1e-4)
    assert len(set(norms)) == 4 and min(norms) > 5.0  # the clip is active
    _assert_states_match(ours, theirs)


def test_accumulation_skips_a_non_finite_mini_step(acmu_pair, tmp_path):
    """A non-finite mini-step counts for nothing: the next finite one
    completes the accumulation, in both packages alike."""
    batches = [make_batch(70 + i) for i in range(5)]
    batches[1]["src_pad"][0, 100] = np.inf
    ours, theirs, results, moved = _train_both(acmu_pair, tmp_path, batches)
    assert results == [(True, True), (False, False), (True, True),
                       (True, True), (True, True)]
    assert moved == [(False, False), (False, False), (True, True),
                     (False, False), (True, True)]
    _assert_states_match(ours, theirs)


def test_accumulation_resumes_between_mini_steps(acmu_pair, tmp_path):
    """The running mean and its counter are in the checkpoint: a run cut
    after the first mini-step and resumed from last.ckpt takes the same
    update at the second as the whole run."""
    task, _, _ = acmu_pair
    batches = [make_batch(80 + i) for i in range(2)]

    def steps(trainer, egs):
        for e in egs:
            assert trainer.train_one_step(dict(e))
            trainer.cur_step += 1
            trainer.lr_scheduler.step()

    whole = aps_trainer("dp")(copy.deepcopy(task), device="cpu",
                              checkpoint=tmp_path / "whole", **ACMU_CONF)
    steps(whole, batches)
    cut = aps_trainer("dp")(copy.deepcopy(task), device="cpu",
                            checkpoint=tmp_path / "cut", **ACMU_CONF)
    steps(cut, batches[:1])
    cut.save_checkpoint(1, best=False)
    assert cut.mini_step == 1 and cut.optimizer.state == {}
    resumed = aps_trainer("dp")(copy.deepcopy(task), device="cpu",
                                checkpoint=tmp_path / "cut", **ACMU_CONF)
    assert resumed.mini_step == 1 and resumed.cur_step == 1
    for a, b in zip(resumed.acc_grads, cut.acc_grads):
        assert torch.equal(a, b)
    assert max(a.abs().max() for a in resumed.acc_grads) > 0
    steps(resumed, batches[1:])
    assert whole.mini_step == resumed.mini_step == 0
    moved = False
    for (key, a), b in zip(whole.task.state_dict().items(),
                           resumed.task.state_dict().values()):
        torch.testing.assert_close(a, b, atol=1e-7, rtol=0, msg=key)
        moved |= not torch.equal(a, task.state_dict()[key])
    assert moved


# ---------------------------------------------------------------------------
# matmul_precision
# ---------------------------------------------------------------------------
def test_matmul_precision_is_a_no_op_on_the_cpu(acmu_pair, tmp_path):
    """Every value aps_tpu takes is accepted; on the CPU a step under the
    recipes' "bfloat16" equals the float32 step to the bit, and the TF32
    flags are not touched."""
    task, _, _ = acmu_pair
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    conf = dict(ACMU_CONF, acmu_gradient=1)
    stepped = []
    for value in ("float32", "bfloat16", "tensorfloat32", "highest",
                  "default"):
        trainer = aps_trainer("dp")(copy.deepcopy(task), device="cpu",
                                    checkpoint=tmp_path / value,
                                    matmul_precision=value, **conf)
        if value in ("float32", "bfloat16"):
            assert trainer.train_one_step(make_batch(90))
            stepped.append(trainer.task.state_dict())
    for (key, a), b in zip(stepped[0].items(), stepped[1].values()):
        assert torch.equal(a, b), key
    assert flags == (torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32)


@pytest.mark.parametrize("value,tf32", sorted(
    port_base.TF32_PRECISIONS.items()))
def test_matmul_precision_sets_and_restores_the_tf32_flags(value, tf32):
    """On a CUDA device the step runs under cuBLAS's and cuDNN's TF32 flags
    as the value asks, and the flags come back afterwards (a decode in the
    same process keeps its own)."""
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = matmul.allow_tf32, cudnn.allow_tf32
    try:
        for before in (False, True):
            matmul.allow_tf32 = cudnn.allow_tf32 = before
            with port_base.matmul_precision(value, torch.device("cuda")):
                assert (matmul.allow_tf32, cudnn.allow_tf32) == (tf32, tf32)
            assert (matmul.allow_tf32, cudnn.allow_tf32) == (before, before)
    finally:
        matmul.allow_tf32, cudnn.allow_tf32 = saved
    with pytest.raises(ValueError, match="matmul_precision"):
        aps_trainer("dp")(torch.nn.Linear(2, 2), device="cpu",
                          checkpoint="unused", matmul_precision="int8")


# ---------------------------------------------------------------------------
# epoch checkpoints, averaging, --eval-interval, --init
# ---------------------------------------------------------------------------
def _jax_average_command():
    spec = importlib.util.spec_from_file_location(
        "aps_tpu_average_checkpoint", REPO / "cmd" / "average_checkpoint.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_average_checkpoint_matches_aps_tpu(tmp_path):
    """average_checkpoint 3 makes the trainer write epoch.N.ckpt every
    epoch; the port's average_checkpoint command and aps_tpu's give the
    same parameters on those files, and each package loads the other's
    output."""
    from aps_tpu_torch.cmd import average_checkpoint, train_am
    _write_corpus(tmp_path)
    _train_conf(tmp_path)
    conf = json.loads((tmp_path / "train.yaml").read_text())
    conf["trainer_conf"]["average_checkpoint"] = 3
    (tmp_path / "train.yaml").write_text(json.dumps(conf))
    cpt = tmp_path / "cpt"
    train_am.main(["--conf", str(tmp_path / "train.yaml"), "--dict",
                   str(tmp_path / "dict"), "--checkpoint", str(cpt),
                   "--batch-size", "6", "--epochs", "3", "--device", "cpu"])
    assert sorted(p.name for p in cpt.glob("epoch.*.ckpt")) == [
        "epoch.1.ckpt", "epoch.2.ckpt", "epoch.3.ckpt"]
    average_checkpoint.main([str(cpt), str(cpt / "avg.ckpt"), "--beg", "2",
                             "--end", "3"])
    jax_cmd = _jax_average_command()
    jax_cmd.run(jax_cmd.argparse.Namespace(checkpoint=str(cpt),
                                           out=str(cpt / "avg_jax.ckpt"),
                                           beg=2, end=3))
    with open(cpt / "avg.ckpt", "rb") as fd:
        ours = pickle.load(fd)
    with open(cpt / "avg_jax.ckpt", "rb") as fd:
        theirs = pickle.load(fd)
    assert ours["epoch"] == theirs["epoch"] == 2
    got, want = dict(_leaves(ours["params"])), dict(_leaves(theirs["params"]))
    assert sorted(got) == sorted(want)
    for key, val in want.items():
        assert got[key].dtype == val.dtype
        np.testing.assert_array_equal(got[key], val, err_msg=key)
    # the average lies between the two epochs' weights
    with open(cpt / "epoch.2.ckpt", "rb") as fd:
        two = dict(_leaves(pickle.load(fd)["params"]))
    key = next(k for k in two if k.endswith("ctc_head/kernel"))
    assert not np.array_equal(got[key], two[key])
    # each package loads the other's file
    port_nnet = load_checkpoint(str(cpt), "avg_jax")["nnet"]
    jax_side = jax_load(str(cpt), "avg")
    rng = np.random.default_rng(5)
    wav = (0.1 * rng.standard_normal((1, 9000))).astype(np.float32)
    with torch.no_grad():
        enc = port_nnet.decode_enc(torch.from_numpy(wav))[0]
    want_enc = jax_side["nnet"].apply(jax_side["variables"], jnp.asarray(wav),
                                      method="decode_enc")[0]
    np.testing.assert_allclose(enc.numpy(), np.asarray(want_enc), atol=1e-4)


class _Batches:
    """A loader of `count` empty batches a pass."""

    def __init__(self, count):
        self.count = count

    def set_epoch(self, epoch):
        pass

    def __iter__(self):
        return iter([{}] * self.count)


def _scripted(checkpoint, **kwargs):
    """The port's Trainer on a stand-in step whose validations report a
    falling loss; it counts its validations."""

    class Scripted(port_base.Trainer):
        validations = 0

        def train_one_step(self, egs):
            self.reporter.add("loss", 1.0)
            return True

        def valid_one_step(self, egs):
            self.reporter.add("loss", 10.0 - self.validations)
            type(self).validations += 1

    return Scripted(torch.nn.Linear(2, 2), device="cpu",
                    checkpoint=checkpoint, **kwargs)


def test_eval_interval_validates_every_n_steps(tmp_path):
    """With eval_interval 2 the trainer validates (and saves) every second
    step across epochs, as aps_tpu's _run_in_batch does, and the options
    reach the trainer from the command line."""
    from aps_tpu_torch.cmd.train_am import make_parser
    trainer = _scripted(tmp_path / "a", save_interval=1)
    trainer.run(_Batches(5), _Batches(1), num_epochs=2, eval_interval=2)
    assert trainer.cur_step == 10 and trainer.cur_epoch == 2
    # the first validation, then after steps 2, 4, ..., 10
    assert type(trainer).validations == 6
    log = (tmp_path / "a" / "trainer.log").read_text()
    assert [ln.split("Epoch ")[1][:8] for ln in log.splitlines()
            if "/valid:" in ln] == ["00/valid", "01/valid", "01/valid",
                                    "02/valid", "02/valid", "02/valid"]
    assert sorted(p.name for p in (tmp_path / "a").glob("epoch.*")) == [
        "epoch.1.ckpt", "epoch.2.ckpt"]
    per_epoch = _scripted(tmp_path / "b")
    per_epoch.run(_Batches(5), _Batches(1), num_epochs=2)
    assert type(per_epoch).validations == 3
    assert not list((tmp_path / "b").glob("epoch.*"))
    args = make_parser().parse_args([
        "--conf", "c", "--dict", "d", "--checkpoint", "x", "--eval-interval",
        "3", "--save-interval", "2", "--init", "w.ckpt"])
    assert (args.eval_interval, args.save_interval, args.init) == \
        (3, 2, "w.ckpt")


def test_init_loads_weights_and_not_the_optimizer(acmu_pair, tmp_path):
    """--init takes every weight whose path and shape match and nothing of
    the optimizer, the step or the epoch; a leaf of another shape keeps
    the new model's own value."""
    task, _, _ = acmu_pair
    conf = dict(ACMU_CONF, acmu_gradient=1)
    first = aps_trainer("dp")(copy.deepcopy(task), device="cpu",
                              checkpoint=tmp_path / "a", **conf)
    assert first.train_one_step(make_batch(95))
    first.cur_step += 1
    first.save_checkpoint(4, best=False)
    init = str(tmp_path / "a" / "last.ckpt")
    warm = aps_trainer("dp")(copy.deepcopy(task), device="cpu",
                             checkpoint=tmp_path / "b", init=init, **conf)
    assert warm.cur_epoch == 0 and warm.cur_step == 0
    assert warm.optimizer.state == {}
    for (key, a), b in zip(first.task.state_dict().items(),
                           warm.task.state_dict().values()):
        assert torch.equal(a, b), key
    # another vocabulary: the output layers keep their own weights
    other = no_dropout_conf()
    nnet_conf = other["nnet_conf"]
    nnet_conf.update(vocab_size=70, sos=67, eos=68)
    torch.manual_seed(4)
    fresh = aps_task("asr@ctc_xent", build_flagship(other),
                     **dict(TASK_CONF, blank=69))
    own = copy.deepcopy(fresh.state_dict())
    mixed = aps_trainer("dp")(fresh, device="cpu", checkpoint=tmp_path / "c",
                              init=init, **conf)
    state = mixed.task.state_dict()
    for key, val in state.items():
        src = first.task.state_dict()[key]
        if src.shape == val.shape:
            assert torch.equal(val, src), key
        else:
            assert torch.equal(val, own[key]), key
    assert any(first.task.state_dict()[k].shape != v.shape
               for k, v in state.items())
    log = (tmp_path / "c" / "trainer.log").read_text()
    assert "Warm start: loaded" in log


# ---------------------------------------------------------------------------
# the nine asr@xfmr recipes as written
# ---------------------------------------------------------------------------
def _recipe_conf(recipe, root):
    """The recipe's YAML as written, its dictionary a small one, and only
    sizes patched: depth 1, width 64, feed-forward 128, 16 conv
    channels."""
    with open(root / "dict", "w") as fd:
        fd.write("<unk> 0\n")
        for i in range(1, 17):
            fd.write(f"t{i} {i}\n")
        fd.write("<sos> 17\n<eos> 18\n")
    path = REPO / "examples" / "asr" / recipe.replace("/", "/conf/")
    conf, _ = load_am_conf(f"{path}.yaml", str(root / "dict"))
    assert conf["nnet"] == "asr@xfmr"
    nnet_conf = conf["nnet_conf"]
    for part in ("enc_kwargs", "dec_kwargs"):
        nnet_conf[part]["num_layers"] = 1
        nnet_conf[part]["arch_kwargs"].update(att_dim=64,
                                              feedforward_dim=128)
    nnet_conf["enc_kwargs"]["proj_kwargs"]["conv_channels"] = 16
    return conf


def test_the_nine_recipes_are_the_asr_xfmr_recipes():
    found = sorted(
        f"{p.parents[1].name}/{p.stem}"
        for p in (REPO / "examples" / "asr").glob("*/conf/*.yaml")
        if load_yaml(p).get("nnet") == "asr@xfmr")
    assert found == RECIPES


@pytest.mark.parametrize("recipe", RECIPES)
def test_recipe_trains_as_written(recipe, tmp_path):
    """Transform, model, task and the dp trainer from the recipe's YAML,
    then one training step on the CPU through perturb and aug (int16
    rescale, the recipe's optimizer, precision and accumulation).
    librispeech/1c and 2a hand warmup_noam_lr a transformer_dim, which
    neither package's NoamLR takes: both raise the same TypeError."""
    conf = _recipe_conf(recipe, tmp_path)
    transform = aps_transform("asr")(**conf["asr_transform"])
    nnet = aps_asr_nnet(conf["nnet"])(asr_transform=transform,
                                      **conf["nnet_conf"])
    task = aps_task(conf["task"], nnet, **conf["task_conf"])
    trainer_conf = conf["trainer_conf"]
    if recipe in RAISES_IN_BOTH:
        with pytest.raises(TypeError) as ours:
            aps_trainer("dp")(task, device="cpu",
                              checkpoint=tmp_path / "port", **trainer_conf)
        with pytest.raises(TypeError) as theirs:
            JaxTrainer(None, checkpoint=tmp_path / "jax", **trainer_conf)
        assert "transformer_dim" in str(ours.value)
        assert str(ours.value) == str(theirs.value)
        return
    trainer = aps_trainer("dp")(task, device="cpu",
                                checkpoint=tmp_path / "port", **trainer_conf)
    assert transform.generator is trainer.generator
    assert transform.rescale is not None
    drawn = []
    for layer in (transform.perturb, transform.specaug):
        layer.draw = (lambda fn: lambda *a: drawn.append(fn(*a)) or
                      drawn[-1])(layer.draw)
    rng = np.random.default_rng(len(recipe))
    lens = np.array([16000, 13000])
    wav = np.zeros((2, 16000), dtype=np.float32)
    for i, n in enumerate(lens):
        wav[i, :n] = 0.1 * rng.standard_normal(n)
    tgt = rng.integers(1, 17, (2, 6))
    tgt[1, 4:] = -1
    egs = {"src_pad": wav, "src_len": lens, "tgt_pad": tgt,
           "tgt_len": np.array([6, 4]), "#utt": 2, "#tok": 10}
    assert trainer.train_one_step(egs)
    assert len(drawn) == 2 and drawn[0] in (0, 1, 2)
    assert math.isfinite(float(trainer.reporter.stats["loss"][-1]))
    assert trainer.mini_step == (1 if trainer.acmu_gradient > 1 else 0)
