#!/usr/bin/env python
"""PyTorch port, the whole training slice: the small flagship (Conformer
AED + CTC) under task asr@ctc_xent with weights converted from aps_tpu,
against aps_tpu on the same numpy batch — loss, stats, every parameter
gradient and the batch statistics after the step; two trainer steps (clip +
Adam + scheduled rate) against the same steps with optax; the non-finite
skip; and the train_am command, whose checkpoint both packages load."""

import copy
import json
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from aps_tpu import libs as jax_libs  # noqa: E402
from aps_tpu.eval.wrapper import load_checkpoint as jax_load  # noqa: E402
from aps_tpu.transform import AsrTransform as JaxTransform  # noqa: E402
from aps_tpu_torch.convert import (to_gradients, to_state_dict,  # noqa: E402
                                   to_variables)
from aps_tpu_torch.eval.wrapper import load_checkpoint  # noqa: E402
from aps_tpu_torch.flagship import build_flagship, flagship_conf  # noqa
from aps_tpu_torch.io import write_audio  # noqa: E402
from aps_tpu_torch.libs import aps_task, aps_trainer  # noqa: E402
from aps_tpu_torch.trainer.dp import DataParallelTrainer  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
VOCAB = 64
TASK_CONF = dict(ctc_weight=0.2, blank=VOCAB - 1, lsm_factor=0.1)
# the loss is an O(30) sum of float32 log-probs through a 2-layer model
LOSS_RTOL = 1e-5
# a gradient leaf sums the batch's contributions in another order; its
# bound is relative to the leaf's largest entry (at least 1)
GRAD_RTOL = 2e-4
# a leaf whose exact gradient is 0 (its float64 gradient below ZERO_F64 of
# the model's largest entry: a bias that feeds a batch norm in training
# mode, or a softmax over the channels) has float32 values that are
# rounding noise; both packages' must stay below ZERO_F32 of that entry
ZERO_F64 = 1e-12
ZERO_F32 = 1e-5
# running statistics: 0.9 old + 0.1 batch statistic; the conv front end's
# variances reach ~1e2, so the bound is relative to the leaf's largest entry
STATS_RTOL = 1e-5
# parameters after two Adam steps of rate ~1e-3: the update divides the
# gradient's mean by its rms, so gradient rounding shows in the quotient
STEP_ATOL = 2e-5


def no_dropout_conf():
    """Small flagship with every dropout off, so both sides compute the
    same function in training mode."""
    conf = flagship_conf(VOCAB, small=True, enc_att_dropout=0.0)
    nnet_conf = conf["nnet_conf"]
    nnet_conf["enc_kwargs"]["arch_kwargs"]["ffn_dropout"] = 0.0
    nnet_conf["dec_kwargs"]["arch_kwargs"].update(att_dropout=0.0,
                                                  ffn_dropout=0.0)
    return conf


def make_batch(seed, N=3, S=24000, L=7):
    rng = np.random.default_rng(seed)
    src_len = np.array([S, S - 3100, S - 7000][:N])
    src = np.zeros((N, S), dtype=np.float32)
    for i, n in enumerate(src_len):
        src[i, :n] = 0.1 * rng.standard_normal(n)
    tgt_len = np.array([L, L - 2, 3][:N])
    tgt = rng.integers(0, VOCAB - 3, (N, L))
    for i, n in enumerate(tgt_len):
        tgt[i, n:] = -1
    return {"src_pad": src, "src_len": src_len, "tgt_pad": tgt,
            "tgt_len": tgt_len}


def _leaves(tree, prefix=""):
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(val, dict):
            yield from _leaves(val, path)
        else:
            yield path, np.asarray(val)


def assert_trees_close(got, want, rtol=0.0, atol=0.0, exact=None,
                       zero=None):
    """Each leaf of got within atol + rtol x its own largest entry of
    want's (a leaf's bound does not borrow from another leaf's scale).
    With exact (the tree of a float64 pass), a leaf that is 0 there (below
    `zero`, default ZERO_F64, of that tree's largest entry) is held to
    ZERO_F32 of it in both trees instead, its float32 values being
    rounding noise; returns the paths of those leaves."""
    zero = ZERO_F64 if zero is None else zero
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(got) == sorted(want)
    zeros = []
    if exact is not None:
        exact = dict(_leaves(exact))
        assert sorted(exact) == sorted(want)
        top = max(float(np.abs(v).max()) for v in exact.values())
        zeros = sorted(p for p, v in exact.items()
                       if np.abs(v).max() <= zero * top)
        for path in zeros:
            for side in (got[path], want[path]):
                assert np.abs(side).max() <= ZERO_F32 * top, \
                    (path, float(np.abs(side).max()), top)
    for path, w in want.items():
        if path not in zeros:
            bound = atol + rtol * float(np.abs(w).max())
            np.testing.assert_allclose(got[path], w, atol=bound, rtol=0,
                                       err_msg=path)
    return zeros


def float64_gradients(task, egs):
    """The gradients of one training-mode pass of a float64 copy of the
    port's task on the batch (its float arrays in float64), as aps_tpu's
    tree: the referee that tells a leaf whose exact gradient is 0."""
    exact = copy.deepcopy(task).double().train()
    exact.zero_grad(set_to_none=True)

    def cast(v):
        if isinstance(v, list):
            return [cast(x) for x in v]
        v = np.asarray(v)
        return torch.from_numpy(v.astype(np.float64)
                                if v.dtype == np.float32 else v)

    exact({k: cast(v) for k, v in egs.items()})["loss"].backward()
    return to_gradients(exact.nnet)


@pytest.fixture(scope="module")
def slice_pair():
    """(flax task, its variables as numpy, the port's task with the same
    weights, the batch)."""
    conf = no_dropout_conf()
    jnnet = jax_libs.aps_asr_nnet(conf["nnet"])(
        asr_transform=JaxTransform(**conf["asr_transform"]),
        **conf["nnet_conf"])
    jtask = jax_libs.aps_task("asr@ctc_xent", jnnet, **TASK_CONF)
    egs = make_batch(11)
    jegs = {k: jnp.asarray(v) for k, v in egs.items()}
    key = jax.random.PRNGKey(0)
    variables = jtask.init({"params": key, "dropout": key, "aug": key,
                            "ss": key}, jegs, training=True)
    variables = jax.tree_util.tree_map(np.array, dict(variables))
    rng = np.random.default_rng(5)
    for path, val in _leaves(variables["batch_stats"]):
        val[...] = 0.1 * rng.standard_normal(val.shape) \
            if path.endswith("mean") else 1 + 0.2 * rng.random(val.shape)
    task = aps_task("asr@ctc_xent", build_flagship(conf), **TASK_CONF)
    task.nnet.load_state_dict(to_state_dict(
        {"params": variables["params"]["nnet"],
         "batch_stats": variables["batch_stats"]["nnet"]}, task.nnet))
    return jtask, variables, task, egs


def jax_loss_and_grads(jtask, variables, egs):
    jegs = {k: jnp.asarray(v) for k, v in egs.items()}
    key = jax.random.PRNGKey(1)

    def loss_fn(params):
        out, new_state = jtask.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jegs, training=True, mutable=["batch_stats"],
            rngs={"dropout": key, "aug": key, "ss": key})
        return out["loss"], (out, new_state)

    (_, (out, new_state)), grads = jax.value_and_grad(
        loss_fn, has_aux=True)(variables["params"])
    return out, new_state["batch_stats"], grads


def test_ctc_xent_step_matches_jax(slice_pair):
    """Loss, stats (accu, @ctc, xent), every parameter gradient and the
    batch_stats after one training-mode pass."""
    jtask, variables, task, egs = slice_pair
    task = copy.deepcopy(task).train()
    stats = task({k: torch.from_numpy(v) for k, v in egs.items()})
    stats["loss"].backward()
    want, want_stats, want_grads = jax_loss_and_grads(jtask, variables, egs)
    assert sorted(stats) == sorted(want) == ["@ctc", "accu", "loss", "xent"]
    for key in want:
        np.testing.assert_allclose(stats[key].item(), float(want[key]),
                                   rtol=LOSS_RTOL, err_msg=key)
    zeros = assert_trees_close(to_gradients(task.nnet), want_grads["nnet"],
                               rtol=GRAD_RTOL,
                               exact=float64_gradients(slice_pair[2], egs))
    # the conv biases before a batch norm in training mode
    assert zeros == [
        "encoder/encoder/layer_0/dconv/bias",
        "encoder/encoder/layer_1/dconv/bias",
        "encoder/proj_layer/Conv2dEncoder_0/conv_0/Conv_0/bias",
        "encoder/proj_layer/Conv2dEncoder_0/conv_1/Conv_0/bias"], zeros
    assert_trees_close(to_variables(task.nnet)["batch_stats"],
                       want_stats["nnet"], rtol=STATS_RTOL)
    # the statistics did move, and by the biased batch variance
    before = dict(_leaves(variables["batch_stats"]["nnet"]))
    after = dict(_leaves(want_stats["nnet"]))
    assert all(np.abs(after[k] - before[k]).max() > 1e-4 for k in before)


def test_ctc_xent_eval_matches_jax(slice_pair):
    """The same task in eval mode (running statistics, no update)."""
    jtask, variables, task, egs = slice_pair
    task = copy.deepcopy(task).eval()
    with torch.no_grad():
        stats = task({k: torch.from_numpy(v) for k, v in egs.items()})
    want = jtask.apply(variables, {k: jnp.asarray(v) for k, v in egs.items()},
                       training=False)
    for key in want:
        np.testing.assert_allclose(stats[key].item(), float(want[key]),
                                   rtol=LOSS_RTOL, err_msg=key)
    assert_trees_close(to_variables(task.nnet)["batch_stats"],
                       variables["batch_stats"]["nnet"])


TRAINER_CONF = dict(
    optimizer="adam",
    # eps well above the gradients' rounding noise: with the default 1e-8
    # an entry whose gradient is ~1e-7 gets an update of order lr whose
    # size follows that noise, and the two sides cannot be compared
    optimizer_kwargs={"lr": 1e-3, "eps": 1e-3},
    lr_scheduler="warmup_noam_lr",
    lr_scheduler_period="step",
    lr_scheduler_kwargs={"peak_lr": 2e-3, "warmup": 2},
    clip_gradient=5.0,
    report_metrics=["loss", "accu", "@ctc", "xent"],
)


def test_two_trainer_steps_match_optax(slice_pair, tmp_path):
    """Two steps of the port's trainer on two batches == the step of
    aps_tpu's trainer (clip_by_global_norm -> adam at rate 1, the update
    scaled by the scheduler's rate): parameters, batch_stats, the clipped
    norm reported."""
    jtask, variables, task, _ = slice_pair
    trainer = aps_trainer("dp")(copy.deepcopy(task), device="cpu",
                                checkpoint=tmp_path, **TRAINER_CONF)
    tx = optax.chain(optax.clip_by_global_norm(5.0),
                     optax.adam(1.0, eps=1e-3))
    params, state = variables["params"], variables["batch_stats"]
    opt_state = tx.init(params)
    from aps_tpu.trainer.lr import LrScheduler
    sched = LrScheduler["warmup_noam_lr"](lr=1e-3, peak_lr=2e-3, warmup=2)
    for step in range(2):
        egs = make_batch(20 + step)
        assert trainer.train_one_step(dict(egs, **{"#utt": 3, "#tok": 14}))
        trainer.cur_step += 1
        trainer.lr_scheduler.step()
        out, state, grads = jax_loss_and_grads(
            jtask, {"params": params, "batch_stats": state}, egs)
        norm = float(optax.global_norm(grads))
        assert norm > 5.0  # the clip is active
        updates, opt_state = tx.update(grads, opt_state, params)
        rate = sched.get_lr()
        sched.step()
        params = optax.apply_updates(
            params, jax.tree_util.tree_map(lambda u: u * rate, updates))
        np.testing.assert_allclose(float(trainer.reporter.stats["norm"][-1]),
                                   norm, rtol=1e-4)
        np.testing.assert_allclose(float(trainer.reporter.stats["loss"][-1]),
                                   float(out["loss"]), rtol=1e-4)
        assert trainer.reporter.stats["rate"][-1] == rate
    got = to_variables(trainer.task.nnet)
    assert_trees_close(got["params"], params["nnet"], atol=STEP_ATOL)
    assert_trees_close(got["batch_stats"], state["nnet"], rtol=STATS_RTOL)
    moved = dict(_leaves(variables["params"]["nnet"]))
    after = dict(_leaves(got["params"]))
    assert max(np.abs(after[k] - moved[k]).max() for k in moved) > 1e-3


def test_one_trainer_step_at_default_eps_matches_optax(slice_pair, tmp_path):
    """One step with the port's default Adam eps (1e-8) against optax's
    default. The first Adam update of an entry is g / (|g| + eps), so it is
    compared where the clipped gradient is clearly above float32 rounding
    (|g| > 1e-4, against gradient errors of ~1e-7): there the two sides
    must agree to 2e-3 of the update, while an eps of 1e-3 would shrink
    these updates by up to a factor of ten."""
    jtask, variables, task, _ = slice_pair
    conf = dict(TRAINER_CONF, optimizer_kwargs={"lr": 1e-3})
    trainer = aps_trainer("dp")(copy.deepcopy(task), device="cpu",
                                checkpoint=tmp_path, **conf)
    assert trainer.optimizer.defaults["eps"] == 1e-8
    egs = make_batch(20)
    assert trainer.train_one_step(dict(egs))
    rate = trainer.reporter.stats["rate"][-1]
    params = variables["params"]
    _, _, grads = jax_loss_and_grads(jtask, variables, egs)
    tx = optax.chain(optax.clip_by_global_norm(5.0), optax.adam(1.0))
    updates, _ = tx.update(grads, tx.init(params), params)
    scale = 5.0 / max(float(optax.global_norm(grads)), 5.0)
    clipped = dict(_leaves(grads["nnet"]))
    want = dict(_leaves(updates["nnet"]))
    before = dict(_leaves(params["nnet"]))
    compared = total = 0
    for path, after in _leaves(to_variables(trainer.task.nnet)["params"]):
        sure = np.abs(clipped[path]) * scale > 1e-4
        step = (after.astype(np.float64) - before[path]) / rate
        # a parameter of size |w| moves by rate * update in float32
        atol = 2e-3 + 2e-7 * np.abs(before[path][sure]) / rate
        assert np.all(np.abs(step[sure] - want[path][sure]) <= atol), path
        compared += int(sure.sum())
        total += sure.size
    assert compared > 0.5 * total, (compared, total)


def test_adam_reads_what_aps_tpu_reads(slice_pair, tmp_path):
    """optimizer_kwargs {lr, weight_decay} as the separation recipes give
    them: aps_tpu's "adam" reads beta1, beta2 and eps only, so weight_decay
    has no effect there and must have none in the port (where handing it to
    torch.optim.Adam would add an L2 term). One step in both packages from
    the same kwargs: the parameters agree, they equal the port's step
    without the key to the bit, and trainer.log says the key was ignored."""
    from aps_tpu.trainer.dp import OPTIMIZERS
    jtask, variables, task, _ = slice_pair
    kwargs = {"lr": 1e-3, "weight_decay": 1e-5, "eps": 1e-3}
    egs = make_batch(20)
    trainers = []
    for name, opt_kwargs in (("with", kwargs),
                             ("without", {"lr": 1e-3, "eps": 1e-3})):
        conf = dict(TRAINER_CONF, optimizer_kwargs=opt_kwargs)
        trainers.append(aps_trainer("dp")(copy.deepcopy(task), device="cpu",
                                          checkpoint=tmp_path / name, **conf))
        assert trainers[-1].train_one_step(dict(egs))
    with_wd, without = trainers
    assert with_wd.optimizer.defaults["weight_decay"] == 0
    for (key, a), b in zip(with_wd.task.state_dict().items(),
                           without.task.state_dict().values()):
        assert torch.equal(a, b), key
    log = (tmp_path / "with" / "trainer.log").read_text()
    assert "weight_decay have no effect" in log
    assert "no effect" not in (tmp_path / "without" /
                               "trainer.log").read_text()
    params = variables["params"]
    _, _, grads = jax_loss_and_grads(jtask, variables, egs)
    tx = optax.chain(optax.clip_by_global_norm(5.0),
                     OPTIMIZERS["adam"](kwargs))
    updates, _ = tx.update(grads, tx.init(params), params)
    rate = with_wd.reporter.stats["rate"][-1]
    want = optax.apply_updates(
        params, jax.tree_util.tree_map(lambda u: u * rate, updates))
    assert_trees_close(to_variables(with_wd.task.nnet)["params"],
                       want["nnet"], atol=STEP_ATOL)


def test_am_raw_loader_matches_jax_package(tmp_path):
    """The port's am@raw loader with the word tokenizer gives the batches
    of aps_tpu's loader on the same corpus, in validation order and in two
    shuffled training epochs: same keys, bit-equal arrays."""
    from aps_tpu_torch.libs import aps_dataloader
    _write_corpus(tmp_path)
    vocab = {f"w{i}": i for i in range(1, 20)}
    vocab.update({"<unk>": 0, "<sos>": 20, "<eos>": 21})
    kwargs = dict(fmt="am@raw", vocab_dict=vocab, max_batch_size=4,
                  min_batch_size=2, adapt_dur=0.7, tokenizer="word",
                  tokenizer_kwargs={"filter_words": ["w3"]},
                  wav_scp=str(tmp_path / "wav.scp"),
                  text=str(tmp_path / "text"),
                  utt2dur=str(tmp_path / "utt2dur"))
    num_batches = 0
    for train, epoch in ((False, 0), (True, 0), (True, 1)):
        ours = aps_dataloader(train=train, **kwargs)
        theirs = jax_libs.aps_dataloader(train=train, **kwargs)
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        ours, theirs = list(ours), list(theirs)
        assert len(ours) == len(theirs) > 1
        for got, want in zip(ours, theirs):
            assert sorted(got) == sorted(want)
            for key, val in want.items():
                np.testing.assert_array_equal(np.asarray(got[key]),
                                              np.asarray(val), err_msg=key)
                assert np.asarray(got[key]).dtype == np.asarray(val).dtype
        num_batches += len(ours)
    assert num_batches >= 6


@pytest.mark.parametrize("mode,thres", [("min", 1e-3), ("min", 0.5),
                                         ("max", 1e-3), ("max", 0.5)])
def test_stop_detector_matches_aps_tpu(mode, thres):
    """The port's StopDetector and aps_tpu's on the same values: the same
    verdict at every step, the same best, the same point where it stops,
    the same state_dict; a legacy state (mode + unsigned best) loads into
    both alike."""
    from aps_tpu.trainer.base import StopDetector as JaxStopDetector
    from aps_tpu_torch.trainer.base import StopDetector
    rng = np.random.default_rng(len(mode) + int(thres * 10))
    values = np.cumsum(rng.normal(0.0, 0.6, size=40)).tolist()
    ours = StopDetector(4, mode=mode, no_impr_thres=thres)
    theirs = JaxStopDetector(4, mode=mode, no_impr_thres=thres)
    ours.reset(values[0])
    theirs.reset(values[0])
    stops = []
    for n, value in enumerate(values[1:]):
        assert ours.step(value) == theirs.step(value), n
        assert ours.best == theirs.best and ours.stop() == theirs.stop()
        if ours.stop():
            stops.append(n)
    assert stops, "the sequence never stalls for 4 steps"
    assert ours.state_dict() == theirs.state_dict()
    legacy = {"mode": mode, "best_criterion": 1.5, "no_impr": 2,
              "max_no_impr": 4, "no_impr_thres": thres}
    ours, theirs = StopDetector(1), JaxStopDetector(1)
    ours.load_state_dict(legacy)
    theirs.load_state_dict(legacy)
    assert ours.state_dict() == theirs.state_dict()
    assert ours.best == theirs.best == 1.5
    after = [ours.step(1.2), ours.step(1.9), ours.stop()]
    assert after == [theirs.step(1.2), theirs.step(1.9), theirs.stop()]


class _OneBatch:
    """A loader of one batch a pass."""

    def set_epoch(self, epoch):
        pass

    def __iter__(self):
        return iter([{}])


def _scripted_trainer(checkpoint, dev_losses, **kwargs):
    """The port's Trainer on a stand-in step whose n-th validation
    reports dev_losses[n]."""
    from aps_tpu_torch.trainer.base import Trainer

    class Scripted(Trainer):
        validations = 0

        def train_one_step(self, egs):
            self.reporter.add("loss", 1.0)
            return True

        def valid_one_step(self, egs):
            self.reporter.add("loss", dev_losses[type(self).validations])
            type(self).validations += 1

    return Scripted(torch.nn.Linear(2, 2), device="cpu",
                    checkpoint=checkpoint,
                    **kwargs)


def test_trainer_stops_early_as_aps_tpu_does(tmp_path):
    """Trainer.run on a dev loss that stalls stops after the epoch where
    aps_tpu's StopDetector says stop, logs aps_tpu's line, writes its
    stop_state into the checkpoints, and a run cut short and resumed from
    last.ckpt keeps the count and stops after the same epoch."""
    from aps_tpu.trainer.base import StopDetector as JaxStopDetector
    dev = [5.0, 4.0, 3.0, 3.0005, 2.9995, 3.5, 2.0, 2.0, 2.0]
    rule = JaxStopDetector(3, no_impr_thres=1e-3)
    rule.reset(dev[0])
    stop_epoch = next(n for n, value in enumerate(dev[1:], 1)
                      if not rule.step(value) and rule.stop())
    assert stop_epoch == 5
    whole = _scripted_trainer(tmp_path / "whole", dev, no_impr=3)
    whole.run(_OneBatch(), _OneBatch(), num_epochs=8)
    assert whole.cur_epoch == stop_epoch
    log = (tmp_path / "whole" / "trainer.log").read_text()
    assert "Stop training cause no impr for 3 epochs" in log
    for name in ("last", "best"):
        with open(tmp_path / "whole" / f"{name}.ckpt", "rb") as fd:
            state = pickle.load(fd)
        epoch = stop_epoch if name == "last" else 2
        assert state["epoch"] == epoch
        assert state["stop_state"]["no_impr"] == (3 if name == "last" else 0)
        assert state["stop_state"]["best_criterion"] == 3.0
    assert whole.stop_detector.state_dict() == rule.state_dict()

    cut = _scripted_trainer(tmp_path / "cut", dev, no_impr=3)
    cut.run(_OneBatch(), _OneBatch(), num_epochs=4)
    assert cut.cur_epoch == 4 and cut.stop_detector.no_impr == 2
    # the resumed run validates once more before its first epoch: its
    # script repeats the value of epoch 4
    again = _scripted_trainer(tmp_path / "cut", [dev[4]] + dev[5:],
                              no_impr=3)
    assert again.cur_epoch == 4 and again.stop_detector.no_impr == 2
    assert again.stop_detector.best == 3.0
    again.run(_OneBatch(), _OneBatch(), num_epochs=8)
    assert again.cur_epoch == stop_epoch


def test_trainer_defaults_are_aps_tpus():
    """The port's Trainer takes aps_tpu's defaults for early stopping and
    the stop criterion."""
    import inspect

    from aps_tpu.trainer.base import Trainer as JaxTrainer
    from aps_tpu_torch.trainer.base import Trainer
    ours = inspect.signature(Trainer).parameters
    theirs = inspect.signature(JaxTrainer).parameters
    for key in ("no_impr", "no_impr_thres", "stop_criterion",
                "report_metrics", "stop_on_errors", "prog_interval"):
        assert ours[key].default == theirs[key].default, key
    assert ours["no_impr"].default == 6
    assert ours["no_impr_thres"].default == 1e-3


def test_trainer_skips_a_non_finite_step(slice_pair, tmp_path):
    """A batch that gives a non-finite loss leaves parameters, optimizer
    state and batch statistics as they were and reports failure."""
    _, _, task, _ = slice_pair
    trainer = DataParallelTrainer(copy.deepcopy(task), device="cpu",
                                  checkpoint=tmp_path, **TRAINER_CONF)
    before = copy.deepcopy(trainer.task.state_dict())
    egs = make_batch(30)
    egs["src_pad"][0, 100] = np.inf
    assert trainer.train_one_step(egs) is False
    for key, val in trainer.task.state_dict().items():
        assert torch.equal(val, before[key]), key
    assert len(trainer.optimizer.state) == 0
    assert trainer.train_one_step(make_batch(31)) is True


def test_trainer_refuses_what_is_not_ported(slice_pair, tmp_path):
    _, _, task, _ = slice_pair
    with pytest.raises(ValueError, match="optimizer"):
        DataParallelTrainer(task, device="cpu", checkpoint=tmp_path,
                            optimizer="lamb")
    with pytest.raises(ValueError, match="matmul_precision"):
        DataParallelTrainer(task, device="cpu", checkpoint=tmp_path,
                            matmul_precision="float16")
    # weight noise, profile and tensorboard are ported
    # (tests/test_torch_trainer_opts.py holds them), and so are the data
    # axis of the device mesh and the pipeline depth
    # (tests/test_torch_distributed.py) and its tensor and sequence axes
    # (tests/test_torch_parallel.py); a model axis that does not divide
    # the world is refused, as aps_tpu's build_mesh refuses it, and
    # sequence_parallel without it has no effect, as in aps_tpu
    with pytest.raises(ValueError, match="tensor_parallel 2 does not "
                       "divide the 1 process"):
        DataParallelTrainer(task, device="cpu", checkpoint=tmp_path,
                            tensor_parallel=2)
    assert not DataParallelTrainer(
        copy.deepcopy(task), device="cpu", checkpoint=tmp_path,
        sequence_parallel=True).sequence_parallel
    assert DataParallelTrainer(copy.deepcopy(task), device="cpu",
                               checkpoint=tmp_path,
                               pipeline_depth=2).pipeline_depth == 2
    with pytest.raises(ValueError, match="pipeline_depth 2 with acmu"):
        DataParallelTrainer(task, device="cpu", checkpoint=tmp_path,
                            pipeline_depth=2, acmu_gradient=2)
    # the values that turn those options off pass; schedule sampling is
    # ported (tests/test_torch_att_decode.py holds it)
    DataParallelTrainer(copy.deepcopy(task), device="cpu",
                        checkpoint=tmp_path, matmul_precision="float32",
                        tensor_parallel=1, pipeline_depth=1)
    trainer = DataParallelTrainer(
        copy.deepcopy(task), device="cpu", checkpoint=tmp_path,
        ss_scheduler="linear", ss_scheduler_kwargs={"ssr": 0.1},
        report_metrics=["loss", "accu"])
    assert trainer.ss_scheduler is not None and trainer.ssr == 0
    with pytest.raises(ValueError, match="Unknown trainer option"):
        DataParallelTrainer(task, device="cpu", checkpoint=tmp_path,
                            bogus=1)


def _write_corpus(root: Path, num_utts: int = 12):
    """wav.scp / text / utt2dur of seeded noise and a dict file."""
    rng = np.random.default_rng(40)
    words = [f"w{i}" for i in range(1, 20)]
    with open(root / "dict", "w") as fd:
        fd.write("<unk> 0\n")
        for i, w in enumerate(words):
            fd.write(f"{w} {i + 1}\n")
        fd.write("<sos> 20\n<eos> 21\n")
    with open(root / "wav.scp", "w") as scp, \
            open(root / "text", "w") as text, \
            open(root / "utt2dur", "w") as dur:
        for n in range(num_utts):
            secs = 0.6 + 0.05 * n
            wav = 0.1 * rng.standard_normal(int(16000 * secs))
            write_audio(str(root / f"u{n}.wav"), wav)
            scp.write(f"u{n} {root / f'u{n}.wav'}\n")
            toks = rng.choice(words + ["oov"], size=2 + n % 3)
            text.write(f"u{n} {' '.join(toks)}\n")
            dur.write(f"u{n} {secs:.2f}\n")


def _train_conf(root: Path):
    conf = flagship_conf(VOCAB, small=True, enc_att_dropout=0.0)
    for key in ("vocab_size", "sos", "eos", "ctc"):
        conf["nnet_conf"].pop(key)  # load_am_conf takes them from the dict
    data = dict(wav_scp=str(root / "wav.scp"), text=str(root / "text"),
                utt2dur=str(root / "utt2dur"))
    conf.update(
        task="asr@ctc_xent",
        task_conf=dict(ctc_weight=0.2, lsm_factor=0.1),
        trainer_conf=dict(TRAINER_CONF, no_impr=4),
        data_conf=dict(fmt="am@raw",
                       loader=dict(min_batch_size=2, adapt_dur=0.7,
                                   tokenizer="word"),
                       train=data, valid=data))
    (root / "train.yaml").write_text(json.dumps(conf))


def test_train_am_command_and_checkpoint(tmp_path):
    """`aps_tpu_torch.cmd.train_am --device cpu` in a fresh interpreter
    (which must not import jax or aps_tpu) trains two epochs on a small
    corpus; the checkpoint it writes loads in aps_tpu and in the port and
    both give the same decode_enc; training lowered the dev loss."""
    _write_corpus(tmp_path)
    _train_conf(tmp_path)
    cpt = tmp_path / "cpt"
    argv = ["--conf", str(tmp_path / "train.yaml"), "--dict",
            str(tmp_path / "dict"), "--checkpoint", str(cpt), "--batch-size",
            "4", "--epochs", "2", "--seed", "7", "--device", "cpu",
            "--prog-interval", "2"]
    code = ("import sys\n"
            "from aps_tpu_torch.cmd import train_am\n"
            f"train_am.main({argv!r})\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.split('.')[0] == 'aps_tpu']\n"
            "assert not bad, bad\n"
            "print('TRAINED-WITHOUT-JAX')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "TRAINED-WITHOUT-JAX" in proc.stdout
    for name in ("best.ckpt", "last.ckpt", "train.yaml", "dict",
                 "trainer.log"):
        assert (cpt / name).is_file(), name
    log = (cpt / "trainer.log").read_text()
    losses = [float(line.split(") = ")[1].split("/")[0])
              for line in log.splitlines() if "/valid:" in line]
    assert len(losses) == 3 and losses[-1] < losses[0], losses

    rng = np.random.default_rng(41)
    wav = (0.1 * rng.standard_normal((2, 12000))).astype(np.float32)
    lens = np.array([12000, 9000])
    ours = load_checkpoint(str(cpt), "last")
    with torch.no_grad():
        got = ours["nnet"].decode_enc(torch.from_numpy(wav),
                                      torch.from_numpy(lens))
    theirs = jax_load(str(cpt), "last")
    want = theirs["nnet"].apply(theirs["variables"], jnp.asarray(wav),
                                jnp.asarray(lens), method="decode_enc")
    assert ours["epoch"] == theirs["epoch"] == 2
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=1e-4)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               atol=1e-4)


def test_trainer_resumes_from_its_checkpoint(slice_pair, tmp_path):
    """last.ckpt brings back weights, optimizer moments, step and
    scheduler state: a resumed trainer takes the same next step."""
    _, _, task, _ = slice_pair
    first = DataParallelTrainer(copy.deepcopy(task), device="cpu",
                                checkpoint=tmp_path / "a", **TRAINER_CONF)
    assert first.train_one_step(make_batch(50))
    first.cur_step += 1
    first.lr_scheduler.step()
    first.save_checkpoint(1, best=False)
    resumed = DataParallelTrainer(copy.deepcopy(task), device="cpu",
                                  checkpoint=tmp_path / "a", **TRAINER_CONF)
    assert resumed.cur_epoch == 1 and resumed.cur_step == 1
    assert resumed.lr_scheduler.get_lr() == first.lr_scheduler.get_lr()
    for trainer in (first, resumed):
        assert trainer.train_one_step(make_batch(51))
    for (key, a), b in zip(first.task.state_dict().items(),
                           resumed.task.state_dict().values()):
        torch.testing.assert_close(a, b, atol=1e-7, rtol=0, msg=key)
