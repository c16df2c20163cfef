#!/usr/bin/env python
"""PyTorch port, the trainer options weight_noise_std / weight_noise_cfg,
profile / profile_steps and tensorboard: weight noise with the draws fed
in against aps_tpu's update rule (noise added to the parameters for good,
the gradient at the noised parameters, clip and Adam on them), its
schedule against aps_tpu's, the non-finite and OOM steps, the port's own
draws by their statistics; the profiler's trace window and its log lines;
tensorboard's scalars against aps_tpu's reporter, and a trainer without
the package."""

import builtins
import copy
import json
import sys
import types
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import optax  # noqa: E402

from aps_tpu_torch.convert import to_variables  # noqa: E402
from aps_tpu_torch.libs import aps_trainer  # noqa: E402

from test_torch_train import (STEP_ATOL, TRAINER_CONF,  # noqa: E402
                              _OneBatch, _scripted_trainer,
                              assert_trees_close, jax_loss_and_grads,
                              make_batch)
from test_torch_train import slice_pair  # noqa: E402,F401

NOISE_STD = 0.01


def _draws(task, seed: int = 4):
    """A standard normal draw of each trainable parameter, by name."""
    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy(rng.standard_normal(p.shape).astype(
        np.float32)) for k, p in task.named_parameters() if p.requires_grad}


def _as_tree(task, draws):
    """The draws in aps_tpu's layout (the converter's rules)."""
    model = copy.deepcopy(task.nnet)
    with torch.no_grad():
        for key, p in model.named_parameters():
            p.copy_(draws[f"nnet.{key}"])
    return to_variables(model)["params"]


def test_weight_noise_step_matches_aps_tpus_rule(slice_pair,  # noqa: F811
                                                 tmp_path):
    """One step with weight noise, the draws fed in: aps_tpu's rule
    (params + std * draws, the gradient and loss there, clip and Adam on
    the noised parameters, the update scaled by the rate) gives the port's
    parameters, loss and norm."""
    jtask, variables, task, _ = slice_pair
    trainer = aps_trainer("dp")(copy.deepcopy(task), device="cpu",
                                checkpoint=tmp_path,
                                weight_noise_std=NOISE_STD, **TRAINER_CONF)
    draws = _draws(trainer.task)
    names = [k for k, p in trainer.task.named_parameters() if p.requires_grad]
    trainer.draw_weight_noise = lambda: [draws[k] for k in names]
    assert trainer.weight_noise_now()
    egs = make_batch(31)
    assert trainer.train_one_step(dict(egs, **{"#utt": 3, "#tok": 14}))
    tree = {"nnet": _as_tree(trainer.task, draws)}
    noised = jax.tree_util.tree_map(lambda p, d: p + NOISE_STD * d,
                                    variables["params"], tree)
    # jitted: the eager flax pass takes several times as long
    out, _, grads = jax.jit(lambda p: jax_loss_and_grads(
        jtask, {"params": p, "batch_stats": variables["batch_stats"]},
        egs))(noised)
    tx = optax.chain(optax.clip_by_global_norm(5.0),
                     optax.adam(1.0, eps=1e-3))
    updates, _ = tx.update(grads, tx.init(noised), noised)
    rate = trainer.reporter.stats["rate"][-1]
    want = optax.apply_updates(
        noised, jax.tree_util.tree_map(lambda u: u * rate, updates))
    np.testing.assert_allclose(float(trainer.reporter.stats["loss"][-1]),
                               float(out["loss"]), rtol=1e-4)
    np.testing.assert_allclose(float(trainer.reporter.stats["norm"][-1]),
                               float(optax.global_norm(grads)), rtol=1e-4)
    assert_trees_close(to_variables(trainer.task.nnet)["params"],
                       want["nnet"], atol=STEP_ATOL)


def test_weight_noise_stays_on_a_non_finite_step_and_leaves_on_oom(
        slice_pair, tmp_path):  # noqa: F811
    """A non-finite step keeps the noised parameters (aps_tpu selects the
    noised ones); an out-of-memory step, after which aps_tpu's state is as
    it was, takes the noise back off."""
    _, _, task, _ = slice_pair
    trainer = aps_trainer("dp")(copy.deepcopy(task), device="cpu",
                                checkpoint=tmp_path,
                                weight_noise_std=NOISE_STD, **TRAINER_CONF)
    draws = _draws(trainer.task, 9)
    names = [k for k, p in trainer.task.named_parameters() if p.requires_grad]
    trainer.draw_weight_noise = lambda: [draws[k] for k in names]
    before = {k: p.detach().clone()
              for k, p in trainer.task.named_parameters()}
    egs = make_batch(32)
    egs["src_pad"][0, 100] = np.inf
    assert trainer.train_one_step(egs) is False
    for key, p in trainer.task.named_parameters():
        torch.testing.assert_close(p.detach(),
                                   before[key] + draws[key] * NOISE_STD,
                                   atol=0, rtol=0)
    before = {k: p.detach().clone()
              for k, p in trainer.task.named_parameters()}

    def oom(egs):
        raise torch.cuda.OutOfMemoryError("out of memory")

    trainer.task.forward = oom
    assert trainer.train_one_step(make_batch(33)) is False
    for key, p in trainer.task.named_parameters():
        assert torch.equal(p.detach(), before[key]), key


@pytest.mark.parametrize("cfg", [(0, 1, -1), (2, 3, 9), (1, 0, 4),
                                 (5, 2, -1)])
def test_weight_noise_schedule_is_aps_tpus(tmp_path, cfg):
    """weight_noise_now over steps 0-14 == aps_tpu's _weight_noise_now;
    without weight_noise_std no step is noised; the defaults are
    aps_tpu's."""
    import inspect

    from aps_tpu.trainer.base import Trainer as JaxTrainer
    from aps_tpu.trainer.dp import DataParallelTrainer as JaxDP
    trainer = _scripted_trainer(tmp_path, [1.0], weight_noise_std=0.1,
                                weight_noise_cfg=list(cfg))
    got, want = [], []
    for step in range(15):
        trainer.cur_step = step
        got.append(trainer.weight_noise_now())
        want.append(JaxDP._weight_noise_now(SimpleNamespace(
            weight_noise_std=0.1, weight_noise_cfg=list(cfg),
            cur_step=step)))
    assert got == want and any(got)
    trainer.weight_noise_std = None
    assert not trainer.weight_noise_now()
    theirs = inspect.signature(JaxTrainer).parameters
    ours = inspect.signature(type(trainer)).parameters
    for key in ("weight_noise_cfg", "profile_steps"):
        assert list(ours[key].default) == list(theirs[key].default), key
    for key in ("weight_noise_std", "tensorboard", "profile"):
        assert ours[key].default == theirs[key].default, key


def test_weight_noise_draws_by_statistics(slice_pair, tmp_path):  # noqa
    """The port's own draws: standard normal by their statistics, one of
    each trainable parameter's shape, from the trainer's seeded generator
    (a second trainer of the same seed draws the same)."""
    _, _, task, _ = slice_pair
    trainers = [aps_trainer("dp")(copy.deepcopy(task), device="cpu",
                                  checkpoint=tmp_path / str(i),
                                  weight_noise_std=NOISE_STD, seed=5)
                for i in range(2)]
    first, second = (t.draw_weight_noise() for t in trainers)
    assert [d.shape for d in first] == [p.shape for p in trainers[0].params]
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    flat = torch.cat([d.reshape(-1) for d in first])
    assert flat.numel() > 10000
    # the mean and standard deviation of n standard normal draws lie
    # within 5 / sqrt(n) and 5 / sqrt(2n) of 0 and 1
    n = flat.numel()
    assert abs(flat.mean().item()) < 5 / n**0.5
    assert abs(flat.std().item() - 1) < 5 / (2 * n)**0.5


class _Batches:
    """A loader of `count` batches a pass."""

    def __init__(self, count):
        self.count = count

    def set_epoch(self, epoch):
        pass

    def __iter__(self):
        return iter([{}] * self.count)


@pytest.mark.parametrize("steps,window", [((1, 3), "1-3"),
                                          ((3, 100), "3-5")])
def test_profile_traces_the_steps_window(tmp_path, steps, window):
    """profile: the steps [beg, end) are traced into one Chrome trace,
    trace.<beg>-<end>.json (a window still open when training ends is
    written then), with aps_tpu's two log lines; the trace holds the
    steps' host events."""
    prof = tmp_path / "prof"
    trainer = _scripted_trainer(tmp_path / "cpt", [1.0, 1.0],
                                profile=str(prof),
                                profile_steps=list(steps))
    trainer.run(_Batches(5), _OneBatch(), num_epochs=1)
    assert trainer._profiler is None
    traces = sorted(p.name for p in prof.iterdir())
    assert traces == [f"trace.{window}.json"]
    events = json.loads((prof / traces[0]).read_text())["traceEvents"]
    assert len(events) > 0
    log = (tmp_path / "cpt" / "trainer.log").read_text()
    assert f"Profiler: tracing steps [{steps[0]}, {steps[1]}) into " \
        f"{prof}" in log
    assert f"Profiler: trace saved to {prof}" in log


class _Writer:
    """SummaryWriter stand-in that records add_scalar's arguments."""
    made = []

    def __init__(self, logdir):
        self.logdir = str(logdir)
        self.scalars = []
        _Writer.made.append(self)

    def add_scalar(self, tag, value, step):
        self.scalars.append((tag, float(value), step))

    def flush(self):
        self.scalars.append("flush")


def test_tensorboard_scalars_match_aps_tpu(tmp_path, monkeypatch):
    """tensorboard: true hands the reports' scalars (<mode>/<metric>, the
    epoch) to a SummaryWriter of the checkpoint directory, as aps_tpu's
    reporter does on the same statistics."""
    from aps_tpu.trainer.base import ProgressReporter as JaxReporter
    from aps_tpu_torch.trainer.base import ProgressReporter
    fake = types.ModuleType("torch.utils.tensorboard")
    fake.SummaryWriter = _Writer
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", fake)
    _Writer.made.clear()
    reporters = [cls(tmp_path / name, ["loss", "accu"], tensorboard=True)
                 for name, cls in (("port", ProgressReporter),
                                   ("jax", JaxReporter))]
    for rep in reporters:
        for epoch, mode in ((1, "train"), (1, "valid"), (2, "train")):
            rep.train() if mode == "train" else rep.eval()
            for i in range(3):
                rep.update({"loss": 2.0 - 0.1 * i - epoch,
                            "accu": 0.5 + 0.1 * i})
            rep.report(epoch, 1e-3)
    port, jax_writer = _Writer.made
    assert port.logdir == str(tmp_path / "port")
    # the port flushes after each report's scalars
    scalars = [s for s in port.scalars if s != "flush"]
    assert port.scalars.count("flush") == 3
    assert scalars == jax_writer.scalars and len(scalars) == 6
    assert scalars[0][0] == "train/loss"


def test_tensorboard_absent_warns_and_trains(tmp_path, monkeypatch):
    """Where torch.utils.tensorboard does not import, the trainer warns as
    aps_tpu does, writes no scalars and trains."""
    real = builtins.__import__

    def no_tensorboard(name, *args, **kwargs):
        if name == "torch.utils.tensorboard":
            raise ImportError("No module named 'tensorboard'")
        return real(name, *args, **kwargs)

    monkeypatch.delitem(sys.modules, "torch.utils.tensorboard",
                        raising=False)
    monkeypatch.setattr(builtins, "__import__", no_tensorboard)
    with pytest.warns(UserWarning, match="tensorboard not installed"):
        trainer = _scripted_trainer(tmp_path, [1.0, 1.0], tensorboard=True)
    assert trainer.reporter.board_writer is None
    trainer.run(_Batches(2), _OneBatch(), num_epochs=1)
    assert trainer.cur_epoch == 1
