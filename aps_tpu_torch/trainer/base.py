#!/usr/bin/env python
"""Trainer base: progress reporting, scheduling, checkpointing and the
epoch/step loops (port of aps_tpu/trainer/base.py: ProgressReporter,
ErrorDetector, Trainer). The step itself lives in
aps_tpu_torch/trainer/dp.py.

Checkpoints keep aps_tpu's layout: a pickled dict of numpy trees with the
task's parameters under "params" ({"nnet": ...}) and the other collections
under "mstate" ({"batch_stats": {"nnet": ...}}), beside "epoch", "step"
and "lr_scheduler_state"; train.yaml beside them rebuilds the model. So
aps_tpu_torch.cmd.decode_batch and aps_tpu's own load_checkpoint both read
them. The optimizer's state goes under "torch_opt_state" (its layout is
PyTorch's, not optax's).

Not ported yet, and refused when asked for: schedule sampling, gradient
accumulation, weight noise, checkpoint averaging, tensorboard, profiling,
another matmul precision than float32, tensor/sequence parallelism, a
pipeline depth, warm starts from another checkpoint (init), checkpoints
every N epochs and validation every N steps. Early stopping is not ported
either: no_impr is accepted, since aps_tpu sets it by default, and
trainer.log says that training runs all its epochs."""

import math
import pickle
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional, Union

import torch

from aps_tpu_torch.trainer.lr import LrScheduler
from aps_tpu_torch.utils import SimpleTimer, get_logger


class ProgressReporter(object):
    """Track training stats with weighted reduction (#utt/#tok/none).
    Values may be device scalars; they are read at logging time only."""

    def __init__(self,
                 checkpoint: Path,
                 metrics: List[str],
                 period: int = 100,
                 reduction_tag: str = "none") -> None:
        self.period = period
        self.reduction_tag = reduction_tag
        checkpoint.mkdir(parents=True, exist_ok=True)
        self.logger = get_logger((checkpoint / "trainer.log").as_posix(),
                                 file=True)
        self.header = "Trainer"
        self.metrics = metrics
        self.mode = "train"
        self.reset()

    def log(self, sstr: str) -> None:
        self.logger.info(f"{self.header} - {sstr}")

    def eval(self) -> None:
        self.log(">> Set eval mode ...")
        self.mode = "valid"
        self.reset()

    def train(self) -> None:
        self.log(">> Set train mode ...")
        self.mode = "train"
        self.reset()

    def reset(self) -> None:
        self.stats = defaultdict(list)
        self.timer = SimpleTimer()

    def update(self, dict_obj: Optional[Dict]) -> None:
        for key, value in (dict_obj or {}).items():
            self.add(key, value)

    def add(self, key: str, value) -> None:
        self.stats[key].append(value)
        N = len(self.stats[key])
        if not N % self.period:
            if key == "rate":
                cur = float(self.stats[key][-1])
                self.log(f"Processed {N:.2e} batches ({key} = {cur:.3e}) ...")
            elif key[0] == "#":
                cur = int(
                    sum(float(v) for v in self.stats[key][-self.period:]) //
                    self.period)
                self.log(f"Processed {N:.2e} batches ({key} = {cur:d}) ...")
            else:
                avg = self._report_metric(key, period=self.period)
                self.log(f"Processed {N:.2e} batches ({key} = {avg:+.2f}) ...")

    def _values(self, key: str, period: int = 0) -> List[float]:
        vals = [float(v) for v in self.stats[key][-period:]]
        return [v if math.isfinite(v) else 0.0 for v in vals]

    def _report_metric(self, key: str, period: int = 0) -> float:
        nors = self._values(key, period)
        if self.reduction_tag in self.stats:
            dens = self._values(self.reduction_tag, period)
            avg = sum(n * d for n, d in zip(nors, dens)) / sum(dens)
        else:
            avg = sum(nors) / len(nors)
        if key == "accu":
            avg *= 100
        if key == "@ppl":
            avg = math.exp(avg)
        return avg

    def report(self, epoch: int, lr: float):
        N = len(self.stats["loss"])
        if self.mode == "valid":
            sstr = ",".join(f"{v:.2f}" for v in self._values("loss"))
            self.log(f"Loss on {N:d} batches: {sstr}")
        if N == 0:
            raise RuntimeError("No statistics to report")
        reports = {m: self._report_metric(m) for m in self.metrics}
        cost = self.timer.elapsed()
        header = "/".join(self.metrics)
        values = "/".join(f"{reports[m]:.4f}" for m in self.metrics)
        logstr = (f"Epoch {epoch:02d}/{self.mode}: {header}(time/#batch, "
                  f"lr={lr:.3e}) = {values}({cost:.2f}m/{N:d})")
        return reports, logstr


class ErrorDetector(object):
    """Circuit breaker for the train loop: trips once `stop_on_errors`
    consecutive steps fail (a success closes the breaker again)."""

    def __init__(self, stop_on_errors: int) -> None:
        self.stop_on_errors = stop_on_errors
        self.counter = 0

    def step(self, succ: bool) -> bool:
        self.counter = 0 if succ else self.counter + 1
        return self.counter >= self.stop_on_errors


# trainer_conf keys of aps_tpu that the port refuses unless left at the
# value that turns them off
_UNPORTED = {
    "ss_scheduler_kwargs": None,
    "acmu_gradient": 1,
    "weight_noise_std": None,
    "average_checkpoint": 0,
    "tensorboard": False,
    "profile": "",
    "matmul_precision": "float32",
    "tensor_parallel": 1,
    "sequence_parallel": False,
    "pipeline_depth": 1,
}
# accepted without effect: they only tune options refused above
_TUNES_UNPORTED = ("ss_scheduler", "weight_noise_cfg", "profile_steps")


class Trainer(object):
    """Owns the scheduler, reporter, checkpoint IO and the epoch loops; the
    step is the subclass's (train_one_step / valid_one_step)."""

    def __init__(self,
                 task: torch.nn.Module,
                 device: Union[str, torch.device] = "cuda",
                 checkpoint: Union[str, Path] = "cpt",
                 optimizer: str = "adam",
                 optimizer_kwargs: Optional[Dict] = None,
                 lr_scheduler: str = "reduce_lr",
                 lr_scheduler_kwargs: Optional[Dict] = None,
                 lr_scheduler_period: str = "epoch",
                 clip_gradient: Optional[float] = None,
                 prog_interval: int = 100,
                 resume: str = "",
                 stop_criterion: str = "loss",
                 no_impr: int = 0,
                 no_impr_thres: float = 1e-3,
                 report_metrics: List[str] = ["loss"],
                 reduction_tag: str = "none",
                 stop_on_errors: int = 32,
                 seed: int = 777,
                 **kwargs) -> None:
        for key, value in kwargs.items():
            if key in _TUNES_UNPORTED:
                continue
            if key not in _UNPORTED:
                raise ValueError(f"Unknown trainer option: {key}")
            if value != _UNPORTED[key] and value:
                raise NotImplementedError(
                    f"trainer option {key}={value!r} is not ported yet")
        if lr_scheduler_period not in ["epoch", "step"]:
            raise ValueError(
                f"Unsupported lr_scheduler_period: {lr_scheduler_period}")
        if stop_criterion not in report_metrics:
            raise ValueError("stop_criterion not in report_metrics: "
                             f"{stop_criterion}")
        self.device = torch.device(device)
        self.task = task.to(self.device)
        self.checkpoint = Path(checkpoint)
        last_checkpoint = self.checkpoint / "last.ckpt"
        if last_checkpoint.exists():
            resume = last_checkpoint.as_posix()  # auto-resume
        self.reporter = ProgressReporter(self.checkpoint, report_metrics,
                                         period=prog_interval,
                                         reduction_tag=reduction_tag)
        self.clip_gradient = clip_gradient
        self.cur_epoch = 0
        self.cur_step = 0
        self.seed = int(seed)
        self.stop_on = stop_criterion
        self.sign = -1.0 if stop_criterion == "accu" else 1.0
        self.no_impr_thres = no_impr_thres
        self.best = math.inf
        self.detector = ErrorDetector(stop_on_errors)
        self.optimizer_name = optimizer
        self.optimizer_kwargs = dict(optimizer_kwargs or {})

        lr0 = self.optimizer_kwargs.get("lr", 1e-3)
        lr_kwargs = dict(lr_scheduler_kwargs or {})
        lr_kwargs.pop("state", None)
        if lr_scheduler == "reduce_lr":
            lr_scheduler_period = "epoch"
            lr_kwargs.update({
                "mode": "max" if stop_criterion == "accu" else "min",
                "threshold_mode": "abs",
                "threshold": no_impr_thres
            })
        if lr_scheduler not in LrScheduler:
            raise ValueError(f"Unsupported lr scheduler: {lr_scheduler}")
        self.lr_scheduler = LrScheduler[lr_scheduler](lr=lr0, **lr_kwargs)
        self.lr_scheduler_period = lr_scheduler_period

        if no_impr:
            self.reporter.log(
                f"no_impr={no_impr} has no effect: early stopping is not "
                "ported, training runs all its epochs")
        # the checkpoint to resume from (applied by the subclass)
        self.cpt_stats = None
        if resume:
            self.cpt_stats = self.load_checkpoint_file(resume)
            self.cur_epoch = self.cpt_stats["epoch"]
            self.cur_step = self.cpt_stats.get("step", 0)
            self.best = self.cpt_stats.get("best", math.inf)
            if "lr_scheduler_state" in self.cpt_stats:
                self.lr_scheduler.load_state_dict(
                    self.cpt_stats["lr_scheduler_state"])
            self.reporter.log(
                f"Resume from checkpoint {resume}: epoch {self.cur_epoch}")
        if clip_gradient:
            self.reporter.log(
                f"Clip gradient if over {clip_gradient} L2 norm")

    # ------------------------------------------------------------------
    # checkpoint IO
    # ------------------------------------------------------------------
    @staticmethod
    def load_checkpoint_file(path: str) -> Dict:
        from aps_tpu_torch.eval.wrapper import read_checkpoint
        return read_checkpoint(path)

    def checkpoint_states(self, epoch: int) -> Dict:
        """Collect states to store (the subclass adds the weights)."""
        return {
            "epoch": epoch,
            "step": self.cur_step,
            "best": self.best,
            "lr_scheduler_state": self.lr_scheduler.state_dict(),
        }

    def save_checkpoint(self, epoch: int, best: bool = True) -> None:
        blob = pickle.dumps(self.checkpoint_states(epoch))
        (self.checkpoint / "last.ckpt").write_bytes(blob)
        if best:
            (self.checkpoint / "best.ckpt").write_bytes(blob)
            self.reporter.log(f"Save the best checkpoint: epoch {epoch}")

    # ------------------------------------------------------------------
    # hooks of the subclass
    # ------------------------------------------------------------------
    def train_one_step(self, egs: Dict) -> bool:
        """One optimizer step; False when the step was skipped."""
        raise NotImplementedError

    def valid_one_step(self, egs: Dict) -> None:
        raise NotImplementedError

    # ------------------------------------------------------------------
    # epoch loops
    # ------------------------------------------------------------------
    def _breaker(self, succ: bool) -> None:
        if self.detector.step(succ):
            raise RuntimeError(
                f"Stop training: detected {self.detector.counter} "
                "consecutive errors")

    def valid_epoch(self, data_loader) -> None:
        self.reporter.eval()
        for egs in data_loader:
            self.valid_one_step(egs)

    def _train_step(self, egs: Dict) -> None:
        self._breaker(self.train_one_step(egs))
        self.cur_step += 1
        if self.lr_scheduler_period == "step":
            self.lr_scheduler.step()

    def _eval_and_schedule(self, dev_loader) -> bool:
        self.valid_epoch(dev_loader)
        lr = self.lr_scheduler.get_lr()
        reports, logstr = self.reporter.report(self.cur_epoch, lr)
        value = reports[self.stop_on]
        better = self.sign * value + self.no_impr_thres < self.best
        if better:
            self.best = self.sign * value
        if self.lr_scheduler_period == "epoch":
            self.lr_scheduler.step(value)
        logstr += " | best" if better else \
            f" | no impr, best = {self.sign * self.best:.4f}"
        self.reporter.log(logstr)
        self.save_checkpoint(self.cur_epoch, best=better)
        return better

    def run(self, trn_loader, dev_loader, num_epochs: int = 50) -> None:
        """Validate once, then train num_epochs epochs, validating (and
        saving a checkpoint) after each."""
        timer = SimpleTimer()
        self.valid_epoch(dev_loader)
        reports, logstr = self.reporter.report(self.cur_epoch, 0)
        self.reporter.log(logstr)
        if self.cpt_stats is None:
            self.best = self.sign * reports[self.stop_on]
        while self.cur_epoch < num_epochs:
            trn_loader.set_epoch(self.cur_epoch)
            self.cur_epoch += 1
            self.reporter.train()
            for egs in trn_loader:
                self._train_step(egs)
            _, logstr = self.reporter.report(self.cur_epoch,
                                             self.lr_scheduler.get_lr())
            self.reporter.log(logstr)
            self._eval_and_schedule(dev_loader)
        self.reporter.log(
            f"Training for {self.cur_epoch:d}/{num_epochs:d} epochs done "
            f"(best = {self.sign * self.best:.4f}, {timer.elapsed():.2f}m)")
