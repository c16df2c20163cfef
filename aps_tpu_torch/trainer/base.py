#!/usr/bin/env python
"""Trainer base: progress reporting, scheduling, checkpointing and the
epoch/step loops (port of aps_tpu/trainer/base.py: ProgressReporter,
ErrorDetector, StopDetector, Trainer). The step itself lives in
aps_tpu_torch/trainer/dp.py.

Checkpoints keep aps_tpu's layout: a pickled dict of numpy trees with the
task's parameters under "params" ({"nnet": ...}) and the other collections
under "mstate" ({"batch_stats": {"nnet": ...}}), beside "epoch", "step"
"lr_scheduler_state" and "stop_state" (the early-stopping state);
train.yaml beside them rebuilds the model. So
aps_tpu_torch.cmd.decode_batch and aps_tpu's own load_checkpoint both read
them. The optimizer's state goes under "torch_opt_state" (its layout is
PyTorch's, not optax's). With save_interval N (1 when average_checkpoint
asks for more than one), every N-th epoch also goes to epoch.N.ckpt, which
aps_tpu_torch.cmd.average_checkpoint averages.

matmul_precision takes aps_tpu's five values. On a CUDA device the
training and validation steps run under cuBLAS's and cuDNN's TF32 flags
set from it ("bfloat16", "tensorfloat32" and "default": TF32; "float32"
and "highest": full float32), and the flags are restored after each step.
aps_tpu scopes its steps with jax.default_matmul_precision, which XLA runs
on an NVIDIA GPU as TF32 products with float32 in and out for everything
below "highest"; PyTorch has no float32 product with bfloat16 operands, and
autocast would change the types the model sees. On the CPU the value has
no effect (JAX's CPU backend ignores it too). The hand-written kernels do
not read it.

The trainer owns a torch.Generator on its device, seeded from `seed`, and
hands it to every module of the task with a `generator` attribute (the
feature transform's speed perturbation and SpecAugment draw from it, and
the RNN decoder its schedule-sampling coins).

Schedule sampling (ss_scheduler with ss_scheduler_kwargs, the schedulers
of aps_tpu_torch/trainer/ss.py) as in aps_tpu: the rate ssr starts at 0,
after each validation it becomes the scheduler's step(epoch, accu) (accu
in percent, as the reporter gives it), and the training steps hand it to
the task as egs["#ssr"]. It is not kept in a checkpoint, so a resumed run
trains at 0 until its first validation, as aps_tpu's does.

Weight noise (weight_noise_std, on the steps weight_noise_cfg = [beg,
step, end] picks: every step-th step from beg, up to end unless it is -1)
is added to the parameters by the dp trainer's step. profile names a
directory: torch.profiler traces the training steps [profile_steps[0],
profile_steps[1]) (the CPU and, on a card, its kernels) and writes one
Chrome trace a window, trace.<beg>-<end>.json, logging the two lines
aps_tpu logs; a window still open when training ends is closed and
written then. tensorboard: true writes the reports' scalars
(<mode>/<metric> by epoch, as aps_tpu) through
torch.utils.tensorboard.SummaryWriter into the checkpoint directory, and
warns and goes on without it where that does not import.

Data parallelism, one process a device (aps_tpu_torch.distributed): the
chief (rank 0) alone writes the checkpoints (and start_trainer's
train.yaml); in a run of more than one process each rank logs to
trainer.rank.<rank>.log, as aps_tpu, and trainer.log otherwise. Under a
process group the generator above stays the same on every rank (the
weight noise draws from it), while the modules' generator (speed
perturbation, SpecAugment, schedule-sampling coins) and torch's global one
(the dropouts) are seeded with seed + 1 + the rank's data index, so the
rows of each data index get draws of their own and the model ranks of one
data index, which compute the same rows, draw alike.

tensor_parallel (aps_tpu's "model" mesh axis): the world is data x model
ranks, tensor_parallel model ranks a data index
(distributed.init_model_parallel; a world that it does not divide raises
a ValueError). The dp trainer swaps the large weights for column-parallel
slices (aps_tpu_torch/parallel/tp.py) and splits the batch over the data
axis only. sequence_parallel (with tensor_parallel above 1 only, as in
aps_tpu): the model ranks of a data index split the frames of the
frame-local front end (the STFT and K1) of every transform that has one
(`seq_split`) and gather them; a model without one computes the whole
input on every rank, which the trainer logs once. Neither changes a
result, as in aps_tpu.

The step is the subclass's: dispatch_step runs one and returns the results
(True, or False for a skipped step) of the steps finished by then, in
order, each of which the error breaker sees once; drain() returns those
still outstanding, and the loops call it before a report, a validation
or a checkpoint. A subclass that reads each step's result at once
(pipeline depth 1) returns it from dispatch_step."""

import math
import pickle
import warnings
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from aps_tpu_torch import distributed
from aps_tpu_torch.parallel import SeqSplit
from aps_tpu_torch.trainer.lr import LrScheduler
from aps_tpu_torch.trainer.ss import SsScheduler
from aps_tpu_torch.utils import (TF32_PRECISIONS, SimpleTimer, get_logger,
                                 matmul_precision)


class ParameterAverager(object):
    """Average trees (nested dicts) of numpy arrays across checkpoints:
    the sum in the leaves' own type, divided by the count at the end."""

    def __init__(self):
        self.count = 0
        self.averaged = None

    def add(self, params: Dict) -> None:
        if self.averaged is None:
            self.averaged = _tree_map(np.copy, params)
        else:
            self.averaged = _tree_map(np.add, self.averaged, params)
        self.count += 1

    def state_dict(self) -> Dict:
        return _tree_map(lambda x: (x / self.count).astype(x.dtype),
                         self.averaged)


def _tree_map(fn, tree, *rest):
    """fn over the leaves of nested dicts of arrays of the same layout."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(np.asarray(tree), *map(np.asarray, rest))


class ProgressReporter(object):
    """Track training stats with weighted reduction (#utt/#tok/none).
    Values may be device scalars; they are read at logging time only."""

    def __init__(self,
                 checkpoint: Path,
                 metrics: List[str],
                 period: int = 100,
                 tensorboard: bool = False,
                 reduction_tag: str = "none",
                 rank: Optional[int] = None) -> None:
        self.period = period
        self.reduction_tag = reduction_tag
        checkpoint.mkdir(parents=True, exist_ok=True)
        name = "trainer.log" if rank is None else f"trainer.rank.{rank}.log"
        self.logger = get_logger((checkpoint / name).as_posix(), file=True)
        self.header = "Trainer"
        self.board_writer = None
        if tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self.board_writer = SummaryWriter(checkpoint)
            except ImportError:
                warnings.warn("tensorboard not installed, disabling it...")
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
        if self.board_writer:
            for name, value in reports.items():
                self.board_writer.add_scalar(f"{self.mode}/{name}", value,
                                             epoch)
            self.board_writer.flush()
        cost = self.timer.elapsed()
        header = "/".join(self.metrics)
        values = "/".join(f"{reports[m]:.4f}" for m in self.metrics)
        logstr = (f"Epoch {epoch:02d}/{self.mode}: {header}(time/#batch, "
                  f"lr={lr:.3e}) = {values}({cost:.2f}m/{N:d})")
        return reports, logstr


class StopDetector(object):
    """Early stopping: stop once the tracked dev metric has gone `no_impr`
    evaluations without beating the best so far by more than
    `no_impr_thres`. It tracks `sign * value`, so that "min" (losses) and
    "max" (accuracies) share one comparison; its state_dict is aps_tpu's."""

    def __init__(self,
                 no_impr: int,
                 mode: str = "min",
                 no_impr_thres: float = 2e-3) -> None:
        if mode not in ("min", "max"):
            raise ValueError(f"StopDetector: unknown mode {mode}")
        self.max_no_impr = no_impr
        self.no_impr = 0
        self.no_impr_thres = no_impr_thres
        self.sign = 1.0 if mode == "min" else -1.0
        self.best_criterion = self.sign * math.inf

    def reset(self, update_value: float) -> None:
        self.best_criterion = self.sign * update_value

    def stop(self) -> bool:
        return self.no_impr >= self.max_no_impr

    @property
    def best(self) -> float:
        return self.sign * self.best_criterion

    def state_dict(self) -> Dict:
        return dict(self.__dict__)

    def load_state_dict(self, state_dict: Dict) -> None:
        state_dict = dict(state_dict)
        if "mode" in state_dict:
            # older checkpoints keep the mode and an unsigned best
            sign = 1.0 if state_dict.pop("mode") == "min" else -1.0
            state_dict["sign"] = sign
            if "best_criterion" in state_dict:
                state_dict["best_criterion"] = \
                    sign * state_dict["best_criterion"]
        self.__dict__.update(state_dict)

    def step(self, update_value: float) -> bool:
        """True when update_value is a new best."""
        signed = self.sign * update_value
        if signed + self.no_impr_thres < self.best_criterion:
            self.best_criterion = signed
            self.no_impr = 0
            return True
        self.no_impr += 1
        return False


class ErrorDetector(object):
    """Circuit breaker for the train loop: trips once `stop_on_errors`
    consecutive steps fail (a success closes the breaker again)."""

    def __init__(self, stop_on_errors: int) -> None:
        self.stop_on_errors = stop_on_errors
        self.counter = 0

    def step(self, succ: bool) -> bool:
        self.counter = 0 if succ else self.counter + 1
        return self.counter >= self.stop_on_errors


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
                 ss_scheduler: str = "const",
                 ss_scheduler_kwargs: Optional[Dict] = None,
                 clip_gradient: Optional[float] = None,
                 acmu_gradient: int = 1,
                 prog_interval: int = 100,
                 save_interval: int = -1,
                 resume: str = "",
                 init: str = "",
                 stop_criterion: str = "loss",
                 no_impr: int = 6,
                 no_impr_thres: float = 1e-3,
                 average_checkpoint: int = 0,
                 report_metrics: List[str] = ["loss"],
                 reduction_tag: str = "none",
                 stop_on_errors: int = 32,
                 seed: int = 777,
                 matmul_precision: str = "float32",
                 weight_noise_std: Optional[float] = None,
                 weight_noise_cfg: Sequence[int] = (0, 1, -1),
                 tensorboard: bool = False,
                 profile: str = "",
                 profile_steps: Sequence[int] = (10, 15),
                 tensor_parallel: int = 1,
                 sequence_parallel: bool = False,
                 **kwargs) -> None:
        for key in kwargs:
            raise ValueError(f"Unknown trainer option: {key}")
        if lr_scheduler_period not in ["epoch", "step"]:
            raise ValueError(
                f"Unsupported lr_scheduler_period: {lr_scheduler_period}")
        if stop_criterion not in report_metrics:
            raise ValueError("stop_criterion not in report_metrics: "
                             f"{stop_criterion}")
        if matmul_precision not in TF32_PRECISIONS:
            raise ValueError(
                f"Unsupported matmul_precision: {matmul_precision}")
        self.matmul_precision = matmul_precision
        self.device = torch.device(device)
        self.task = task.to(self.device)
        self.checkpoint = Path(checkpoint)
        self.data_parallel = distributed.initialized()
        self.rank = distributed.rank()
        self.world = distributed.world_size()
        self.is_chief = self.rank == 0
        # the model axis: tp model ranks a data index
        self.tp = int(tensor_parallel)
        distributed.init_model_parallel(self.tp)
        self.data_index = distributed.data_index()
        self.model_index = distributed.model_index()
        self.data_size = distributed.data_parallel_size()
        self.sequence_parallel = bool(sequence_parallel) and self.tp > 1
        last_checkpoint = self.checkpoint / "last.ckpt"
        if last_checkpoint.exists():
            resume = last_checkpoint.as_posix()  # auto-resume
        self.reporter = ProgressReporter(
            self.checkpoint, report_metrics, period=prog_interval,
            tensorboard=tensorboard and self.is_chief,
            reduction_tag=reduction_tag,
            rank=self.rank if self.world > 1 else None)
        self.weight_noise_std = weight_noise_std
        self.weight_noise_cfg = tuple(weight_noise_cfg)
        # trace the training steps [profile_steps) into `profile`
        self.profile_dir = profile
        self.profile_steps = tuple(profile_steps)
        self._profiler, self._profile_beg = None, 0
        self.clip_gradient = clip_gradient
        self.acmu_gradient = acmu_gradient
        self.cur_epoch = 0
        self.cur_step = 0
        self.ssr = 0
        self.save_interval = 1 if average_checkpoint > 1 else save_interval
        self.seed = int(seed)
        self.generator = torch.Generator(device=self.device)
        if self.seed >= 0:
            self.generator.manual_seed(self.seed)
        else:
            self.generator.seed()
        draws = self.generator
        if self.data_parallel:
            draws = torch.Generator(device=self.device)
            if self.seed >= 0:
                draws.manual_seed(self.seed + 1 + self.data_index)
                torch.manual_seed(self.seed + 1 + self.data_index)
            else:
                draws.seed()
        for module in self.task.modules():
            if hasattr(module, "generator"):
                module.generator = draws
        if self.sequence_parallel:
            split = SeqSplit(self.model_index, self.tp,
                             distributed.model_group())
            fronts = [m for m in self.task.modules()
                      if hasattr(m, "seq_split")]
            for module in fronts:
                module.seq_split = split
            if not fronts:
                self.reporter.log(
                    "Sequence parallel: the model has no frame-local front "
                    "end, so every model rank computes the whole input")
        mode = "max" if stop_criterion == "accu" else "min"
        self.stop_on = stop_criterion
        self.stop_detector = StopDetector(no_impr, mode=mode,
                                          no_impr_thres=no_impr_thres)
        self.detector = ErrorDetector(stop_on_errors)
        self.optimizer_name = optimizer
        self.optimizer_kwargs = dict(optimizer_kwargs or {})

        lr0 = self.optimizer_kwargs.get("lr", 1e-3)
        lr_kwargs = dict(lr_scheduler_kwargs or {})
        lr_kwargs.pop("state", None)
        if lr_scheduler == "reduce_lr":
            lr_scheduler_period = "epoch"
            lr_kwargs.update({
                "mode": mode,
                "threshold_mode": "abs",
                "threshold": no_impr_thres
            })
        if lr_scheduler not in LrScheduler:
            raise ValueError(f"Unsupported lr scheduler: {lr_scheduler}")
        self.lr_scheduler = LrScheduler[lr_scheduler](lr=lr0, **lr_kwargs)
        self.lr_scheduler_period = lr_scheduler_period

        self.ss_scheduler = None
        if ss_scheduler_kwargs:
            if ss_scheduler not in SsScheduler:
                raise ValueError(f"Unsupported ss scheduler: {ss_scheduler}")
            if "accu" not in report_metrics:
                raise ValueError("schedule sampling requires tracking accu")
            self.ss_scheduler = SsScheduler[ss_scheduler](
                **ss_scheduler_kwargs)
            self.reporter.log(f"Using schedule sampling: {ss_scheduler}")

        # the checkpoint to resume or warm start from (applied by the
        # subclass): "resume" restores everything, "init" the weights only
        self.cpt_stats = None
        self.init_mode = ""
        if resume:
            self.cpt_stats = self.load_checkpoint_file(resume)
            self.init_mode = "resume"
            self.cur_epoch = self.cpt_stats["epoch"]
            self.cur_step = self.cpt_stats.get("step", 0)
            if "lr_scheduler_state" in self.cpt_stats:
                self.lr_scheduler.load_state_dict(
                    self.cpt_stats["lr_scheduler_state"])
            if "stop_state" in self.cpt_stats:
                self.stop_detector.load_state_dict(
                    self.cpt_stats["stop_state"])
            self.reporter.log(
                f"Resume from checkpoint {resume}: epoch {self.cur_epoch}")
        elif init:
            self.cpt_stats = self.load_checkpoint_file(init)
            self.init_mode = "init"
            self.reporter.log(f"Initialize model from checkpoint {init}")
        if clip_gradient:
            self.reporter.log(
                f"Clip gradient if over {clip_gradient} L2 norm")
        if acmu_gradient > 1:
            self.reporter.log(
                f"Accumulate gradient per {acmu_gradient} batches")

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
            "lr_scheduler_state": self.lr_scheduler.state_dict(),
            "stop_state": self.stop_detector.state_dict(),
        }

    def save_checkpoint(self, epoch: int, best: bool = True) -> None:
        # the chief, with its model group under tensor parallelism, which
        # gathers the sharded weights for it
        if self.data_index != 0:
            return
        states = self.checkpoint_states(epoch)
        if not self.is_chief:
            return
        blob = pickle.dumps(states)
        (self.checkpoint / "last.ckpt").write_bytes(blob)
        if best:
            (self.checkpoint / "best.ckpt").write_bytes(blob)
            self.reporter.log(f"Save the best checkpoint: epoch {epoch}")
        if self.save_interval > 0 and epoch % self.save_interval == 0:
            (self.checkpoint / f"epoch.{epoch}.ckpt").write_bytes(blob)

    # ------------------------------------------------------------------
    # hooks of the subclass
    # ------------------------------------------------------------------
    def train_one_step(self, egs: Dict) -> bool:
        """One optimizer step; False when the step was skipped."""
        raise NotImplementedError

    def dispatch_step(self, egs: Dict) -> List[bool]:
        """One step; the results of the steps finished by now, in order."""
        return [self.train_one_step(egs)]

    def drain(self) -> List[bool]:
        """The results of the steps still outstanding, in order."""
        return []

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

    def weight_noise_now(self) -> bool:
        """Whether this step adds weight noise (aps_tpu's schedule,
        weight_noise_cfg = [beg, step, end]: every step-th step from beg,
        up to end unless it is -1 or below)."""
        if not self.weight_noise_std:
            return False
        beg, step, end = self.weight_noise_cfg
        if self.cur_step < beg or (end > 0 and self.cur_step > end):
            return False
        return (self.cur_step - beg) % max(step, 1) == 0

    def _profile_tick(self) -> None:
        """Start the profiler at step profile_steps[0], stop it (and write
        the window's trace) once profile_steps[1] is reached."""
        if not self.profile_dir:
            return
        beg, end = self.profile_steps
        if self._profiler is None and self.cur_step == beg:
            from torch.profiler import ProfilerActivity, profile
            activities = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            self._profiler = profile(activities=activities)
            self._profiler.start()
            self._profile_beg = self.cur_step
            self.reporter.log(f"Profiler: tracing steps [{beg}, {end}) "
                              f"into {self.profile_dir}")
        elif self._profiler is not None and self.cur_step >= end:
            self._stop_profile()

    def _stop_profile(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._profiler.stop()
        out = Path(self.profile_dir)
        out.mkdir(parents=True, exist_ok=True)
        self._profiler.export_chrome_trace(
            (out / f"trace.{self._profile_beg}-{self.cur_step}.json"
             ).as_posix())
        self._profiler = None
        self.reporter.log(f"Profiler: trace saved to {self.profile_dir}")

    def _train_step(self, egs: Dict) -> None:
        self._profile_tick()
        for succ in self.dispatch_step(egs):
            self._breaker(succ)
        self.cur_step += 1
        if self.lr_scheduler_period == "step":
            self.lr_scheduler.step()

    def _drain(self) -> None:
        for succ in self.drain():
            self._breaker(succ)

    def _eval_and_schedule(self, dev_loader) -> bool:
        self._drain()
        self.valid_epoch(dev_loader)
        lr = self.lr_scheduler.get_lr()
        reports, logstr = self.reporter.report(self.cur_epoch, lr)
        value = reports[self.stop_on]
        better = self.stop_detector.step(value)
        if self.lr_scheduler_period == "epoch":
            self.lr_scheduler.step(value)
        if self.ss_scheduler is not None:
            self.ssr = self.ss_scheduler.step(self.cur_epoch,
                                              reports.get("accu", 0))
        logstr += " | best" if better else \
            f" | no impr {self.stop_detector.no_impr:d}, " \
            f"best = {self.stop_detector.best:.4f}"
        self.reporter.log(logstr)
        self.save_checkpoint(self.cur_epoch, best=better)
        return better

    def run(self, trn_loader, dev_loader, num_epochs: int = 50,
            eval_interval: int = -1) -> None:
        """Validate once, then train up to num_epochs epochs, validating
        (and saving a checkpoint) after each, or every eval_interval steps
        when that is above 0; stop early once the stop criterion has not
        improved for no_impr validations."""
        timer = SimpleTimer()
        self.valid_epoch(dev_loader)
        reports, logstr = self.reporter.report(self.cur_epoch, 0)
        self.reporter.log(logstr)
        if self.init_mode != "resume":
            self.stop_detector.reset(reports[self.stop_on])
        if eval_interval > 0:
            self._run_in_batch(trn_loader, dev_loader, num_epochs,
                               eval_interval)
        else:
            self._run_in_epoch(trn_loader, dev_loader, num_epochs)
        self._drain()
        if self._profiler is not None:
            self._stop_profile()
        self.reporter.log(
            f"Training for {self.cur_epoch:d}/{num_epochs:d} epochs done "
            f"(best = {self.stop_detector.best:.4f}, "
            f"{timer.elapsed():.2f}m)")

    def _run_in_epoch(self, trn_loader, dev_loader, num_epochs: int) -> None:
        while self.cur_epoch < num_epochs:
            trn_loader.set_epoch(self.cur_epoch)
            self.cur_epoch += 1
            self.reporter.train()
            for egs in trn_loader:
                self._train_step(egs)
            self._drain()
            _, logstr = self.reporter.report(self.cur_epoch,
                                             self.lr_scheduler.get_lr())
            self.reporter.log(logstr)
            self._eval_and_schedule(dev_loader)
            if self.stop_detector.stop():
                self.reporter.log("Stop training cause no impr for "
                                  f"{self.stop_detector.no_impr:d} epochs")
                break

    def _run_in_batch(self, trn_loader, dev_loader, num_epochs: int,
                      eval_interval: int) -> None:
        """For large corpora: validate every eval_interval steps (the
        checkpoints keep the number of the epoch under way)."""
        stop = False
        while not stop and self.cur_epoch < num_epochs:
            trn_loader.set_epoch(self.cur_epoch)
            self.cur_epoch += 1
            self.reporter.train()
            for egs in trn_loader:
                self._train_step(egs)
                if self.cur_step % eval_interval == 0:
                    self._drain()
                    _, logstr = self.reporter.report(
                        self.cur_epoch, self.lr_scheduler.get_lr())
                    self.reporter.log(logstr)
                    self._eval_and_schedule(dev_loader)
                    if self.stop_detector.stop():
                        stop = True
                        break
                    self.reporter.train()
