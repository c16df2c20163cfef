#!/usr/bin/env python
"""Learning-rate schedulers (the port's own copy of aps_tpu/trainer/lr.py,
plain Python): the trainer multiplies the optimizer's unit-rate update by
get_lr(). Same registry names; schedulers are objects with step()/get_lr()/
state_dict()."""

import math
from typing import Dict, List, Optional

from aps_tpu_torch.libs import Register

LrScheduler = Register("lr_scheduler")


class SchedulerBase(object):
    """lr(step) scheduler; step() is called per-epoch or per-step according
    to the trainer's lr_scheduler_period."""

    def __init__(self, lr: float = 1e-3):
        self.lr = lr
        self.step_count = 0

    def get_lr(self) -> float:
        return self.lr

    def step(self, value: Optional[float] = None) -> None:
        self.step_count += 1

    def state_dict(self) -> Dict:
        return dict(self.__dict__)

    def load_state_dict(self, state: Dict) -> None:
        self.__dict__.update(state)


@LrScheduler.register("reduce_lr")
class ReduceLROnPlateau(SchedulerBase):
    """Multiply lr by factor after `patience` epochs without improvement."""

    def __init__(self,
                 lr: float = 1e-3,
                 mode: str = "min",
                 factor: float = 0.5,
                 patience: int = 5,
                 threshold: float = 1e-3,
                 threshold_mode: str = "abs",
                 min_lr: float = 1e-8):
        super(ReduceLROnPlateau, self).__init__(lr)
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.threshold_mode = threshold_mode
        self.min_lr = min_lr
        self.best = math.inf if mode == "min" else -math.inf
        self.num_bad = 0

    def step(self, value: Optional[float] = None) -> None:
        self.step_count += 1
        if value is None:
            return
        if self.threshold_mode == "abs":
            better = (value < self.best - self.threshold if self.mode == "min"
                      else value > self.best + self.threshold)
        else:
            delta = abs(self.best) * self.threshold
            better = (value < self.best - delta if self.mode == "min"
                      else value > self.best + delta)
        if better:
            self.best = value
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.num_bad = 0


@LrScheduler.register("step_lr")
class StepLR(SchedulerBase):

    def __init__(self, lr: float = 1e-3, step_size: int = 10,
                 gamma: float = 0.1):
        super(StepLR, self).__init__(lr)
        self.init_lr = lr
        self.step_size = step_size
        self.gamma = gamma

    def step(self, value: Optional[float] = None) -> None:
        self.step_count += 1
        self.lr = self.init_lr * self.gamma**(
            self.step_count // self.step_size)


@LrScheduler.register("multi_step_lr")
class MultiStepLR(SchedulerBase):

    def __init__(self, lr: float = 1e-3, milestones: List[int] = [10, 20],
                 gamma: float = 0.1):
        super(MultiStepLR, self).__init__(lr)
        self.init_lr = lr
        self.milestones = sorted(milestones)
        self.gamma = gamma

    def step(self, value: Optional[float] = None) -> None:
        self.step_count += 1
        n = sum(1 for m in self.milestones if self.step_count >= m)
        self.lr = self.init_lr * self.gamma**n


@LrScheduler.register("warmup_noam_lr")
class NoamLR(SchedulerBase):
    """Transformer Noam schedule: peak_lr = factor * (att_dim*warmup)^-0.5."""

    def __init__(self,
                 lr: float = 1e-3,
                 factor: float = 1,
                 att_dim: int = 512,
                 peak_lr: float = -1,
                 warmup: int = 8000):
        super(NoamLR, self).__init__(lr)
        self.warmup = warmup
        self.scaler = factor * att_dim**(-0.5) if peak_lr <= 0 else \
            peak_lr * warmup**0.5
        self.step()

    def step(self, value: Optional[float] = None) -> None:
        self.step_count += 1
        s = self.step_count
        self.lr = self.scaler * min(s**(-0.5), s * self.warmup**(-1.5))


class WarmupDecayLRBase(SchedulerBase):
    """warmup -> holdon -> decay -> floor (timestamps in steps)."""

    def __init__(self,
                 lr: float = 1e-3,
                 time_stamps: List[int] = [1000, 4000, 16000],
                 peak_lr: float = 1e-3,
                 stop_lr: float = 1e-8):
        super(WarmupDecayLRBase, self).__init__(lr)
        self.peak_lr, self.stop_lr = peak_lr, stop_lr
        self.warmup, self.holdon, self.max_steps = time_stamps
        self.step()

    def step(self, value: Optional[float] = None) -> None:
        self.step_count += 1
        s = self.step_count
        if s <= self.holdon:
            self.lr = min(self.warmup, s) * self.peak_lr / self.warmup
        elif s >= self.max_steps:
            self.lr = self.stop_lr
        else:
            self.lr = self._decay_lr(s)

    def _decay_lr(self, step: int) -> float:
        raise NotImplementedError


@LrScheduler.register("warmup_exp_decay_lr")
class ExponentialDecayLR(WarmupDecayLRBase):

    def _decay_lr(self, step: int) -> float:
        gamma = math.log(self.stop_lr / self.peak_lr) / (self.max_steps -
                                                         self.holdon)
        return self.peak_lr * math.exp(gamma * (step - self.holdon))


@LrScheduler.register("warmup_linear_decay_lr")
class LinearDecayLR(WarmupDecayLRBase):

    def _decay_lr(self, step: int) -> float:
        gamma = (self.stop_lr - self.peak_lr) / (self.max_steps - self.holdon)
        return self.peak_lr + gamma * (step - self.holdon)


@LrScheduler.register("warmup_cos_decay_lr")
class CosineDecayLR(WarmupDecayLRBase):

    def _decay_lr(self, step: int) -> float:
        gamma = math.pi / (self.max_steps - self.holdon)
        return (self.peak_lr - self.stop_lr) * (
            1 + math.cos(gamma * (step - self.holdon))) / 2 + self.stop_lr


@LrScheduler.register("warmup_power_decay_lr")
class PowerDecayLR(WarmupDecayLRBase):

    def __init__(self,
                 lr: float = 1e-3,
                 time_stamps: List[int] = [1000, 4000, 16000],
                 power: float = 2,
                 peak_lr: float = 1e-3,
                 stop_lr: float = 1e-8):
        self.power = power
        super(PowerDecayLR, self).__init__(lr, time_stamps=time_stamps,
                                           peak_lr=peak_lr, stop_lr=stop_lr)

    def _decay_lr(self, step: int) -> float:
        gamma = 1 / (self.max_steps - self.holdon)
        return (self.peak_lr - self.stop_lr) * (
            (self.max_steps - step) * gamma)**self.power + self.stop_lr
