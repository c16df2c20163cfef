#!/usr/bin/env python
"""Schedule-sampling schedulers (port of aps_tpu/trainer/ss.py: "const",
"epoch", "trigger" and "linear" in SsScheduler). step(epoch, accu) gives
the rate for the epochs after it.

LinearScheduler, as aps_tpu's, returns inv x inc inside its window without
a cap at ssr: with epochs [0, 2] and update_interval 4 it gives 0.4 at
epoch 1 for ssr 0.2."""

from typing import List

from aps_tpu_torch.libs import Register

SsScheduler = Register("ss_scheduler")


class BaseScheduler(object):

    def __init__(self, ssr: float) -> None:
        self.ssr = ssr

    def step(self, epoch: int, accu: float) -> float:
        raise NotImplementedError


@SsScheduler.register("const")
class ConstScheduler(BaseScheduler):

    def __init__(self, ssr: float = 0) -> None:
        super(ConstScheduler, self).__init__(ssr)

    def step(self, epoch: int, accu: float) -> float:
        return self.ssr


@SsScheduler.register("epoch")
class EpochScheduler(BaseScheduler):
    """ssr inside the epoch window [beg, end], 0 outside it."""

    def __init__(self, ssr: float = 0, epochs: List[int] = (10, 20)) -> None:
        super(EpochScheduler, self).__init__(ssr)
        self.beg, self.end = epochs

    def step(self, epoch: int, accu: float) -> float:
        return self.ssr if self.beg <= epoch <= self.end else 0


@SsScheduler.register("trigger")
class TriggerScheduler(BaseScheduler):
    """ssr once the accuracy reaches the trigger."""

    def __init__(self, ssr: float = 0, trigger: float = 0.6) -> None:
        super(TriggerScheduler, self).__init__(ssr)
        self.trigger = trigger

    def step(self, epoch: int, accu: float) -> float:
        return 0 if accu < self.trigger else self.ssr


@SsScheduler.register("linear")
class LinearScheduler(BaseScheduler):
    """A linear ramp over the epoch window, in steps of update_interval
    epochs."""

    def __init__(self,
                 ssr: float = 0,
                 epochs: List[int] = (10, 20),
                 update_interval: int = 1) -> None:
        super(LinearScheduler, self).__init__(ssr)
        self.beg, self.end = epochs
        self.inc = ssr * update_interval / (self.end - self.beg)
        self.interval = update_interval

    def step(self, epoch: int, accu: float) -> float:
        if epoch < self.beg:
            return 0
        if epoch >= self.end:
            return self.ssr
        return ((epoch - self.beg) // self.interval + 1) * self.inc
