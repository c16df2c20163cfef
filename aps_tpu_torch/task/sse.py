#!/usr/bin/env python
"""Separation / enhancement tasks (port of aps_tpu/task/sse.py: SepTask,
TimeDomainTask and SisnrTask "sse@sisnr"; the other tasks of that file are
not ported yet)."""

from typing import Dict, Optional

from torch import nn

from aps_tpu_torch.libs import ApsRegisters
from aps_tpu_torch.task.base import Task
from aps_tpu_torch.task.objf import hybrid_permu_objf, sisnr_objf

__all__ = ["SisnrTask"]


def _parse_weight(weight):
    if weight is None:
        return None
    if isinstance(weight, str):
        return [float(w) for w in weight.split(",")]
    return list(weight)


class SepTask(Task):
    """Base class for separation & enhancement tasks."""

    def __init__(self, nnet: nn.Module, weight: Optional[str] = None,
                 description: str = "unknown"):
        super(SepTask, self).__init__(nnet, description=description)
        self.weight = weight

    def branch_weight(self):
        return _parse_weight(self.weight)

    def objf(self, out, ref):
        raise NotImplementedError

    def transform(self, tensor):
        return tensor


class TimeDomainTask(SepTask):
    """Waveform-level loss task."""

    def __init__(self, nnet: nn.Module, num_spks: int = 2,
                 permute: bool = True, **kwargs):
        super(TimeDomainTask, self).__init__(nnet, **kwargs)
        self.num_spks = num_spks
        self.permute = permute

    def forward(self, egs: Dict) -> Dict:
        """egs: {mix: N x (C) x S, ref: N x S or [N x S, ...]}."""
        ref = egs["ref"]
        out = self.nnet(egs["mix"])
        if not isinstance(out, (list, tuple)):
            out, ref = [out], [ref]
        loss = hybrid_permu_objf(list(out), list(ref), self.objf,
                                 weight=self.branch_weight(),
                                 permute=self.permute,
                                 permu_num_spks=self.num_spks)
        return {"loss": loss.mean()}


@ApsRegisters.task.register("sse@sisnr")
class SisnrTask(TimeDomainTask):
    """Negative SiSNR objective."""

    def __init__(self, nnet: nn.Module, zero_mean: bool = True,
                 non_nagetive: bool = False, **kwargs):
        super(SisnrTask, self).__init__(nnet, **kwargs)
        self.zero_mean = zero_mean
        self.non_nagetive = non_nagetive

    def objf(self, out, ref):
        return -sisnr_objf(out, ref, zero_mean=self.zero_mean,
                           non_nagetive=self.non_nagetive)
