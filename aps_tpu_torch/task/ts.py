#!/usr/bin/env python
"""Teacher-student (knowledge distillation) task for SSE (port of
aps_tpu/task/ts.py: SseFreqTsTask "sse@ts").

The student mimics the outputs of a frozen teacher: the teacher is read
from an aps_tpu-format checkpoint directory (train.yaml and
<teacher_tag>.ckpt) through eval.wrapper.load_checkpoint, its parameters
take no gradient and hold no optimizer state (requires_grad_(False)), it
stays in eval mode whatever mode the task is put in, and its forward runs
under torch.no_grad(). The loss is hybrid_permu_objf of the student's
outputs against the teacher's, with the L1 or L2 distance summed over the
last axis, as aps_tpu's (objf_name "L1"; any other name takes L2)."""

from typing import Dict

import torch
from torch import nn

from aps_tpu_torch.libs import ApsRegisters
from aps_tpu_torch.task.base import Task
from aps_tpu_torch.task.objf import hybrid_permu_objf

__all__ = ["SseFreqTsTask"]


@ApsRegisters.task.register("sse@ts")
class SseFreqTsTask(Task):
    """Frequency-domain KD: the student mimics a frozen teacher's
    outputs."""

    def __init__(self,
                 nnet: nn.Module,
                 teacher: str = "",
                 teacher_tag: str = "best",
                 objf_name: str = "L1",
                 permute: bool = True,
                 num_spks: int = 2):
        super(SseFreqTsTask, self).__init__(
            nnet, description="teacher-student SSE task")
        from aps_tpu_torch.eval.wrapper import load_checkpoint
        self.teacher_nnet = load_checkpoint(teacher,
                                            cpt_tag=teacher_tag)["nnet"]
        self.teacher_nnet.requires_grad_(False)
        self.teacher_nnet.eval()
        self.objf_name = objf_name
        self.permute = permute
        self.num_spks = num_spks

    def train(self, mode: bool = True) -> "SseFreqTsTask":
        """Put the student in `mode`; the teacher stays in eval mode."""
        super(SseFreqTsTask, self).train(mode)
        self.teacher_nnet.eval()
        return self

    def objf(self, out: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
        dist = (out - ref).abs() if self.objf_name == "L1" else \
            (out - ref)**2
        return dist.sum(-1)

    def forward(self, egs: Dict) -> Dict:
        """egs: {mix: N x (C) x S, ...}; the references are the
        teacher's."""
        mix = egs["mix"]
        with torch.no_grad():
            ref = self.teacher_nnet(mix)
        out = self.nnet(mix)
        if not isinstance(out, (list, tuple)):
            out, ref = [out], [ref]
        loss = hybrid_permu_objf(list(out), list(ref), self.objf,
                                 permute=self.permute,
                                 permu_num_spks=self.num_spks)
        return {"loss": loss.mean()}
