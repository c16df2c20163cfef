#!/usr/bin/env python
"""Task base: glues the network forward and the loss (port of
aps_tpu/task/base.py::Task). A Task is an nn.Module holding the nnet as a
submodule; forward(egs) returns {"loss": scalar, ...stats}. The nnet's own
training flag (task.train() / task.eval()) takes the place of aps_tpu's
`training` argument."""

from typing import Dict

from torch import nn


class Task(nn.Module):

    def __init__(self, nnet: nn.Module, description: str = "unknown"):
        super(Task, self).__init__()
        self.nnet = nnet
        self.description = description

    def forward(self, egs: Dict) -> Dict:
        raise NotImplementedError
