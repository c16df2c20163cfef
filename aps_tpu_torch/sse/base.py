#!/usr/bin/env python
"""Separation / enhancement model base (port of aps_tpu/sse/base.py:
SSEBase, MaskNonLinear, supported_nonlinear and the name sets). tf_masking
comes with the first frequency-domain model."""

from typing import Optional

import torch
from torch import nn

all_ = ["none", "relu", "tanh", "softplus", "sigmoid", "softmax"]
all_wo_softmax = ["none", "relu", "tanh", "softplus", "sigmoid"]
positive = ["relu", "softplus", "sigmoid", "softmax"]
positive_wo_softmax = ["relu", "softplus", "sigmoid"]
positive_wo_softplus = ["relu", "sigmoid", "softmax"]
common = ["relu", "sigmoid"]
bounded = ["sigmoid", "softmax"]
unbounded = ["none", "relu", "tanh", "softplus"]

supported_nonlinear = {
    "none": lambda x: x,  # [-oo, +oo]
    "relu": torch.relu,  # [0, +oo]
    "tanh": torch.tanh,  # [-1, 1]
    "softplus": nn.functional.softplus,  # [0, +oo]
    "sigmoid": torch.sigmoid,  # [0, 1]
    "softmax": lambda x: torch.softmax(x, dim=0),  # over the speaker axis
}


class SSEBase(nn.Module):
    """Base class of the separation / enhancement models: training goes
    through forward(), inference through infer(). `training_mode` is "freq"
    or "time"; `enh_transform` is the feature front end of the
    frequency-domain models (not ported yet)."""

    def __init__(self, enh_transform: Optional[nn.Module] = None,
                 training_mode: str = "freq"):
        super(SSEBase, self).__init__()
        if enh_transform is not None:
            raise NotImplementedError("enh_transform is not ported yet")
        self.enh_transform = enh_transform
        self.training_mode = training_mode

    def check_args(self, mix: torch.Tensor, training: bool = True,
                   valid_dim=(2,)) -> None:
        if mix.dim() not in valid_dim:
            supported = "/".join(str(d) for d in valid_dim)
            raise RuntimeError(
                f"Expects {supported}D tensor "
                f"({'training' if training else 'inference'}), "
                f"got {mix.dim()} instead")

    def infer(self, mix: torch.Tensor, mode: str = "time"):
        raise NotImplementedError


class MaskNonLinear(nn.Module):
    """Mask activation with optional scaling/clipping."""

    def __init__(self, non_linear: str, enable: str = "all",
                 scale: float = 1, vmax: Optional[float] = None,
                 vmin: Optional[float] = None):
        super(MaskNonLinear, self).__init__()
        supported_set = {
            "positive": positive,
            "positive_wo_softmax": positive_wo_softmax,
            "positive_wo_softplus": positive_wo_softplus,
            "all": all_,
            "all_wo_softmax": all_wo_softmax,
            "bounded": bounded,
            "unbounded": unbounded,
            "common": common
        }
        if non_linear not in supported_set[enable]:
            raise ValueError(f"Unsupported nonlinear: {non_linear}")
        self.fn = supported_nonlinear[non_linear]
        self.scale, self.vmax, self.vmin = scale, vmax, vmin

    def forward(self, inp: torch.Tensor) -> torch.Tensor:
        if inp.dim() not in (3, 4):
            raise RuntimeError(
                f"MaskNonLinear expects 3/4D tensor, got {inp.dim()}")
        out = self.fn(inp) * self.scale
        if self.vmax is not None:
            out = out.clamp(max=self.vmax)
        if self.vmin is not None:
            out = out.clamp(min=self.vmin)
        return out
