#!/usr/bin/env python
"""Encoder building blocks (port of aps_tpu/asr/base/component.py:
Normalize1d, Conv1d, Conv2d, and the batch norms with aps_tpu's running
statistics).

aps_tpu is channel-last (N x T x F x C); PyTorch convolutions are
channel-first, so the port runs N x C x T x F and the encoders that flatten
the result do so in the same (C, F) order as aps_tpu."""

from typing import Tuple, Union

import torch
from torch import nn

IntPair = Union[int, Tuple[int, int]]


def _pair(v: IntPair) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


class _FlaxRunningStats(object):
    """BatchNorm whose running statistics follow aps_tpu (flax, momentum
    0.9): in training running <- 0.9 running + 0.1 batch, with the BIASED
    batch variance, where PyTorch's own update takes the unbiased one. The
    statistics are taken over every position of the batch, padded frames
    included, as in aps_tpu. The normalisation itself is PyTorch's (batch
    statistics in training, running ones in eval)."""

    def forward(self, inp: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super(_FlaxRunningStats, self).forward(inp)
        dims = [0] + list(range(2, inp.dim()))
        with torch.no_grad():
            var, mean = torch.var_mean(inp, dims, unbiased=False)
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
        return nn.functional.batch_norm(inp, None, None, self.weight,
                                        self.bias, True, 0.0, self.eps)


class BatchNorm1d(_FlaxRunningStats, nn.BatchNorm1d):
    pass


class BatchNorm2d(_FlaxRunningStats, nn.BatchNorm2d):
    pass


class Normalize1d(nn.Module):
    """BN / LN over N x T x F (the feature axis is normalised)."""

    def __init__(self, name: str, inp_features: int):
        super(Normalize1d, self).__init__()
        name = name.upper()
        if name not in ("BN", "LN"):
            raise ValueError(f"Unknown type of Normalize1d: {name}")
        # aps_tpu's epsilons: BatchNorm 1e-5, LayerNorm 1e-6
        self.bnorm = BatchNorm1d(inp_features, eps=1e-5, momentum=0.1) \
            if name == "BN" else None
        self.lnorm = nn.LayerNorm(inp_features, eps=1e-6) \
            if name == "LN" else None

    def forward(self, inp: torch.Tensor) -> torch.Tensor:
        if self.lnorm is not None:
            return self.lnorm(inp)
        return self.bnorm(inp.transpose(1, 2)).transpose(1, 2)


class Conv1d(nn.Module):
    """TDNN block: Conv1d -> Norm -> ReLU -> Dropout on N x T x F."""

    def __init__(self,
                 inp_features: int,
                 out_features: int,
                 kernel_size: int = 3,
                 stride: int = 2,
                 dilation: int = 1,
                 norm: str = "BN",
                 dropout: float = 0,
                 for_streaming: bool = False):
        super(Conv1d, self).__init__()
        self.kernel_size, self.stride, self.dilation = kernel_size, stride, \
            dilation
        self.padding = 0 if for_streaming else \
            (dilation * (kernel_size - 1)) // 2
        self.conv = nn.Conv1d(inp_features, out_features, kernel_size,
                              stride=stride, padding=self.padding,
                              dilation=dilation)
        self.norm1d = Normalize1d(norm, out_features)
        self.drop = nn.Dropout(dropout)

    def compute_outp_dim(self, dim):
        return (dim + 2 * self.padding - self.dilation *
                (self.kernel_size - 1) - 1) // self.stride + 1

    def forward(self, inp: torch.Tensor) -> torch.Tensor:
        out = self.conv(inp.transpose(1, 2)).transpose(1, 2)
        return self.drop(torch.relu(self.norm1d(out)))


class Conv2d(nn.Module):
    """Conv2d block: Conv -> Norm -> ReLU on N x C x T x F."""

    def __init__(self,
                 in_channels: int,
                 out_channels: int,
                 kernel_size: IntPair = 3,
                 stride: IntPair = 2,
                 dilation: IntPair = 1,
                 norm: str = "BN",
                 for_streaming: bool = False):
        super(Conv2d, self).__init__()
        k, s, d = _pair(kernel_size), _pair(stride), _pair(dilation)
        pad = tuple((dd * (kk - 1)) // 2 for dd, kk in zip(d, k))
        if for_streaming:
            pad = (0, pad[-1])
        self.kernel_size, self.stride, self.dilation = k, s, d
        self.padding = pad
        self.conv = nn.Conv2d(in_channels, out_channels, k, stride=s,
                              padding=pad, dilation=d)
        if norm.upper() != "BN":
            raise NotImplementedError(f"Conv2d norm {norm} is not ported "
                                      "yet (only BN)")
        # aps_tpu's BatchNorm: epsilon 1e-5, momentum 0.9 (torch: 0.1)
        self.norm2d = BatchNorm2d(out_channels, eps=1e-5, momentum=0.1)

    def compute_outp_dim(self, dim, axis: int):
        k, d, s = self.kernel_size[axis], self.dilation[axis], \
            self.stride[axis]
        return (dim + 2 * self.padding[axis] - d * k) // s + 1

    def forward(self, inp: torch.Tensor) -> torch.Tensor:
        """inp: N x C x T x F."""
        return torch.relu(self.norm2d(self.conv(inp)))
