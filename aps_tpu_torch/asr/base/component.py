#!/usr/bin/env python
"""Encoder building blocks (port of aps_tpu/asr/base/component.py: Conv2d).

aps_tpu is channel-last (N x T x F x C); PyTorch convolutions are
channel-first, so the port runs N x C x T x F and the encoders that flatten
the result do so in the same (C, F) order as aps_tpu."""

from typing import Tuple, Union

import torch
from torch import nn

IntPair = Union[int, Tuple[int, int]]


def _pair(v: IntPair) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


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
        self.norm2d = nn.BatchNorm2d(out_channels, eps=1e-5, momentum=0.1)

    def compute_outp_dim(self, dim, axis: int):
        k, d, s = self.kernel_size[axis], self.dilation[axis], \
            self.stride[axis]
        return (dim + 2 * self.padding[axis] - d * k) // s + 1

    def forward(self, inp: torch.Tensor) -> torch.Tensor:
        """inp: N x C x T x F."""
        return torch.relu(self.norm2d(self.conv(inp)))
