#!/usr/bin/env python
"""ASR encoders (port of aps_tpu/asr/base/encoder.py: Conv2dEncoder)."""

from typing import List, Union

import torch
from torch import nn

from aps_tpu_torch.asr.base.component import Conv2d


class Conv2dEncoder(nn.Module):
    """Stack of conv2d layers with time/freq reduction, flattened to
    N x T' x (C*F') channel-major, as aps_tpu flattens its channel-last
    output after swapping F and C."""

    def __init__(self,
                 inp_features: int,
                 out_features: int,
                 channel: Union[int, List[int]] = 32,
                 in_channels: int = 1,
                 norm: str = "BN",
                 num_layers: int = 3,
                 kernel: Union[List, int] = 3,
                 stride: Union[List, int] = 2,
                 for_streaming: bool = False):
        super(Conv2dEncoder, self).__init__()
        channels = [channel] * num_layers if isinstance(channel, int) \
            else list(channel)
        kernels = self._pairs(kernel, num_layers)
        strides = self._pairs(stride, num_layers)
        self.convs = []
        for i, (k, s) in enumerate(zip(kernels, strides)):
            conv = Conv2d(in_channels if i == 0 else channels[i - 1],
                          channels[i],
                          kernel_size=k,
                          stride=s,
                          norm=norm,
                          for_streaming=for_streaming)
            self.add_module(f"conv_{i}", conv)
            self.convs.append(conv)
        self.inp_features = inp_features
        self.out_features = out_features
        freq = inp_features
        for conv in self.convs:
            freq = conv.compute_outp_dim(freq, 1)
        self.outp = nn.Linear(freq * channels[-1], out_features) \
            if out_features > 0 else None

    @staticmethod
    def _pairs(param, num_layers):
        if isinstance(param, int):
            return [(param, param)] * num_layers
        if isinstance(param[0], int):
            return [(p, p) for p in param]
        return [tuple(p) for p in param]

    def compute_outp_dim(self, dim):
        for conv in self.convs:
            dim = conv.compute_outp_dim(dim, 0)
        return dim

    def forward(self, inp: torch.Tensor, inp_len=None):
        """inp: N x T x F (or N x C x T x F) -> (N x T' x D, inp_len')."""
        if inp.dim() == 3:
            inp = inp[:, None]
        for conv in self.convs:
            inp = conv(inp)
            if inp_len is not None:
                inp_len = conv.compute_outp_dim(inp_len, 0)
        N, C, T, F = inp.shape
        out = inp.permute(0, 2, 1, 3).reshape(N, T, C * F)
        if self.outp is not None:
            out = self.outp(out)
        return out, inp_len
