#!/usr/bin/env python
"""ASR encoders (port of aps_tpu/asr/base/encoder.py: Conv1dEncoder,
Conv2dEncoder, RNNEncoderBase and PyTorchRNNEncoder, registered
"pytorch_rnn" and "rnn" in BaseEncoder). aps_tpu's concat, variant_rnn,
jit_lstm and fsmn encoders are not ported yet."""

from typing import List, Optional, Union

import torch
from torch import nn

from aps_tpu_torch.asr.base.component import Conv1d, Conv2d
from aps_tpu_torch.asr.base.rnn import StackedRNN
from aps_tpu_torch.libs import Register

BaseEncoder = Register("base_encoder")

rnn_output_nonlinear = {
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "none": None,
}


class Conv1dEncoder(nn.Module):
    """Stack of TDNN (conv1d) layers with time reduction on N x T x F."""

    def __init__(self,
                 inp_features: int,
                 out_features: int,
                 dim: int = 512,
                 norm: str = "BN",
                 num_layers: int = 3,
                 kernel: Union[List[int], int] = 3,
                 stride: Union[List[int], int] = 2,
                 dilation: Union[List[int], int] = 1,
                 dropout: float = 0,
                 for_streaming: bool = False):
        super(Conv1dEncoder, self).__init__()
        cfgs = zip(*(self._list(p, num_layers)
                     for p in (kernel, stride, dilation)))
        self.convs = []
        for i, (k, s, d) in enumerate(cfgs):
            last = i == num_layers - 1
            conv = Conv1d(inp_features if i == 0 else dim,
                          (out_features if out_features > 0 else dim)
                          if last else dim,
                          kernel_size=k, stride=s, dilation=d, norm=norm,
                          dropout=dropout, for_streaming=for_streaming)
            self.add_module(f"conv_{i}", conv)
            self.convs.append(conv)

    @staticmethod
    def _list(param, repeat):
        return [param] * repeat if isinstance(param, int) else list(param)

    def compute_outp_dim(self, dim):
        for conv in self.convs:
            dim = conv.compute_outp_dim(dim)
        return dim

    def forward(self, inp: torch.Tensor, inp_len=None):
        for conv in self.convs:
            inp = conv(inp)
            if inp_len is not None:
                inp_len = conv.compute_outp_dim(inp_len)
        return inp, inp_len


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


class RNNEncoderBase(nn.Module):
    """(Linear + ReLU) -> stacked RNN -> (Linear) -> (non-linearity), on
    N x T x F with lengths; the modules carry aps_tpu's names (proj, impl,
    outp). out_features -1: no output layer."""

    def __init__(self,
                 inp_features: int,
                 out_features: int = -1,
                 input_proj: int = -1,
                 rnn: str = "lstm",
                 num_layers: int = 3,
                 hidden: int = 512,
                 hidden_proj: int = -1,
                 dropout: float = 0.2,
                 bidirectional: bool = False,
                 non_linear: str = "none",
                 use_ln: bool = False):
        super(RNNEncoderBase, self).__init__()
        if non_linear not in rnn_output_nonlinear:
            raise ValueError(f"Unsupported non-linear: {non_linear}")
        self.proj = nn.Linear(inp_features, input_proj) \
            if input_proj > 0 else None
        self.impl = StackedRNN(input_proj if input_proj > 0 else inp_features,
                               hidden,
                               num_layers=num_layers,
                               rnn_type=rnn,
                               bidirectional=bidirectional,
                               dropout=dropout,
                               hidden_proj=hidden_proj,
                               layer_norm=use_ln)
        self.outp = nn.Linear(self.impl.output_size, out_features) \
            if out_features > 0 else None
        self.non_linear = rnn_output_nonlinear[non_linear]
        self.out_features = out_features

    def output_dim(self) -> int:
        if self.out_features > 0:
            return self.out_features
        return self.impl.output_size

    def forward(self, inp: torch.Tensor,
                inp_len: Optional[torch.Tensor] = None):
        """inp: N x T x F, inp_len: N or None -> (N x T x D, inp_len);
        with lengths the frames past each one are not valid output."""
        if self.proj is not None:
            inp = torch.relu(self.proj(inp))
        out = self.impl(inp, inp_len)
        if self.outp is not None:
            out = self.outp(out)
            if self.non_linear is not None:
                out = self.non_linear(out)
        return out, inp_len


@BaseEncoder.register("pytorch_rnn")
class PyTorchRNNEncoder(RNNEncoderBase):
    """The name aps_tpu keeps for configs (a flax RNN there, cuDNN here)."""
    pass


BaseEncoder.register("rnn")(PyTorchRNNEncoder)
