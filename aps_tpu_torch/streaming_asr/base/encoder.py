#!/usr/bin/env python
"""Streaming encoders (port of aps_tpu/streaming_asr/base/encoder.py:
StreamingRNNEncoder "pytorch_rnn", StreamingFSMNEncoder "fsmn",
StreamingConv1dEncoder "conv1d" and StreamingConv2dEncoder "conv2d",
registered in StreamingBaseEncoder).

Each maps (inp N x T x F, inp_len) to (out, out_len) offline, as the
port's encoders do, and has step(chunk, state) -> (out, state): the RNN
carries its recurrent state; the FSMN and conv encoders convolve without
padding (for_streaming), so a chunk that holds its left and right context
frames gives the same frames as the offline pass, and they carry no
state."""

from typing import List, Union

import torch
from torch import nn

from aps_tpu_torch.asr.base.component import rnn_output_nonlinear
from aps_tpu_torch.asr.base.encoder import (Conv1dEncoder, Conv2dEncoder,
                                            FSMNEncoder)
from aps_tpu_torch.asr.base.rnn import StackedLSTMWithState
from aps_tpu_torch.libs import Register

StreamingBaseEncoder = Register("streaming_encoder")


@StreamingBaseEncoder.register("pytorch_rnn")
class StreamingRNNEncoder(nn.Module):
    """(Linear + ReLU) -> unidirectional stacked RNN with carried state
    (the port's StackedLSTMWithState) -> (Linear) -> (non-linearity)."""

    def __init__(self,
                 inp_features: int,
                 out_features: int,
                 input_proj: int = -1,
                 rnn: str = "lstm",
                 num_layers: int = 3,
                 hidden: int = 512,
                 hidden_proj: int = -1,
                 dropout: float = 0.0,
                 non_linear: str = "none"):
        super(StreamingRNNEncoder, self).__init__()
        if non_linear not in rnn_output_nonlinear:
            raise ValueError(f"Unsupported non-linear: {non_linear}")
        self.proj = nn.Linear(inp_features, input_proj) \
            if input_proj > 0 else None
        self.impl = StackedLSTMWithState(
            input_proj if input_proj > 0 else inp_features, hidden,
            num_layers=num_layers, dropout=dropout, rnn_type=rnn,
            proj_size=hidden_proj)
        self.outp = nn.Linear(self.impl.output_size, out_features) \
            if out_features > 0 else None
        self.out_features = out_features
        self.non_linear = rnn_output_nonlinear[non_linear]

    def output_dim(self) -> int:
        if self.out_features > 0:
            return self.out_features
        return self.impl.output_size

    def init_step_state(self, batch: int, device=None):
        return self.impl.init_state(batch, device=device)

    def step(self, chunk: torch.Tensor, state=None):
        """chunk: N x (T) x D -> (out N x T x D', state)."""
        if chunk.dim() == 2:
            chunk = chunk[:, None]
        if self.proj is not None:
            chunk = torch.relu(self.proj(chunk))
        out, state = self.impl(chunk, state=state)
        if self.outp is not None:
            out = self.outp(out)
        if self.non_linear is not None:
            out = self.non_linear(out)
        return out, state

    def forward(self, inp: torch.Tensor, inp_len=None):
        """The whole padded input from a zero state (the lengths pass
        through, as in aps_tpu: nothing is packed)."""
        out, _ = self.step(inp)
        return out, inp_len


@StreamingBaseEncoder.register("fsmn")
class StreamingFSMNEncoder(nn.Module):
    """The port's FSMNEncoder with valid context convolutions (impl). The
    offline pass takes an input its caller padded with the stack's left and
    right context; step takes a chunk that holds them."""

    def __init__(self,
                 inp_features: int,
                 out_features: int,
                 dim: int = 1024,
                 project: int = 512,
                 num_layers: int = 4,
                 lctx: Union[List[int], int] = 3,
                 rctx: Union[List[int], int] = 3,
                 residual: bool = False,
                 norm: str = "BN",
                 dropout: float = 0.0):
        super(StreamingFSMNEncoder, self).__init__()
        self.impl = FSMNEncoder(inp_features, out_features, dim=dim,
                                project=project, num_layers=num_layers,
                                residual=residual, lctx=lctx, rctx=rctx,
                                norm=norm, dilation=1, dropout=dropout,
                                for_streaming=True)
        self.out_features = out_features

    def output_dim(self) -> int:
        return self.out_features

    def forward(self, inp: torch.Tensor, inp_len=None):
        return self.impl(inp, inp_len)

    def step(self, chunk: torch.Tensor, state=None):
        """A chunk with its context frames -> (the frames it determines,
        state unchanged)."""
        out, _ = self.impl(chunk, None)
        return out, state


@StreamingBaseEncoder.register("conv1d")
class StreamingConv1dEncoder(Conv1dEncoder):
    """The port's Conv1dEncoder (TDNN) without padding."""

    def __init__(self, inp_features: int, out_features: int,
                 for_streaming: bool = True, **kwargs):
        super(StreamingConv1dEncoder, self).__init__(
            inp_features, out_features, for_streaming=for_streaming,
            **kwargs)

    def step(self, chunk: torch.Tensor, state=None):
        out, _ = self.forward(chunk, None)
        return out, state


@StreamingBaseEncoder.register("conv2d")
class StreamingConv2dEncoder(Conv2dEncoder):
    """The port's Conv2dEncoder without padding on the time axis."""

    def __init__(self, inp_features: int, out_features: int,
                 for_streaming: bool = True, **kwargs):
        super(StreamingConv2dEncoder, self).__init__(
            inp_features, out_features, for_streaming=for_streaming,
            **kwargs)

    def step(self, chunk: torch.Tensor, state=None):
        out, _ = self.forward(chunk, None)
        return out, state

