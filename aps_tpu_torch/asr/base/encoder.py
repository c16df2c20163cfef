#!/usr/bin/env python
"""ASR encoders (port of aps_tpu/asr/base/encoder.py: encoder_instance,
ConcatEncoder, RNNEncoderBase, PyTorchRNNEncoder ("pytorch_rnn", "rnn"),
JitLSTMEncoder ("jit_lstm"), VariantRNNEncoder ("variant_rnn"),
Conv1dEncoder ("conv1d"), Conv2dEncoder ("conv2d") and FSMNEncoder
("fsmn"), registered in BaseEncoder). Every encoder maps (inp N x T x F,
inp_len N or None) to (out N x T' x D, out_len) and tells its D through
output_dim(); the module names follow aps_tpu's parameter paths.

A recurrent layer given lengths runs on the packed sequence: the frames
past each length come out as zeros where flax carries its state on, so
only the valid frames agree with aps_tpu (what follows reads the valid
frames only, except a batch norm in training, whose statistics take every
frame in both packages)."""

from typing import Dict, List, Optional, Union

import torch
from torch import nn

from aps_tpu_torch.asr.base.component import (FSMN, Conv1d, Conv2d,
                                              VariantRNN,
                                              rnn_output_nonlinear)
from aps_tpu_torch.asr.base.rnn import StackedRNN
from aps_tpu_torch.libs import Register

BaseEncoder = Register("base_encoder")


def encoder_instance(enc_type: str, inp_features: int, out_features: int,
                     enc_kwargs: Dict, enc_class: Dict) -> nn.Module:
    """Build an encoder, or for "concat" the chain of the encoders that
    enc_kwargs names in order (each one's input the output_dim() of the
    one before; out_features goes to the last)."""

    def encoder(enc_type, inp_features, out_features, **kwargs):
        if enc_type not in enc_class:
            raise RuntimeError(f"Unknown encoder type: {enc_type}")
        return enc_class[enc_type](inp_features=inp_features,
                                   out_features=out_features, **kwargs)

    if enc_type != "concat":
        return encoder(enc_type, inp_features, out_features, **enc_kwargs)
    if len(enc_kwargs) <= 1:
        raise ValueError("Use >= 2 encoders for 'concat' type encoder")
    enc_layers = []
    for i, (name, kwargs) in enumerate(enc_kwargs.items()):
        last = i == len(enc_kwargs) - 1
        enc_layers.append(encoder(
            name, inp_features if i == 0 else enc_layers[-1].output_dim(),
            out_features if last else -1, **kwargs))
    return ConcatEncoder(enc_layers)


class ConcatEncoder(nn.Module):
    """A chain of encoders, e.g. conv2d -> pytorch_rnn (enc_list_<i>)."""

    def __init__(self, enc_list: List[nn.Module]):
        super(ConcatEncoder, self).__init__()
        for i, enc in enumerate(enc_list):
            self.add_module(f"enc_list_{i}", enc)
        self.enc_list = enc_list

    def output_dim(self) -> int:
        return self.enc_list[-1].output_dim()

    def forward(self, inp: torch.Tensor, inp_len=None):
        for enc in self.enc_list:
            inp, inp_len = enc(inp, inp_len)
        return inp, inp_len


@BaseEncoder.register("conv1d")
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
        self.out_features = out_features if out_features > 0 else dim
        self.convs = []
        for i, (k, s, d) in enumerate(cfgs):
            last = i == num_layers - 1
            conv = Conv1d(inp_features if i == 0 else dim,
                          self.out_features if last else dim,
                          kernel_size=k, stride=s, dilation=d, norm=norm,
                          dropout=dropout, for_streaming=for_streaming)
            self.add_module(f"conv_{i}", conv)
            self.convs.append(conv)

    @staticmethod
    def _list(param, repeat):
        return [param] * repeat if isinstance(param, int) else list(param)

    def output_dim(self) -> int:
        return self.out_features

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


@BaseEncoder.register("conv2d")
class Conv2dEncoder(nn.Module):
    """Stack of conv2d layers with time/freq reduction, flattened to
    N x T' x (C*F') channel-major, as aps_tpu flattens its channel-last
    output after swapping F and C. Channel-first: N x T x F is one channel,
    N x C x T x F is C (WSJ 1a's three delta orders, in_channels 3)."""

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
        freq = inp_features
        for conv in self.convs:
            freq = conv.compute_outp_dim(freq, 1)
        self.out_features = out_features if out_features > 0 else \
            freq * channels[-1]
        self.outp = nn.Linear(freq * channels[-1], out_features) \
            if out_features > 0 else None

    @staticmethod
    def _pairs(param, num_layers):
        if isinstance(param, int):
            return [(param, param)] * num_layers
        if isinstance(param[0], int):
            return [(p, p) for p in param]
        return [tuple(p) for p in param]

    def output_dim(self) -> int:
        return self.out_features

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


@BaseEncoder.register("jit_lstm")
class JitLSTMEncoder(RNNEncoderBase):
    """RNNEncoderBase with a layer norm after each layer by default."""

    def __init__(self, inp_features: int, out_features: int = -1,
                 use_ln: bool = True, **kwargs):
        super(JitLSTMEncoder, self).__init__(inp_features, out_features,
                                             use_ln=use_ln, **kwargs)


@BaseEncoder.register("variant_rnn")
class VariantRNNEncoder(nn.Module):
    """Stack of VariantRNN layers (layer_<i>). pyramid_stack: from the
    second layer on, pairs of frames are stacked on the feature axis (an
    odd last frame dropped) and the lengths halved. The last layer has no
    norm, non-linearity or dropout and projects to output_dim()."""

    def __init__(self,
                 inp_features: int,
                 out_features: int = -1,
                 rnn: str = "lstm",
                 hidden: int = 512,
                 num_layers: int = 3,
                 bidirectional: bool = True,
                 dropout: float = 0.0,
                 dropout_input: bool = True,
                 project: int = -1,
                 non_linear: str = "tanh",
                 norm: str = "",
                 pyramid_stack: bool = False,
                 add_forward_backward: bool = False):
        super(VariantRNNEncoder, self).__init__()
        factor = 2 if bidirectional and not add_forward_backward else 1
        self.out_features = out_features if out_features > 0 else \
            hidden * factor
        self.pyramid_stack = pyramid_stack
        self.layers = []
        size = inp_features
        for i in range(num_layers):
            last = i == num_layers - 1
            if i != 0:
                size = project if project > 0 else hidden * factor
                if pyramid_stack:
                    size *= 2
            layer = VariantRNN(size,
                               rnn=rnn,
                               norm=norm if not last else "",
                               hidden=hidden,
                               project=project if not last else
                               self.out_features,
                               dropout=dropout if not last else 0,
                               bidirectional=bidirectional,
                               non_linear=non_linear if not last else "none",
                               add_forward_backward=add_forward_backward)
            self.add_module(f"layer_{i}", layer)
            self.layers.append(layer)

    def output_dim(self) -> int:
        return self.out_features

    def forward(self, inp: torch.Tensor,
                inp_len: Optional[torch.Tensor] = None):
        for i, layer in enumerate(self.layers):
            if i != 0 and self.pyramid_stack:
                if inp.shape[1] % 2:
                    inp = inp[:, :-1]
                inp = torch.cat([inp[:, ::2], inp[:, 1::2]], -1)
                inp_len = None if inp_len is None else inp_len // 2
            inp = layer(inp, inp_len)
        return inp, inp_len


@BaseEncoder.register("fsmn")
class FSMNEncoder(nn.Module):
    """Stack of FSMN layers (fsmn_<i>), each layer's memory added into the
    next one's (residual); the last has no norm and gives out_features.
    The lengths pass through."""

    def __init__(self,
                 inp_features: int,
                 out_features: int,
                 dim: int = 1024,
                 project: int = 512,
                 num_layers: int = 4,
                 residual: bool = True,
                 lctx: Union[List[int], int] = 3,
                 rctx: Union[List[int], int] = 3,
                 norm: str = "BN",
                 dilation: Union[List[int], int] = 1,
                 dropout: float = 0.0,
                 for_streaming: bool = False):
        super(FSMNEncoder, self).__init__()
        _list = lambda p: [p] * num_layers if isinstance(p, int) \
            else list(p)  # noqa: E731
        lctx, rctx, dilation = _list(lctx), _list(rctx), _list(dilation)
        self.out_features = out_features
        self.residual = residual
        self.layers = []
        for i in range(num_layers):
            last = i == num_layers - 1
            layer = FSMN(inp_features if i == 0 else dim,
                         dim if not last else out_features,
                         project,
                         lctx=lctx[i],
                         rctx=rctx[i],
                         norm=norm if not last else "none",
                         dilation=dilation[i],
                         dropout=dropout,
                         for_streaming=for_streaming)
            self.add_module(f"fsmn_{i}", layer)
            self.layers.append(layer)

    def output_dim(self) -> int:
        return self.out_features

    def forward(self, inp: torch.Tensor,
                inp_len: Optional[torch.Tensor] = None):
        memory = None
        for layer in self.layers:
            inp, new_memory = layer(inp, memory=memory)
            memory = new_memory if self.residual else None
        return inp, inp_len
