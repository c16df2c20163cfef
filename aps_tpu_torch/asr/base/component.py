#!/usr/bin/env python
"""Encoder building blocks (port of aps_tpu/asr/base/component.py:
Normalize1d, Normalize2d, Conv1d, Conv2d, FSMN, VariantRNN,
OneHotEmbedding, and the batch norms with aps_tpu's running statistics).

aps_tpu is channel-last (N x T x F x C); PyTorch convolutions are
channel-first, so the port runs N x C x T x F and the encoders that flatten
the result do so in the same (C, F) order as aps_tpu."""

from typing import Optional, Tuple, Union

import torch
from torch import nn

IntPair = Union[int, Tuple[int, int]]

rnn_output_nonlinear = {
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "none": None,
}


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


class Normalize2d(nn.Module):
    """BN / IN over N x C x T x F (IN: each (N, C) over T x F, eps 1e-5, no
    affine parameters)."""

    def __init__(self, name: str, inp_features: int):
        super(Normalize2d, self).__init__()
        name = name.upper()
        if name not in ("BN", "IN"):
            raise ValueError(f"Unknown type of Normalize2d: {name}")
        # aps_tpu's BatchNorm: epsilon 1e-5, momentum 0.9 (torch: 0.1)
        self.bnorm = BatchNorm2d(inp_features, eps=1e-5, momentum=0.1) \
            if name == "BN" else None

    def forward(self, inp: torch.Tensor) -> torch.Tensor:
        if self.bnorm is not None:
            return self.bnorm(inp)
        var, mean = torch.var_mean(inp, (2, 3), unbiased=False, keepdim=True)
        return (inp - mean) * torch.rsqrt(var + 1e-5)


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
        self.norm2d = Normalize2d(norm, out_channels)

    def compute_outp_dim(self, dim, axis: int):
        k, d, s = self.kernel_size[axis], self.dilation[axis], \
            self.stride[axis]
        return (dim + 2 * self.padding[axis] - d * k) // s + 1

    def forward(self, inp: torch.Tensor) -> torch.Tensor:
        """inp: N x C x T x F."""
        return torch.relu(self.norm2d(self.conv(inp)))


class FSMN(nn.Module):
    """Feedforward sequential memory network layer on N x T x F:
    inp_proj (no bias) -> proj + the depthwise context conv over lctx
    frames before and rctx after (+ the memory of the layer before) ->
    out_proj (-> norm -> ReLU -> dropout unless norm is "none"). Returns
    (out N x T x O, the memory N x T x P). for_streaming convolves without
    padding and trims proj (and the memory) to the frames the conv keeps."""

    def __init__(self,
                 inp_features: int,
                 out_features: int,
                 proj_features: int,
                 lctx: int = 3,
                 rctx: int = 3,
                 norm: str = "BN",
                 dilation: int = 1,
                 dropout: float = 0.0,
                 for_streaming: bool = False):
        super(FSMN, self).__init__()
        self.lctx, self.rctx = lctx, rctx
        self.for_streaming = for_streaming
        dilation = max(dilation, 1)
        self.inp_proj = nn.Linear(inp_features, proj_features, bias=False)
        # flax pads (lctx, rctx) frames on the dilated kernel's two sides
        self.pad = (0, 0) if for_streaming else (lctx, rctx)
        self.ctx_conv = nn.Conv1d(proj_features, proj_features,
                                  lctx + rctx + 1, dilation=dilation,
                                  groups=proj_features, bias=False)
        self.out_proj = nn.Linear(proj_features, out_features)
        self.norm1d = Normalize1d(norm, out_features) \
            if norm != "none" else None
        self.drop = nn.Dropout(dropout)

    def forward(self, inp: torch.Tensor,
                memory: Optional[torch.Tensor] = None):
        if inp.dim() == 2:
            inp = inp[None]
        proj = self.inp_proj(inp)
        ctx = self.ctx_conv(nn.functional.pad(proj.transpose(1, 2),
                                              self.pad)).transpose(1, 2)
        if self.for_streaming:
            end = -self.rctx if self.rctx > 0 else None
            proj = proj[:, self.lctx:end]
            if memory is not None:
                memory = memory[:, self.lctx:end]
        proj = proj + ctx
        if memory is not None:
            proj = proj + memory
        out = self.out_proj(proj)
        if self.norm1d is not None:
            out = self.drop(torch.relu(self.norm1d(out)))
        return out, proj


class VariantRNN(nn.Module):
    """One recurrent layer (with lengths: packed) -> (the sum of its two
    directions) -> (Linear) -> (norm) -> (non-linearity) -> (dropout) on
    N x T x F; the modules carry aps_tpu's names (single_rnn, dense,
    norm1d)."""

    def __init__(self,
                 input_size: int,
                 rnn: str = "lstm",
                 norm: str = "",
                 hidden: int = 512,
                 project: int = -1,
                 non_linear: str = "relu",
                 dropout: float = 0.0,
                 bidirectional: bool = False,
                 add_forward_backward: bool = False):
        super(VariantRNN, self).__init__()
        # imported here: rnn.py imports the transformer layers, which import
        # this module's batch norms
        from aps_tpu_torch.asr.base.rnn import SingleRNN
        if non_linear not in rnn_output_nonlinear:
            raise ValueError(f"Unsupported non_linear: {non_linear}")
        self.single_rnn = SingleRNN(input_size, hidden, rnn_type=rnn,
                                    bidirectional=bidirectional)
        self.add_forward_backward = bidirectional and add_forward_backward
        size = hidden if self.add_forward_backward else \
            self.single_rnn.output_size
        self.dense = nn.Linear(size, project) if project > 0 else None
        size = project if project > 0 else size
        self.norm1d = Normalize1d(norm, size) if norm else None
        self.non_linear = rnn_output_nonlinear[non_linear]
        self.drop = nn.Dropout(dropout) if dropout != 0 else None

    def forward(self, inp: torch.Tensor,
                inp_len: Optional[torch.Tensor] = None) -> torch.Tensor:
        out = self.single_rnn(inp, inp_len)
        if self.add_forward_backward:
            fwd, bwd = out.chunk(2, -1)
            out = fwd + bwd
        if self.dense is not None:
            out = self.dense(out)
        if self.norm1d is not None:
            out = self.norm1d(out)
        if self.non_linear is not None:
            out = self.non_linear(out)
        if self.drop is not None:
            out = self.drop(out)
        return out


class OneHotEmbedding(nn.Module):
    """Token ids -> one-hot vectors (port of aps_tpu's OneHotEmbedding, the
    LM's embedding when embed_size equals the vocabulary)."""

    def __init__(self, vocab_size: int):
        super(OneHotEmbedding, self).__init__()
        self.vocab_size = vocab_size

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return nn.functional.one_hot(x, self.vocab_size).float()
