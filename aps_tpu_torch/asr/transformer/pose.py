#!/usr/bin/env python
"""Positional encodings (port of aps_tpu/asr/transformer/pose.py:
SinPosEncoding "xl", RelPosEncoding "rel", InputSinPosEncoding "abs",
Conv1dPosEncoding "conv1d"). Batch-first outputs."""

import math

import torch
import torch.nn.functional as tf
from torch import nn

from aps_tpu_torch.libs import Register

PosEncodings = Register("pos_encodings")


def get_xfmr_pose(pose: str, dim: int, **kwargs) -> nn.Module:
    if pose not in PosEncodings:
        raise ValueError(f"Unsupported pose layer: {pose}")
    return PosEncodings[pose](embed_dim=dim, **kwargs)


@PosEncodings.register("xl")
class SinPosEncoding(nn.Module):
    """Sinusoidal encodings of given (possibly negative) positions."""

    def __init__(self, embed_dim: int, dropout: float = 0.0):
        super(SinPosEncoding, self).__init__()
        self.embed_dim = embed_dim
        self.dropout = nn.Dropout(dropout)

    def _sin_enc(self, position: torch.Tensor) -> torch.Tensor:
        div_term = torch.exp(
            -math.log(10000.0) *
            torch.arange(0, self.embed_dim, 2.0, device=position.device) /
            self.embed_dim)
        sequence = position[:, None] * div_term
        sin_enc = torch.stack([torch.sin(sequence), torch.cos(sequence)], -1)
        return sin_enc.reshape(position.shape[0], -1)

    def forward(self, position: torch.Tensor) -> torch.Tensor:
        """position: T -> T x D"""
        return self.dropout(self._sin_enc(position))


@PosEncodings.register("rel")
class RelPosEncoding(nn.Module):
    """Learnt relative-position embeddings (Shaw-style), clipped radius."""

    def __init__(self, embed_dim: int, dropout: float = 0.0,
                 lradius: int = 128, rradius: int = 128):
        super(RelPosEncoding, self).__init__()
        self.lradius, self.rradius = lradius, rradius
        self.embed = nn.Embedding(lradius + rradius + 1, embed_dim)
        self.dropout = nn.Dropout(dropout)

    def forward(self, position: torch.Tensor) -> torch.Tensor:
        """position: T (relative offsets) -> T x D"""
        position = torch.clamp(position, -self.lradius, self.rradius)
        return self.dropout(self.embed(position + self.lradius))


@PosEncodings.register("abs")
class InputSinPosEncoding(SinPosEncoding):
    """Add sinusoidal encodings to the input: N x T x D -> N x T x D."""

    def __init__(self, embed_dim: int, dropout: float = 0.0,
                 scaled: bool = False):
        super(InputSinPosEncoding, self).__init__(embed_dim, dropout=dropout)
        self.scaled = scaled

    def forward(self, inp: torch.Tensor, t: int = 0) -> torch.Tensor:
        pos = t + torch.arange(inp.shape[1], dtype=torch.float32,
                               device=inp.device)
        factor = self.embed_dim**0.5 if self.scaled else 1
        return self.dropout(inp * factor + self._sin_enc(pos))


@PosEncodings.register("conv1d")
class Conv1dPosEncoding(nn.Module):
    """Convolutional position encoding: N x T x D -> N x T x D (added)."""

    def __init__(self, embed_dim: int, dropout: float = 0.1,
                 kernel: int = 33, groups: int = 16):
        super(Conv1dPosEncoding, self).__init__()
        self.conv = nn.Conv1d(embed_dim, embed_dim, kernel,
                              padding=(kernel - 1) // 2, groups=groups)
        nn.init.normal_(self.conv.weight,
                        std=math.sqrt(4 / (kernel * embed_dim)))
        self.dropout = nn.Dropout(dropout)

    def forward(self, inp: torch.Tensor) -> torch.Tensor:
        pos = self.dropout(self.conv(inp.transpose(1, 2)).transpose(1, 2))
        # jax.nn.gelu defaults to the tanh approximation
        return tf.gelu(pos, approximate="tanh") + inp
