#!/usr/bin/env python
"""Input projection before transformer encoders (port of
aps_tpu/asr/transformer/proj.py: LinearProj, Conv1dProj, Conv2dProj)."""

from typing import List, Union

import torch
from torch import nn

from aps_tpu_torch.asr.base.component import Normalize1d
from aps_tpu_torch.asr.base.encoder import Conv1dEncoder, Conv2dEncoder
from aps_tpu_torch.libs import Register

XfmrProjLayer = Register("xfmr_proj_layer")


def get_xfmr_proj(proj_name: str, in_features: int, att_dim: int,
                  **kwargs) -> nn.Module:
    if proj_name not in XfmrProjLayer:
        raise ValueError(f"Unsupported projection layer: {proj_name}")
    return XfmrProjLayer[proj_name](input_size=in_features,
                                    embed_dim=att_dim, **kwargs)


@XfmrProjLayer.register("linear")
class LinearProj(nn.Module):
    """Linear -> Norm -> Dropout -> ReLU on N x T x F."""

    def __init__(self, input_size: int, embed_dim: int, dropout: float = 0.0,
                 norm: str = "LN"):
        super(LinearProj, self).__init__()
        self.dense = nn.Linear(input_size, embed_dim)
        self.norm1d = Normalize1d(norm, embed_dim)
        self.drop = nn.Dropout(dropout)

    def num_frames(self, inp_len):
        return inp_len

    def forward(self, inp: torch.Tensor, inp_len=None):
        return torch.relu(self.drop(self.norm1d(self.dense(inp)))), inp_len


@XfmrProjLayer.register("conv1d")
class Conv1dProj(nn.Module):

    def __init__(self,
                 input_size: int,
                 embed_dim: int,
                 norm: str = "BN",
                 dropout: float = 0.0,
                 dim: int = 256,
                 kernel: Union[List[int], int] = 3,
                 stride: Union[List[int], int] = 2,
                 num_layers: int = 2,
                 for_streaming: bool = False):
        super(Conv1dProj, self).__init__()
        self.conv1d_encoder = Conv1dEncoder(input_size,
                                            embed_dim,
                                            dim=dim,
                                            norm=norm,
                                            num_layers=num_layers,
                                            dropout=dropout,
                                            kernel=kernel,
                                            stride=stride,
                                            for_streaming=for_streaming)

    def num_frames(self, inp_len):
        return self.conv1d_encoder.compute_outp_dim(inp_len)

    def forward(self, inp: torch.Tensor, inp_len=None):
        """inp: N x T x F or N x C x T x F."""
        if inp.dim() == 4:
            # N x C x T x F (front-end output) -> N x T x C*F
            N, _, T, _ = inp.shape
            inp = inp.transpose(1, 2).reshape(N, T, -1)
        return self.conv1d_encoder(inp, inp_len)


@XfmrProjLayer.register("conv2d")
class Conv2dProj(nn.Module):

    def __init__(self,
                 input_size: int,
                 embed_dim: int,
                 norm: str = "BN",
                 kernel: Union[List, int] = 3,
                 stride: Union[List, int] = 2,
                 num_layers: int = 2,
                 in_channels: int = 1,
                 conv_channels: int = 256,
                 for_streaming: bool = False):
        super(Conv2dProj, self).__init__()
        self.conv_encoder = Conv2dEncoder(input_size,
                                          embed_dim,
                                          channel=conv_channels,
                                          in_channels=in_channels,
                                          num_layers=num_layers,
                                          norm=norm,
                                          kernel=kernel,
                                          stride=stride,
                                          for_streaming=for_streaming)

    def num_frames(self, inp_len):
        return self.conv_encoder.compute_outp_dim(inp_len)

    def forward(self, inp: torch.Tensor, inp_len=None):
        """inp: N x T x F or N x C x T x F."""
        return self.conv_encoder(inp, inp_len)
