#!/usr/bin/env python
"""Input projection before transformer encoders (port of
aps_tpu/asr/transformer/proj.py: Conv2dProj)."""

from typing import List, Union

import torch
from torch import nn

from aps_tpu_torch.asr.base.encoder import Conv2dEncoder
from aps_tpu_torch.libs import Register

XfmrProjLayer = Register("xfmr_proj_layer")


def get_xfmr_proj(proj_name: str, in_features: int, att_dim: int,
                  **kwargs) -> nn.Module:
    if proj_name not in XfmrProjLayer:
        raise NotImplementedError(f"projection layer {proj_name} is not "
                                  "ported yet")
    return XfmrProjLayer[proj_name](input_size=in_features,
                                    embed_dim=att_dim, **kwargs)


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
