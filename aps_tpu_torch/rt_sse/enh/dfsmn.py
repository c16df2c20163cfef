#!/usr/bin/env python
"""Real-time DFSMN enhancement (port of aps_tpu/rt_sse/enh/dfsmn.py: DFSMN
registered "rt_sse@dfsmn"): the streaming FSMN encoder on the enh
transform's features. Offline the features get the stack's whole left and
right context in zero frames (lctx_total, rctx_total) and the valid
convolutions consume them; step and mask_predict take a block that holds
its context frames and give the frames it determines."""

from typing import List, Optional, Union

import torch
from torch import nn

from aps_tpu_torch.libs import ApsRegisters
from aps_tpu_torch.rt_sse.base import RealTimeSSEBase
from aps_tpu_torch.streaming_asr.base.encoder import StreamingFSMNEncoder


@ApsRegisters.sse.register("rt_sse@dfsmn")
class DFSMN(RealTimeSSEBase):

    def __init__(self,
                 enh_transform: Optional[nn.Module] = None,
                 dim: int = 1024,
                 num_bins: int = 257,
                 num_branchs: int = 1,
                 num_layers: int = 4,
                 project: int = 512,
                 dropout: float = 0.0,
                 residual: bool = True,
                 lctx: Union[List[int], int] = 3,
                 rctx: Union[List[int], int] = 3,
                 norm: str = "BN",
                 complex_mask: bool = True,
                 non_linear: str = "relu",
                 training_mode: str = "freq"):
        super(DFSMN, self).__init__(enh_transform=enh_transform,
                                    num_branchs=num_branchs,
                                    complex_mask=complex_mask,
                                    non_linear=non_linear,
                                    training_mode=training_mode)
        out = num_bins * num_branchs * (2 if complex_mask else 1)
        self.dfsmn = StreamingFSMNEncoder(num_bins, out, dim=dim, norm=norm,
                                          project=project, dropout=dropout,
                                          num_layers=num_layers,
                                          residual=residual, lctx=lctx,
                                          rctx=rctx)

        def context(ctx):
            return num_layers * ctx if isinstance(ctx, int) else sum(ctx)

        self.lctx_total, self.rctx_total = context(lctx), context(rctx)

    def _context_pad(self, feats: torch.Tensor) -> torch.Tensor:
        return nn.functional.pad(feats, (0, 0, self.lctx_total,
                                         self.rctx_total))

    def _network(self, feats: torch.Tensor) -> torch.Tensor:
        return self.dfsmn(feats, None)[0]

    def _network_step(self, chunk: torch.Tensor, state):
        return self.dfsmn.step(chunk, state=state)
