#!/usr/bin/env python
"""Real-time transformer enhancement (port of
aps_tpu/rt_sse/enh/transformer.py: FreqXfmr registered
"rt_sse@freq_xfmr"): the chunked StreamingTransformerEncoder (a linear
projection, rel pose, `chunk` frames a chunk and `lctx` chunks of left
context) on the enh transform's features. Its attention is dense, under
the chunk-context mask offline and over the cached frames in step, as in
aps_tpu; no hand-written kernel is on its path."""

from typing import Dict, Optional

import torch
from torch import nn

from aps_tpu_torch.libs import ApsRegisters
from aps_tpu_torch.rt_sse.base import RealTimeSSEBase
from aps_tpu_torch.streaming_asr.transformer.encoder import \
    StreamingTransformerEncoder


@ApsRegisters.sse.register("rt_sse@freq_xfmr")
class FreqXfmr(RealTimeSSEBase):

    def __init__(self,
                 enh_transform: Optional[nn.Module] = None,
                 num_bins: int = 257,
                 num_branchs: int = 1,
                 num_layers: int = 6,
                 chunk: int = 1,
                 lctx: int = 3,
                 arch: str = "xfmr",
                 proj_kwargs: Optional[Dict] = None,
                 pose: str = "rel",
                 pose_kwargs: Optional[Dict] = None,
                 arch_kwargs: Optional[Dict] = None,
                 complex_mask: bool = True,
                 non_linear: str = "relu",
                 training_mode: str = "freq"):
        super(FreqXfmr, self).__init__(enh_transform=enh_transform,
                                       num_branchs=num_branchs,
                                       complex_mask=complex_mask,
                                       non_linear=non_linear,
                                       training_mode=training_mode)
        self.xfmr = StreamingTransformerEncoder(
            arch, num_bins,
            output_proj=num_bins * num_branchs * (2 if complex_mask else 1),
            num_layers=num_layers, chunk=chunk, lctx=lctx, proj="linear",
            proj_kwargs=proj_kwargs or {}, pose="rel",
            pose_kwargs=pose_kwargs or {}, arch_kwargs=arch_kwargs or {})

    def _network(self, feats: torch.Tensor) -> torch.Tensor:
        return self.xfmr(feats, None)[0]

    def _network_step(self, chunk: torch.Tensor, state):
        return self.xfmr.step(chunk, state=state)
