#!/usr/bin/env python
"""Frequency-domain transformer masking model (port of
aps_tpu/sse/bss/transformer.py: FreqXfmr "sse@freq_xfmr").

The enh transform's features go through the port's TransformerEncoder
(a linear projection, the layers, output_proj = num_spks x num_bins) and a
mask non-linearity. With the default rel pose its self-attention runs
through flash_attention_rel: on the card the hand-written kernel of
csrc/rel_attention.cu, and in training its three backward kernels, unless
an attention dropout is active or lctx / rctx set a context mask (then the
dense path, as in aps_tpu). aps_tpu takes its TPU rel kernel only from 512
frames on and its plain path below; the port takes the kernel at any
length (aps_tpu_torch/asr/transformer/impl.py)."""

from typing import Dict, List, Optional

import torch
from torch import nn

from aps_tpu_torch.asr.transformer.encoder import TransformerEncoder
from aps_tpu_torch.libs import ApsRegisters
from aps_tpu_torch.sse.base import FreqMaskingSSE, MaskNonLinear


@ApsRegisters.sse.register("sse@freq_xfmr")
class FreqXfmr(FreqMaskingSSE):
    """Transformer mask estimator over the enh transform's features."""

    def __init__(self,
                 enh_transform: Optional[nn.Module] = None,
                 input_size: int = 257,
                 num_spks: int = 2,
                 num_bins: int = 257,
                 rctx: int = -1,
                 lctx: int = -1,
                 arch: str = "xfmr",
                 pose: str = "rel",
                 arch_kwargs: Optional[Dict] = None,
                 pose_kwargs: Optional[Dict] = None,
                 proj_kwargs: Optional[Dict] = None,
                 num_layers: int = 6,
                 non_linear: str = "sigmoid",
                 training_mode: str = "freq"):
        super(FreqXfmr, self).__init__(enh_transform=enh_transform,
                                       num_spks=num_spks,
                                       training_mode=training_mode)
        self.xfmr = TransformerEncoder(arch,
                                       input_size,
                                       output_proj=num_bins * num_spks,
                                       num_layers=num_layers,
                                       chunk_size=1,
                                       lctx=lctx,
                                       rctx=rctx,
                                       proj="linear",
                                       proj_kwargs=proj_kwargs or {},
                                       pose=pose,
                                       pose_kwargs=pose_kwargs or {},
                                       arch_kwargs=arch_kwargs or {})
        self.mask_act = MaskNonLinear(non_linear, enable="common")

    def _tf_mask(self, feats: torch.Tensor) -> List[torch.Tensor]:
        """feats: N x T x F -> [N x F x T, ...]"""
        out, _ = self.xfmr(feats, None)
        # N x T x S*F -> N x S*F x T
        masks = self.mask_act(out).transpose(1, 2)
        return list(torch.chunk(masks, self.num_spks, 1))

    def mask_predict(self, feats: torch.Tensor) -> torch.Tensor:
        """feats: N x T x F -> masks (S x) N x F x T"""
        masks = torch.stack(self._tf_mask(feats))
        return masks[0] if self.num_spks == 1 else masks
