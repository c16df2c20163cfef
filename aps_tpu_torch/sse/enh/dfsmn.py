#!/usr/bin/env python
"""Deep FSMN enhancement (port of aps_tpu/sse/enh/dfsmn.py, DFSMN
"sse@dfsmn"): the port's FSMNEncoder on the enh transform's features
predicting one real or complex TF mask a branch. A complex mask is
complex64 (aps_tpu: the pair N x F x T x 2), its real part the first F
outputs of the branch and its imaginary part the next F."""

from typing import List, Optional, Union

import torch
from torch import nn

from aps_tpu_torch.asr.base.encoder import FSMNEncoder
from aps_tpu_torch.libs import ApsRegisters
from aps_tpu_torch.sse.base import FreqMaskingSSE, MaskNonLinear


@ApsRegisters.sse.register("sse@dfsmn")
class DFSMN(FreqMaskingSSE):
    """DFSMN mask estimator."""

    def __init__(self,
                 enh_transform: Optional[nn.Module] = None,
                 dim: int = 1024,
                 num_bins: int = 257,
                 num_branchs: int = 1,
                 num_layers: int = 4,
                 project: int = 512,
                 dropout: float = 0.0,
                 residual: bool = True,
                 lctx: int = 3,
                 rctx: int = 3,
                 norm: str = "BN",
                 dilation: Union[List[int], int] = 1,
                 complex_mask: bool = True,
                 non_linear: str = "relu",
                 training_mode: str = "freq"):
        super(DFSMN, self).__init__(enh_transform=enh_transform,
                                    num_spks=num_branchs,
                                    training_mode=training_mode)
        self.complex_mask = complex_mask
        out = num_bins * num_branchs * (2 if complex_mask else 1)
        self.dfsmn = FSMNEncoder(num_bins, out, dim=dim, norm=norm,
                                 project=project, dropout=dropout,
                                 num_layers=num_layers, residual=residual,
                                 lctx=lctx, rctx=rctx, dilation=dilation)
        self.mask_act = MaskNonLinear(
            "none" if complex_mask else non_linear,
            enable="all" if complex_mask else "common")

    def _tf_mask(self, feats: torch.Tensor) -> List[torch.Tensor]:
        """feats: N x T x F -> [N x F x T (complex for complex_mask), ...]"""
        proj, _ = self.dfsmn(feats, None)
        # N x T x B*F -> N x B*F x T
        masks = torch.chunk(self.mask_act(proj).transpose(1, 2),
                            self.num_spks, 1)
        if self.complex_mask:
            return [torch.complex(*torch.chunk(m, 2, 1)) for m in masks]
        return list(masks)

    def mask_predict(self, feats: torch.Tensor) -> torch.Tensor:
        """feats: N x T x F -> masks (B x) N x F x T"""
        masks = torch.stack(self._tf_mask(feats))
        return masks[0] if self.num_spks == 1 else masks
