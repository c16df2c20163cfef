#!/usr/bin/env python
"""RNN mask estimator for separation and enhancement (port of
aps_tpu/sse/toy.py: ToyRNN, registered as "sse@base_rnn"): the enh
transform's features -> a stacked (B)LSTM -> one TF mask a speaker.

Training mode "freq" returns the masks, "time" the masked mixtures taken
back to waveforms. The masks are N x F x T, real and positive
(MaskNonLinear "positive", clipped at mask_max_clip)."""

from typing import Optional

import torch
from torch import nn

from aps_tpu_torch.asr.base.rnn import StackedRNN
from aps_tpu_torch.libs import ApsRegisters
from aps_tpu_torch.sse.base import FreqMaskingSSE, MaskNonLinear


@ApsRegisters.sse.register("sse@base_rnn")
class ToyRNN(FreqMaskingSSE):
    """RNN mask estimator. Training: mix N x (C) x S -> masks or
    waveforms; inference: (C) x S -> enhanced signal(s)."""

    def __init__(self,
                 enh_transform: Optional[nn.Module] = None,
                 input_size: int = 257,
                 input_proj: int = -1,
                 num_bins: int = 257,
                 num_spks: int = 2,
                 rnn: str = "lstm",
                 num_layers: int = 3,
                 hidden: int = 512,
                 hidden_proj: int = -1,
                 dropout: float = 0.2,
                 bidirectional: bool = False,
                 mask_max_clip: Optional[float] = None,
                 mask_non_linear: str = "sigmoid",
                 training_mode: str = "freq"):
        super(ToyRNN, self).__init__(enh_transform=enh_transform,
                                     num_spks=num_spks,
                                     training_mode=training_mode)
        if num_spks == 1 and mask_non_linear == "softmax":
            raise ValueError("softmax mask invalid when num_spks == 1")
        self.encoder = StackedRNN(input_size,
                                  hidden,
                                  num_layers=num_layers,
                                  rnn_type=rnn,
                                  bidirectional=bidirectional,
                                  dropout=dropout,
                                  input_proj=input_proj,
                                  hidden_proj=hidden_proj)
        self.mask_out = nn.Linear(self.encoder.output_size,
                                  num_bins * num_spks)
        self.non_linear = MaskNonLinear(mask_non_linear,
                                        enable="positive",
                                        vmax=mask_max_clip)

    def _tf_mask(self, feats: torch.Tensor) -> torch.Tensor:
        """feats: N x T x F -> masks: S x N x F x T"""
        # N x T x S*F -> N x S*F x T
        masks = self.mask_out(self.encoder(feats)).transpose(1, 2)
        return self.non_linear(torch.stack(
            torch.chunk(masks, self.num_spks, dim=-2)))

    def mask_predict(self, feats: torch.Tensor) -> torch.Tensor:
        """feats: N x T x F -> masks S x N x F x T"""
        return self._tf_mask(feats)
