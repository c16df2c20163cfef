#!/usr/bin/env python
"""Chimera++: a mask head and a deep-clustering embedding head on one
recurrent trunk (port of aps_tpu/sse/bss/chimera.py, Chimera
"sse@chimera++").

dpcl_embed(mix) recomputes the trunk from the mixture, as aps_tpu does,
with the trunk's dropout off and the transform in inference mode (aps_tpu
calls it with training False; the trunk stays in training mode, so that
cuDNN's recurrences take a backward on the card); the task "sse@freq_linear_sa" or
"sse@freq_mel_sa" with dpcl_weight > 0 adds its deep-clustering loss."""

from typing import List, Optional

import torch
from torch import nn

from aps_tpu_torch.asr.base.rnn import StackedRNN
from aps_tpu_torch.libs import ApsRegisters
from aps_tpu_torch.sse.base import FreqMaskingSSE, MaskNonLinear


@ApsRegisters.sse.register("sse@chimera++")
class Chimera(FreqMaskingSSE):
    """The trunk (a stacked RNN on the enh transform's features), the masks
    (mask_proj, one a speaker) and the embeddings (dpcl_proj, D a TF bin)."""

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
                 dpcl_embed_size: int = 20,
                 bidirectional: bool = False,
                 mask_non_linear: str = "sigmoid",
                 training_mode: str = "freq"):
        super(Chimera, self).__init__(enh_transform=enh_transform,
                                      num_spks=num_spks,
                                      training_mode=training_mode)
        if num_spks < 1:
            raise ValueError(f"Chimera: num_spks = {num_spks}")
        self.encoder = StackedRNN(input_size, hidden, num_layers=num_layers,
                                  rnn_type=rnn, bidirectional=bidirectional,
                                  dropout=dropout, input_proj=input_proj,
                                  hidden_proj=hidden_proj)
        self.mask_proj = nn.Linear(self.encoder.output_size,
                                   num_spks * num_bins)
        self.dpcl_proj = nn.Linear(self.encoder.output_size,
                                   dpcl_embed_size * num_bins)
        self.dpcl_embed_size = dpcl_embed_size
        self.mask_act = MaskNonLinear(mask_non_linear, enable="positive")

    def _tf_mask(self, feats: torch.Tensor) -> List[torch.Tensor]:
        """feats: N x T x F -> [N x F x T, ...]"""
        # N x T x S*F -> N x S*F x T
        masks = self.mask_proj(self.encoder(feats)).transpose(1, 2)
        masks = self.mask_act(torch.stack(torch.chunk(masks, self.num_spks,
                                                      -2)))
        return list(masks)

    def dpcl_embed(self, mix: torch.Tensor) -> torch.Tensor:
        """mix: N x S -> sigmoid of the unit-norm embeddings N x FT x D."""
        stft, _ = self.enh_transform.encode(mix, None)
        feats = self.enh_transform(stft, training=False)
        # the trunk's dropout off by taking its dropout layer out, not by
        # eval mode: cuDNN's recurrences refuse a backward in eval mode
        drop, self.encoder.drop = self.encoder.drop, None
        try:
            rnn_out = self.encoder(feats)
        finally:
            self.encoder.drop = drop
        N, T, _ = rnn_out.shape
        embed = self.dpcl_proj(rnn_out).reshape(N, T, -1,
                                                self.dpcl_embed_size)
        embed = embed / torch.linalg.vector_norm(embed, dim=-1, keepdim=True)
        # N x T x F x D -> N x FT x D (F major)
        embed = embed.transpose(1, 2).reshape(N, -1, self.dpcl_embed_size)
        return torch.sigmoid(embed)
