#!/usr/bin/env python
"""Transformer language model (port of aps_tpu/asr/lm/transformer.py,
registered "asr@xfmr_lm"): token embedding, the "abs" sinusoidal
encoding, the port's abs-pose "xfmr" encoder under a causal mask, and the
output layer. hidden carries the embedded prefix (N x T' x D): a call
appends the new tokens' embeddings to it and runs the encoder over the
whole of it.

The causal mask is an additive attn_mask, so the encoder's attention takes
the dense path (plain PyTorch) on every device, as aps_tpu's does: its
flash kernel is for calls without one."""

from typing import Dict, Optional

import torch
from torch import nn

from aps_tpu_torch.asr.base.attention import padding_mask
from aps_tpu_torch.asr.transformer.impl import get_xfmr_encoder
from aps_tpu_torch.asr.transformer.pose import get_xfmr_pose
from aps_tpu_torch.asr.transformer.utils import prep_sub_mask
from aps_tpu_torch.libs import ApsRegisters


@ApsRegisters.asr.register("asr@xfmr_lm")
class TorchXfmrLM(nn.Module):

    def __init__(self,
                 vocab_size: int = 40,
                 num_layers: int = 6,
                 pose_kwargs: Optional[Dict] = None,
                 arch_kwargs: Optional[Dict] = None):
        super(TorchXfmrLM, self).__init__()
        arch_kwargs = dict(arch_kwargs or {})
        att_dim = arch_kwargs["att_dim"]
        self.vocab_size = vocab_size
        self.vocab_embed = nn.Embedding(vocab_size, att_dim)
        self.abs_pos_enc = get_xfmr_pose("abs", att_dim,
                                         **(pose_kwargs or {}))
        self.encoder = get_xfmr_encoder("xfmr", "abs", num_layers,
                                        arch_kwargs)
        self.dist = nn.Linear(att_dim, vocab_size)

    def forward(self, token: torch.Tensor,
                hidden: Optional[torch.Tensor] = None,
                token_len: Optional[torch.Tensor] = None):
        """token: N x T -> (logits N x (T' + T) x V, hidden N x (T' + T)
        x D)."""
        t = 0 if hidden is None else hidden.shape[1]
        emb = self.abs_pos_enc(self.vocab_embed(token), t=t)
        hidden = emb if hidden is None else torch.cat([hidden, emb], 1)
        tgt_mask = prep_sub_mask(hidden.shape[1], device=token.device)
        pad_mask = None if token_len is None else padding_mask(
            token_len, hidden.shape[1])
        enc_out = self.encoder(hidden, src_mask=tgt_mask,
                               src_key_padding_mask=pad_mask)
        return self.dist(enc_out), hidden
