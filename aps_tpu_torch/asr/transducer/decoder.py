#!/usr/bin/env python
"""Transducer prediction and joint networks (port of
aps_tpu/asr/transducer/decoder.py: DecoderBase with joint,
TorchRNNDecoder, TorchTransformerDecoder with pred and pred_fixed).

The submodules keep aps_tpu's names (vocab_embed, enc_proj, dec_proj,
output, decoder), so aps_tpu_torch.convert maps them. The transformer
prediction net carries a causal attn_mask, so its self-attention takes the
dense path of asr/transformer/impl.py (no flash kernel), as in aps_tpu.
Dropout follows the modules' own training flags."""

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from aps_tpu_torch.asr.base.attention import padding_mask
from aps_tpu_torch.asr.base.component import OneHotEmbedding
from aps_tpu_torch.asr.base.rnn import StackedLSTMWithState
from aps_tpu_torch.asr.transformer.impl import get_xfmr_encoder
from aps_tpu_torch.asr.transformer.pose import get_xfmr_pose
from aps_tpu_torch.asr.transformer.utils import prep_sub_mask


class DecoderBase(nn.Module):
    """The embedding, the encoder and decoder projections and the joint
    network. embed_dim: the embedding's width (the one-hot one's is the
    vocabulary); dec_out_dim: the prediction net's output width."""

    def __init__(self, vocab_size: int, embed_dim: int, dec_out_dim: int,
                 enc_dim: int = 512, jot_dim: int = 512,
                 onehot_embed: bool = False):
        super(DecoderBase, self).__init__()
        self.vocab_size = vocab_size
        if onehot_embed:
            self.vocab_embed = OneHotEmbedding(vocab_size)
        else:
            self.vocab_embed = nn.Embedding(vocab_size, embed_dim)
        self.enc_proj = nn.Linear(enc_dim, jot_dim, bias=False)
        self.dec_proj = nn.Linear(dec_out_dim, jot_dim)
        self.output = nn.Linear(jot_dim, vocab_size, bias=False)

    def joint(self, enc_proj_out: torch.Tensor,
              dec_proj_out: torch.Tensor) -> torch.Tensor:
        """enc: N x Ti x J (or N x J), dec: N x To+1 x J (or N x J) ->
        N x Ti x To+1 x V (or N x V)."""
        if enc_proj_out.dim() == 2:
            add_out = enc_proj_out + dec_proj_out
        else:
            add_out = enc_proj_out[:, :, None] + dec_proj_out[:, None]
        return self.output(torch.tanh(add_out))


class TorchRNNDecoder(DecoderBase):
    """RNN prediction network + joint."""

    def __init__(self,
                 vocab_size: int,
                 embed_size: int = 512,
                 enc_dim: int = 512,
                 dec_dim: int = 512,
                 jot_dim: int = 512,
                 onehot_embed: bool = False,
                 rnn: str = "lstm",
                 num_layers: int = 3,
                 hidden: int = 512,
                 proj_size: int = -1,
                 add_ln: bool = False,
                 dropout: float = 0.0):
        # dec_dim is accepted and read by neither package
        embed_dim = vocab_size if onehot_embed else embed_size
        super(TorchRNNDecoder, self).__init__(
            vocab_size, embed_dim, proj_size if proj_size > 0 else hidden,
            enc_dim=enc_dim, jot_dim=jot_dim, onehot_embed=onehot_embed)
        self.decoder = StackedLSTMWithState(embed_dim,
                                            hidden,
                                            num_layers=num_layers,
                                            dropout=dropout,
                                            rnn_type=rnn,
                                            layer_norm=add_ln,
                                            proj_size=proj_size)

    def forward(self, enc_out: torch.Tensor, tgt_pad: torch.Tensor,
                tgt_len: Optional[torch.Tensor] = None) -> torch.Tensor:
        """enc_out: N x Ti x D, tgt_pad: N x To+1 (blank-prefixed) ->
        N x Ti x To+1 x V."""
        dec_out, _ = self.decoder(self.vocab_embed(tgt_pad))
        return self.joint(self.enc_proj(enc_out), self.dec_proj(dec_out))

    def pred(self, pred_prev: torch.Tensor,
             hidden: Optional[Tuple] = None) -> Tuple[torch.Tensor, Tuple]:
        """One prediction-net step: pred_prev N x 1 -> (dec_out N x J,
        hidden)."""
        dec_out, hidden = self.decoder(self.vocab_embed(pred_prev),
                                       state=hidden)
        return self.dec_proj(dec_out[:, -1]), hidden

    def init_state(self, batch: int, device=None) -> Tuple:
        return self.decoder.init_state(batch, device=device)


class TorchTransformerDecoder(DecoderBase):
    """Transformer prediction network + joint."""

    def __init__(self,
                 vocab_size: int,
                 embed_size: int = 512,
                 enc_dim: int = 512,
                 dec_dim: int = 512,
                 jot_dim: int = 512,
                 onehot_embed: bool = False,
                 att_dim: int = 512,
                 pose_kwargs: Optional[Dict] = None,
                 arch_kwargs: Optional[Dict] = None,
                 num_layers: int = 6):
        # the embedding is att_dim wide, whatever embed_size says
        super(TorchTransformerDecoder, self).__init__(
            vocab_size, vocab_size if onehot_embed else att_dim, att_dim,
            enc_dim=enc_dim, jot_dim=jot_dim, onehot_embed=onehot_embed)
        self.abs_pos_enc = get_xfmr_pose("abs", att_dim,
                                         **(pose_kwargs or {}))
        self.decoder = get_xfmr_encoder("xfmr", "abs", num_layers,
                                        dict(arch_kwargs or {}))

    def forward(self, enc_out: torch.Tensor, tgt_pad: torch.Tensor,
                tgt_len: Optional[torch.Tensor] = None) -> torch.Tensor:
        U = tgt_pad.shape[-1]
        pad_mask = None if tgt_len is None else padding_mask(tgt_len, U)
        emb = self.abs_pos_enc(self.vocab_embed(tgt_pad))
        dec_out = self.decoder(emb,
                               src_mask=prep_sub_mask(U,
                                                      device=emb.device),
                               src_key_padding_mask=pad_mask)
        return self.joint(self.enc_proj(enc_out), self.dec_proj(dec_out))

    def pred(self, pred_prev: torch.Tensor,
             hidden: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """pred_prev: N x 1; hidden: N x T' x E prefix embeddings ->
        (dec_out N x J, the prefix embeddings with this step's)."""
        t = 0 if hidden is None else hidden.shape[1]
        emb = self.abs_pos_enc(self.vocab_embed(pred_prev), t=t)
        hidden = emb if hidden is None else torch.cat([hidden, emb], 1)
        dec_out = self.decoder(hidden, src_mask=prep_sub_mask(
            hidden.shape[1], device=hidden.device))
        return self.dec_proj(dec_out[:, -1]), hidden

    def pred_fixed(self, tokens_buf: torch.Tensor,
                   lengths: torch.Tensor) -> torch.Tensor:
        """The whole N x U token buffer ([blank, emissions...],
        blank-padded) under a causal mask, read at the last valid position
        (index `lengths`) -> N x J."""
        U = tokens_buf.shape[1]
        emb = self.abs_pos_enc(self.vocab_embed(tokens_buf))
        dec_out = self.decoder(emb, src_mask=prep_sub_mask(
            U, device=emb.device))
        idx = lengths.long()[:, None, None].expand(-1, 1, dec_out.shape[-1])
        return self.dec_proj(torch.gather(dec_out, 1, idx)[:, 0])
