#!/usr/bin/env python
"""The attention RNN decoder with input feeding and schedule sampling
(port of aps_tpu/asr/base/decoder.py::TorchRNNDecoder).

The attention network is the decoder's child att_net, as in aps_tpu. One
step: the previous token's embedding beside the last context (or, with
input_feeding, the last projection) -> the stacked LSTM -> the attention
over the encoder output -> proj of [decoder output, context] -> ReLU ->
dropout -> pred, the logits. The carry between steps is (dec_hid, att_ctx,
att_ali, proj, prev_logits), as aps_tpu's init_carry gives it.

The teacher-forced loop runs one step a target position in Python (aps_tpu
scans it). With a schedule-sampling rate ssr > 0 it draws one coin a step
for the whole batch, uniform in [0, 1), and feeds the argmax of the
previous step's logits (no gradient through it) in place of the target
where coin < ssr and t > 0, as aps_tpu does. The coins come from the
decoder's `generator` (the trainer sets its own), drawn on the device all
at once, or from the caller (`coins`, To values), which lets a check feed
in aps_tpu's draws. aps_tpu, whose ssr is traced, also draws at ssr 0; no
coin is below 0, so the port skips the draws there."""

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from aps_tpu_torch.asr.base.attention import att_instance
from aps_tpu_torch.asr.base.component import OneHotEmbedding
from aps_tpu_torch.asr.base.rnn import StackedLSTMWithState


class TorchRNNDecoder(nn.Module):
    """RNN decoder over an encoder output of enc_proj features."""

    def __init__(self,
                 enc_proj: int,
                 vocab_size: int,
                 att_type: str = "ctx",
                 att_kwargs: Optional[Dict] = None,
                 rnn: str = "lstm",
                 add_ln: bool = False,
                 num_layers: int = 3,
                 proj_size: int = -1,
                 hidden: int = 512,
                 dropout: float = 0.0,
                 input_feeding: bool = False,
                 onehot_embed: bool = False):
        super(TorchRNNDecoder, self).__init__()
        if onehot_embed:
            self.vocab_embed = OneHotEmbedding(vocab_size)
            embed_dim = vocab_size
        else:
            self.vocab_embed = nn.Embedding(vocab_size, hidden)
            embed_dim = hidden
        self.decoder = StackedLSTMWithState(embed_dim + enc_proj,
                                            hidden,
                                            num_layers=num_layers,
                                            dropout=dropout,
                                            rnn_type=rnn,
                                            layer_norm=add_ln,
                                            proj_size=proj_size)
        self.att_net = att_instance(att_type, enc_proj,
                                    self.decoder.output_size,
                                    **(att_kwargs or {}))
        self.proj = nn.Linear(self.decoder.output_size + enc_proj, enc_proj)
        self.drop = nn.Dropout(dropout)
        self.pred = nn.Linear(enc_proj, vocab_size)
        self.enc_proj = enc_proj
        self.vocab_size = vocab_size
        self.input_feeding = input_feeding
        # the schedule-sampling coins' generator (the trainer sets one on
        # its device); None draws from torch's default generator
        self.generator = None

    def init_carry(self, batch: int, T: int, enc_len=None, device=None,
                   dtype=None) -> Tuple:
        """(dec_hid, att_ctx, att_ali, proj, prev_logits) before the first
        step."""
        zero = lambda n: torch.zeros(batch, n, device=device,  # noqa: E731
                                     dtype=dtype)
        return (self.decoder.init_state(batch, device=device, dtype=dtype),
                zero(self.enc_proj),
                self.att_net.init_ali(batch, T, enc_len, device=device,
                                      dtype=dtype),
                zero(self.enc_proj), zero(self.vocab_size))

    def step(self, out_pre: torch.Tensor, enc_out: torch.Tensor,
             att_ctx: torch.Tensor, dec_hid=None, att_ali=None, proj=None,
             enc_len=None, att_cache=None, emb_pre=None):
        """One prediction step from the previous tokens out_pre (N) (or
        their embeddings emb_pre, N x E) -> (pred N x V, att_ctx, dec_hid,
        att_ali, proj)."""
        if emb_pre is None:
            emb_pre = self.vocab_embed(out_pre)
        feed = proj if self.input_feeding else att_ctx
        dec_out, dec_hid = self.decoder(
            torch.cat([emb_pre, feed], -1)[:, None], state=dec_hid)
        dec_out = dec_out[:, 0]
        att_ali, att_ctx = self.att_net(enc_out, enc_len, dec_out, att_ali,
                                        cache=att_cache)
        proj = self.drop(torch.relu(self.proj(torch.cat([dec_out, att_ctx],
                                                        -1))))
        return self.pred(proj), att_ctx, dec_hid, att_ali, proj

    def draw_coins(self, steps: int, device=None) -> torch.Tensor:
        """One schedule-sampling coin a step, uniform in [0, 1)."""
        if self.generator is not None:
            device = self.generator.device
        return torch.rand(steps, generator=self.generator, device=device)

    def forward(self, enc_pad: torch.Tensor, enc_len: Optional[torch.Tensor],
                tgt_pad: torch.Tensor, schedule_sampling: float = 0,
                coins: Optional[torch.Tensor] = None):
        """Teacher-forced loop. enc_pad: N x Ti x D, tgt_pad: N x To
        (sos-prefixed ids) -> (outs N x To x V, alis N x To x (H x) Ti)."""
        N, T, _ = enc_pad.shape
        To = tgt_pad.shape[-1]
        dev = enc_pad.device
        att_cache = self.att_net.prep(enc_pad)
        dec_hid, att_ctx, att_ali, proj, pred = self.init_carry(
            N, T, enc_len, device=dev, dtype=enc_pad.dtype)
        sample = coins is not None or schedule_sampling > 0
        if sample:
            if coins is None:
                coins = self.draw_coins(To, device=dev)
            # the previous prediction where coin < ssr (never at t = 0)
            use_pred = (coins.to(dev) < schedule_sampling) & \
                (torch.arange(To, device=dev) > 0)
        else:
            # teacher forcing: every position's embedding in one call
            emb = self.vocab_embed(tgt_pad)
        outs, alis = [], []
        for t in range(To):
            if sample:
                tok = torch.where(use_pred[t], pred.detach().argmax(-1),
                                  tgt_pad[:, t])
                emb_t = None
            else:
                tok, emb_t = None, emb[:, t]
            pred, att_ctx, dec_hid, att_ali, proj = self.step(
                tok, enc_pad, att_ctx, dec_hid=dec_hid, att_ali=att_ali,
                proj=proj, enc_len=enc_len, att_cache=att_cache,
                emb_pre=emb_t)
            outs.append(pred)
            alis.append(att_ali)
        return torch.stack(outs, 1), torch.stack(alis, 1)
