#!/usr/bin/env python
"""Decoder attentions of the RNN decoder (port of
aps_tpu/asr/base/attention.py: padding_mask, att_instance and the "dot",
"ctx", "loc", "mhdot", "mhctx" and "mhloc" attentions in AsrAtt).

Each attention gives
  prep(enc_pad)                    -> the encoder projections, made once
                                      an utterance (a dict)
  init_ali(N, T, enc_len)          -> the first alignment: uniform over the
                                      valid frames (N x T, N x H x T for the
                                      multi-head ones)
  forward(enc_pad, enc_len, dec_prev, ali_prev, cache)
                                   -> (alignment, context N x D_enc)
Scores of padded frames take NEG_INF before the softmax. The location
filters F are convolutions over the previous alignment, 2 loc_context + 1
taps, padded loc_context each side: one input channel for "loc", grouped by
head for "mhloc" (flax's feature_group_count, the torch conv's groups). The
multi-head scores' weight w (H x D) is a parameter of aps_tpu's own name
(jax_params)."""

from typing import Dict, Optional

import torch
from torch import nn

from aps_tpu_torch.const import NEG_INF
from aps_tpu_torch.libs import Register

AsrAtt = Register("asr_att")


def padding_mask(vec: torch.Tensor, maxlen: int) -> torch.Tensor:
    """N lengths -> N x maxlen bool mask (True = padding position)."""
    return torch.arange(maxlen, device=vec.device)[None, :] >= vec[:, None]


def att_instance(att_type: str, enc_dim: int, dec_dim: int,
                 **kwargs) -> nn.Module:
    if att_type not in AsrAtt:
        raise RuntimeError(f"Unknown attention type: {att_type}")
    return AsrAtt[att_type](enc_dim=enc_dim, dec_dim=dec_dim, **kwargs)


class Attention(nn.Module):

    def __init__(self, enc_dim: int = 512, dec_dim: int = 512,
                 att_dim: int = 512):
        super(Attention, self).__init__()
        self.enc_dim, self.dec_dim, self.att_dim = enc_dim, dec_dim, att_dim

    @staticmethod
    def _softmax(score: torch.Tensor, enc_len: Optional[torch.Tensor]
                 ) -> torch.Tensor:
        """Softmax over the last axis (T), padded frames masked."""
        if enc_len is not None:
            mask = padding_mask(enc_len, score.shape[-1])
            if score.dim() == 3:
                mask = mask[:, None]
            score = score.masked_fill(mask, NEG_INF)
        return torch.softmax(score, -1)

    def init_ali(self, batch: int, T: int, enc_len=None, device=None,
                 dtype=None) -> torch.Tensor:
        ali = torch.ones(batch, T, device=device, dtype=dtype)
        if enc_len is None:
            return ali / T
        ali = ali.masked_fill(padding_mask(enc_len, T), 0.0)
        return ali / enc_len[:, None]

    def prep(self, enc_pad: torch.Tensor) -> Dict:
        return {}


@AsrAtt.register("dot")
class DotAttention(Attention):
    """Scaled dot attention (LAS-style)."""

    def __init__(self, enc_dim: int = 512, dec_dim: int = 512,
                 att_dim: int = 512, scaled: bool = True):
        super(DotAttention, self).__init__(enc_dim, dec_dim, att_dim)
        self.enc_proj = nn.Linear(enc_dim, att_dim)
        self.dec_proj = nn.Linear(dec_dim, att_dim)
        self.scaled = scaled

    def prep(self, enc_pad):
        return {"enc": self.enc_proj(enc_pad)}

    def forward(self, enc_pad, enc_len, dec_prev, ali_prev, cache=None):
        if cache is None:
            cache = self.prep(enc_pad)
        score = torch.einsum("ntd,nd->nt", cache["enc"],
                             self.dec_proj(dec_prev))
        if self.scaled:
            score = score / (self.att_dim**0.5)
        ali = self._softmax(score, enc_len)
        return ali, torch.einsum("nt,ntd->nd", ali, enc_pad)


@AsrAtt.register("ctx")
class CtxAttention(Attention):
    """Additive (Bahdanau) attention."""

    def __init__(self, enc_dim: int = 512, dec_dim: int = 512,
                 att_dim: int = 512):
        super(CtxAttention, self).__init__(enc_dim, dec_dim, att_dim)
        self.enc_proj = nn.Linear(enc_dim, att_dim)
        self.dec_proj = nn.Linear(dec_dim, att_dim, bias=False)
        self.w = nn.Linear(att_dim, 1, bias=False)

    def prep(self, enc_pad):
        return {"enc": self.enc_proj(enc_pad)}

    def forward(self, enc_pad, enc_len, dec_prev, ali_prev, cache=None):
        if cache is None:
            cache = self.prep(enc_pad)
        sum_part = torch.tanh(cache["enc"] + self.dec_proj(dec_prev)[:, None])
        ali = self._softmax(self.w(sum_part)[..., 0], enc_len)
        return ali, torch.einsum("nt,ntd->nd", ali, enc_pad)


@AsrAtt.register("loc")
class LocAttention(Attention):
    """Location-aware attention: a convolution over the previous
    alignment."""

    def __init__(self, enc_dim: int = 512, dec_dim: int = 512,
                 att_dim: int = 512, conv_channels: int = 10,
                 loc_context: int = 64):
        super(LocAttention, self).__init__(enc_dim, dec_dim, att_dim)
        self.enc_proj = nn.Linear(enc_dim, att_dim)
        self.dec_proj = nn.Linear(dec_dim, att_dim, bias=False)
        self.att = nn.Linear(conv_channels, att_dim, bias=False)
        self.F = nn.Conv1d(1, conv_channels, loc_context * 2 + 1,
                           padding=loc_context)
        self.w = nn.Linear(att_dim, 1, bias=False)

    def prep(self, enc_pad):
        return {"enc": self.enc_proj(enc_pad)}

    def forward(self, enc_pad, enc_len, dec_prev, ali_prev, cache=None):
        if cache is None:
            cache = self.prep(enc_pad)
        if ali_prev is None:
            ali_prev = self.init_ali(enc_pad.shape[0], enc_pad.shape[1],
                                     enc_len, device=enc_pad.device,
                                     dtype=enc_pad.dtype)
        # N x 1 x T -> N x C x T -> N x T x D_att
        att_part = self.att(self.F(ali_prev[:, None]).transpose(1, 2))
        sum_part = torch.tanh(att_part + self.dec_proj(dec_prev)[:, None] +
                              cache["enc"])
        ali = self._softmax(self.w(sum_part)[..., 0], enc_len)
        return ali, torch.einsum("nt,ntd->nd", ali, enc_pad)


class MHAttentionBase(Attention):
    """The multi-head attentions' shared parts: value, key and query
    projections of att_head x att_dim, and the context projection back to
    enc_dim."""

    def __init__(self, enc_dim: int = 512, dec_dim: int = 512,
                 att_dim: int = 512, att_head: int = 4):
        super(MHAttentionBase, self).__init__(enc_dim, dec_dim, att_dim)
        self.att_head = att_head
        self.enc_proj = nn.Linear(enc_dim, att_dim * att_head)
        self.key_proj = nn.Linear(enc_dim, att_dim * att_head, bias=False)
        self.dec_proj = nn.Linear(dec_dim, att_dim * att_head, bias=False)
        self.ctx_proj = nn.Linear(att_dim * att_head, enc_dim)

    def init_ali(self, batch: int, T: int, enc_len=None, device=None,
                 dtype=None) -> torch.Tensor:
        ali = super(MHAttentionBase, self).init_ali(batch, T, enc_len,
                                                    device=device,
                                                    dtype=dtype)
        return ali[:, None].repeat(1, self.att_head, 1)

    def _heads(self, x: torch.Tensor) -> torch.Tensor:
        """N x T x (H*D) -> N x H x T x D."""
        N, T, _ = x.shape
        return x.reshape(N, T, self.att_head, self.att_dim).transpose(1, 2)

    def prep(self, enc_pad):
        return {"value": self._heads(self.enc_proj(enc_pad)),
                "key": self._heads(self.key_proj(enc_pad))}

    def _query(self, dec_prev):
        return self.dec_proj(dec_prev).reshape(-1, self.att_head,
                                               self.att_dim)

    def _ctx(self, ali, value):
        """ali N x H x T, value N x H x T x D -> N x D_enc."""
        ctx = torch.einsum("nht,nhtd->nhd", ali, value)
        return self.ctx_proj(ctx.reshape(ali.shape[0], -1))


@AsrAtt.register("mhdot")
class MHDotAttention(MHAttentionBase):

    def __init__(self, enc_dim: int = 512, dec_dim: int = 512,
                 att_dim: int = 512, att_head: int = 4, scaled: bool = True):
        super(MHDotAttention, self).__init__(enc_dim, dec_dim, att_dim,
                                             att_head)
        self.scaled = scaled

    def forward(self, enc_pad, enc_len, dec_prev, ali_prev, cache=None):
        if cache is None:
            cache = self.prep(enc_pad)
        score = torch.einsum("nhtd,nhd->nht", cache["key"],
                             self._query(dec_prev))
        if self.scaled:
            score = score / (self.att_dim**0.5)
        ali = self._softmax(score, enc_len)
        return ali, self._ctx(ali, cache["value"])


def _lecun_normal(shape, fan_in: int) -> nn.Parameter:
    """flax's lecun_normal: a normal truncated at two standard deviations,
    variance 1 / fan_in."""
    w = torch.empty(shape)
    nn.init.trunc_normal_(w, std=1.0, a=-2.0, b=2.0)
    return nn.Parameter(w * (1.0 / fan_in)**0.5 / 0.87962566103423978)


@AsrAtt.register("mhctx")
class MHCtxAttention(MHAttentionBase):
    jax_params = ("w",)

    def __init__(self, enc_dim: int = 512, dec_dim: int = 512,
                 att_dim: int = 512, att_head: int = 4):
        super(MHCtxAttention, self).__init__(enc_dim, dec_dim, att_dim,
                                             att_head)
        # a grouped 1 x 1 conv, one Dense(1) a head
        self.w = _lecun_normal((att_head, att_dim), att_head)

    def forward(self, enc_pad, enc_len, dec_prev, ali_prev, cache=None):
        if cache is None:
            cache = self.prep(enc_pad)
        sum_part = torch.tanh(cache["key"] + self._query(dec_prev)[:, :, None])
        ali = self._softmax(torch.einsum("nhtd,hd->nht", sum_part, self.w),
                            enc_len)
        return ali, self._ctx(ali, cache["value"])


@AsrAtt.register("mhloc")
class MHLocAttention(MHAttentionBase):
    jax_params = ("w",)

    def __init__(self, enc_dim: int = 512, dec_dim: int = 512,
                 att_dim: int = 512, att_head: int = 4,
                 conv_channels: int = 10, loc_context: int = 64):
        super(MHLocAttention, self).__init__(enc_dim, dec_dim, att_dim,
                                             att_head)
        self.F = nn.Conv1d(att_head, conv_channels * att_head,
                           loc_context * 2 + 1, padding=loc_context,
                           groups=att_head)
        self.att = nn.Linear(conv_channels * att_head, att_dim * att_head,
                             bias=False)
        self.w = _lecun_normal((att_head, att_dim), att_head)

    def forward(self, enc_pad, enc_len, dec_prev, ali_prev, cache=None):
        if cache is None:
            cache = self.prep(enc_pad)
        N, T, _ = enc_pad.shape
        if ali_prev is None:
            ali_prev = self.init_ali(N, T, enc_len, device=enc_pad.device,
                                     dtype=enc_pad.dtype)
        # N x H x T -> N x (C*H) x T -> N x H x T x D_att
        att_part = self._heads(self.att(self.F(ali_prev).transpose(1, 2)))
        sum_part = torch.tanh(cache["key"] + att_part +
                              self._query(dec_prev)[:, :, None])
        ali = self._softmax(torch.einsum("nhtd,hd->nht", sum_part, self.w),
                            enc_len)
        return ali, self._ctx(ali, cache["value"])
