#!/usr/bin/env python
"""Streaming transformer / conformer encoder layers with per-layer caches
(port of aps_tpu/streaming_asr/transformer/impl.py:
StreamingRelMultiheadAttention, StreamingTransformerRelEncoderLayer,
StreamingConformerRelEncoderLayer, ApsStreamingTransformerEncoder).

The offline pass (forward) and the chunk-by-chunk pass (step) share the
parameters. The cache is an explicit dict of tensors threaded through
step, as in aps_tpu: each attention layer keeps the projected keys and
values of the last lctx frames of its own input, and a conformer layer
also the last K - 1 outputs of its GLU for its causal depthwise conv, so
step equals the offline pass under the chunk-context mask for any number
of layers.

The attention is dense, in plain torch ops on whatever device the tensors
are on, as aps_tpu's is: the offline pass takes the chunk-context mask and
the step a mask over the cache slots not filled yet, and no hand-written
kernel takes either (the rel-pose flash kernel has no context mask).
step runs with dropout and batch norm as in evaluation; the encoder's
step (streaming_asr/transformer/encoder.py) puts the module in eval mode
around it."""

from typing import Dict, Optional

import torch
from torch import nn

from aps_tpu_torch.asr.base.component import BatchNorm1d
from aps_tpu_torch.asr.transformer.impl import LN_EPS, FeedForward
from aps_tpu_torch.asr.transformer.utils import (digit_shift,
                                                 get_activation_fn)
from aps_tpu_torch.const import MIN_F32


class StreamingRelMultiheadAttention(nn.Module):
    """Shaw relative-position self-attention, offline and cached step.
    Offline: inj_pose is the (2T - 1) x D relative table (digit_shift), the
    caller passes the chunk-context mask. Step: the queries are the C
    frames of the chunk, the keys and values [cache, chunk] (S = lctx + C),
    rel_mat the C x S x D table of their offsets, and `count` the cached
    frames that are valid (right-aligned)."""

    def __init__(self, embed_dim: int, num_heads: int, lctx: int,
                 dropout: float = 0.0):
        super(StreamingRelMultiheadAttention, self).__init__()
        if embed_dim % num_heads != 0:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of "
                             f"num_heads {num_heads}")
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.head_dim = embed_dim // num_heads
        self.lctx = lctx  # frames
        self.in_proj = nn.Linear(embed_dim, 3 * embed_dim)
        self.out_proj = nn.Linear(embed_dim, embed_dim)
        self.attn_drop = nn.Dropout(dropout)

    def _qkv(self, inp: torch.Tensor):
        """N x T x E -> q, k, v: N x T x H x D"""
        N, T = inp.shape[:2]
        return (m.reshape(N, T, self.num_heads, self.head_dim)
                for m in self.in_proj(inp).chunk(3, -1))

    def _context(self, weight: torch.Tensor, v: torch.Tensor):
        context = torch.einsum("nhls,nshd->nlhd", weight, v)
        N, L = context.shape[:2]
        return self.out_proj(context.reshape(N, L, self.embed_dim))

    def forward(self, src: torch.Tensor, inj_pose: torch.Tensor,
                src_mask: Optional[torch.Tensor] = None,
                src_key_padding_mask: Optional[torch.Tensor] = None):
        """src: N x T x E, inj_pose: (2T - 1) x D -> N x T x E."""
        q, k, v = self._qkv(src)
        term_a = torch.einsum("nlhd,nshd->nhls", q, k)
        term_b = torch.einsum("nlhd,sd->nhls", q, inj_pose)
        logit = (term_a + digit_shift(term_b)) / (self.head_dim**0.5)
        if src_key_padding_mask is not None:
            logit = logit.masked_fill(src_key_padding_mask[:, None, None, :],
                                      MIN_F32)
        if src_mask is not None:
            logit = logit + src_mask[None, None]
        weight = self.attn_drop(torch.softmax(logit, -1))
        return self._context(weight, v)

    def init_cache(self, batch: int, device=None) -> Dict:
        shape = (batch, self.lctx, self.num_heads, self.head_dim)
        return {"k": torch.zeros(shape, device=device),
                "v": torch.zeros(shape, device=device)}

    def step(self, chunk: torch.Tensor, rel_mat: torch.Tensor, cache: Dict,
             count: torch.Tensor):
        """chunk: N x C x E, rel_mat: C x S x D, count: 0-d int tensor ->
        (N x C x E, the new cache)."""
        q, k, v = self._qkv(chunk)
        k_full = torch.cat([cache["k"], k], 1)
        v_full = torch.cat([cache["v"], v], 1)
        S = k_full.shape[1]
        term_a = torch.einsum("nlhd,nshd->nhls", q, k_full)
        term_b = torch.einsum("nlhd,lsd->nhls", q, rel_mat)
        logit = (term_a + term_b) / (self.head_dim**0.5)
        # slots [0, lctx - count) hold the zeros of init_cache
        valid = torch.arange(S, device=chunk.device) >= (self.lctx - count)
        logit = torch.where(valid, logit, MIN_F32)
        out = self._context(torch.softmax(logit, -1), v_full)
        return out, {"k": k_full[:, S - self.lctx:],
                     "v": v_full[:, S - self.lctx:]}


class StreamingTransformerRelEncoderLayer(nn.Module):
    """Pre- or post-norm transformer layer on the streaming attention."""

    def __init__(self,
                 att_dim: int,
                 nhead: int,
                 lctx: int,
                 feedforward_dim: int = 2048,
                 att_dropout: float = 0.1,
                 ffn_dropout: float = 0.1,
                 activation: str = "relu",
                 pre_norm: bool = False):
        super(StreamingTransformerRelEncoderLayer, self).__init__()
        self.self_attn = StreamingRelMultiheadAttention(
            att_dim, nhead, lctx, dropout=att_dropout)
        self.norm1 = nn.LayerNorm(att_dim, eps=LN_EPS)
        self.norm2 = nn.LayerNorm(att_dim, eps=LN_EPS)
        self.feedforward = FeedForward(att_dim, feedforward_dim,
                                       dropout=ffn_dropout,
                                       activation=activation)
        self.drop = nn.Dropout(ffn_dropout)
        self.pre_norm = pre_norm

    def _post_attn(self, src, att):
        src = src + self.drop(att)
        if self.pre_norm:
            return src + self.feedforward(self.norm2(src))
        src = self.norm1(src)
        return self.norm2(src + self.feedforward(src))

    def forward(self, src, inj_pose, src_mask=None,
                src_key_padding_mask=None):
        inp = self.norm1(src) if self.pre_norm else src
        return self._post_attn(src, self.self_attn(
            inp, inj_pose, src_mask=src_mask,
            src_key_padding_mask=src_key_padding_mask))

    def init_cache(self, batch: int, device=None) -> Dict:
        return self.self_attn.init_cache(batch, device=device)

    def step(self, chunk, rel_mat, cache, count):
        inp = self.norm1(chunk) if self.pre_norm else chunk
        att, cache = self.self_attn.step(inp, rel_mat, cache, count)
        return self._post_attn(chunk, att), cache


class StreamingConformerRelEncoderLayer(nn.Module):
    """Conformer block (macaron FFN -> attention -> causal conv module ->
    FFN) with the attention's cache and the depthwise conv's: offline the
    conv pads K - 1 zeros on the left, a step prepends the last K - 1 GLU
    outputs instead (zeros at the start, as the padding)."""

    def __init__(self,
                 att_dim: int,
                 nhead: int,
                 lctx: int,
                 feedforward_dim: int = 2048,
                 att_dropout: float = 0.1,
                 ffn_dropout: float = 0.1,
                 kernel_size: int = 15,
                 macaron: bool = True,
                 pre_norm: bool = True,
                 activation: str = "swish"):
        super(StreamingConformerRelEncoderLayer, self).__init__()
        self.self_attn = StreamingRelMultiheadAttention(
            att_dim, nhead, lctx, dropout=att_dropout)
        self.macaron, self.pre_norm = macaron, pre_norm
        self.kernel_size, self.att_dim = kernel_size, att_dim
        if macaron:
            self.norm_ffn1 = nn.LayerNorm(att_dim, eps=LN_EPS)
            self.feedforward1 = FeedForward(att_dim, feedforward_dim,
                                            dropout=ffn_dropout,
                                            activation=activation)
        self.norm_attn = nn.LayerNorm(att_dim, eps=LN_EPS)
        self.norm_conv = nn.LayerNorm(att_dim, eps=LN_EPS)
        self.norm_ffn2 = nn.LayerNorm(att_dim, eps=LN_EPS)
        self.feedforward2 = FeedForward(att_dim, feedforward_dim,
                                        dropout=ffn_dropout,
                                        activation=activation)
        self.pconv1 = nn.Linear(att_dim, att_dim * 2)
        self.dconv = nn.Conv1d(att_dim, att_dim, kernel_size,
                               groups=att_dim)
        self.bn = BatchNorm1d(att_dim, eps=1e-5, momentum=0.1)
        self.pconv2 = nn.Linear(att_dim, att_dim)
        self.act = get_activation_fn(activation)
        self.drop = nn.Dropout(ffn_dropout)

    def _conv_module(self, inp, conv_cache):
        """inp: N x T x E; conv_cache: N x K-1 x E or None (offline: zeros
        on the left) -> (out, the new conv cache)."""
        out = nn.functional.glu(self.pconv1(inp), dim=-1)
        if conv_cache is None:
            padded = nn.functional.pad(out, (0, 0, self.kernel_size - 1, 0))
            new_cache = None
        else:
            padded = torch.cat([conv_cache, out], 1)
            new_cache = padded[:, padded.shape[1] - (self.kernel_size - 1):]
        conv = self.bn(self.dconv(padded.transpose(1, 2))).transpose(1, 2)
        return self.drop(self.pconv2(self.act(conv))), new_cache

    def _block(self, src, attn_fn, conv_cache):
        f = 0.5 if self.macaron else 1
        if self.macaron:
            if self.pre_norm:
                src = self.feedforward1(self.norm_ffn1(src)) * f + src
            else:
                src = self.norm_ffn1(self.feedforward1(src) * f + src)
        inp = self.norm_attn(src) if self.pre_norm else src
        att, attn_cache = attn_fn(inp)
        src = src + self.drop(att)
        if self.pre_norm:
            conv, conv_cache = self._conv_module(self.norm_conv(src),
                                                 conv_cache)
            src = conv + src
            out = self.feedforward2(self.norm_ffn2(src)) * f + src
        else:
            conv, conv_cache = self._conv_module(self.norm_attn(src),
                                                 conv_cache)
            src = self.norm_conv(conv + src)
            out = self.norm_ffn2(self.feedforward2(src) * f + src)
        return out, attn_cache, conv_cache

    def forward(self, src, inj_pose, src_mask=None,
                src_key_padding_mask=None):
        out, _, _ = self._block(src, lambda inp: (self.self_attn(
            inp, inj_pose, src_mask=src_mask,
            src_key_padding_mask=src_key_padding_mask), None), None)
        return out

    def init_cache(self, batch: int, device=None) -> Dict:
        cache = self.self_attn.init_cache(batch, device=device)
        cache["conv"] = torch.zeros((batch, self.kernel_size - 1,
                                     self.att_dim), device=device)
        return cache

    def step(self, chunk, rel_mat, cache, count):
        attn_cache = {"k": cache["k"], "v": cache["v"]}
        out, attn_cache, conv_cache = self._block(
            chunk, lambda inp: self.self_attn.step(inp, rel_mat, attn_cache,
                                                   count), cache["conv"])
        return out, dict(attn_cache, conv=conv_cache)


class ApsStreamingTransformerEncoder(nn.Module):
    """A stack of streaming transformer ("xfmr") or conformer ("cfmr")
    layers (layer_<i>, as aps_tpu names them) and, with pre_norm, a final
    LayerNorm. The step state: {"count": the valid cached frames, "layers":
    one cache a layer}."""

    def __init__(self, arch: str, num_layers: int, lctx: int,
                 arch_kwargs: Optional[Dict] = None):
        super(ApsStreamingTransformerEncoder, self).__init__()
        if arch not in ("xfmr", "cfmr"):
            raise ValueError(f"Unknown streaming encoder arch: {arch}")
        kwargs = dict(arch_kwargs or {})
        att_dim = kwargs.pop("att_dim")
        nhead = kwargs.pop("nhead")
        pre_norm = kwargs.pop("pre_norm", arch == "cfmr")
        layer_cls = StreamingTransformerRelEncoderLayer if arch == "xfmr" \
            else StreamingConformerRelEncoderLayer
        self.layers = []
        for i in range(num_layers):
            layer = layer_cls(att_dim, nhead, lctx, pre_norm=pre_norm,
                              **kwargs)
            self.add_module(f"layer_{i}", layer)
            self.layers.append(layer)
        self.norm = nn.LayerNorm(att_dim, eps=LN_EPS) if pre_norm else None
        self.lctx = lctx

    def forward(self, src, inj_pose, src_mask=None,
                src_key_padding_mask=None):
        out = src
        for layer in self.layers:
            out = layer(out, inj_pose, src_mask=src_mask,
                        src_key_padding_mask=src_key_padding_mask)
        return out if self.norm is None else self.norm(out)

    def init_state(self, batch: int, device=None) -> Dict:
        return {"count": torch.zeros((), dtype=torch.int64, device=device),
                "layers": tuple(layer.init_cache(batch, device=device)
                                for layer in self.layers)}

    def step(self, chunk, rel_mat, state: Dict):
        count, caches, out = state["count"], [], chunk
        for layer, cache in zip(self.layers, state["layers"]):
            out, cache = layer.step(out, rel_mat, cache, count)
            caches.append(cache)
        if self.norm is not None:
            out = self.norm(out)
        count = torch.clamp(count + chunk.shape[1], max=self.lctx)
        return out, {"count": count, "layers": tuple(caches)}
