#!/usr/bin/env python
"""Transformer decoder, incremental decoding (port of
aps_tpu/asr/transformer/decoder.py: TransformerDecoderLayer.step_token and
TorchTransformerDecoder.prep_memory_kv / init_cache / step_inc).
The teacher-forced full pass comes with the training port."""

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from aps_tpu_torch.asr.base.attention import padding_mask
from aps_tpu_torch.asr.transformer.impl import (LN_EPS, ApsMultiheadAttention,
                                                FeedForward)
from aps_tpu_torch.asr.transformer.pose import get_xfmr_pose


class TransformerDecoderLayer(nn.Module):
    """Self-attn -> cross-attn -> FFN (pre/post norm)."""

    def __init__(self,
                 att_dim: int,
                 nhead: int,
                 feedforward_dim: int = 2048,
                 pre_norm: bool = False,
                 att_dropout: float = 0.1,
                 ffn_dropout: float = 0.1,
                 activation: str = "relu"):
        super(TransformerDecoderLayer, self).__init__()
        self.pre_norm = pre_norm
        self.self_attn = ApsMultiheadAttention(att_dim, nhead,
                                               dropout=att_dropout)
        self.cross_attn = ApsMultiheadAttention(att_dim, nhead,
                                                dropout=att_dropout)
        self.feedforward = FeedForward(att_dim, feedforward_dim,
                                       dropout=ffn_dropout,
                                       activation=activation)
        self.norm1 = nn.LayerNorm(att_dim, eps=LN_EPS)
        self.norm2 = nn.LayerNorm(att_dim, eps=LN_EPS)
        self.norm3 = nn.LayerNorm(att_dim, eps=LN_EPS)
        self.drop = nn.Dropout(ffn_dropout)

    def _cross_ffn(self, tgt, memory, memory_key_padding_mask,
                   memory_kv=None):
        skip = tgt
        if self.pre_norm:
            tgt = self.norm2(tgt)
        att, _ = self.cross_attn(tgt, memory, memory,
                                 key_padding_mask=memory_key_padding_mask,
                                 kv_cache=memory_kv)
        tgt = skip + self.drop(att)
        if not self.pre_norm:
            tgt = self.norm2(tgt)
        skip = tgt
        if self.pre_norm:
            tgt = self.norm3(tgt)
        tgt = skip + self.feedforward(tgt)
        if not self.pre_norm:
            tgt = self.norm3(tgt)
        return tgt

    def step_token(self, tok, hist, t: int, memory, memory_key_padding_mask,
                   memory_kv=None):
        """Incremental decode: ONE token (N x 1 x D) against the layer-input
        history hist (N x Lmax x D, positions [0, t] valid)."""
        N, Lmax = hist.shape[:2]
        pos_pad = torch.arange(Lmax, device=hist.device)[None, :] > t
        pos_pad = pos_pad.expand(N, Lmax)
        skip = tok
        if self.pre_norm:
            q, kv = self.norm1(tok), self.norm1(hist)
        else:
            q, kv = tok, hist
        att, _ = self.self_attn(q, kv, kv, key_padding_mask=pos_pad)
        tgt = skip + att
        if not self.pre_norm:
            tgt = self.norm1(tgt)
        return self._cross_ffn(tgt, memory, memory_key_padding_mask,
                               memory_kv=memory_kv)


class TorchTransformerDecoder(nn.Module):
    """Vanilla transformer decoder stack. Name kept for config parity."""

    def __init__(self,
                 vocab_size: int,
                 pose_kwargs: Optional[Dict] = None,
                 arch_kwargs: Optional[Dict] = None,
                 num_layers: int = 6):
        super(TorchTransformerDecoder, self).__init__()
        arch_kwargs = dict(arch_kwargs or {})
        att_dim = arch_kwargs["att_dim"]
        self.att_dim = att_dim
        self.num_layers = num_layers
        self.pre_norm = arch_kwargs.get("pre_norm", False)
        self.vocab_embed = nn.Embedding(vocab_size, att_dim)
        self.abs_pos_enc = get_xfmr_pose("abs", att_dim,
                                         **(pose_kwargs or {}))
        self.layers = nn.ModuleList([
            TransformerDecoderLayer(**arch_kwargs) for _ in range(num_layers)
        ])
        self.final_norm = nn.LayerNorm(att_dim, eps=LN_EPS) \
            if self.pre_norm else None
        self.output = nn.Linear(att_dim, vocab_size, bias=False)

    def prep_memory_kv(self, memory: torch.Tensor) -> List[Tuple]:
        """Per-layer cross-attention (K, V) of a fixed memory, computed once
        per utterance and passed to step_inc via mem_kv."""
        return [layer.cross_attn.proj_kv(memory, memory)
                for layer in self.layers]

    def init_cache(self, batch: int, max_len: int,
                   device=None) -> torch.Tensor:
        """Per-layer input histories: num_layers x N x Lmax x D."""
        return torch.zeros((self.num_layers, batch, max_len, self.att_dim),
                           device=device)

    def step_inc(self, enc_out, tok, cache, t: int, enc_len=None,
                 mem_kv=None):
        """Incremental step: tok (N,) at position t -> (logits N x V,
        cache). The cache is updated IN PLACE (column t of each layer's
        history), which saves a copy of the whole cache per step; callers
        that need the old cache keep a copy. With mem_kv given, enc_out is
        only read for its frame count and may be per utterance."""
        mem_pad_mask = None if enc_len is None else padding_mask(
            enc_len, enc_out.shape[1])
        x = self.abs_pos_enc(self.vocab_embed(tok[:, None]), t=t)
        for i, layer in enumerate(self.layers):
            cache[i, :, t] = x[:, 0]
            x = layer.step_token(
                x, cache[i], t, enc_out, mem_pad_mask,
                memory_kv=None if mem_kv is None else mem_kv[i])
        out = self.final_norm(x) if self.final_norm is not None else x
        return self.output(out[:, 0]), cache
