#!/usr/bin/env python
"""Multi-head attention variants and transformer/conformer encoder layers.

Port of aps_tpu/asr/transformer/impl.py (ApsMultiheadAttention,
RelMultiheadAttention [Shaw], XlMultiheadAttention [Transformer-XL],
FeedForward, ApsTransformerEncoderLayer, ApsConformerEncoderLayer,
ApsTransformerEncoder for the six layer names xfmr|cfmr x abs|rel|xl,
get_xfmr_encoder). Batch-first N x T x D; the QKV projection is one fused
(3E, E) Linear.

Which path an attention call takes, as in aps_tpu: an additive attn_mask,
attention dropout that is active (training and dropout > 0) or the
beam-shared kv_cache fold take the dense path (dot_att + context_weight,
plain PyTorch on whatever device the tensors are on) and return (context,
weight). Every other call is eligible for a flash kernel and returns
(context, None):

  - ApsMultiheadAttention itself (abs pose, no inj_pose) runs
    flash_attention. aps_tpu takes its TPU kernel only from 512 query
    frames on, a crossover measured on a TPU that is not carried over: here
    an eligible self-attention (no kv_cache, L == S) takes the kernel at
    any length, and any other eligible call from 512 query frames on, as in
    aps_tpu. So the decoder's cross-attention over a cached memory and its
    one-step self-attention over a history stay on the dense path.
  - RelMultiheadAttention and XlMultiheadAttention run self-attention
    through flash_attention_rel at any length (aps_tpu: from T >= 512, the
    same kind of TPU crossover).

On a CUDA tensor the flash path launches the hand-written kernels, on a CPU
tensor their plain versions; in training the gradient comes from the
backward kernels through the wrappers' autograd Functions. A key padding
mask on the flash path must be a suffix mask (suffix_klen raises
otherwise, where aps_tpu would ignore the mask's holes). The two paths
differ by design on a row without any valid key (k_len 0): the dense
softmax gives a uniform row there, the kernels 0."""

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from aps_tpu_torch.asr.base.component import BatchNorm1d
from aps_tpu_torch.const import MIN_F32
from aps_tpu_torch.asr.transformer.utils import digit_shift, get_activation_fn
from aps_tpu_torch.ops.attention import flash_attention
from aps_tpu_torch.ops.rel_attention import flash_attention_rel

# aps_tpu's LayerNorm epsilon (the JAX default)
LN_EPS = 1e-6
# from this many query frames on an eligible abs-pose call that is not a
# self-attention takes the flash kernel, as in aps_tpu
FLASH_MIN_QUERY_LEN = 512


class ApsMultiheadAttention(nn.Module):
    """Standard MHSA. forward(query N x L x E, key/value N x S x E) ->
    (context N x L x E, weight N x L x S or None)."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0):
        super(ApsMultiheadAttention, self).__init__()
        if embed_dim % num_heads != 0:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of "
                             f"num_heads {num_heads}")
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.dropout = dropout
        self.in_proj = nn.Linear(embed_dim, 3 * embed_dim)
        self.out_proj = nn.Linear(embed_dim, embed_dim)
        self.attn_drop = nn.Dropout(dropout)

    def _split_heads(self, m: torch.Tensor) -> torch.Tensor:
        return m.reshape(m.shape[0], m.shape[1], self.num_heads,
                         self.head_dim)

    def _proj(self, x: torch.Tensor, part: int) -> torch.Tensor:
        """One of the q (0), k (1), v (2) slices of the fused projection."""
        E = self.embed_dim
        return nn.functional.linear(
            x, self.in_proj.weight[part * E:(part + 1) * E],
            self.in_proj.bias[part * E:(part + 1) * E])

    def inp_proj(self, query, key, value):
        """-> q/k/v: N x T x H x D"""
        if query is key and key is value:
            q, k, v = self.in_proj(query).chunk(3, dim=-1)
        else:
            q, k, v = self._proj(query, 0), self._proj(key, 1), \
                self._proj(value, 2)
        return self._split_heads(q), self._split_heads(k), \
            self._split_heads(v)

    def proj_kv(self, key, value):
        """Project K/V only (N x S x H x D), once per fixed memory; the
        decoder passes the result back through `kv_cache` each step."""
        return self._split_heads(self._proj(key, 1)), \
            self._split_heads(self._proj(value, 2))

    def dot_att(self, query, key, inj_pose=None):
        """q: N x L x H x D, k: N x S x H x D -> logit N x H x L x S"""
        return torch.einsum("nlhd,nshd->nhls", query, key)

    def context_weight(self, logit, value, key_padding_mask=None,
                       attn_mask=None):
        """logit: N x H x L x S, value: N x S x H x D."""
        logit = logit / (self.head_dim**0.5)
        if key_padding_mask is not None:
            logit = logit.masked_fill(key_padding_mask[:, None, None, :],
                                      MIN_F32)
        if attn_mask is not None:
            logit = logit + attn_mask[None, None]
        weight = self.attn_drop(torch.softmax(logit, dim=-1))
        context = torch.einsum("nhls,nshd->nlhd", weight, value)
        return context, weight

    def wrap_out(self, context, weight):
        N, L = context.shape[:2]
        context = self.out_proj(context.reshape(N, L, self.embed_dim))
        return context, weight.mean(1)

    def forward(self, query, key, value, inj_pose=None,
                key_padding_mask=None, attn_mask=None, kv_cache=None):
        """kv_cache may be beam-shared: (k, v) with batch Nk < the query
        batch Nq = Nk * G (G beams per utterance, utterance-major lanes).
        The G beams then fold into the query-length axis so the memory is
        read once per utterance, and no attention weights are returned."""
        group = 1
        if kv_cache is not None:
            q = self._split_heads(self._proj(query, 0))
            k, v = kv_cache
            if q.shape[0] != k.shape[0]:
                if q.shape[0] % k.shape[0] != 0:
                    raise ValueError(
                        f"beam-shared kv_cache: query batch {q.shape[0]} "
                        f"not a multiple of kv batch {k.shape[0]}")
                if attn_mask is not None:
                    raise ValueError(
                        "beam-shared kv_cache does not support attn_mask")
                group = q.shape[0] // k.shape[0]
                L = q.shape[1]
                q = q.reshape(k.shape[0], group * L, self.num_heads,
                              self.head_dim)
                if key_padding_mask is not None:
                    # lanes of one utterance share the padding row
                    key_padding_mask = key_padding_mask[::group]
        else:
            q, k, v = self.inp_proj(query, key, value)
        if group == 1 and attn_mask is None and not (
                self.training and self.dropout > 0):
            context = self._flash(q, k, v, inj_pose, key_padding_mask,
                                  kv_cache is None)
            if context is not None:
                N, L = context.shape[:2]
                return self.out_proj(context.reshape(N, L,
                                                     self.embed_dim)), None
        logit = self.dot_att(q, k, inj_pose)
        context, weight = self.context_weight(
            logit, v, key_padding_mask=key_padding_mask, attn_mask=attn_mask)
        if group > 1:
            N, GL = context.shape[:2]
            context = self.out_proj(
                context.reshape(N * group, GL // group, self.embed_dim))
            return context, None
        return self.wrap_out(context, weight)

    def _flash(self, q, k, v, inj_pose, key_padding_mask,
               fresh_kv: bool) -> Optional[torch.Tensor]:
        """The flash path of a call without attn_mask, active dropout or
        beam fold: q N x L x H x D, k/v N x S x H x D -> context N x L x H x
        D, or None when the call takes the dense path after all. fresh_kv:
        k and v were projected by this call (no kv_cache)."""
        if type(self) is not ApsMultiheadAttention or inj_pose is not None:
            return None
        L, S = q.shape[1], k.shape[1]
        if not ((fresh_kv and L == S) or L >= FLASH_MIN_QUERY_LEN):
            return None
        o = flash_attention(q.transpose(1, 2).contiguous(),
                            k.transpose(1, 2).contiguous(),
                            v.transpose(1, 2).contiguous(),
                            k_len=suffix_klen(key_padding_mask))
        return o.transpose(1, 2)


def suffix_klen(key_padding_mask: Optional[torch.Tensor]
                ) -> Optional[torch.Tensor]:
    """Valid key lengths of a suffix padding mask (True = pad). Raises on a
    mask that is not a suffix: the flash kernel only honours k_len, so any
    other mask would be silently ignored. The check reads one flag back
    from the device per call (once per encoder layer)."""
    if key_padding_mask is None:
        return None
    S = key_padding_mask.shape[-1]
    k_len = (~key_padding_mask).sum(-1)
    suffix = torch.arange(S, device=key_padding_mask.device)[None, :] >= \
        k_len[:, None]
    if not torch.equal(suffix, key_padding_mask):
        raise ValueError("key_padding_mask is not a suffix padding mask: "
                         "the flash kernels only take suffix padding")
    return k_len.to(torch.int32)


class RelMultiheadAttention(ApsMultiheadAttention):
    """MHSA with Shaw-style learnt relative-position keys.
    inj_pose: (2L-1) x D relative key embeddings."""

    def dot_att(self, query, key, inj_pose=None):
        term_a = torch.einsum("nlhd,nshd->nhls", query, key)
        term_b = torch.einsum("nlhd,sd->nhls", query, inj_pose)
        return term_a + digit_shift(term_b)

    def _flash(self, q, k, v, inj_pose, key_padding_mask, fresh_kv):
        """Self-attention with the rel scores inside flash_attention_rel
        (q_c = q_p = q, one shared pose table)."""
        if not fresh_kv:
            return None
        check_rel_shapes(q, k, inj_pose)
        qh = q.transpose(1, 2).contiguous()
        o = flash_attention_rel(qh, qh,
                                k.transpose(1, 2).contiguous(),
                                v.transpose(1, 2).contiguous(),
                                inj_pose[None].contiguous(),
                                k_len=suffix_klen(key_padding_mask))
        return o.transpose(1, 2)


def check_rel_shapes(q, k, inj_pose) -> None:
    L = q.shape[1]
    if inj_pose is None or k.shape[1] != L or \
            inj_pose.shape[0] != 2 * L - 1:
        raise ValueError(
            f"rel attention needs self-attention with a (2L-1) pose table: "
            f"L {L}, S {k.shape[1]}, pose "
            f"{None if inj_pose is None else inj_pose.shape[0]}")


class XlMultiheadAttention(ApsMultiheadAttention):
    """MHSA with Transformer-XL relative encodings (rel_u / rel_v biases).
    inj_pose: (2L-1) x E sinusoidal encodings. tie_uv: (rel_u, rel_v)
    parameters shared by the layers and owned by the encoder; without it
    the module owns its pair."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0,
                 tie_uv: Optional[Tuple[nn.Parameter, nn.Parameter]] = None):
        super(XlMultiheadAttention, self).__init__(embed_dim, num_heads,
                                                   dropout=dropout)
        self.rel_proj = nn.Linear(embed_dim, embed_dim, bias=False)
        # a tuple is not registered: the shared pair stays the encoder's
        self.tie_uv = tie_uv
        if tie_uv is None:
            self.rel_u = nn.Parameter(make_rel_uv(num_heads, self.head_dim))
            self.rel_v = nn.Parameter(make_rel_uv(num_heads, self.head_dim))
            self.jax_params = ("rel_u", "rel_v")

    def _uv(self):
        return (self.rel_u, self.rel_v) if self.tie_uv is None \
            else self.tie_uv

    def _rel_pos(self, inj_pose):
        """-> (2L-1) x H x D"""
        return self.rel_proj(inj_pose).reshape(-1, self.num_heads,
                                               self.head_dim)

    def dot_att(self, query, key, inj_pose=None):
        rel_u, rel_v = self._uv()
        term_ac = torch.einsum("nlhd,nshd->nhls", query + rel_u, key)
        term_bd = torch.einsum("nlhd,shd->nhls", query + rel_v,
                               self._rel_pos(inj_pose))
        return term_ac + digit_shift(term_bd)

    def _flash(self, q, k, v, inj_pose, key_padding_mask, fresh_kv):
        """The XL scores inside flash_attention_rel: rel_u / rel_v fold
        into the content and position queries, one projected sinusoid table
        per head."""
        if not fresh_kv:
            return None
        check_rel_shapes(q, k, inj_pose)
        rel_u, rel_v = self._uv()
        o = flash_attention_rel((q + rel_u).transpose(1, 2).contiguous(),
                                (q + rel_v).transpose(1, 2).contiguous(),
                                k.transpose(1, 2).contiguous(),
                                v.transpose(1, 2).contiguous(),
                                self._rel_pos(inj_pose).transpose(
                                    0, 1).contiguous(),
                                k_len=suffix_klen(key_padding_mask))
        return o.transpose(1, 2)


def make_rel_uv(num_heads: int, head_dim: int) -> torch.Tensor:
    """A rel_u / rel_v value, Xavier-uniform as in aps_tpu."""
    return nn.init.xavier_uniform_(torch.empty(num_heads, head_dim))


class FeedForward(nn.Module):
    """FFN: Linear -> act -> Dropout -> Linear -> Dropout."""

    def __init__(self, att_dim: int, feedforward_dim: int,
                 dropout: float = 0.1, activation: str = "relu"):
        super(FeedForward, self).__init__()
        self.linear1 = nn.Linear(att_dim, feedforward_dim)
        self.linear2 = nn.Linear(feedforward_dim, att_dim)
        self.act = get_activation_fn(activation)
        self.drop = nn.Dropout(dropout)

    def forward(self, inp: torch.Tensor) -> torch.Tensor:
        out = self.drop(self.act(self.linear1(inp)))
        return self.drop(self.linear2(out))


class ApsTransformerEncoderLayer(nn.Module):
    """Transformer encoder layer (pre/post norm)."""

    def __init__(self,
                 att_dim: int,
                 self_attn: nn.Module,
                 feedforward_dim: int = 2048,
                 dropout: float = 0.1,
                 activation: str = "relu",
                 pre_norm: bool = False):
        super(ApsTransformerEncoderLayer, self).__init__()
        self.self_attn = self_attn
        self.pre_norm = pre_norm
        self.norm1 = nn.LayerNorm(att_dim, eps=LN_EPS)
        self.norm2 = nn.LayerNorm(att_dim, eps=LN_EPS)
        self.feedforward = FeedForward(att_dim, feedforward_dim,
                                       dropout=dropout,
                                       activation=activation)
        self.drop = nn.Dropout(dropout)

    def forward(self, src, inj_pose=None, src_mask=None,
                src_key_padding_mask=None):
        inp = self.norm1(src) if self.pre_norm else src
        att, _ = self.self_attn(inp, inp, inp, inj_pose=inj_pose,
                                attn_mask=src_mask,
                                key_padding_mask=src_key_padding_mask)
        src = src + self.drop(att)
        if self.pre_norm:
            return src + self.feedforward(self.norm2(src))
        src = self.norm1(src)
        return self.norm2(src + self.feedforward(src))


class ApsConformerEncoderLayer(nn.Module):
    """Conformer block: (macaron FFN) -> MHSA -> conv module -> FFN."""

    def __init__(self,
                 att_dim: int,
                 self_attn: nn.Module,
                 feedforward_dim: int = 2048,
                 dropout: float = 0.1,
                 kernel_size: int = 15,
                 macaron: bool = True,
                 pre_norm: bool = True,
                 casual_conv1d: bool = False,
                 activation: str = "swish"):
        super(ApsConformerEncoderLayer, self).__init__()
        if kernel_size % 2 != 1:
            raise ValueError(f"kernel_size must be odd, got {kernel_size}")
        self.self_attn = self_attn
        self.macaron = macaron
        self.pre_norm = pre_norm
        self.kernel_size = kernel_size
        self.casual_conv1d = casual_conv1d
        self.act = get_activation_fn(activation)
        self.drop = nn.Dropout(dropout)
        self.macaron_factor = 0.5 if macaron else 1
        if macaron:
            self.norm_ffn1 = nn.LayerNorm(att_dim, eps=LN_EPS)
            self.feedforward1 = FeedForward(att_dim, feedforward_dim,
                                            dropout=dropout,
                                            activation=activation)
        self.norm_attn = nn.LayerNorm(att_dim, eps=LN_EPS)
        self.norm_conv = nn.LayerNorm(att_dim, eps=LN_EPS)
        self.norm_ffn2 = nn.LayerNorm(att_dim, eps=LN_EPS)
        self.feedforward2 = FeedForward(att_dim, feedforward_dim,
                                        dropout=dropout,
                                        activation=activation)
        self.pconv1 = nn.Linear(att_dim, att_dim * 2)
        pad = 0 if casual_conv1d else (kernel_size - 1) // 2
        self.dconv = nn.Conv1d(att_dim, att_dim, kernel_size, padding=pad,
                               groups=att_dim)
        self.bn = BatchNorm1d(att_dim, eps=1e-5, momentum=0.1)
        self.pconv2 = nn.Linear(att_dim, att_dim)

    def conv_module(self, inp: torch.Tensor) -> torch.Tensor:
        """pointwise -> GLU -> depthwise -> BN -> act -> pointwise."""
        out = nn.functional.glu(self.pconv1(inp), dim=-1)
        out = out.transpose(1, 2)  # N x C x T
        if self.casual_conv1d:
            out = nn.functional.pad(out, (self.kernel_size - 1, 0))
        out = self.bn(self.dconv(out)).transpose(1, 2)
        return self.drop(self.pconv2(self.act(out)))

    def forward(self, src, inj_pose=None, src_mask=None,
                src_key_padding_mask=None):
        f = self.macaron_factor
        if self.macaron:
            if self.pre_norm:
                src = self.feedforward1(self.norm_ffn1(src)) * f + src
            else:
                src = self.norm_ffn1(self.feedforward1(src) * f + src)
        inp = self.norm_attn(src) if self.pre_norm else src
        att, _ = self.self_attn(inp, inp, inp, inj_pose=inj_pose,
                                attn_mask=src_mask,
                                key_padding_mask=src_key_padding_mask)
        src = src + self.drop(att)
        if self.pre_norm:
            src = self.conv_module(self.norm_conv(src)) + src
            return self.feedforward2(self.norm_ffn2(src)) * f + src
        src = self.conv_module(self.norm_attn(src)) + src
        src = self.norm_conv(src)
        return self.norm_ffn2(self.feedforward2(src) * f + src)


def _make_attn(pose: str, att_dim: int, nhead: int, att_dropout: float,
               tie_uv) -> nn.Module:
    if pose == "abs":
        return ApsMultiheadAttention(att_dim, nhead, dropout=att_dropout)
    if pose == "rel":
        return RelMultiheadAttention(att_dim, nhead, dropout=att_dropout)
    if pose == "xl":
        return XlMultiheadAttention(att_dim, nhead, dropout=att_dropout,
                                    tie_uv=tie_uv)
    raise ValueError(f"Unknown pose for encoder layer: {pose}")


class ApsTransformerEncoder(nn.Module):
    """Stack of transformer ("xfmr") or conformer ("cfmr") encoder layers
    with abs, rel or xl attention (+ final LayerNorm)."""

    def __init__(self, arch: str, pose: str, num_layers: int,
                 arch_kwargs: Optional[Dict] = None,
                 final_norm: bool = False):
        super(ApsTransformerEncoder, self).__init__()
        if arch not in ("xfmr", "cfmr") or pose not in ("abs", "rel", "xl"):
            raise ValueError(f"Unknown type of the encoders: {arch}_{pose}")
        kwargs = dict(arch_kwargs or {})
        att_dim = kwargs.pop("att_dim")
        nhead = kwargs.pop("nhead")
        att_dropout = kwargs.pop("att_dropout", 0.1)
        ffn_dropout = kwargs.pop("ffn_dropout", 0.1)
        pre_norm = kwargs.pop("pre_norm", arch == "cfmr")
        # remat trades training memory for compute; nothing to do here
        kwargs.pop("remat", None)
        tie_uv = None
        if kwargs.pop("tie", False) and pose == "xl":
            # one (rel_u, rel_v) pair for all layers, owned here
            self.rel_u = nn.Parameter(make_rel_uv(nhead, att_dim // nhead))
            self.rel_v = nn.Parameter(make_rel_uv(nhead, att_dim // nhead))
            self.jax_params = ("rel_u", "rel_v")
            tie_uv = (self.rel_u, self.rel_v)
        layer_cls = ApsTransformerEncoderLayer if arch == "xfmr" \
            else ApsConformerEncoderLayer
        self.layers = nn.ModuleList([
            layer_cls(att_dim,
                      _make_attn(pose, att_dim, nhead, att_dropout, tie_uv),
                      dropout=ffn_dropout,
                      pre_norm=pre_norm,
                      **kwargs) for _ in range(num_layers)
        ])
        self.norm = nn.LayerNorm(att_dim, eps=LN_EPS) \
            if final_norm or pre_norm else None

    def forward(self, src, inj_pose=None, src_mask=None,
                src_key_padding_mask=None):
        out = src
        for layer in self.layers:
            out = layer(out, inj_pose=inj_pose, src_mask=src_mask,
                        src_key_padding_mask=src_key_padding_mask)
        if self.norm is not None:
            out = self.norm(out)
        return out


def get_xfmr_encoder(arch: str, pose: str, num_layers: int,
                     arch_kwargs: Dict) -> nn.Module:
    return ApsTransformerEncoder(arch=arch, pose=pose, num_layers=num_layers,
                                 arch_kwargs=arch_kwargs)
