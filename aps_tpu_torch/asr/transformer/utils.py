#!/usr/bin/env python
"""Transformer helpers (port of aps_tpu/asr/transformer/utils.py:
digit_shift, prep_sub_mask, get_activation_fn). Batch-first layout."""

import torch
import torch.nn.functional as tf

from aps_tpu.const import NEG_INF


def digit_shift(term: torch.Tensor) -> torch.Tensor:
    """Relative-position trick: ... x L x 2L-1 -> ... x L x L.
    Index [l, s] of the output reads input [l, s - l + L - 1]."""
    *pre, L, X = term.shape
    if L * 2 - 1 != X:
        raise RuntimeError(f"digit_shift expects ... x L x 2L-1, got "
                           f"{tuple(term.shape)}")
    term_pad = tf.pad(term, (1, 0))
    term_pad = term_pad.reshape(*pre, 2 * L, L)
    term = term_pad[..., 1:, :].reshape(*pre, L, 2 * L - 1)
    return term[..., :L]


def prep_sub_mask(num_frames: int, device=None) -> torch.Tensor:
    """Causal (sub-sequence) additive mask: T x T with NEG_INF above the
    diagonal."""
    mask = torch.triu(torch.ones(num_frames, num_frames, device=device),
                      diagonal=1)
    return torch.where(mask == 1, NEG_INF, 0.0).to(torch.float32)


def get_activation_fn(activation: str):
    if activation == "relu":
        return torch.relu
    if activation == "gelu":
        # jax.nn.gelu defaults to the tanh approximation
        return lambda x: tf.gelu(x, approximate="tanh")
    if activation == "swish":
        return tf.silu
    raise RuntimeError(f"activation should be relu/gelu/swish, "
                       f"not {activation}")
