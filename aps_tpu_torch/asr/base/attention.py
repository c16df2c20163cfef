#!/usr/bin/env python
"""Attention helpers (port of aps_tpu/asr/base/attention.py: padding_mask)."""

import torch


def padding_mask(vec: torch.Tensor, maxlen: int) -> torch.Tensor:
    """N lengths -> N x maxlen bool mask (True = padding position)."""
    return torch.arange(maxlen, device=vec.device)[None, :] >= vec[:, None]
