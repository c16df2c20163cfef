#!/usr/bin/env python
"""LM loader helpers (the port's own copy of aps_tpu/loader/lm/utils.py:
filter_utts, concat_data)."""

import warnings
from typing import List

import numpy as np


def filter_utts(dataset,
                min_token_num: int = 4,
                max_token_num: int = 1000) -> List[int]:
    """Indices of utterances whose token count is within bounds."""
    kept = []
    n_short, n_long = 0, 0
    for index in range(len(dataset)):
        tok_len = len(dataset[index])
        if tok_len < min_token_num:
            n_short += 1
        elif tok_len > max_token_num:
            n_long += 1
        else:
            kept.append(index)
    if n_short or n_long:
        warnings.warn(
            f"filter {n_long * 100.0 / len(dataset):.2f}% long & "
            f"{n_short * 100.0 / len(dataset):.2f}% short utterances...")
    return kept


def concat_data(batch_size: int, dataset, sampler, sos: int = 0,
                eos: int = 1) -> np.ndarray:
    """Concatenate <sos> utt <eos> streams and fold into batch_size rows."""
    data = []
    for index in sampler:
        data += ([sos] + list(dataset[index]) + [eos])
    truncated = (len(data) // batch_size) * batch_size
    return np.asarray(data[:truncated],
                      dtype=np.int64).reshape(batch_size, -1)
