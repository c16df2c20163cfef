#!/usr/bin/env python
"""Chunk-wise separation outputs stitched back into one signal (the port's
own copy of aps_tpu/eval/sse.py::ChunkStitcher; numpy only)."""

from itertools import permutations
from typing import List

import numpy as np


class ChunkStitcher(object):
    """Stitch chunk-wise separation outputs (continuous speech separation
    style), fixing chunk-to-chunk permutation via overlap distance."""

    def __init__(self, chunk_len: int, lctx: int, rctx: int) -> None:
        self.chunk_len = chunk_len
        self.lctx, self.rctx = lctx, rctx

    def _reorder(self, pred: List[np.ndarray], succ: List[np.ndarray]):
        if self.lctx == 0:
            return succ
        num_streams = len(pred)
        pred_ov = [c[-self.lctx - self.rctx:] for c in pred]
        succ_ov = [c[:self.lctx + self.rctx] for c in succ]
        permu_list = list(permutations(range(num_streams)))
        dists = [
            sum(
                float(np.abs(pred_ov[i] - succ_ov[j]).sum())
                for i, j in enumerate(permu)) for permu in permu_list
        ]
        permu = permu_list[int(np.argmin(dists))]
        return [succ[i] for i in permu]

    def _stitch_one_stream(self, chunks: List[np.ndarray],
                           expected_length: int) -> np.ndarray:
        stream = np.zeros(expected_length, dtype=np.float32)
        for i, chunk in enumerate(chunks):
            chunk = np.asarray(chunk)
            beg = i * self.chunk_len + self.lctx
            if i == 0:
                end = min(beg + self.chunk_len, expected_length)
                stream[:end] = chunk[:end]
            elif i == len(chunks) - 1:
                last_len = min(expected_length - beg,
                               chunk.shape[-1] - self.lctx)
                stream[beg:beg + last_len] = \
                    chunk[self.lctx:self.lctx + last_len]
            else:
                stream[beg:beg + self.chunk_len] = \
                    chunk[self.lctx:self.lctx + self.chunk_len]
        return stream

    def _stitch_multiple_streams(self, chunks: List[List[np.ndarray]],
                                 expected_length: int):
        num_streams = len(chunks[-1])
        stream_chunks = []
        for i, chunk in enumerate(chunks):
            if i:
                chunk = self._reorder(stream_chunks[-1], chunk)
            stream_chunks.append(chunk)
        return [
            self._stitch_one_stream([s[i] for s in stream_chunks],
                                    expected_length)
            for i in range(num_streams)
        ]

    def stitch(self, chunks: List, expected_length: int):
        num_streams = 1
        if isinstance(chunks[-1], (list, tuple)):
            num_streams = len(chunks[-1])
        if num_streams == 1:
            return self._stitch_one_stream(chunks, expected_length)
        return self._stitch_multiple_streams(chunks, expected_length)
