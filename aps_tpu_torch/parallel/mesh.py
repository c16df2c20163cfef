#!/usr/bin/env python
"""The data axis of aps_tpu/parallel/mesh.py, one process a device.

aps_tpu shards the global batch over the "data" axis of a device mesh
inside one SPMD program. Here every process loads the same global batch
and computes on its own rows: fit_batch_to_mesh drops the remainder rows
as aps_tpu does (its #utt / #tok recompute included), rank_rows takes the
rank's contiguous block of rows (aps_tpu's data sharding) and replicates a
batch smaller than the world, as aps_tpu's trainer does, and sharded_map
runs a search on the rank's rows of a list and gathers every rank's
results in order. The tensor and sequence axes (tp_param_shardings,
seq_sharding) are not part of the port."""

from typing import Callable, Dict, List

import numpy as np
import torch

from aps_tpu_torch import distributed

_ARRAYS = (np.ndarray, torch.Tensor)


def _is_batch_array(val) -> bool:
    return isinstance(val, _ARRAYS) and val.ndim > 0


def _batch_size(egs: Dict) -> int:
    """The smallest leading size of the batch's arrays (also inside the
    lists of a separation batch's references); 0 when there is none."""
    sizes = [v.shape[0] for v in egs.values() if _is_batch_array(v)]
    sizes += [v[0].shape[0] for v in egs.values()
              if isinstance(v, list) and v and _is_batch_array(v[0])]
    return min(sizes) if sizes else 0


def _take(egs: Dict, bsz: int, rows: slice) -> Dict:
    """The rows of every array of leading size bsz (and of each array of a
    list); the rest as it is."""
    out = {}
    for key, val in egs.items():
        if _is_batch_array(val) and val.shape[0] == bsz:
            out[key] = val[rows]
        elif isinstance(val, list) and val and _is_batch_array(val[0]):
            out[key] = [v[rows] for v in val]
        else:
            out[key] = val
    return out


def fit_batch_to_mesh(egs: Dict, multiple: int) -> Dict:
    """Make the batch axis divide `multiple` (the world size) by dropping
    the trailing remainder rows; a batch smaller than `multiple` is left
    as it is (rank_rows replicates it). "#utt" and "#tok" are recomputed
    for the kept rows, as in aps_tpu."""
    bsz = _batch_size(egs)
    keep = (bsz // multiple) * multiple
    if keep in (bsz, 0):
        return egs
    out = _take(egs, bsz, slice(0, keep))
    if "#utt" in out:
        out["#utt"] = keep
    if "#tok" in out and "tgt_len" in egs:
        out["#tok"] = int(np.sum(np.asarray(egs["tgt_len"][:keep]))) + keep
    elif "#tok" in out:
        out["#tok"] = max(1, int(egs["#tok"] * keep / bsz))
    return out


def row_blocks(num_rows: int, world: int) -> List[slice]:
    """Contiguous blocks of rows, one a rank, the first ones a row longer
    when world does not divide num_rows."""
    bounds = np.cumsum([0] + [len(b) for b in np.array_split(
        np.arange(num_rows), world)])
    return [slice(int(b), int(e)) for b, e in zip(bounds[:-1], bounds[1:])]


def rank_rows(egs: Dict, rank: int, world: int) -> Dict:
    """The rows of rank `rank` of `world` ranks (a contiguous block; the
    blocks differ by one row at most when world does not divide the
    batch); a batch smaller than the world whole on every rank."""
    bsz = _batch_size(egs)
    if world == 1 or bsz < world:
        return egs
    return _take(egs, bsz, row_blocks(bsz, world)[rank])


def sharded_map(fn: Callable, batch: List, pad_to: int = -1) -> List:
    """fn(rows, pad_to) on this rank's block of `batch` (a list of arrays
    whose last axis is the length), padded to the global batch's longest
    (or to pad_to when that is longer), so that every rank pads as one
    process would; -> every rank's results, in the batch's order, on
    every rank. A rank whose block is empty (a batch smaller than the
    world) searches nothing. One process: fn(batch, pad_to)."""
    world = distributed.world_size()
    if world == 1:
        return fn(batch, pad_to)
    pad_to = max([pad_to] + [np.shape(x)[-1] for x in batch])
    rows = row_blocks(len(batch), world)[distributed.rank()]
    mine = fn(batch[rows], pad_to) if rows.stop > rows.start else []
    return [out for part in distributed.gather_objects(mine)
            for out in part]
