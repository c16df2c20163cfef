#!/usr/bin/env python
"""aps_tpu/parallel/mesh.py, one process a device.

The data axis. aps_tpu shards the global batch over the "data" axis of a
device mesh inside one SPMD program. Here every process loads the same
global batch and computes on its own rows: fit_batch_to_mesh drops the
remainder rows as aps_tpu does (its #utt / #tok recompute included),
rank_rows takes the rank's contiguous block of rows (aps_tpu's data
sharding) and replicates a batch smaller than the world, as aps_tpu's
trainer does, and sharded_map runs a search on the rank's rows of a list
and gathers every rank's results in order.

The model axis (tensor parallelism). The world is data x model ranks,
`tensor_parallel` model ranks a data index, in the order of aps_tpu's
build_mesh: rank r has data index r // tp and model index r % tp
(aps_tpu_torch.distributed.init_model_parallel makes the groups).
tp_param_shardings picks the weights that shard by aps_tpu's rule: a 2-D
leaf whose output dim divides by tp and whose smaller dim is at least
min_dim (256, aps_tpu's default). aps_tpu's Dense kernels are
(in, out) and shard their out dim; the port's nn.Linear weight is (out,
in), so the rule reads it transposed and splits its rows; an embedding's
(V, D) splits D, as aps_tpu's P(None, "model"). aps_tpu shards any 2-D
leaf; the port shards those of nn.Linear and nn.Embedding only (the
column-parallel layers of aps_tpu_torch/parallel/tp.py), and keeps
replicated: biases, norms, convolution kernels (aps_tpu too), the cuDNN
recurrent layers' weights (aps_tpu holds its cells as 2-D Dense kernels
and would shard them) and any other 2-D parameter a module uses directly
(none of the repo's models reaches min_dim there), and a weight tied
between two modules. Keeping a leaf replicated changes no result, only
the memory layout.

The sequence axis (aps_tpu's seq_sharding). With sequence parallelism the
model ranks of a data index split the frames of the frame-local front end
(the STFT and what follows it frame by frame, K1 on the fused path):
frame_block gives a rank its frames, frame_samples the samples they read
(every rank holds the whole waveform, so no halo is exchanged), and the
frames are gathered along time after it (distributed.gather_slices)."""

from typing import Callable, Dict, List, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

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


def rank_rows(egs: Dict, rank: int, world: int, whole_below: int = 0
              ) -> Dict:
    """The rows of rank `rank` of `world` ranks (a contiguous block; the
    blocks differ by one row at most when world does not divide the
    batch); a batch smaller than the world, or than whole_below (under
    tensor parallelism: data x model ranks, where `world` counts the data
    axis), whole on every rank."""
    bsz = _batch_size(egs)
    if world == 1 or bsz < max(world, whole_below):
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


def tp_param_shardings(model: nn.Module, tp: int,
                       min_dim: int = 256) -> Dict[str, int]:
    """The parameters that shard over tp model ranks by aps_tpu's rule
    (module docstring) -> {parameter name: the axis of the port's tensor
    that is split (0 for an nn.Linear weight, 1 for an nn.Embedding
    weight)}; every other parameter stays replicated."""
    if tp <= 1:
        return {}
    owners = {}
    for mod in model.modules():
        for p in mod._parameters.values():
            if p is not None:
                owners[id(p)] = owners.get(id(p), 0) + 1
    out = {}
    for name, mod in model.named_modules():
        if isinstance(mod, nn.Linear):
            axis, split = 0, mod.weight.shape[0]
        elif isinstance(mod, nn.Embedding):
            axis, split = 1, mod.weight.shape[1]
        else:
            continue
        w = mod.weight
        if w.dim() == 2 and split % tp == 0 and min(w.shape) >= min_dim \
                and owners[id(w)] == 1:
            out[f"{name}.weight" if name else "weight"] = axis
    return out


class SeqSplit(NamedTuple):
    """A rank's place on the sequence axis: its model index, the model
    size and the model group."""
    index: int
    size: int
    group: object


def frame_block(num_frames: int, index: int, size: int) -> slice:
    """The frames of model rank `index` of `size` (contiguous blocks, the
    first ones a frame longer when size does not divide num_frames)."""
    return row_blocks(num_frames, size)[index]


def frame_samples(frames: slice, win_length: int, hop: int) -> slice:
    """The samples that frames [start, stop) of a framing of win_length
    samples every hop read."""
    return slice(frames.start * hop, (frames.stop - 1) * hop + win_length)


def split_frames(wav: torch.Tensor, win_length: int, hop: int, center: bool,
                 split: SeqSplit):
    """The samples of a model rank's frames of a waveform ... x S, framed
    every hop samples by win_length (with center: after the reflection
    padding of win_length // 2 each side, as forward_stft pads) ->
    (those samples, contiguous, the rank's frames as a slice, the frame
    count); None
    when there are fewer frames than model ranks (every rank then frames
    the whole waveform)."""
    S = wav.shape[-1]
    pad = win_length // 2 if center else 0
    total = (S + 2 * pad - win_length) // hop + 1
    if total < split.size:
        return None
    if pad:
        wav = F.pad(wav.reshape(-1, 1, S), (pad, pad),
                    mode="reflect").reshape(wav.shape[:-1] + (-1,))
    frames = frame_block(total, split.index, split.size)
    # a copy: the kernels take contiguous rows
    local = wav[..., frame_samples(frames, win_length, hop)].contiguous()
    return local, frames, total


def gather_frames(x: torch.Tensor, axis: int, frames: slice, total: int,
                  group) -> torch.Tensor:
    """Every model rank's frames `frames` of `total` on the time axis
    `axis` (negative) of x -> all frames (complex tensors through their
    real view)."""
    if x.is_complex():
        return torch.view_as_complex(gather_frames(
            torch.view_as_real(x), axis - 1, frames, total, group))
    return distributed.gather_slices(x, axis, frames.start, frames.stop,
                                     total, group)
