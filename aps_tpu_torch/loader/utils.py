#!/usr/bin/env python
"""Host-side dataloader machinery (the port's own copy of what "am@raw"
needs from aps_tpu/loader/utils.py): deterministic batch order seeded by
the epoch, adaptive batching over a length-sorted dataset, padding of
sequence lengths up to a bucket grid (quantize_len), and an ordered thread
pool of collate workers. Datasets are plain Python objects and batches are
dicts of numpy arrays; the trainer moves them to its device.

Unlike aps_tpu, which reads rank and world size from its JAX process
indices, the sharding of the batch order takes them as explicit arguments
(rank, world_size), so a launcher of several processes passes its own."""

from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Optional

import numpy as np


def derive_indices(num_batches: int,
                   seed: int = 0,
                   shuffle: bool = True,
                   rank: int = 0,
                   world_size: int = 1) -> List[int]:
    """Deterministic (seeded) shuffled batch order; with world_size > 1
    each process takes a rank-strided subset of the global order."""
    num_batches = num_batches * world_size
    if shuffle:
        g = np.random.default_rng(seed)
        indices = g.permutation(num_batches).tolist()
    else:
        indices = list(range(num_batches))
    return indices[rank:num_batches:world_size]


def quantize_len(n: int,
                 floor: int = 1,
                 multiple: int = 1,
                 factor: float = 1.25) -> int:
    """Round n up onto a bounded geometric grid: the smallest value
    >= n of the form ceil(floor * factor^k) rounded up to `multiple`."""
    roundup = lambda x: -(-x // multiple) * multiple
    if factor <= 1.0:
        # plain round-up-to-multiple
        return roundup(max(n, floor))
    v = max(floor, multiple)
    r = roundup(v)
    while r < n:
        v = max(int(v * factor), v + 1)
        r = roundup(v)
    return r


def pad_seqs(seqs: List[np.ndarray],
             value: float = 0,
             axis: int = -1,
             max_len: Optional[int] = None,
             len_quantize: Optional[Callable[[int], int]] = None,
             dtype=None) -> np.ndarray:
    """Stack variable-length arrays into a padded batch along `axis`
    (the sequence axis). Other dims must agree."""
    lens = [s.shape[axis] for s in seqs]
    tgt = max(lens) if max_len is None else max_len
    if len_quantize is not None:
        tgt = len_quantize(tgt)
    out_shape = list(seqs[0].shape)
    out_shape[axis] = tgt
    out = np.full([len(seqs)] + out_shape,
                  value,
                  dtype=dtype or seqs[0].dtype)
    for i, s in enumerate(seqs):
        sl = [slice(None)] * s.ndim
        sl[axis if axis >= 0 else s.ndim + axis] = slice(0, s.shape[axis])
        out[(i, *sl)] = s
    return out


class BatchSampler(object):
    """Adaptive/constraint batch index sampler over a length-sorted dataset.

    adaptive: cur_bz = max(min_bz, max_bz // (1 + factor)),
              factor = max(dur // adapt_dur, (len-1) // adapt_token_num)
    constraint: sum of durations per batch <= max_batch_size."""

    def __init__(self,
                 dataset,
                 max_batch_size: int,
                 shuffle: bool = False,
                 batch_mode: str = "adaptive",
                 adapt_dur: float = 800,
                 adapt_token_num: int = 150,
                 min_batch_size: int = 4,
                 rank: int = 0,
                 world_size: int = 1) -> None:
        if batch_mode not in ("adaptive", "constraint"):
            raise ValueError(f"Unsupported batch mode: {batch_mode}")
        stats = [dataset.token_reader[i] for i in range(len(dataset))]
        if batch_mode == "adaptive":
            batches = self._adapt(stats, adapt_dur, adapt_token_num,
                                  max_batch_size, min_batch_size)
        else:
            batches = self._const(stats, max_batch_size)
        self.epoch = 0
        self.batches = batches
        self.shuffle = shuffle
        self.rank = rank
        self.world_size = world_size
        self.num_batches = len(batches) // self.world_size

    def _const(self, stats, max_batch_size):
        beg, cur_dur, out = 0, 0, []
        if stats and stats[0]["dur"] > max_batch_size:
            raise ValueError("batch_size is smaller than the longest utt")
        for idx, cur in enumerate(stats):
            if cur_dur < max_batch_size:
                cur_dur += cur["dur"]
            else:
                out.append((beg, idx))
                cur_dur = cur["dur"]
                beg = idx
        if len(stats) - beg > 1:
            out.append((beg, len(stats)))
        return out

    def _adapt(self, stats, adapt_dur, adapt_num, max_bz, min_bz):
        beg, out = 0, []
        tot = len(stats)
        while beg < tot:
            cur = stats[beg]
            factor = max(int(cur["dur"] // adapt_dur),
                         (cur["len"] - 1) // adapt_num)
            cur_bz = int(max(min_bz, max_bz // (1 + factor)))
            out.append((beg, min(beg + cur_bz, tot)))
            beg += cur_bz
        return out

    def __iter__(self):
        indices = derive_indices(self.num_batches,
                                 seed=self.epoch,
                                 shuffle=self.shuffle,
                                 rank=self.rank,
                                 world_size=self.world_size)
        for i in indices:
            beg, end = self.batches[i]
            yield list(range(beg, end))

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        return self.num_batches


class SimpleDataLoader(object):
    """Map batches of dataset items through a collate function.
    num_workers <= 0 runs inline; otherwise batches build concurrently on a
    thread pool while the batch order is kept (a bounded window of futures
    in flight). Threads, not processes: the host work (audio decode,
    np.pad/stack collate) releases the GIL."""

    def __init__(self,
                 dataset,
                 sampler,
                 collate_fn: Callable,
                 num_workers: int = 0,
                 prefetch: int = 4):
        self.dataset = dataset
        self.sampler = sampler
        self.collate_fn = collate_fn
        self.num_workers = num_workers
        self.prefetch = max(prefetch, 2)

    def set_epoch(self, epoch: int) -> None:
        if hasattr(self.sampler, "set_epoch"):
            self.sampler.set_epoch(epoch)

    def __len__(self) -> int:
        return len(self.sampler)

    def _build(self, batch_indices):
        return self.collate_fn([self.dataset[i] for i in batch_indices])

    def __iter__(self):
        if self.num_workers <= 0:
            for batch_indices in self.sampler:
                yield self._build(batch_indices)
            return
        window = self.num_workers + self.prefetch
        with ThreadPoolExecutor(max_workers=self.num_workers) as ex:
            pending = deque()
            try:
                for batch_indices in self.sampler:
                    pending.append(ex.submit(self._build, batch_indices))
                    if len(pending) >= window:
                        yield pending.popleft().result()
                while pending:
                    yield pending.popleft().result()
            finally:
                for f in pending:  # consumer bailed early / worker raised
                    f.cancel()
