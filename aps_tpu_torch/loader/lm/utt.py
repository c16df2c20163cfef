#!/usr/bin/env python
"""Utterance-level LM dataloader (port of aps_tpu/loader/lm/utt.py,
registered "lm@utt"; the same arguments and egs contract): sos/eos
padding, chunk-sorted adaptive batches. The sharding of the batch order
takes rank and world_size as arguments (aps_tpu reads them from its JAX
processes); the order is shuffled per epoch from the epoch number, as the
port's "am@raw" does."""

import gzip
from typing import Dict, Iterable, Iterator, List, Optional

import numpy as np

from aps_tpu_torch.const import IGNORE_ID
from aps_tpu_torch.libs import ApsRegisters
from aps_tpu_torch.loader.lm.utils import filter_utts
from aps_tpu_torch.loader.utils import (SimpleDataLoader, derive_indices,
                                        pad_seqs, quantize_len)
from aps_tpu_torch.tokenizer import Tokenizer


@ApsRegisters.loader.register("lm@utt")
def DataLoader(text: str = "",
               vocab_dict: Optional[Dict] = None,
               tokenizer: str = "",
               tokenizer_kwargs: Dict = {},
               train: bool = True,
               sos: int = -1,
               eos: int = -1,
               rank: int = 0,
               world_size: int = 1,
               kaldi_format: bool = True,
               chunk_size_for_sort: int = 10000,
               min_token_num: int = 2,
               max_token_num: int = 2000,
               adapt_token_num: int = 400,
               min_batch_size: int = 8,
               max_batch_size: int = 64,
               num_workers: int = 0) -> Iterable[Dict]:
    dataset = Dataset(text,
                      vocab_dict,
                      kaldi_format=kaldi_format,
                      tokenizer=tokenizer,
                      tokenizer_kwargs=tokenizer_kwargs)
    return UttDataLoader(dataset,
                         sos=sos,
                         eos=eos,
                         shuffle=train,
                         max_batch_size=max_batch_size,
                         rank=rank,
                         world_size=world_size,
                         num_workers=num_workers,
                         min_token_num=min_token_num,
                         max_token_num=max_token_num,
                         min_batch_size=min_batch_size,
                         adapt_token_num=adapt_token_num,
                         chunk_size_for_sort=chunk_size_for_sort)


class Dataset(object):
    """Text corpus dataset: one (optionally keyed) utterance per line."""

    def __init__(self,
                 text: str,
                 vocab_dict: Optional[Dict],
                 tokenizer: str = "",
                 tokenizer_kwargs: Dict = {},
                 kaldi_format: bool = True) -> None:
        if vocab_dict:
            self.tokenizer = Tokenizer(vocab_dict,
                                       tokenizer=tokenizer,
                                       tokenizer_kwargs=tokenizer_kwargs)
        else:
            self.tokenizer = None
        self.kaldi_format = kaldi_format
        if text.endswith(".gz"):
            with gzip.open(text, "r") as fd:
                self.token = [line.decode() for line in fd.readlines()]
        else:
            with open(text, "r", encoding="utf-8") as fd:
                self.token = fd.readlines()

    def __getitem__(self, index: int) -> List[int]:
        str_toks = self.token[index].split()
        if self.kaldi_format:
            str_toks = str_toks[1:]
        if self.tokenizer:
            return self.tokenizer.encode(str_toks)
        return list(map(int, str_toks))

    def __len__(self) -> int:
        return len(self.token)


class BatchSampler(object):
    """Chunk-wise length-sorting batch sampler for big LM corpora."""

    def __init__(self,
                 dataset,
                 max_batch_size: int,
                 shuffle: bool = False,
                 rank: int = 0,
                 world_size: int = 1,
                 min_token_num: int = 2,
                 max_token_num: int = 2000,
                 min_batch_size: int = 8,
                 adapt_token_num: int = 400,
                 chunk_size_for_sort: int = 10000) -> None:
        batches = []
        kept_index = filter_utts(dataset,
                                 min_token_num=min_token_num,
                                 max_token_num=max_token_num)
        total = len(kept_index)
        for base in range(0, total, chunk_size_for_sort):
            subset = kept_index[base:base + chunk_size_for_sort]
            batches += self._sort_indices(dataset, subset, max_batch_size,
                                          min_batch_size=min_batch_size,
                                          adapt_token_num=adapt_token_num)
        self.epoch = 0
        self.batches = batches
        self.shuffle = shuffle
        self.rank = rank
        self.world_size = world_size
        self.num_batches = len(batches) // world_size

    def _sort_indices(self, dataset, subset, max_batch_size,
                      min_batch_size=4, adapt_token_num=400):
        toks_len = [len(dataset[i]) for i in subset]
        sort_idx = np.argsort(toks_len)[::-1]
        batches = []
        beg, cur_bz = 0, max_batch_size
        while beg + cur_bz <= len(sort_idx):
            cur_len = toks_len[sort_idx[beg]]
            factor = (cur_len - 1) // adapt_token_num
            cur_bz = int(max(min_batch_size, max_batch_size // (1 + factor)))
            batches.append([subset[i] for i in sort_idx[beg:beg + cur_bz]])
            beg += cur_bz
        return batches

    def __iter__(self) -> Iterator[List[int]]:
        indices = derive_indices(self.num_batches,
                                 seed=self.epoch,
                                 shuffle=self.shuffle,
                                 rank=self.rank,
                                 world_size=self.world_size)
        return iter([self.batches[i] for i in indices])

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        return self.num_batches


class UttDataLoader(SimpleDataLoader):
    """Utterance LM loader: egs {#utt, #tok, src N x T, tgt N x T, len N}."""

    def __init__(self,
                 dataset,
                 sos: int = -1,
                 eos: int = -1,
                 shuffle: bool = True,
                 max_batch_size: int = 64,
                 rank: int = 0,
                 world_size: int = 1,
                 num_workers: int = 0,
                 min_token_num: int = 2,
                 max_token_num: int = 2000,
                 adapt_token_num: int = 400,
                 min_batch_size: int = 8,
                 chunk_size_for_sort: int = 1000) -> None:
        if sos < 0 or eos < 0:
            raise ValueError(f"Invalid sos/eos value: {sos}/{eos}")
        self.sos, self.eos = sos, eos
        sampler = BatchSampler(dataset,
                               max_batch_size,
                               shuffle=shuffle,
                               rank=rank,
                               world_size=world_size,
                               min_token_num=min_token_num,
                               max_token_num=max_token_num,
                               min_batch_size=min_batch_size,
                               adapt_token_num=adapt_token_num,
                               chunk_size_for_sort=chunk_size_for_sort)
        super(UttDataLoader, self).__init__(dataset, sampler,
                                            self.egs_collate,
                                            num_workers=num_workers)

    def egs_collate(self, egs):
        quant = lambda n: quantize_len(n, multiple=8, factor=1.0)
        sos_egs = [np.asarray([self.sos] + list(eg)) for eg in egs]
        egs_eos = [np.asarray(list(eg) + [self.eos]) for eg in egs]
        return {
            "#utt": len(egs),
            "#tok": sum(len(eg) + 1 for eg in egs),
            "src": pad_seqs(sos_egs, value=self.eos, len_quantize=quant),
            "tgt": pad_seqs(egs_eos, value=IGNORE_ID, len_quantize=quant),
            "len": np.asarray([len(eg) + 1 for eg in egs], dtype=np.int64)
        }
