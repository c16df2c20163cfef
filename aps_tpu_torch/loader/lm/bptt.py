#!/usr/bin/env python
"""Truncated-BPTT LM dataloader (port of aps_tpu/loader/lm/bptt.py,
registered "lm@bptt"; the same arguments and egs contract): one continuous
<sos> utt <eos> token stream folded into batch rows, yielded in windows of
bptt_size. The sharding of the utterance order takes rank and world_size
as arguments; the order is shuffled per epoch from the epoch number."""

from typing import Dict, Iterable, Iterator, Optional

import numpy as np

from aps_tpu_torch.libs import ApsRegisters
from aps_tpu_torch.loader.lm.utils import concat_data, filter_utts
from aps_tpu_torch.loader.lm.utt import Dataset
from aps_tpu_torch.loader.utils import derive_indices


@ApsRegisters.loader.register("lm@bptt")
def DataLoader(text: str = "",
               vocab_dict: Optional[Dict] = None,
               tokenizer: str = "",
               tokenizer_kwargs: Dict = {},
               train: bool = True,
               sos: int = -1,
               eos: int = -1,
               bptt_size: int = 100,
               rank: int = 0,
               world_size: int = 1,
               kaldi_format: bool = True,
               min_token_num: int = 2,
               max_token_num: int = 2000,
               max_batch_size: int = 64,
               num_workers: int = 0) -> Iterable[Dict]:
    dataset = Dataset(text,
                      vocab_dict,
                      kaldi_format=kaldi_format,
                      tokenizer=tokenizer,
                      tokenizer_kwargs=tokenizer_kwargs)
    return BpttDataLoader(dataset,
                          max_batch_size,
                          bptt_size=bptt_size,
                          sos=sos,
                          eos=eos,
                          shuffle=train,
                          rank=rank,
                          world_size=world_size,
                          min_token_num=min_token_num,
                          max_token_num=max_token_num)


class SequenceSampler(object):
    """Per-epoch shuffled, rank-strided utterance order."""

    def __init__(self,
                 dataset,
                 shuffle: bool = False,
                 rank: int = 0,
                 world_size: int = 1,
                 min_token_num: int = 2,
                 max_token_num: int = 2000) -> None:
        self.indices = filter_utts(dataset,
                                   min_token_num=min_token_num,
                                   max_token_num=max_token_num)
        self.epoch = 0
        self.shuffle = shuffle
        self.rank = rank
        self.world_size = world_size
        self.num_batches = len(self.indices) // world_size

    def __iter__(self):
        order = derive_indices(self.num_batches,
                               seed=self.epoch,
                               shuffle=self.shuffle,
                               rank=self.rank,
                               world_size=self.world_size)
        return iter([self.indices[i] for i in order])

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        return self.num_batches


class BpttDataLoader(object):

    def __init__(self,
                 dataset,
                 batch_size: int,
                 bptt_size: int = 100,
                 sos: int = -1,
                 eos: int = -1,
                 shuffle: bool = True,
                 rank: int = 0,
                 world_size: int = 1,
                 min_token_num: int = 2,
                 max_token_num: int = 2000) -> None:
        if sos < 0 or eos < 0:
            raise ValueError(f"Invalid sos/eos value: {sos}/{eos}")
        self.sos, self.eos = sos, eos
        self.bptt_size = bptt_size
        self.batch_size = batch_size
        self.dataset = dataset
        self.sampler = SequenceSampler(dataset,
                                       shuffle=shuffle,
                                       rank=rank,
                                       world_size=world_size,
                                       min_token_num=min_token_num,
                                       max_token_num=max_token_num)

    def __iter__(self) -> Iterator[Dict]:
        batch = concat_data(self.batch_size, self.dataset, self.sampler,
                            sos=self.sos, eos=self.eos)
        for t in range(0, batch.shape[-1], self.bptt_size):
            if t + 1 + self.bptt_size > batch.shape[-1]:
                break
            yield {
                "#utt": self.batch_size,
                "#tok": self.batch_size * self.bptt_size,
                "len": np.full((self.batch_size,), self.bptt_size,
                               dtype=np.int64),
                "src": batch[:, t:t + self.bptt_size],
                "tgt": batch[:, t + 1:t + 1 + self.bptt_size],
                "reset": t == 0
            }

    def __len__(self) -> int:
        return 0

    def set_epoch(self, epoch: int) -> None:
        self.sampler.set_epoch(epoch)
