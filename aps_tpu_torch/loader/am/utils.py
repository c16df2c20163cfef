#!/usr/bin/env python
"""Shared AM dataset machinery: token reading/filtering + dataloader (the
port's own copy of aps_tpu/loader/am/utils.py: TokenReader,
CommonASRDataset, asr_egs_collate, CommonASRDataLoader)."""

import warnings
from typing import Dict, List, Optional

import numpy as np

from aps_tpu_torch.const import IGNORE_ID
from aps_tpu_torch.io.base import BaseReader
from aps_tpu_torch.loader.utils import (BatchSampler, SimpleDataLoader, pad_seqs,
                                  quantize_len)
from aps_tpu_torch.tokenizer import Tokenizer


class TokenReader(object):
    """Token/text reader that filters utterances by token count, duration
    and a skip list, sorts long -> short, and (optionally) tokenizes
    on the fly."""

    def __init__(self,
                 text: str,
                 utt2dur: str,
                 vocab_dict: Optional[Dict],
                 tokenizer: str = "",
                 tokenizer_kwargs: Dict = {},
                 max_token_num: int = 400,
                 min_token_num: int = 2,
                 max_dur: float = 3000,
                 min_dur: float = 40,
                 skip_utts: str = ""):
        if vocab_dict:
            self.tokenizer = Tokenizer(vocab_dict,
                                       tokenizer=tokenizer,
                                       tokenizer_kwargs=tokenizer_kwargs)
        else:
            self.tokenizer = None
        self.token_stats = self._pre_process(text,
                                             utt2dur,
                                             max_dur=max_dur,
                                             min_dur=min_dur,
                                             skip_utts=skip_utts,
                                             max_token_num=max_token_num,
                                             min_token_num=min_token_num)
        if len(self.token_stats) < 10:
            raise RuntimeError(
                f"Too few utterances: {len(self.token_stats)}, "
                "please check data configurations")

    def _pre_process(self, text, utt2dur, max_token_num, min_token_num,
                     skip_utts, max_dur, min_dur) -> List[Dict]:
        skip_keys = []
        if skip_utts:
            with open(skip_utts, "r") as fd:
                skip_keys = [k.strip() for k in fd.readlines()]
        dur_reader = BaseReader(utt2dur, value_processor=float)
        if self.tokenizer:
            text_reader = BaseReader(text, num_tokens=-1, restrict=False)
        else:
            text_reader = BaseReader(
                text, value_processor=lambda tok: list(map(int, tok)),
                num_tokens=-1, restrict=False)
        token_stats = []
        dropped = 0
        for key, tokens in text_reader:
            num_toks = len(tokens)
            if num_toks > max_token_num or num_toks < min_token_num:
                dropped += 1
                continue
            if key not in dur_reader:
                dropped += 1
                continue
            if key in skip_keys:
                continue
            dur = dur_reader[key]
            if dur < min_dur or dur > max_dur:
                dropped += 1
                continue
            token_stats.append({
                "key": key, "dur": dur, "len": num_toks, "tok": tokens
            })
        token_stats = sorted(token_stats, key=lambda d: d["dur"], reverse=True)
        if dropped:
            ratio = dropped * 100 / len(text_reader)
            warnings.warn(f"Drop {dropped}({ratio:.2f}%) utterances")
        return token_stats

    def __getitem__(self, index):
        stats = self.token_stats[index]
        if self.tokenizer and "vis" not in stats:
            stats["tok"] = self.tokenizer.encode(stats["tok"])
            stats["vis"] = True
        return stats

    def __len__(self) -> int:
        return len(self.token_stats)


class CommonASRDataset(object):
    """(input reader, token reader) pair for AM training."""

    def __init__(self,
                 input_reader,
                 text: str,
                 utt2dur: str,
                 vocab_dict: Optional[Dict],
                 tokenizer: str = "",
                 tokenizer_kwargs: Dict = {},
                 dur_axis: int = -1,
                 skip_utts: str = "",
                 max_token_num: int = 400,
                 min_token_num: int = 2,
                 max_dur: float = 3000,
                 min_dur: float = 40) -> None:
        self.input_reader = input_reader
        self.token_reader = TokenReader(text,
                                        utt2dur,
                                        vocab_dict,
                                        tokenizer=tokenizer,
                                        tokenizer_kwargs=tokenizer_kwargs,
                                        skip_utts=skip_utts,
                                        max_dur=max_dur,
                                        min_dur=min_dur,
                                        max_token_num=max_token_num,
                                        min_token_num=min_token_num)
        self.dur_axis = dur_axis

    def __getitem__(self, idx: int) -> Dict:
        tok = self.token_reader[idx]
        inp = self.input_reader[tok["key"]]
        return {
            "dur": inp.shape[self.dur_axis],
            "inp": inp,
            "len": tok["len"],
            "ref": tok["tok"]
        }

    def __len__(self) -> int:
        return len(self.token_reader)


def asr_egs_collate(egs: List[Dict],
                    src_quantize=None,
                    tgt_quantize=None) -> Dict:
    """Collate AM egs. Returns the reference egs-dict contract:
    {#utt, #tok, src_pad N x (C) x S, tgt_pad N x T, src_len N, tgt_len N}.
    Sequence axes are padded up to bucket boundaries for shape reuse."""
    src = [np.asarray(eg["inp"]) for eg in egs]
    tgt = [np.asarray(eg["ref"], dtype=np.int64) for eg in egs]
    return {
        "#utt": len(egs),
        "#tok": sum(int(eg["len"]) + 1 for eg in egs),  # +1: sos pad in task
        "src_pad": pad_seqs(src, value=0, axis=-1, len_quantize=src_quantize,
                            dtype=np.float32),
        "tgt_pad": pad_seqs(tgt, value=IGNORE_ID, axis=-1,
                            len_quantize=tgt_quantize),
        "src_len": np.asarray([eg["dur"] for eg in egs], dtype=np.int64),
        "tgt_len": np.asarray([eg["len"] for eg in egs], dtype=np.int64),
    }


class CommonASRDataLoader(SimpleDataLoader):
    """ASR dataloader: adaptive batching + deterministic sharding +
    padding of the sequence axes up to bucket boundaries."""

    def __init__(self,
                 dataset,
                 collate_fn=None,
                 shuffle: bool = True,
                 rank: int = 0,
                 world_size: int = 1,
                 num_workers: int = 0,
                 adapt_dur: float = 800,
                 adapt_token_num: int = 150,
                 batch_mode: str = "adaptive",
                 max_batch_size: int = 32,
                 min_batch_size: int = 4,
                 src_bucket_floor: int = 8000,
                 src_bucket_factor: float = 1.2,
                 tgt_bucket_multiple: int = 8) -> None:
        sampler = BatchSampler(dataset,
                               max_batch_size,
                               shuffle=shuffle,
                               adapt_dur=adapt_dur,
                               batch_mode=batch_mode,
                               rank=rank,
                               world_size=world_size,
                               min_batch_size=min_batch_size,
                               adapt_token_num=adapt_token_num)
        if collate_fn is None:
            src_q = lambda n: quantize_len(n, floor=src_bucket_floor,
                                           factor=src_bucket_factor)
            tgt_q = lambda n: quantize_len(n, multiple=tgt_bucket_multiple,
                                           factor=1.0)
            collate_fn = lambda egs: asr_egs_collate(
                egs, src_quantize=src_q, tgt_quantize=tgt_q)
        super(CommonASRDataLoader, self).__init__(dataset,
                                                  sampler,
                                                  collate_fn,
                                                  num_workers=num_workers)
