#!/usr/bin/env python
"""Tokenizer facade: string sequences <-> id sequences (the port's own
copy of aps_tpu/tokenizer/base.py)."""

from abc import ABC
from typing import Dict, List, Union

from aps_tpu_torch.const import UNK_TOKEN


class TokenizerAbc(ABC):

    def encode(self, utt: Union[str, List[str]]) -> List[str]:
        raise NotImplementedError

    def decode(self, utt: Union[str, List[str]]) -> List[str]:
        raise NotImplementedError


class Tokenizer(TokenizerAbc):
    """Map between token strings and integer ids, with an optional
    sub-tokenizer (word/char/subword) applied first."""

    def __init__(self,
                 vocab_dict: Dict,
                 tokenizer: str = "",
                 tokenizer_kwargs: Dict = {}):
        super(Tokenizer, self).__init__()
        if tokenizer:
            from aps_tpu_torch.libs import aps_tokenizer
            self.tokenizer = aps_tokenizer(tokenizer)(**tokenizer_kwargs)
        else:
            self.tokenizer = None
        self.unk_idx = vocab_dict.get(UNK_TOKEN, None)
        self.str2int = vocab_dict
        self.int2str = {v: k for k, v in vocab_dict.items()}

    def symbol2int(self, sym: str) -> int:
        return self.str2int[sym]

    def int2symbol(self, idx: int) -> str:
        return self.int2str[idx]

    def encode(self, str_seq: List[str]) -> List[int]:
        if self.tokenizer:
            str_seq = self.tokenizer.encode(str_seq)
        if self.unk_idx is None:
            return [self.str2int[c] for c in str_seq]
        return [self.str2int.get(c, self.unk_idx) for c in str_seq]

    def decode(self, int_seq: List[int], unk_sym: str = "<unk>") -> List[str]:
        str_seq = [self.int2str[n] for n in int_seq]
        if self.tokenizer:
            str_seq = self.tokenizer.decode(str_seq)
        if self.unk_idx is not None and unk_sym != UNK_TOKEN:
            return [(s if s != UNK_TOKEN else unk_sym) for s in str_seq]
        return str_seq
