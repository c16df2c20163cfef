#!/usr/bin/env python
"""ASR text pre/post processing (the port's own copy of
aps_tpu/eval/asr.py: TextProcess, TextPreProcessor, TextPostProcessor on
the word, char and subword tokenizers)."""

from typing import List

from aps_tpu_torch.conf import load_dict
from aps_tpu_torch.tokenizer import Tokenizer


class TextProcess(object):

    def __init__(self, dict_str: str, space: str = "", spm: str = "") -> None:
        tokenizer_kwargs = {}
        if spm:
            tokenizer = "subword"
            tokenizer_kwargs["spm"] = spm
        elif space:
            tokenizer = "char"
            tokenizer_kwargs["space"] = space
        else:
            tokenizer = "word"
        if dict_str:
            vocab_dict = load_dict(dict_str)
            self.tokenizer = Tokenizer(vocab_dict,
                                       tokenizer=tokenizer,
                                       tokenizer_kwargs=tokenizer_kwargs)
        else:
            self.tokenizer = None


class TextPreProcessor(TextProcess):

    def run(self, str_seq: List[str]) -> List[int]:
        if self.tokenizer:
            return self.tokenizer.encode(str_seq)
        return [int(idx) for idx in str_seq]


class TextPostProcessor(TextProcess):

    def __init__(self, dict_str: str, space: str = "",
                 show_unk: str = "<unk>", spm: str = "") -> None:
        super(TextPostProcessor, self).__init__(dict_str, space=space,
                                                spm=spm)
        self.unk = show_unk

    def run(self, int_seq: List[int]) -> str:
        if self.tokenizer:
            return " ".join(self.tokenizer.decode(int_seq,
                                                  unk_sym=self.unk))
        return " ".join(str(idx) for idx in int_seq)
