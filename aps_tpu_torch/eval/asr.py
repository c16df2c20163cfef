#!/usr/bin/env python
"""Id sequence -> text (port of aps_tpu/eval/asr.py::TextPostProcessor with
the word and char tokenizers of aps_tpu/tokenizer/word.py)."""

from typing import List

from aps_tpu.conf import load_dict
from aps_tpu.const import UNK_TOKEN


class TextPostProcessor(object):

    def __init__(self, dict_str: str, space: str = "",
                 show_unk: str = "<unk>", spm: str = "") -> None:
        if spm:
            raise NotImplementedError("sentencepiece detokenisation is not "
                                      "ported yet")
        self.space = space
        self.unk = show_unk
        self.int2str = None
        if dict_str:
            vocab = load_dict(dict_str)
            self.int2str = {v: k for k, v in vocab.items()}
            self.has_unk = UNK_TOKEN in vocab

    def run(self, int_seq: List[int]) -> str:
        if self.int2str is None:
            return " ".join(str(idx) for idx in int_seq)
        toks = [self.int2str[n] for n in int_seq]
        if self.space:
            # char units with an explicit word separator
            toks = "".join(toks).replace(self.space, " ").split(" ")
        if self.has_unk and self.unk != UNK_TOKEN:
            toks = [self.unk if s == UNK_TOKEN else s for s in toks]
        return " ".join(toks)
