#!/usr/bin/env python
"""Text IO (the port's own copy of what it needs from aps_tpu/io/text.py:
TextReader, NbestReader, io_wrapper)."""

import sys
from collections import defaultdict
from typing import List

from aps_tpu_torch.io.base import BaseReader


class TextReader(BaseReader):
    """Reader for kaldi text files: "key word1 word2 ..."."""

    def __init__(self, text: str, char: bool = False):
        super(TextReader, self).__init__(text, num_tokens=-1)
        self.char = char

    def _load(self, key) -> List[str]:
        words = self.index_dict[key]
        if self.char:
            chars = []
            for w in words:
                chars += list(w)
            return chars
        return list(words)


class NbestReader(object):
    """Reader of the nbest hypothesis files that decode.py writes:

        <nbest>
        key1
        score-1 num-tokens-1 hyp-1
        ...
    """

    def __init__(self, nbest: str):
        self.nbest, self.hypos = self._load_nbest(nbest)

    def __len__(self) -> int:
        return len(self.hypos)

    def __iter__(self):
        return iter(self.hypos.items())

    def _load_nbest(self, nbest: str):
        hypos = defaultdict(list)
        with open(nbest, "r", encoding="utf-8") as f:
            nbest_sz = int(f.readline().strip())
            while True:
                key = f.readline().strip()
                if not key:
                    break
                for _ in range(nbest_sz):
                    toks = f.readline().strip().split()
                    score = float(toks[0])
                    num_tokens = int(toks[1])
                    trans = " ".join(toks[2:])
                    hypos[key].append((score, num_tokens, trans))
        return nbest_sz, hypos


def io_wrapper(io_str: str, mode: str):
    """(is_stdio, fd) for "-" or a path."""
    if io_str == "-":
        return True, (sys.stdout if "w" in mode else sys.stdin)
    return False, open(io_str, mode)
