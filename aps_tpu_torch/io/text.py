#!/usr/bin/env python
"""Text IO (the port's own copy of what it needs from aps_tpu/io/text.py:
TextReader, io_wrapper)."""

import sys
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


def io_wrapper(io_str: str, mode: str):
    """(is_stdio, fd) for "-" or a path."""
    if io_str == "-":
        return True, (sys.stdout if "w" in mode else sys.stdin)
    return False, open(io_str, mode)
