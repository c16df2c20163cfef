#!/usr/bin/env python
"""Word and character tokenizers (the port's own copy of
aps_tpu/tokenizer/word.py: WordBasedTokenizer, "word", "char")."""

from typing import List, Union

from aps_tpu_torch.libs import ApsRegisters
from aps_tpu_torch.tokenizer.base import TokenizerAbc


class WordBasedTokenizer(TokenizerAbc):
    """Word or character units with word filtering and an optional
    inter-word space symbol."""

    def __init__(self,
                 filter_words: List[str] = [],
                 char: bool = False,
                 space: str = ""):
        super(WordBasedTokenizer, self).__init__()
        self.char = char
        self.space = space
        self.filter_words = filter_words

    def encode(self, utt: Union[str, List[str]]) -> List[str]:
        raw_tokens = utt.split() if isinstance(utt, str) else utt
        kept = []
        for tok in raw_tokens:
            if tok in self.filter_words:
                continue
            kept += list(tok) if self.char else [tok]
            if self.space:
                kept.append(self.space)
        if self.space and kept:
            kept = kept[:-1]
        return kept

    def decode(self, utt: Union[str, List[str]]) -> List[str]:
        enc = utt.split() if isinstance(utt, str) else utt
        if not self.char:
            return enc
        if self.space:
            strs = "".join(enc).replace(self.space, " ")
        else:
            strs = " ".join(enc)
        return strs.split(" ")


@ApsRegisters.tokenizer.register("word")
class WordTokenizer(WordBasedTokenizer):

    def __init__(self, filter_words: List[str] = []):
        super(WordTokenizer, self).__init__(filter_words=filter_words,
                                            char=False, space="")


@ApsRegisters.tokenizer.register("char")
class CharTokenizer(WordBasedTokenizer):

    def __init__(self, filter_words: List[str] = [], space: str = "<space>"):
        super(CharTokenizer, self).__init__(filter_words=filter_words,
                                            char=True, space=space)
