#!/usr/bin/env python
"""Word tokenizer (the port's own copy of the "word" tokenizer of
aps_tpu/tokenizer/word.py; its character tokenizer is not ported yet)."""

from typing import List, Union

from aps_tpu_torch.libs import ApsRegisters
from aps_tpu_torch.tokenizer.base import TokenizerAbc


@ApsRegisters.tokenizer.register("word")
class WordTokenizer(TokenizerAbc):
    """Word units, with word filtering."""

    def __init__(self, filter_words: List[str] = []):
        super(WordTokenizer, self).__init__()
        self.filter_words = filter_words

    def encode(self, utt: Union[str, List[str]]) -> List[str]:
        raw_tokens = utt.split() if isinstance(utt, str) else utt
        return [tok for tok in raw_tokens if tok not in self.filter_words]

    def decode(self, utt: Union[str, List[str]]) -> List[str]:
        return utt.split() if isinstance(utt, str) else utt
