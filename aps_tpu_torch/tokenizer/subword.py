#!/usr/bin/env python
"""Subword (word-piece) tokenizer (the port's own copy of
aps_tpu/tokenizer/subword.py). Two backends: a trained sentencepiece model
(when that package is installed) or the built-in pure-python BPE model
(aps_tpu_torch/tokenizer/bpe.py, JSON files); both produce ▁-marked piece
strings."""

from typing import List, Union

from aps_tpu_torch.libs import ApsRegisters
from aps_tpu_torch.tokenizer.base import TokenizerAbc
from aps_tpu_torch.tokenizer.bpe import BpeModel, is_bpe_json


@ApsRegisters.tokenizer.register("subword")
class SubwordTokenizer(TokenizerAbc):
    """Word-piece tokenizer backed by a trained subword model."""

    def __init__(self, spm: str = "", filter_words: List[str] = []):
        super(SubwordTokenizer, self).__init__()
        if not spm:
            raise ValueError("SubwordTokenizer: pass spm=/path/to/model")
        if is_bpe_json(spm):
            self.bpe_mdl = BpeModel.load(spm)
            self.sp_mdl = None
        else:
            try:
                import sentencepiece as sp
            except ImportError as e:
                raise ImportError(
                    "SubwordTokenizer: the model is not a built-in BPE "
                    "JSON and the 'sentencepiece' package is not "
                    "installed (train a JSON model with utils/subword.sh "
                    "to go dependency-free)") from e
            self.sp_mdl = sp.SentencePieceProcessor(model_file=spm)
            self.bpe_mdl = None
        self.filter_words = filter_words

    def encode(self, utt: Union[str, List[str]]) -> List[str]:
        if isinstance(utt, list):
            utt = " ".join([t for t in utt if t not in self.filter_words])
        if self.sp_mdl is not None:
            return self.sp_mdl.encode(utt, out_type=str)
        return self.bpe_mdl.encode(utt)

    def decode(self, utt: Union[str, List[str]]) -> List[str]:
        if isinstance(utt, str):
            utt = utt.split()
        if self.sp_mdl is not None:
            return self.sp_mdl.decode(utt).split()
        return self.bpe_mdl.decode(utt).split()
