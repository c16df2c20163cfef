#!/usr/bin/env python
"""Pure-python BPE subword backend (the port's own copy of
aps_tpu/tokenizer/bpe.py).

The subword pipeline of the original toolkit (utils/subword.sh and its
subword tokenizer) hard-requires the sentencepiece
package; this module provides a self-contained byte-pair-encoding model
with the same piece-string conventions (the U+2581 `▁` word-boundary
marker, `<unk>` surface form) so trained models, encoded corpora and the
SubwordTokenizer API are format-compatible. Models serialize to JSON.

Training is the classic BPE merge loop over the word-frequency table
(Sennrich et al. 2016). Each iteration rescans the distinct-word table —
O(#distinct words) per merge — which is plenty for the recipe-scale
corpora the tools handle (aishell/librispeech transcripts train in
seconds-to-minutes); it is not meant for web-scale corpora.
"""

import json
from collections import Counter
from typing import Dict, Iterable, List, Optional, Tuple, Union

WORD_BOUNDARY = "▁"  # same marker sentencepiece uses
UNK_SURFACE = "<unk>"


def _word_symbols(word: str) -> Tuple[str, ...]:
    """Initial symbol sequence of a word: ▁-prefixed first character."""
    return (WORD_BOUNDARY + word[0],) + tuple(word[1:])


def train_bpe(lines: Iterable[str],
              vocab_size: int = 6000,
              min_pair_freq: int = 2) -> "BpeModel":
    """Learn BPE merges until the piece vocabulary reaches vocab_size (or
    no pair occurs >= min_pair_freq times). lines: raw text sentences."""
    wfreq = Counter()
    for line in lines:
        for w in line.split():
            if w:
                wfreq[w] += 1
    # distinct word -> current symbol split
    splits: Dict[str, Tuple[str, ...]] = {
        w: _word_symbols(w) for w in wfreq
    }
    vocab = set(s for syms in splits.values() for s in syms)
    vocab.add(UNK_SURFACE)
    merges: List[Tuple[str, str]] = []
    while len(vocab) < vocab_size:
        pairs = Counter()
        for w, syms in splits.items():
            f = wfreq[w]
            for a, b in zip(syms, syms[1:]):
                pairs[(a, b)] += f
        if not pairs:
            break
        (a, b), freq = pairs.most_common(1)[0]
        if freq < min_pair_freq:
            break
        merges.append((a, b))
        ab = a + b
        vocab.add(ab)
        for w, syms in splits.items():
            if a not in syms:
                continue
            out = []
            i = 0
            while i < len(syms):
                if i + 1 < len(syms) and syms[i] == a and syms[i + 1] == b:
                    out.append(ab)
                    i += 2
                else:
                    out.append(syms[i])
                    i += 1
            splits[w] = tuple(out)
    return BpeModel(merges, sorted(vocab))


class BpeModel(object):
    """Greedy lowest-rank-first BPE segmenter over learned merges."""

    def __init__(self, merges: List[Tuple[str, str]],
                 vocab: Optional[List[str]] = None) -> None:
        self.merges = [tuple(m) for m in merges]
        self.ranks = {m: i for i, m in enumerate(self.merges)}
        self.vocab = list(vocab) if vocab else None
        self._known = set(self.vocab) if self.vocab else None

    def encode_word(self, word: str) -> List[str]:
        if not word:
            return []
        syms = list(_word_symbols(word))
        while len(syms) > 1:
            best_rank, best_i = None, -1
            for i, pair in enumerate(zip(syms, syms[1:])):
                r = self.ranks.get(pair)
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank, best_i = r, i
            if best_rank is None:
                break
            syms[best_i:best_i + 2] = [syms[best_i] + syms[best_i + 1]]
        if self._known is None:
            return syms
        return [s if s in self._known else UNK_SURFACE for s in syms]

    def encode(self, text: Union[str, List[str]]) -> List[str]:
        words = text.split() if isinstance(text, str) else text
        pieces: List[str] = []
        for w in words:
            pieces += self.encode_word(w)
        return pieces

    def decode(self, pieces: Union[str, List[str]]) -> str:
        if isinstance(pieces, list):
            pieces = "".join(pieces)
        return pieces.replace(WORD_BOUNDARY, " ").strip()

    def save(self, path: str) -> None:
        with open(path, "w") as fd:
            json.dump({"type": "aps_tpu_bpe",
                       "merges": [list(m) for m in self.merges],
                       "vocab": self.vocab}, fd)

    @classmethod
    def load(cls, path: str) -> "BpeModel":
        with open(path) as fd:
            obj = json.load(fd)
        if obj.get("type") != "aps_tpu_bpe":
            raise ValueError(f"{path}: not an aps_tpu BPE model")
        return cls([tuple(m) for m in obj["merges"]], obj.get("vocab"))


def is_bpe_json(path: str) -> bool:
    """True when path holds a JSON BpeModel (vs a sentencepiece binary)."""
    try:
        with open(path, "rb") as fd:
            head = fd.read(256)
        return head.lstrip().startswith(b"{") and b"aps_tpu_bpe" in head
    except OSError:
        return False
