#!/usr/bin/env python
"""N-gram LM for nbest rescoring on the host (the port's own copy of
aps_tpu/asr/lm/ngram.py: ArpaModel, NgramLM). A pure-python ARPA backoff
scorer lets the n-gram path work without the optional kenlm package: text
ARPA models are parsed and scored natively (Katz backoff, the semantics
kenlm implements for query mode); kenlm binaries still require kenlm."""

import math
from typing import Dict, List, Tuple


class ArpaModel(object):
    """Katz-backoff scorer over a text ARPA file.

    logP(w | h) = logp(h, w) if the n-gram exists, else
                  backoff(h) + logP(w | h[1:])   (weights in log10)."""

    def __init__(self, path: str) -> None:
        # (ngram tuple) -> (log10 prob, log10 backoff)
        self.table: Dict[Tuple[str, ...], Tuple[float, float]] = {}
        self.order = 0
        with open(path, encoding="utf-8", errors="replace") as fd:
            section = 0
            for line in fd:
                line = line.strip()
                if not line or line == "\\data\\":
                    continue
                if line == "\\end\\":
                    break
                if line.startswith("\\") and line.endswith("-grams:"):
                    section = int(line[1:].split("-")[0])
                    self.order = max(self.order, section)
                    continue
                if section == 0:
                    continue
                parts = line.split()
                if len(parts) < section + 1:
                    continue
                prob = float(parts[0])
                words = tuple(parts[1:1 + section])
                backoff = float(parts[1 + section]) \
                    if len(parts) > section + 1 else 0.0
                self.table[words] = (prob, backoff)
        if self.order == 0:
            raise ValueError(f"{path}: not an ARPA file (no \\N-grams:)")

    def _logp(self, context: Tuple[str, ...], word: str) -> float:
        """log10 P(word | context) with backoff:
        P(w|h) = p(h,w) if (h,w) listed else b(h) * P(w|h[1:])."""
        total = 0.0
        while True:
            entry = self.table.get(context + (word,))
            if entry is not None:
                return total + entry[0]
            if not context:
                # OOV: treat as <unk> if present, else a hard floor
                unk = self.table.get(("<unk>",))
                return total + (unk[0] if unk is not None else -10.0)
            back = self.table.get(context)
            total += back[1] if back is not None else 0.0
            context = context[1:]

    def score(self, sentence: str, bos: bool = True,
              eos: bool = True) -> float:
        """Full-sentence log10 probability (kenlm.Model.score semantics:
        <s> conditions but is not scored, </s> is scored)."""
        words = sentence.split()
        if eos:
            words = words + ["</s>"]
        context: Tuple[str, ...] = ("<s>",) if bos else ()
        total = 0.0
        for w in words:
            total += self._logp(context[-(self.order - 1):] if
                                self.order > 1 else (), w)
            context = context + (w,)
        return total


def _is_text_arpa(path: str) -> bool:
    try:
        with open(path, "rb") as fd:
            head = fd.read(256)
        return b"\\data\\" in head
    except OSError:
        return False


class NgramLM(object):
    """Query-mode n-gram scorer: kenlm if installed, else the built-in
    ARPA parser for text models."""

    def __init__(self, lm: str, vocab_dict: dict) -> None:
        self.vocab_dict = {v: k for k, v in vocab_dict.items()}
        try:
            import kenlm
            self._model = kenlm.Model(lm)
            self._score10 = self._model.score
        except ImportError:
            if not _is_text_arpa(lm):
                raise ImportError(
                    "binary ngram models require the 'kenlm' package "
                    "(text ARPA files work without it)")
            self._model = ArpaModel(lm)
            self._score10 = self._model.score

    def score(self, hypos: List[int], sos: int = -1, eos: int = -1,
              **kwargs) -> float:
        """Score an id sequence (log10 -> ln to match NN LMs)."""
        sentence = " ".join(self.vocab_dict[i] for i in hypos)
        return self._score10(sentence) * math.log(10)
