#!/usr/bin/env python
"""Beam search for the attention RNN decoder (port of
aps_tpu/asr/beam_search/att.py: beam_search, greedy_search,
beam_search_batch, decoder_rescore), with CTC and LM shallow fusion and
the coverage penalty.

The search is the transformer search's, over N*K flat (utterance x beam) lanes
(transformer.search_one, search_batch and _search_core: CTC fusion through the
CtcScorer, so K4 on CUDA tensors, end detection, the freezing of stalled
utterances), driven by this decoder's steps: the encoder output repeated K
times, the carry (dec_hid, att_ctx, att_ali, proj, logits) gathered to the
parents' lanes after every step. With cov_penalty > 0 the step's alignment
(averaged over the heads of a multi-head attention) is summed into the coverage
of each lane's parent before the carry is gathered, as aps_tpu does (it reads
carry[2] ahead of its _gather_tree), so a lane whose parent moved adds another
beam's alignment. The batched search makes the CTC frames past each length
blank-certain. The single-utterance search runs the encoder output as it is,
where aps_tpu pads it to a frame bucket (as the transformer search)."""

from typing import Dict, List

import numpy as np
import torch

from aps_tpu_torch.asr.beam_search.transformer import (search_batch,
                                                       search_one)


def _gather(tree, idx: torch.Tensor):
    """The lanes idx of every tensor of a nested tuple."""
    if isinstance(tree, (tuple, list)):
        return tuple(_gather(x, idx) for x in tree)
    return tree[idx]


class _RnnSteps(object):
    """The RNN decoder's side of a search over N*K lanes (max_len: the
    transformer decoder's cache length, unused here; dtype is dropped, as
    aps_tpu's RNN search drops it)."""
    coverage = True

    def __init__(self, nnet, enc_out: torch.Tensor, enc_len: torch.Tensor,
                 K: int, max_len: int = 0, dtype: str = "float32"):
        self.nnet = nnet
        self.enc_out = enc_out.repeat_interleave(K, 0)
        self.enc_len = enc_len.repeat_interleave(K)
        self.carry, self.att_cache = nnet.decode_prep(
            self.enc_out, self.enc_out.shape[0], self.enc_len)

    def step(self, tok_prev: torch.Tensor, t: int) -> torch.Tensor:
        pred, self.carry = self.nnet.decode_step(
            tok_prev, self.enc_out, self.carry, self.att_cache, self.enc_len)
        return pred

    def alignment(self) -> torch.Tensor:
        """The last step's alignment, lanes x T (heads averaged)."""
        ali = self.carry[2]
        return ali.mean(1) if ali.dim() == 3 else ali

    def reorder(self, beam_idx: torch.Tensor) -> None:
        self.carry = _gather(self.carry, beam_idx)


def beam_search(nnet, x, **kwargs) -> List[Dict]:
    """Single-utterance beam search (transformer.search_one's arguments)."""
    return search_one(_RnnSteps, nnet, x, **kwargs)


def greedy_search(nnet, x, **kwargs) -> List[Dict]:
    """beam_search with one beam and one hypothesis."""
    kwargs.update(beam_size=1, nbest=1)
    return beam_search(nnet, x, **kwargs)


def beam_search_batch(nnet, batch: List, **kwargs) -> List[List[Dict]]:
    """Batched search over N*K flat lanes (transformer.search_batch's
    arguments)."""
    return search_batch(_RnnSteps, nnet, batch, **kwargs)


def decoder_rescore(ctc_nbest: List[Dict], nnet, enc_out: torch.Tensor,
                    ctc_weight: float = 0,
                    len_norm: bool = True) -> List[Dict]:
    """Rescore CTC nbest hypotheses ({"score", "trans": sos ... eos}) with
    the attention decoder: ctc_weight x the CTC score + the decoder's
    log-probabilities of the tokens after sos, eos included, divided by
    their count with len_norm. enc_out: 1 x T x D."""
    nbest = len(ctc_nbest)
    eos = ctc_nbest[0]["trans"][-1]
    max_len = max(len(h["trans"]) - 1 for h in ctc_nbest)
    tgt = np.full((nbest, max_len), eos, dtype=np.int64)
    for i, h in enumerate(ctc_nbest):
        seq = h["trans"][:-1]
        tgt[i, :len(seq)] = seq
    tgt = torch.from_numpy(tgt).to(enc_out.device)
    with torch.inference_mode():
        enc_rep = enc_out.repeat_interleave(nbest, 0)
        carry, cache = nnet.decode_prep(enc_rep, nbest, None)
        logps = []
        for t in range(max_len):
            pred, carry = nnet.decode_step(tgt[:, t], enc_rep, carry, cache,
                                           None)
            logps.append(torch.log_softmax(pred, -1))
        dec_score = torch.stack(logps, 1).cpu().numpy()
    rescored = []
    for i, hyp in enumerate(ctc_nbest):
        toks = hyp["trans"][1:]
        att_score = sum(float(dec_score[i, n, w]) for n, w in enumerate(toks))
        fusion = hyp["score"] * ctc_weight + att_score
        norm = len(toks) if len_norm else 1
        rescored.append({"score": fusion / norm, "trans": hyp["trans"]})
    return sorted(rescored, key=lambda h: h["score"], reverse=True)
