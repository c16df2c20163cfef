#!/usr/bin/env python
"""CTC scoring and decoding (port of aps_tpu/asr/beam_search/ctc.py:
CtcScorer, the prefix scorer for joint CTC/attention beam search, the eq.
51-53 gamma recursions of "Hybrid CTC/Attention Architecture for End-to-End
Speech Recognition"; and CtcApi, the prefix beam search and the Viterbi
alignment of a CTC model).

Every CtcScorer step runs through ctc_score_step (aps_tpu_torch.ops.
ctc_score): the CUDA kernel for CUDA tensors, its plain version for CPU
tensors. The bookkeeping around it (initial state, candidate gathers, beam
reorder) is plain PyTorch. CtcApi is aps_tpu's host loop in numpy, over the
log-softmax of the logits, formed where the logits are (on the card) and
read back once an utterance."""

from collections import defaultdict
from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from aps_tpu_torch.const import MIN_F32
from aps_tpu_torch.ops.ctc_score import ctc_score_step


class CtcScoreState(NamedTuple):
    gamma_n: torch.Tensor  # T x lanes
    gamma_b: torch.Tensor  # T x lanes
    score: torch.Tensor    # lanes


class CtcScorer(object):
    """Functional CTC prefix scorer over N*beam flat lanes (utterance-major:
    lane u*beam + k is beam k of utterance u). blank = V - 1."""

    def __init__(self, ctc_prob: torch.Tensor, eos: int,
                 beam_size: int) -> None:
        """ctc_prob: N x T x V logits."""
        logp = torch.log_softmax(ctc_prob.to(torch.float32), dim=-1)
        # stored (T, N, V): the candidate gather yields (T, lanes) directly
        self.logp = logp.transpose(0, 1).contiguous()
        self.T, self.N, self.V = self.logp.shape
        self.eos = eos
        self.blank = self.V - 1
        self.beam = beam_size

    @property
    def lanes(self) -> int:
        return self.N * self.beam

    def init_state(self) -> CtcScoreState:
        gamma_n = torch.full((self.T, self.lanes), MIN_F32,
                             device=self.logp.device)
        gamma_b0 = torch.cumsum(self.logp[:, :, self.blank], dim=0)
        gamma_b = gamma_b0.repeat_interleave(self.beam, dim=1)
        return CtcScoreState(gamma_n, gamma_b,
                             torch.zeros(self.lanes, device=self.logp.device))

    def _gather_cand(self, cand: torch.Tensor) -> torch.Tensor:
        """log p(t, cand) for flat candidate lanes: cand B x C ->
        T x (B*C)."""
        B, C = cand.shape
        idx = cand.reshape(self.N, self.beam * C)
        p_c = torch.gather(self.logp, 2,
                           idx[None].expand(self.T, -1, -1))
        return p_c.reshape(self.T, B * C)

    def _blank_col(self) -> torch.Tensor:
        """Blank log-probs, one column per utterance: T x N (the kernel
        broadcasts each column over the utterance's beam*C lanes)."""
        return self.logp[:, :, self.blank].contiguous()

    def __call__(self, state: CtcScoreState, last_tok: torch.Tensor,
                 cand: torch.Tensor, is_first: bool
                 ) -> Tuple[torch.Tensor, CtcScoreState]:
        """state: per-lane gammas; last_tok: B last token of each prefix;
        cand: B x C candidates (B = N*beam); is_first: empty prefix.
        Returns (delta B x C, new state over B*C lanes for update_var)."""
        B, C = cand.shape
        cf = cand.reshape(-1)
        f32 = torch.float32
        # the parent beams' gammas and scores go in unexpanded: lane b*C + c
        # reads column b
        gamma_n, gamma_b, score, delta = ctc_score_step(
            self._gather_cand(cand), state.gamma_n, state.gamma_b,
            self._blank_col(),
            (last_tok.repeat_interleave(C) != cf).to(f32)[None],
            (cf == self.eos).to(f32)[None], state.score[None], is_first)
        return delta.reshape(B, C), CtcScoreState(gamma_n, gamma_b, score[0])

    def update_var(self, state: CtcScoreState,
                   flat_index: torch.Tensor) -> CtcScoreState:
        """Gather the surviving beams from the B*C stacked state."""
        return CtcScoreState(state.gamma_n[:, flat_index],
                             state.gamma_b[:, flat_index],
                             state.score[flat_index])


def _host_log_softmax(logits) -> np.ndarray:
    """T x V logits (a tensor on any device, or an array) -> float32 numpy
    log-probs."""
    logits = torch.as_tensor(logits)
    return torch.log_softmax(logits.float(), -1).cpu().numpy()


class CtcApi(object):
    """Standalone CTC decoding: prefix beam search and Viterbi alignment,
    blank = `blank`."""

    def __init__(self, blank: int):
        if blank < 0:
            raise ValueError(f"CtcApi: blank must be >= 0, got {blank}")
        self.blank = blank

    def beam_search(self,
                    ctc_prob,
                    beam_size: int = 8,
                    nbest: int = 1,
                    sos: int = -1,
                    eos: int = -1,
                    len_norm: bool = True,
                    **kwargs) -> List[Dict]:
        """Prefix beam search over T x V logits (host loop) -> nbest list,
        each trans sos-prefixed and eos-suffixed."""
        logp = _host_log_softmax(ctc_prob)
        T, V = logp.shape
        k = min(beam_size, V)
        topk_token = np.argpartition(-logp, k - 1, axis=-1)[:, :k]
        neg_inf = MIN_F32
        # prefix -> (log_pb, log_pn)
        prev_beam = {(sos,): (0.0, neg_inf)}
        for t in range(T):
            next_beam = defaultdict(lambda: [neg_inf, neg_inf])
            for prefix, (pb, pn) in prev_beam.items():
                total = np.logaddexp(pb, pn)
                for symb in topk_token[t]:
                    logp_t = logp[t, symb]
                    if symb == self.blank:
                        entry = next_beam[prefix]
                        entry[0] = np.logaddexp(entry[0], total + logp_t)
                    else:
                        new_prefix = prefix + (int(symb),)
                        entry = next_beam[new_prefix]
                        if prefix[-1] == symb:
                            entry[1] = np.logaddexp(entry[1], pb + logp_t)
                            # a repeated symbol also merges into the prefix
                            same = next_beam[prefix]
                            same[1] = np.logaddexp(same[1], pn + logp_t)
                        else:
                            entry[1] = np.logaddexp(entry[1], total + logp_t)
            ranked = sorted(next_beam.items(),
                            key=lambda kv: np.logaddexp(kv[1][0], kv[1][1]),
                            reverse=True)[:beam_size]
            prev_beam = dict(ranked)
        hyps = [{
            "score": float(np.logaddexp(pb, pn)) /
                     (max(len(p) - 1, 1) if len_norm else 1),
            "trans": list(p) + [eos],
        } for p, (pb, pn) in prev_beam.items()]
        return sorted(hyps, key=lambda h: h["score"], reverse=True)[:nbest]

    def viterbi_align(self, ctc_enc, dec_seq) -> Dict:
        """Forced alignment: T x V logits + a label sequence of U ids ->
        {score, align (T frame labels, blank = self.blank)}."""
        logp = _host_log_softmax(ctc_enc)
        seq = [int(t) for t in np.asarray(dec_seq)]
        T = logp.shape[0]
        U = len(seq)
        if U * 2 + 1 > T:
            raise ValueError(f"Invalid target length: {U}")
        # the extended sequence: blank t1 blank t2 ... blank
        ext = [self.blank]
        for s in seq:
            ext += [s, self.blank]
        L = len(ext)
        score = np.full((T, L), MIN_F32)
        back = np.zeros((T, L), dtype=np.int64)
        score[0, 0] = logp[0, ext[0]]
        if L > 1:
            score[0, 1] = logp[0, ext[1]]
        for t in range(1, T):
            for l in range(L):
                cands = [score[t - 1, l]]
                if l > 0:
                    cands.append(score[t - 1, l - 1])
                if l > 1 and ext[l] != self.blank and ext[l] != ext[l - 2]:
                    cands.append(score[t - 1, l - 2])
                best = int(np.argmax(cands))
                score[t, l] = cands[best] + logp[t, ext[l]]
                back[t, l] = l - best
        # the final state: L-1 (blank) or L-2 (the last label)
        ends = [L - 1, L - 2] if L > 1 else [0]
        end = max(ends, key=lambda l: score[T - 1, l])
        align = []
        l = end
        for t in range(T - 1, -1, -1):
            align.append(ext[l])
            l = back[t, l]
        return {"score": float(score[T - 1, end]), "align": align[::-1]}
