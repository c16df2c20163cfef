#!/usr/bin/env python
"""CTC prefix scorer for joint CTC/attention beam search (port of
aps_tpu/asr/beam_search/ctc.py::CtcScorer, the eq. 51-53 gamma recursions
of "Hybrid CTC/Attention Architecture for End-to-End Speech Recognition").

Every step runs through ctc_score_step (aps_tpu_torch.ops.ctc_score): the
CUDA kernel for CUDA tensors, its plain version for CPU tensors. The
bookkeeping around it (initial state, candidate gathers, beam reorder) is
plain PyTorch."""

from typing import NamedTuple, Tuple

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
