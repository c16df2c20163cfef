#!/usr/bin/env python
"""Beam search state and helpers (port of
aps_tpu/asr/beam_search/utils.py).

The beam lives in one dense state over flat (utterance x beam) lanes,
lane u*K + k = beam k of utterance u:
  tokens  lanes x (L+1)  decoded ids (sos at column 0)
  score   lanes          accumulated log-prob (frozen once ended)
  done    lanes          ended-with-eos flags
  length  lanes          emitted tokens (eos included once ended)
Finished hypotheses stay in the beam with a forced eos-only continuation,
so the final beam is the nbest list."""

from dataclasses import dataclass
from typing import Dict, List, NamedTuple

import numpy as np
import torch

from aps_tpu_torch.const import MIN_F32


@dataclass
class BeamSearchParam(object):
    """Knobs of the beam search (names match aps_tpu). approx_topk and
    ctc_fused are TPU options kept for config parity: the port always takes
    the exact torch.topk, and on CUDA always the CTC kernel. The coverage
    knobs (cov_*) belong to attention-weight searches; the transformer
    search keeps no attention weights and refuses cov_penalty > 0."""
    beam_size: int = 8
    sos: int = 1
    eos: int = 2
    unk: int = -1
    min_len: int = 1
    max_len: int = 1000
    lm_weight: float = 0
    eos_threshold: float = 0
    len_penalty: float = 0
    cov_method: str = "v1"
    cov_penalty: float = 0
    cov_threshold: float = 0.5
    len_norm: bool = True
    temperature: float = 1
    allow_partial: bool = False
    end_detect: bool = False
    ctc_weight: float = 0
    ctc_beam_size: int = 12
    approx_topk: bool = False
    ctc_fused: bool = False


class BeamState(NamedTuple):
    tokens: torch.Tensor    # lanes x L+1
    score: torch.Tensor     # lanes
    done: torch.Tensor      # lanes bool
    length: torch.Tensor    # lanes int32


def init_beam_state(beam_size: int, max_len: int, sos: int,
                    num_utts: int = 1, device=None) -> BeamState:
    lanes = num_utts * beam_size
    tokens = torch.full((lanes, max_len + 1), sos, dtype=torch.int64,
                        device=device)
    # only beam 0 of each utterance is alive at step 0
    alive = torch.arange(lanes, device=device) % beam_size == 0
    score = torch.where(alive, 0.0, MIN_F32).to(torch.float32)
    return BeamState(tokens=tokens,
                     score=score,
                     done=torch.zeros(lanes, dtype=torch.bool, device=device),
                     length=torch.zeros(lanes, dtype=torch.int32,
                                        device=device))


def mask_finished_scores(fusion: torch.Tensor, done: torch.Tensor,
                         eos: int) -> torch.Tensor:
    """Finished beams may only 'emit' eos with 0 added score."""
    frozen = torch.full((fusion.shape[-1],), MIN_F32, device=fusion.device)
    frozen[eos] = 0.0
    return torch.where(done[:, None], frozen[None, :], fusion)


def apply_eos_threshold(fusion: torch.Tensor, eos: int,
                        eos_threshold: float) -> torch.Tensor:
    """Disable eos when its score < threshold * best non-eos score."""
    if eos_threshold <= 0:
        return fusion
    eos_prob = fusion[:, eos]
    non_eos = fusion.clone()
    non_eos[:, eos] = float(MIN_F32)
    best = non_eos.amax(-1)
    fusion = fusion.clone()
    fusion[:, eos] = torch.where(eos_prob < best * eos_threshold,
                                 torch.full_like(eos_prob, MIN_F32), eos_prob)
    return fusion


def disable_unk(fusion: torch.Tensor, unk: int) -> torch.Tensor:
    if unk < 0:
        return fusion
    fusion = fusion.clone()
    fusion[:, unk] = float(MIN_F32)
    return fusion


def extract_nbest(state: BeamState, param: BeamSearchParam, nbest: int,
                  final: bool = True) -> List[Dict]:
    """nbest hypothesis list from a final beam of host (numpy) arrays."""
    tokens = np.asarray(state.tokens)
    score = np.asarray(state.score)
    done = np.asarray(state.done)
    length = np.asarray(state.length)
    hyps = []
    for k in range(tokens.shape[0]):
        if score[k] <= MIN_F32 / 2:
            continue
        n = int(length[k])
        if not done[k] and not (final and param.allow_partial):
            continue
        seq = [int(t) for t in tokens[k, :n + 1]]
        if not done[k]:
            seq = seq + [param.eos]
        seq_len = max(len(seq) - 1, 1)
        if seq_len < param.min_len + 1:
            continue
        s = float(score[k]) + seq_len * param.len_penalty
        hyps.append({
            "score": s / (seq_len if param.len_norm else 1),
            "trans": seq,
        })
    hyps = sorted(hyps, key=lambda h: h["score"], reverse=True)
    return hyps[:nbest]


def stack_padded(batch: List, pad_to: int = -1, device=None):
    """Stack 1-D utterances zero-padded to a common length S ->
    (x_pad N x S float32 on device, lens list, S)."""
    lens = [int(x.shape[-1]) for x in batch]
    S = max(max(lens), pad_to)
    x_pad = np.zeros((len(batch), S), dtype=np.float32)
    for i, (x, n) in enumerate(zip(batch, lens)):
        x_pad[i, :n] = np.asarray(x, dtype=np.float32)
    return torch.from_numpy(x_pad).to(device), lens, S
