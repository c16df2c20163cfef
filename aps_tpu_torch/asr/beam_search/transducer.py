#!/usr/bin/env python
"""Transducer decoding (port of aps_tpu/asr/beam_search/transducer.py:
beam_search, greedy_search, beam_search_batch, _search_core, _extract).

aps_tpu's frame-synchronous "modified" beam search, not Graves' expansion:
one step an encoder frame over N*K flat (utterance x beam) lanes, at most one
non-blank emission a frame a lane, blank and non-blank candidates ranked
together by segmented_topk, the prediction net advanced only on the lanes
that emit, and the lanes of an utterance frozen past its enc_len. An RNN
prediction net carries its state; a transformer one rescans a blank-prefixed
buffer of U = min(T + 1, 256) tokens every frame, as aps_tpu's does. Greedy
search is beam 1.

Shallow fusion takes an RNN LM (RnnLmAdapter) only, as in aps_tpu: the LM
starts from the blank as its BOS, its log-probs are padded with zero columns
up to the AM's vocabulary and its state advances only on emissions. An LM
trained on the AM's dictionary has one id fewer (the blank is the AM's
last), so the blank is out of its range: aps_tpu's embedding lookup then
gives NaN log-probs and an empty transcript. Here that LM raises a
ValueError before the search starts (check_lm).

Differences from aps_tpu, all deliberate:
  * the compiled fori_loop is a Python loop over the frames with no host
    read inside it; the encoder's joint projection runs once over all
    frames rather than once a frame;
  * the single-utterance search runs on the encoder output as it is, where
    aps_tpu pads it to a frame bucket (frozen by enc_len);
  * the search runs in float32 (no matmul_precision option)."""

from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from aps_tpu_torch.asr.beam_search.lm import (LmAdapter, RnnLmAdapter,
                                              _tree_map, _tree_map2)
from aps_tpu_torch.asr.beam_search.transformer import segmented_topk
from aps_tpu_torch.asr.beam_search.utils import stack_padded
from aps_tpu_torch.const import MIN_F32

# the transformer prediction net's token buffer: at most this many tokens
MAX_BUFFER = 256


class TransducerState(NamedTuple):
    tokens: torch.Tensor   # lanes x (T+1) emitted tokens (blank-padded)
    length: torch.Tensor   # lanes
    score: torch.Tensor    # lanes
    dec_out: torch.Tensor  # lanes x J current prediction-net output
    hidden: Tuple          # the RNN prediction net's state (or ())


def _select(mask: torch.Tensor, new, old):
    """new on the lanes where mask holds, else old (lanes first)."""
    return _tree_map2(
        lambda n, o: torch.where(mask.reshape((-1,) + (1,) * (n.dim() - 1)),
                                 n, o), new, old)


def check_lm(nnet, lm: Optional[LmAdapter], lm_weight: float) -> bool:
    """Whether the search fuses lm; raises where it cannot: an LM that is
    not an RNN LM, or one whose vocabulary does not hold the blank id that
    conditions it."""
    if lm is None or lm_weight == 0:
        return False
    if not isinstance(lm, RnnLmAdapter):
        raise NotImplementedError(
            "transducer LM fusion needs a state-based (RNN) adapter")
    lm_vocab = lm.lm.vocab_size
    if nnet.blank >= lm_vocab:
        raise ValueError(
            f"the transducer's LM fusion starts the LM from the blank, id "
            f"{nnet.blank} of the AM's vocabulary of {nnet.vocab_size}, "
            f"which the LM's vocabulary of {lm_vocab} does not hold (an LM "
            f"trained on the AM's dictionary lacks the blank); train the LM "
            f"with a vocabulary of {nnet.vocab_size}")
    return True


def _search_core(nnet, enc_out: torch.Tensor,
                 enc_len: Optional[torch.Tensor], lm: Optional[LmAdapter],
                 lm_weight: float, beam_size: int) -> TransducerState:
    """The search over N*K flat lanes (lane u*K + k is beam k of
    utterance u) of enc_out N x T x D; frames at t >= enc_len leave that
    utterance's lanes as they are."""
    blank = nnet.blank
    N, T = enc_out.shape[:2]
    K = beam_size
    lanes = N * K
    dev = enc_out.device
    use_lm = check_lm(nnet, lm, lm_weight)
    stateful = nnet.dec_type == "rnn"
    U = min(T + 1, MAX_BUFFER)
    blank_tok = torch.full((lanes, 1), blank, dtype=torch.int64, device=dev)
    if stateful:
        hidden0 = nnet.decoder.init_state(lanes, device=dev)
        dec_out0, hidden0 = nnet.decode_pred(blank_tok, hidden0)
    else:
        hidden0 = ()
        dec_out0 = nnet.decode_pred_fixed(
            torch.full((lanes, U), blank, dtype=torch.int64, device=dev),
            torch.zeros(lanes, dtype=torch.int64, device=dev))
    alive = torch.arange(lanes, device=dev) % K == 0
    state = TransducerState(
        tokens=torch.full((lanes, T + 1), blank, dtype=torch.int64,
                          device=dev),
        length=torch.zeros(lanes, dtype=torch.int64, device=dev),
        score=torch.where(alive, 0.0, float(MIN_F32)).to(torch.float32),
        dec_out=dec_out0,
        hidden=hidden0)
    lm_logp = lm_state = None
    if use_lm:
        # the transducer has no sos: the blank is the LM's BOS
        lm_logp, lm_state = lm.step(lm.init_state(lanes, device=dev),
                                    blank_tok[:, 0], 0)
    # the joint's encoder projection of every frame, repeated a beam
    enc_proj = nnet.decoder.enc_proj(enc_out).repeat_interleave(K, 0)
    act_lanes = None if enc_len is None else \
        torch.arange(T, device=dev)[None, :] < \
        enc_len.to(dev).repeat_interleave(K)[:, None]
    cols = torch.arange(T + 1, device=dev)[None, :]
    for t in range(T):
        if stateful:
            dec_cur = state.dec_out
        else:
            buf = torch.cat([blank_tok, state.tokens[:, :U - 1]], 1)
            dec_cur = nnet.decode_pred_fixed(
                buf, torch.clamp(state.length, max=U - 1))
        logp = torch.log_softmax(
            nnet.decoder.joint(enc_proj[:, t], dec_cur).float(), -1)
        if use_lm:
            # the LM has no blank: zero columns up to the AM's vocabulary
            logp = logp + torch.nn.functional.pad(
                lm_logp * lm_weight, (0, logp.shape[-1] - lm_logp.shape[-1]))
        score, beam_idx, tok, _ = segmented_topk(state.score[:, None] + logp,
                                                 None, N, K)
        emits = tok != blank
        tokens = state.tokens[beam_idx]
        length = state.length[beam_idx]
        tokens = torch.where((cols == length[:, None]) & emits[:, None],
                             tok[:, None], tokens)
        length = length + emits.to(length.dtype)
        if stateful:
            hidden = _tree_map(lambda h: h[beam_idx], state.hidden)
            new_dec, new_hidden = nnet.decode_pred(tok[:, None], hidden)
            dec_out = _select(emits, new_dec, state.dec_out[beam_idx])
            hidden = _select(emits, new_hidden, hidden)
        else:
            hidden = state.hidden
            dec_out = dec_cur[beam_idx]
        new_state = TransducerState(tokens, length, score, dec_out, hidden)
        new_lm = None
        if use_lm:
            lm_logp_g = lm_logp[beam_idx]
            lm_state_g = lm.reorder(lm_state, beam_idx)
            step_logp, step_state = lm.step(lm_state_g, tok, t)
            new_lm = (_select(emits, step_logp, lm_logp_g),
                      _select(emits, step_state, lm_state_g))
        if act_lanes is not None:
            act = act_lanes[:, t]
            new_state = TransducerState(
                *_select(act, tuple(new_state), tuple(state)))
            if use_lm:
                new_lm = _select(act, new_lm, (lm_logp, lm_state))
        state = new_state
        if use_lm:
            lm_logp, lm_state = new_lm
    return state


def _extract(tokens: np.ndarray, length: np.ndarray, score: np.ndarray,
             blank: int, nbest: int, len_norm: bool) -> List[Dict]:
    """The nbest list of one utterance's K lanes (host arrays)."""
    hyps = []
    for k in range(score.shape[0]):
        if float(score[k]) <= MIN_F32 / 2:
            continue
        n = int(length[k])
        seq = [int(v) for v in tokens[k, :n]]
        norm = max(n, 1) if len_norm else 1
        # blank-padded at both ends: the commands strip trans[1:-1]
        hyps.append({"score": float(score[k]) / norm,
                     "trans": [blank] + seq + [blank]})
    hyps = sorted(hyps, key=lambda h: h["score"], reverse=True)
    return hyps[:nbest]


def _nbest_lists(final: TransducerState, blank: int, K: int, nbest: int,
                 len_norm: bool, num_utts: int) -> List[List[Dict]]:
    tokens, length, score = (x.cpu().numpy() for x in
                             (final.tokens, final.length, final.score))
    return [_extract(tokens[b * K:(b + 1) * K], length[b * K:(b + 1) * K],
                     score[b * K:(b + 1) * K], blank, nbest, len_norm)
            for b in range(num_utts)]


def beam_search(nnet, x, lm: Optional[LmAdapter] = None,
                lm_weight: float = 0, beam_size: int = 8, nbest: int = 8,
                len_norm: bool = True, device=None, **kwargs) -> List[Dict]:
    """Single-utterance transducer beam search. x: S samples (or T x F
    features), numpy or tensor. The model must be in eval mode."""
    if device is None:
        device = next(nnet.parameters()).device
    with torch.inference_mode():
        x = torch.as_tensor(np.asarray(x, dtype=np.float32),
                            device=device)[None]
        enc_out, _ = nnet.decode_enc(x)
        final = _search_core(nnet, enc_out, None, lm, lm_weight, beam_size)
    return _nbest_lists(final, nnet.blank, beam_size, nbest, len_norm, 1)[0]


def greedy_search(nnet, x, **kwargs) -> List[Dict]:
    """beam_search with one beam and one hypothesis."""
    kwargs.update(beam_size=1, nbest=1)
    return beam_search(nnet, x, **kwargs)


def beam_search_batch(nnet, batch: List, lm: Optional[LmAdapter] = None,
                      lm_weight: float = 0, beam_size: int = 8,
                      nbest: int = 8, len_norm: bool = True,
                      pad_to: int = -1, device=None,
                      **kwargs) -> List[List[Dict]]:
    """Batched search over N*K lanes: batch, a list of waveforms (numpy),
    padded to a common length (pad_to at least); each utterance's lanes
    frozen past its frames. One nbest list an utterance."""
    if device is None:
        device = next(nnet.parameters()).device
    with torch.inference_mode():
        x_pad, lens, _ = stack_padded(batch, pad_to=pad_to, device=device)
        x_len = torch.as_tensor(lens, device=device)
        enc_out, enc_len = nnet.decode_enc(x_pad, x_len)
        final = _search_core(nnet, enc_out, enc_len, lm, lm_weight,
                             beam_size)
    return _nbest_lists(final, nnet.blank, beam_size, nbest, len_norm,
                        len(batch))
