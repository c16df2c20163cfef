#!/usr/bin/env python
"""Beam search for transformer-decoder AMs (port of
aps_tpu/asr/beam_search/transformer.py: beam_search, greedy_search,
beam_search_batch, _search_core), with LM shallow fusion.

One search over N*K flat (utterance x beam) lanes (N = 1 for the
single-utterance beam_search). With an LM adapter (asr/beam_search/lm.py)
the LM steps on the previous token every step, lm_weight x its log-softmax
is added on the candidates (with CTC) or on the whole vocabulary (without),
and its state is reordered with the parents' lanes and kept on frozen
ones, as the search's own state is. Differences from the JAX package, all
deliberate:
  * the compiled lax.while_loop is a Python loop that stops when every
    utterance is done (or stalled under end detection) or at max_len; the
    stop test reads one flag from the device per step;
  * decoding is always incremental (decode_step_inc against per-layer
    history caches): aps_tpu switches to it from max_len 32 up, a TPU
    measurement, and documents it as equivalent to the full rescore;
  * candidate pruning is the exact torch.topk, called directly (aps_tpu's
    topk_candidates only adds the TPU's approx_max_k option);
  * the single-utterance search runs on the encoder output as it is, where
    aps_tpu pads it to a frame bucket (blank-certain CTC rows, masked
    encoder rows) to limit its compiles;
  * no bfloat16 decoding yet."""

from typing import Dict, List, Optional

import numpy as np
import torch

from aps_tpu_torch.const import MIN_F32
from aps_tpu_torch.asr.beam_search.att import _per_utt, segmented_topk
from aps_tpu_torch.asr.beam_search.ctc import CtcScorer, CtcScoreState
from aps_tpu_torch.asr.beam_search.lm import LmAdapter
from aps_tpu_torch.asr.beam_search.utils import (BeamSearchParam, BeamState,
                                                 apply_eos_threshold,
                                                 disable_unk, extract_nbest,
                                                 init_beam_state,
                                                 mask_finished_scores,
                                                 stack_padded)

# espnet-style end detection: stop an utterance once a finished hypothesis
# exists and none better has finished for this many steps
END_PATIENCE = 3


def _param_from_kwargs(sos, eos, **kwargs) -> BeamSearchParam:
    fields = BeamSearchParam.__dataclass_fields__
    return BeamSearchParam(
        sos=sos, eos=eos,
        **{k: v for k, v in kwargs.items() if k in fields})


def _select(act_lane: torch.Tensor, new: torch.Tensor, old: torch.Tensor,
            axis: int = 0) -> torch.Tensor:
    """new where the lane is active else old; lanes on `axis`."""
    shape = [1] * new.dim()
    shape[axis] = -1
    return torch.where(act_lane.reshape(shape), new, old)


def _search_core(nnet, enc_out: torch.Tensor, enc_len: torch.Tensor,
                 ctc_out: Optional[torch.Tensor], param: BeamSearchParam,
                 max_len: int, lm: Optional[LmAdapter] = None) -> BeamState:
    """enc_out N x T x D, enc_len N, ctc_out N x T x V or None, lm an LM
    adapter or None -> final BeamState over N*K lanes."""
    K = param.beam_size
    N = enc_out.shape[0]
    dev = enc_out.device
    lanes = N * K
    enc_len_tiled = enc_len.repeat_interleave(K)
    use_ctc = param.ctc_weight > 0 and ctc_out is not None
    scorer = CtcScorer(ctc_out, eos=param.eos, beam_size=K) \
        if use_ctc else None
    state = init_beam_state(K, max_len, param.sos, num_utts=N, device=dev)
    ctc_state = scorer.init_state() if use_ctc else None
    lm_state = lm.init_state(lanes, device=dev) if lm is not None else None
    cache = nnet.decode_init_cache(lanes, max_len, device=dev)
    # cross-attention K/V projected once per UTTERANCE and read
    # beam-shared by every step (the attention folds the K beams)
    mem_kv = nnet.decode_prep_kv(enc_out)
    best_done = torch.full((N,), MIN_F32, device=dev)
    last_improve = torch.zeros(N, dtype=torch.int64, device=dev)

    def _go(t, state, best_done, last_improve):
        go = ~_per_utt(state.done, N, torch.all)
        if param.end_detect:
            stalled = (best_done > MIN_F32 / 2) & \
                (t - last_improve >= END_PATIENCE)
            go = go & ~stalled
        return go

    for t in range(max_len):
        act = _go(t, state, best_done, last_improve)
        if not bool(act.any()):
            break
        tok_prev = state.tokens[:, t]
        pred, new_cache = nnet.decode_step_inc(enc_out, tok_prev, cache, t,
                                               enc_len=enc_len_tiled,
                                               mem_kv=mem_kv)
        am_prob = torch.log_softmax(pred.float() / param.temperature, -1)
        V = am_prob.shape[-1]
        new_ctc = new_lm = None
        lm_prob = 0.0
        if lm is not None:
            lm_prob, new_lm = lm.step(lm_state, tok_prev, t)
        if use_ctc:
            C = min(param.ctc_beam_size, V)
            # mask <unk> before pruning so it also holds under CTC fusion
            att_score, cand = torch.topk(disable_unk(am_prob, param.unk),
                                         C, dim=-1)
            cand = torch.where(state.done[:, None],
                               torch.full_like(cand, param.eos), cand)
            delta, ctc_x = scorer(ctc_state, tok_prev, cand, t == 0)
            fusion = att_score * (1 - param.ctc_weight) + \
                delta * param.ctc_weight
            if lm is not None:
                fusion = fusion + param.lm_weight * torch.gather(
                    lm_prob, -1, cand)
            frozen = torch.where(
                torch.arange(C, device=dev) == 0, 0.0,
                MIN_F32).to(fusion.dtype)
            fusion = torch.where(state.done[:, None], frozen[None], fusion)
            total = state.score[:, None] + fusion
            flat_score, beam_idx, tok, flat_idx = segmented_topk(
                total, cand, N, K)
            new_ctc = scorer.update_var(ctc_x, flat_idx)
        else:
            fusion = disable_unk(am_prob + param.lm_weight * lm_prob,
                                 param.unk)
            fusion = apply_eos_threshold(fusion, param.eos,
                                         param.eos_threshold)
            fusion = mask_finished_scores(fusion, state.done, param.eos)
            total = state.score[:, None] + fusion
            flat_score, beam_idx, tok, _ = segmented_topk(total, None, N, K)
        prev_done = state.done[beam_idx]
        tokens = state.tokens[beam_idx]
        tokens[:, t + 1] = torch.where(prev_done, tokens[:, t + 1], tok)
        length = state.length[beam_idx] + (~prev_done).to(torch.int32)
        done = prev_done | (tok == param.eos)
        new_state = BeamState(tokens=tokens, score=flat_score, done=done,
                              length=length)
        # carry the history of the selected parent beams
        new_cache = new_cache[:, beam_idx]
        if lm is not None:
            new_lm = lm.reorder(new_lm, beam_idx)
        cur_best = _per_utt(torch.where(done, flat_score, MIN_F32), N,
                            torch.amax)
        improved = cur_best > best_done
        if param.end_detect and N > 1:
            # freeze utterances that had already stopped: a stalled
            # utterance still has live beams
            act_lane = act.repeat_interleave(K)
            new_state = BeamState(*(_select(act_lane, n, o)
                                    for n, o in zip(new_state, state)))
            if use_ctc:
                new_ctc = CtcScoreState(
                    _select(act_lane, new_ctc.gamma_n, ctc_state.gamma_n,
                            axis=1),
                    _select(act_lane, new_ctc.gamma_b, ctc_state.gamma_b,
                            axis=1),
                    _select(act_lane, new_ctc.score, ctc_state.score))
            if lm is not None:
                new_lm = lm.select(act_lane, new_lm, lm_state)
            # a frozen utterance never resumes, so its cache rows (updated
            # in place at column t) are never read again
            improved = improved & act
        best_done = torch.where(improved, torch.maximum(best_done, cur_best),
                                best_done)
        last_improve = torch.where(improved, t, last_improve)
        state, ctc_state, cache = new_state, new_ctc, new_cache
        lm_state = new_lm
    return state


def _check_param(dtype: str, param: BeamSearchParam) -> None:
    if dtype != "float32":
        raise NotImplementedError("bfloat16 decoding is not ported yet")
    if param.cov_penalty > 0:
        raise NotImplementedError("the transformer search keeps no "
                                  "attention weights for a coverage penalty")


def beam_search(nnet, x, lm: Optional[LmAdapter] = None, sos: int = -1,
                eos: int = -1, beam_size: int = 8, nbest: int = 1,
                max_len: int = -1, dtype: str = "float32", device=None,
                **kwargs) -> List[Dict]:
    """Single-utterance beam search. x: a waveform, S samples or C x S for
    a multi-channel model (numpy or tensor).
    max_len as aps_tpu's: at most min(param.max_len, T) steps when not
    given, else the given number (capped at param.max_len only)."""
    param = _param_from_kwargs(sos, eos, beam_size=beam_size, **kwargs)
    _check_param(dtype, param)
    if device is None:
        device = next(nnet.parameters()).device
    with torch.inference_mode():
        x = torch.as_tensor(np.asarray(x, dtype=np.float32),
                            device=device)[None]
        enc_out, enc_len, ctc_out = nnet.decode_enc(x)
        T = enc_out.shape[1]
        if max_len <= 0:
            max_len = min(param.max_len, T)
        max_len = min(max_len, param.max_len)
        use_ctc = param.ctc_weight > 0 and ctc_out is not None
        enc_len = torch.full((1,), T, dtype=torch.int64, device=device)
        final = _search_core(nnet, enc_out, enc_len,
                             ctc_out if use_ctc else None, param, max_len,
                             lm=lm)
    final = BeamState(*(x.cpu().numpy() for x in final))
    return extract_nbest(final, param, nbest, final=True)


def greedy_search(nnet, x, sos: int = -1, eos: int = -1,
                  **kwargs) -> List[Dict]:
    """beam_search with one beam and one hypothesis."""
    kwargs.pop("beam_size", None)
    kwargs.pop("nbest", None)
    return beam_search(nnet, x, sos=sos, eos=eos, beam_size=1, nbest=1,
                       **kwargs)


def beam_search_batch(nnet, batch: List, lm: Optional[LmAdapter] = None,
                      sos: int = -1, eos: int = -1, beam_size: int = 8,
                      nbest: int = 1, max_len: int = -1, pad_to: int = -1,
                      dtype: str = "float32", device=None,
                      **kwargs) -> List[List[Dict]]:
    """Batched transformer-decoder beam search over N*K flat lanes, with
    LM shallow fusion when lm (an adapter on the same device) is given.
    batch: list of waveforms, S or C x S (numpy; stack_padded pads the
    sample axis). Returns one nbest list
    per utterance. The models must be in eval mode on `device`."""
    param = _param_from_kwargs(sos, eos, beam_size=beam_size, **kwargs)
    _check_param(dtype, param)
    if device is None:
        device = next(nnet.parameters()).device
    with torch.inference_mode():
        x_pad, lens, _ = stack_padded(batch, pad_to=pad_to, device=device)
        x_len = torch.as_tensor(lens, device=device)
        enc_out, enc_len, ctc_out = nnet.decode_enc(x_pad, x_len)
        T = enc_out.shape[1]
        ml = max_len if max_len > 0 else param.max_len
        ml = min(ml, T, param.max_len)
        use_ctc = param.ctc_weight > 0 and ctc_out is not None
        if use_ctc:
            # padded frames become blank-certain, so the prefix scores of
            # a padded utterance equal its unpadded ones
            V = ctc_out.shape[-1]
            tmask = torch.arange(T, device=device)[None, :] < enc_len[:, None]
            pad_logits = torch.full((V,), -1e9, device=device)
            pad_logits[V - 1] = 0.0
            ctc_out = torch.where(tmask[..., None], ctc_out, pad_logits)
        else:
            ctc_out = None
        final = _search_core(nnet, enc_out, enc_len, ctc_out, param, ml,
                             lm=lm)
    final = BeamState(*(x.cpu().numpy() for x in final))
    K = param.beam_size
    return [
        extract_nbest(BeamState(*(x[b * K:(b + 1) * K] for x in final)),
                      param, nbest, final=True) for b in range(len(batch))
    ]
