#!/usr/bin/env python
"""Beam search for transformer-decoder AMs (port of
aps_tpu/asr/beam_search/transformer.py: beam_search, greedy_search,
beam_search_batch, _search_core), with LM shallow fusion.

One search over N*K flat (utterance x beam) lanes (N = 1 for the single-
utterance beam_search): search_one, search_batch and _search_core, which the
RNN decoder's search (att.py) shares with its own decoder steps. With an LM
adapter (asr/beam_search/lm.py) the LM steps on the previous token every step,
lm_weight x its log-softmax is added on the candidates (with CTC) or on the
whole vocabulary (without), and its state is reordered with the parents' lanes
and kept on frozen ones, as the search's own state is. Differences from the
JAX package, all deliberate:
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
    encoder rows) to limit its compiles.

dtype "bfloat16" (the batched search, as in aps_tpu's beam_search_batch;
its single-utterance search drops the key, and so does search_one): the
encoder runs in float32 and its CTC table stays float32 (K4 sees
float32); the transformer decoder's weights and the encoder output are
cast to bfloat16. aps_tpu then computes by JAX's type promotion: the
token embedding in bfloat16, the float32 positional encoding added to it
gives float32, and from there every product of a float32 activation with
a bfloat16 weight is float32; only the cross-attention keys and values,
products of the bfloat16 encoder output with bfloat16 weights, are
bfloat16. The port reproduces that with the weights and the encoder
output rounded to bfloat16 and held as float32, and the keys and values
rounded to bfloat16 after their products; the logits are float32 before
the log-softmax. It saves no bytes here: it gives aps_tpu's numbers.
The RNN decoder's search (att.py) drops the key, as aps_tpu's does.

cov_penalty > 0 in the transformer search: aps_tpu's gathers a coverage
of zeros that never grows (its decoder keeps no alignment), so the
penalty is 0 under cov_method v1 and log 0 = -inf on every hypothesis
under v2 (every score -inf, the hypotheses in lane order); the port's
does the same."""

from typing import Dict, List, Optional

import numpy as np
import torch

from aps_tpu_torch.const import MIN_F32
from aps_tpu_torch.asr.beam_search.ctc import CtcScorer, CtcScoreState
from aps_tpu_torch.asr.beam_search.lm import LmAdapter
from aps_tpu_torch.asr.beam_search.utils import (BeamSearchParam, BeamState,
                                                 apply_eos_threshold,
                                                 disable_unk, extract_nbest,
                                                 init_beam_state, map_beam,
                                                 mask_finished_scores,
                                                 stack_padded)
from aps_tpu_torch.utils import bf16_rounded, bf16_rounded_copy

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


class _XfmrSteps(object):
    """The transformer decoder's side of a search over N*K lanes:
    incremental steps against per-layer history caches, the encoder's
    cross-attention K/V projected once an utterance and read beam-shared
    (the attention folds the K beams). It keeps no alignment: a coverage
    stays zero. dtype "bfloat16": aps_tpu's cast, reproduced as the module
    docstring says."""
    coverage = False

    def __init__(self, nnet, enc_out: torch.Tensor, enc_len: torch.Tensor,
                 K: int, max_len: int, dtype: str = "float32"):
        if dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unsupported decoding dtype: {dtype}")
        self.decoder = nnet.decoder
        if dtype == "bfloat16":
            self.decoder = bf16_rounded_copy(nnet.decoder)
            enc_out = bf16_rounded(enc_out)
        self.enc_out = enc_out
        self.enc_len = enc_len.repeat_interleave(K)
        self.cache = self.decoder.init_cache(enc_out.shape[0] * K, max_len,
                                             device=enc_out.device)
        self.mem_kv = self.decoder.prep_memory_kv(enc_out)
        if dtype == "bfloat16":
            self.mem_kv = [tuple(map(bf16_rounded, kv))
                           for kv in self.mem_kv]

    def step(self, tok_prev: torch.Tensor, t: int) -> torch.Tensor:
        pred, self.cache = self.decoder.step_inc(
            self.enc_out, tok_prev, self.cache, t, enc_len=self.enc_len,
            mem_kv=self.mem_kv)
        return pred

    def reorder(self, beam_idx: torch.Tensor) -> None:
        # a frozen utterance never resumes, so its cache rows (updated in
        # place at column t) are never read again
        self.cache = self.cache[:, beam_idx]


def segmented_topk(total: torch.Tensor, cand: Optional[torch.Tensor],
                   num_utts: int, K: int):
    """Per-utterance top-K beam selection over flat lanes.
    total: (N*K, C) fused scores; cand: (N*K, C) candidate token ids (or
    None -> token id = column index). Returns (score, beam_idx, tok,
    flat_idx), flat (N*K,) each: global lane indices of the parents, the
    chosen tokens and indices into the per-utterance K*C candidate axis
    for scorer-state gathers."""
    N = num_utts
    C = total.shape[-1]
    score_u, idx_u = torch.topk(total.reshape(N, K * C), K, dim=-1)
    base = torch.arange(N, device=total.device)[:, None]
    beam_idx = (base * K + idx_u // C).reshape(-1)
    if cand is None:
        tok = (idx_u % C).reshape(-1)
    else:
        tok = torch.gather(cand.reshape(N, K * C), 1, idx_u).reshape(-1)
    flat_idx = (base * (K * C) + idx_u).reshape(-1)
    return score_u.reshape(-1), beam_idx, tok, flat_idx


def _per_utt(x: torch.Tensor, num_utts: int, reduce) -> torch.Tensor:
    """Reduce a flat (N*K,) lane vector per utterance -> (N,)."""
    return reduce(x.reshape(num_utts, -1), dim=1)


def _search_core(dec, N: int, T: int, ctc_out: Optional[torch.Tensor],
                 param: BeamSearchParam, max_len: int,
                 lm: Optional[LmAdapter] = None,
                 device=None) -> BeamState:
    """The search over N*K flat lanes of N utterances of T encoder frames.
    dec is the decoder's side (_XfmrSteps, att._RnnSteps): step(tok_prev,
    t) -> logits lanes x V, reorder(beam_idx) to the parents' lanes, and
    (with `coverage`) alignment(), lanes x T, read after a step for the
    coverage when cov_penalty > 0 (without it the coverage stays zero, as
    in aps_tpu's transformer search). ctc_out N x T x V or None, lm an LM
    adapter or None -> final BeamState."""
    K = param.beam_size
    dev = device
    lanes = N * K
    use_ctc = param.ctc_weight > 0 and ctc_out is not None
    use_cov = param.cov_penalty > 0
    scorer = CtcScorer(ctc_out, eos=param.eos, beam_size=K) \
        if use_ctc else None
    state = init_beam_state(K, max_len, param.sos, num_utts=N, device=dev,
                            num_frames=T if use_cov else -1)
    ctc_state = scorer.init_state() if use_ctc else None
    lm_state = lm.init_state(lanes, device=dev) if lm is not None else None
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
        pred = dec.step(tok_prev, t)
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
        coverage = None
        if use_cov:
            # as aps_tpu: the step's alignment of lane i is added to the
            # coverage of lane i's parent, beam_idx[i], before the
            # alignments follow their parents
            coverage = state.coverage[beam_idx]
            if dec.coverage:
                coverage = coverage + torch.where(prev_done[:, None], 0.0,
                                                  dec.alignment())
        new_state = BeamState(tokens=tokens, score=flat_score, done=done,
                              length=length, coverage=coverage)
        # carry the decoder state of the selected parent beams
        dec.reorder(beam_idx)
        if lm is not None:
            new_lm = lm.reorder(new_lm, beam_idx)
        cur_best = _per_utt(torch.where(done, flat_score, MIN_F32), N,
                            torch.amax)
        improved = cur_best > best_done
        if param.end_detect and N > 1:
            # freeze utterances that had already stopped: a stalled
            # utterance still has live beams
            act_lane = act.repeat_interleave(K)
            new_state = map_beam(lambda n, o: _select(act_lane, n, o),
                                 new_state, state)
            if use_ctc:
                new_ctc = CtcScoreState(
                    _select(act_lane, new_ctc.gamma_n, ctc_state.gamma_n,
                            axis=1),
                    _select(act_lane, new_ctc.gamma_b, ctc_state.gamma_b,
                            axis=1),
                    _select(act_lane, new_ctc.score, ctc_state.score))
            if lm is not None:
                new_lm = lm.select(act_lane, new_lm, lm_state)
            # a frozen utterance never resumes, so the decoder's state of
            # its lanes is never read again
            improved = improved & act
        best_done = torch.where(improved, torch.maximum(best_done, cur_best),
                                best_done)
        last_improve = torch.where(improved, t, last_improve)
        state, ctc_state = new_state, new_ctc
        lm_state = new_lm
    return state


def _nbest_lists(final: BeamState, param: BeamSearchParam, nbest: int,
                 num_utts: int) -> List[List[Dict]]:
    final = map_beam(lambda x: x.cpu().numpy(), final)
    K = param.beam_size
    return [extract_nbest(map_beam(lambda x: x[b * K:(b + 1) * K], final),
                          param, nbest, final=True)
            for b in range(num_utts)]


def search_one(steps, nnet, x, lm: Optional[LmAdapter] = None,
               sos: int = -1, eos: int = -1, beam_size: int = 8,
               nbest: int = 1, max_len: int = -1, dtype: str = "float32",
               device=None, **kwargs) -> List[Dict]:
    """Single-utterance search with the decoder's steps class `steps`
    (_XfmrSteps, att._RnnSteps). x: a waveform, S samples or C x S for a
    multi-channel model, or T x F features (numpy or tensor). max_len as
    aps_tpu's: at most min(param.max_len, T) steps when not given, else the
    given number (capped at param.max_len only). dtype is read as
    aps_tpu's single search reads it: not at all (float32)."""
    param = _param_from_kwargs(sos, eos, beam_size=beam_size, **kwargs)
    if device is None:
        device = next(nnet.parameters()).device
    with torch.inference_mode():
        x = torch.as_tensor(np.asarray(x, dtype=np.float32),
                            device=device)[None]
        enc_out, _, ctc_out = nnet.decode_enc(x)
        T = enc_out.shape[1]
        if max_len <= 0:
            max_len = min(param.max_len, T)
        max_len = min(max_len, param.max_len)
        use_ctc = param.ctc_weight > 0 and ctc_out is not None
        enc_len = torch.full((1,), T, dtype=torch.int64, device=device)
        final = _search_core(
            steps(nnet, enc_out, enc_len, beam_size, max_len), 1, T,
            ctc_out if use_ctc else None, param, max_len, lm=lm,
            device=device)
    return _nbest_lists(final, param, nbest, 1)[0]


def search_batch(steps, nnet, batch: List, lm: Optional[LmAdapter] = None,
                 sos: int = -1, eos: int = -1, beam_size: int = 8,
                 nbest: int = 1, max_len: int = -1, pad_to: int = -1,
                 dtype: str = "float32", device=None,
                 **kwargs) -> List[List[Dict]]:
    """Batched search over N*K flat lanes with the decoder's steps class
    `steps`, with LM shallow fusion when lm (an adapter on the same
    device) is given. batch: list of waveforms, S or C x S (numpy;
    stack_padded pads the sample axis). Returns one nbest list per
    utterance. The models must be in eval mode on `device`. dtype
    "bfloat16" goes to the decoder's steps (the module docstring)."""
    param = _param_from_kwargs(sos, eos, beam_size=beam_size, **kwargs)
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
        final = _search_core(steps(nnet, enc_out, enc_len, beam_size, ml,
                                   dtype=dtype),
                             enc_out.shape[0], T, ctc_out, param, ml, lm=lm,
                             device=device)
    return _nbest_lists(final, param, nbest, len(batch))


def beam_search(nnet, x, **kwargs) -> List[Dict]:
    """Single-utterance transformer-decoder beam search (search_one)."""
    return search_one(_XfmrSteps, nnet, x, **kwargs)


def greedy_search(nnet, x, **kwargs) -> List[Dict]:
    """beam_search with one beam and one hypothesis."""
    kwargs.update(beam_size=1, nbest=1)
    return beam_search(nnet, x, **kwargs)


def beam_search_batch(nnet, batch: List, **kwargs) -> List[List[Dict]]:
    """Batched transformer-decoder beam search (search_batch)."""
    return search_batch(_XfmrSteps, nnet, batch, **kwargs)
