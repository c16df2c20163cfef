#!/usr/bin/env python
"""LM shallow-fusion adapters for the beam search (port of
aps_tpu/asr/beam_search/lm.py: RnnLmAdapter, XfmrLmAdapter,
NgramLmAdapter, lm_adapter).

Each adapter gives init_state / step / reorder, so that the LM's state
rides in the search loop over flat (utterance x beam) lanes beside the
search's own, on the same device and with no host sync a step. The RNN
LM carries (c, h) a layer; the Transformer LM keeps a token buffer of
max_len + 1 ids filled with sos and scores the whole prefix again each
step (the logits at position t predict token t + 1), as aps_tpu does."""

from typing import Tuple

import torch


def _tree_map(fn, tree):
    if isinstance(tree, (tuple, list)):
        return tuple(_tree_map(fn, x) for x in tree)
    return fn(tree)


def _tree_map2(fn, tree, other):
    if isinstance(tree, (tuple, list)):
        return tuple(_tree_map2(fn, a, b) for a, b in zip(tree, other))
    return fn(tree, other)


class LmAdapter(object):
    """Base adapter: subclasses wrap a concrete LM module (eval mode, on
    the search's device)."""

    def init_state(self, lanes: int, device=None):
        raise NotImplementedError

    def step(self, state, tok_prev: torch.Tensor, t: int):
        """-> (log-probs lanes x V, new state)."""
        raise NotImplementedError

    def reorder(self, state, beam_idx: torch.Tensor):
        """The state of the parent lanes beam_idx."""
        return _tree_map(lambda x: x[beam_idx], state)

    def select(self, act_lane: torch.Tensor, new, old):
        """new on the active lanes, old on the frozen ones (lanes on the
        first axis of every leaf)."""
        return _tree_map2(
            lambda n, o: torch.where(
                act_lane.reshape((-1,) + (1,) * (n.dim() - 1)), n, o),
            new, old)


class RnnLmAdapter(LmAdapter):
    """Adapter for asr@rnn_lm (carried hidden state)."""

    def __init__(self, lm):
        self.lm = lm

    def init_state(self, lanes: int, device=None) -> Tuple:
        return self.lm.init_state(lanes, device=device)

    def step(self, state, tok_prev: torch.Tensor, t: int):
        out, state = self.lm(tok_prev[:, None], state)
        return torch.log_softmax(out[:, -1].float(), -1), state


class XfmrLmAdapter(LmAdapter):
    """Adapter for asr@xfmr_lm: a token buffer of max_len + 1 ids, the
    prefix up to step t scored again every step (O(L^2) over a search)."""

    def __init__(self, lm, max_len: int, sos: int):
        self.lm = lm
        self.max_len = max_len
        self.sos = sos

    def init_state(self, lanes: int, device=None) -> torch.Tensor:
        return torch.full((lanes, self.max_len + 1), self.sos,
                          dtype=torch.int64, device=device)

    def step(self, state: torch.Tensor, tok_prev: torch.Tensor, t: int):
        buf = state.clone()
        buf[:, t] = tok_prev
        # the causal mask keeps position t from the buffer after it, so
        # the prefix alone gives the same logits there
        out, _ = self.lm(buf[:, :t + 1])
        return torch.log_softmax(out[:, t].float(), -1), buf


class NgramLmAdapter(LmAdapter):
    """Adapter for n-gram models: they score on the host, so they cannot
    step inside the search loop (decode.py rescores the nbest instead)."""

    def __init__(self, ngram_lm):
        self.lm = ngram_lm

    def init_state(self, lanes: int, device=None):
        raise RuntimeError("NgramLmAdapter cannot run inside the beam "
                           "search loop; use lm_rescore instead")


def lm_adapter(lm, max_len: int = 256, sos: int = 0) -> LmAdapter:
    """The adapter of a registered LM module."""
    name = type(lm).__name__
    if "Xfmr" in name or "Transformer" in name:
        return XfmrLmAdapter(lm, max_len, sos)
    return RnnLmAdapter(lm)
