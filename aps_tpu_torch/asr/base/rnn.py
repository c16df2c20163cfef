#!/usr/bin/env python
"""Stacked recurrent layers with carried state (port of
aps_tpu/asr/base/rnn.py::StackedLSTMWithState).

One torch.nn.LSTM (or GRU, or tanh RNN) a layer, batch first, on cuDNN on
the card; aps_tpu runs the same recurrence as plain JAX (flax cells under
nn.RNN), outside any Pallas kernel. What follows aps_tpu rather than
torch's habits:

  * the state is a tuple with one entry a layer: (c, h) for an LSTM, in
    flax's order (torch's own hx is (h, c)), h alone for a GRU or an RNN;
    each entry is N x H;
  * after each layer come its projection proj_i (a Linear, when proj_size
    > 0; it is not fed back into the recurrence, unlike torch's own
    proj_size), then dropout (on every layer but the last), then the layer
    norm ln_i, in that order;
  * the layers carry flax's names (OptimizedLSTMCell_i, GRUCell_i or
    SimpleCell_i, proj_i, ln_i), so that aps_tpu_torch.convert maps them
    to aps_tpu's parameter paths segment by segment.

flax's cells have one bias where torch has two: the LSTM's gates take
theirs on the hidden side (hi, hf, hg, ho), the tanh RNN on the input side
(i), the GRU's r and z gates on the input side and its n gate on both. The
torch bias without a flax counterpart is kept at zero and frozen
(requires_grad False: the LSTM's bias_ih, the RNN's bias_hh), so that
training moves the same parameters as aps_tpu. The GRU's bias_hh holds
n's hidden-side bias beside the r and z entries that flax lacks: they
start at zero and train (the sum with bias_ih is what the gate sees, and
the converter writes that sum back). Each layer names its leaves in
`jax_gates`: torch parameter -> one flax leaf a gate in torch's gate order
(LSTM i, f, g, o; GRU r, z, n), None for a zero block, "+leaf" for a block
that the converter adds into that leaf."""

from typing import Optional, Tuple

import torch
from torch import nn

from aps_tpu_torch.asr.transformer.impl import LN_EPS

# rnn_type -> (torch class, flax cell name, gate leaves of weight_ih,
# weight_hh, bias_ih, bias_hh)
_CELLS = {
    "lstm": (nn.LSTM, "OptimizedLSTMCell", {
        "weight_ih_l0": ("ii", "if", "ig", "io"),
        "weight_hh_l0": ("hi", "hf", "hg", "ho"),
        "bias_ih_l0": (None, None, None, None),
        "bias_hh_l0": ("hi", "hf", "hg", "ho"),
    }),
    "gru": (nn.GRU, "GRUCell", {
        "weight_ih_l0": ("ir", "iz", "in"),
        "weight_hh_l0": ("hr", "hz", "hn"),
        "bias_ih_l0": ("ir", "iz", "in"),
        "bias_hh_l0": ("+ir", "+iz", "hn"),
    }),
    "rnn": (nn.RNN, "SimpleCell", {
        "weight_ih_l0": ("i",),
        "weight_hh_l0": ("h",),
        "bias_ih_l0": ("i",),
        "bias_hh_l0": (None,),
    }),
}


def recurrent_layer(rnn_type: str, inp_size: int,
                    hidden: int) -> nn.Module:
    """One batch-first torch recurrent layer whose biases follow flax's
    cell (see the module's docstring)."""
    rnn_type = rnn_type.lower()
    if rnn_type not in _CELLS:
        raise ValueError(f"Unsupported rnn type: {rnn_type}")
    cls, _, gates = _CELLS[rnn_type]
    layer = cls(inp_size, hidden, batch_first=True)
    layer.jax_gates = gates
    for name, parts in gates.items():
        if all(p is None for p in parts):
            param = getattr(layer, name)
            with torch.no_grad():
                param.zero_()
            param.requires_grad_(False)
    with torch.no_grad():
        for name, parts in gates.items():
            param = getattr(layer, name)
            for g, part in enumerate(parts):
                if part is not None and part.startswith("+"):
                    param[g * hidden:(g + 1) * hidden].zero_()
    return layer


class StackedLSTMWithState(nn.Module):
    """Multi-layer unidirectional LSTM (GRU, RNN) exposing carried state.

    forward(x: N x T x D, state or None) -> (out: N x T x H', state)."""

    def __init__(self,
                 inp_size: int,
                 hidden: int,
                 num_layers: int = 2,
                 dropout: float = 0.0,
                 rnn_type: str = "lstm",
                 layer_norm: bool = False,
                 proj_size: int = -1):
        super(StackedLSTMWithState, self).__init__()
        self.hidden = hidden
        self.num_layers = num_layers
        self.rnn_type = rnn_type.lower()
        self.proj_size = proj_size
        self.layer_norm = layer_norm
        cell = _CELLS.get(self.rnn_type, (None, None))[1]
        self.drop = nn.Dropout(dropout)
        self.dropout = dropout
        for i in range(num_layers):
            self.add_module(f"{cell}_{i}", recurrent_layer(
                self.rnn_type, inp_size if i == 0 else self.output_size,
                hidden))
            if proj_size > 0:
                self.add_module(f"proj_{i}", nn.Linear(hidden, proj_size))
            if layer_norm:
                self.add_module(f"ln_{i}", nn.LayerNorm(self.output_size,
                                                        eps=LN_EPS))
        self.cells = [getattr(self, f"{cell}_{i}") for i in range(num_layers)]

    @property
    def output_size(self) -> int:
        return self.proj_size if self.proj_size > 0 else self.hidden

    def init_state(self, batch: int, device=None) -> Tuple:
        """Zero carried state (lstm: (c, h) a layer; gru/rnn: h)."""
        zero = lambda: torch.zeros(batch, self.hidden, device=device)
        if self.rnn_type == "lstm":
            return tuple((zero(), zero()) for _ in range(self.num_layers))
        return tuple(zero() for _ in range(self.num_layers))

    def forward(self, inp: torch.Tensor,
                state: Optional[Tuple] = None) -> Tuple[torch.Tensor, Tuple]:
        if state is None:
            state = self.init_state(inp.shape[0], device=inp.device)
        new_state = []
        out = inp
        for i in range(self.num_layers):
            if self.rnn_type == "lstm":
                c, h = state[i]
                out, (h, c) = self.cells[i](
                    out, (h[None].contiguous(), c[None].contiguous()))
                new_state.append((c[0], h[0]))
            else:
                out, h = self.cells[i](out, state[i][None].contiguous())
                new_state.append(h[0])
            if self.proj_size > 0:
                out = getattr(self, f"proj_{i}")(out)
            if self.dropout > 0 and i != self.num_layers - 1:
                out = self.drop(out)
            if self.layer_norm:
                out = getattr(self, f"ln_{i}")(out)
        return out, tuple(new_state)
