#!/usr/bin/env python
"""Stacked recurrent layers (port of aps_tpu/asr/base/rnn.py:
StackedLSTMWithState, with carried state, and SingleRNN and StackedRNN,
bidirectional as set).

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


def _in_cell(cell: str, part: Optional[str]) -> Optional[str]:
    """A gate leaf of _CELLS inside the flax cell `cell`."""
    if part is None:
        return None
    if part[0] == "+":
        return f"+{cell}/{part[1:]}"
    return f"{cell}/{part}"


def recurrent_layer(rnn_type: str, inp_size: int, hidden: int,
                    bidirectional: bool = False,
                    named_cells: bool = False) -> nn.Module:
    """One batch-first torch recurrent layer whose biases follow flax's
    cell (see the module's docstring). named_cells: the layer stands for a
    SingleRNN, whose flax cells are its children <cell>_0 (the forward
    direction) and <cell>_1 (the reverse one, the _reverse parameters)."""
    rnn_type = rnn_type.lower()
    if rnn_type not in _CELLS:
        raise ValueError(f"Unsupported rnn type: {rnn_type}")
    cls, cell, gates = _CELLS[rnn_type]
    layer = cls(inp_size, hidden, batch_first=True,
                bidirectional=bidirectional)
    if named_cells:
        gates = {
            name + suffix: tuple(_in_cell(f"{cell}_{d}", p) for p in parts)
            for d, suffix in enumerate(("", "_reverse")[:1 + bidirectional])
            for name, parts in gates.items()
        }
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

    def init_state(self, batch: int, device=None, dtype=None) -> Tuple:
        """Zero carried state (lstm: (c, h) a layer; gru/rnn: h)."""
        zero = lambda: torch.zeros(batch, self.hidden, device=device,
                                   dtype=dtype)
        if self.rnn_type == "lstm":
            return tuple((zero(), zero()) for _ in range(self.num_layers))
        return tuple(zero() for _ in range(self.num_layers))

    def forward(self, inp: torch.Tensor,
                state: Optional[Tuple] = None) -> Tuple[torch.Tensor, Tuple]:
        if state is None:
            state = self.init_state(inp.shape[0], device=inp.device,
                                    dtype=inp.dtype)
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


class SingleRNN(nn.Module):
    """One (optionally bidirectional) recurrent layer over N x T x D, one
    torch layer (cuDNN on the card) whose directions map onto flax's cells
    <cell>_0 and <cell>_1 (aps_tpu creates the forward cell first); the
    torch layer `cells` has no path segment of its own in aps_tpu
    (convert.MODULE_NAMES). Without lengths, as aps_tpu's without
    seq_lengths, the reverse direction reads the whole padded sequence.
    With lengths (inp_len, N) the layer runs on the packed sequence
    (pack_padded_sequence, the same cuDNN layer): as in aps_tpu, each
    utterance's reverse direction starts at its last valid frame. The
    frames past a length come out as zeros, where flax carries its state
    on; consumers mask them."""

    def __init__(self, inp_size: int, hidden: int, rnn_type: str = "lstm",
                 bidirectional: bool = False):
        super(SingleRNN, self).__init__()
        self.cells = recurrent_layer(rnn_type, inp_size, hidden,
                                     bidirectional=bidirectional,
                                     named_cells=True)
        self.output_size = hidden * (2 if bidirectional else 1)

    def forward(self, inp: torch.Tensor,
                inp_len: Optional[torch.Tensor] = None) -> torch.Tensor:
        if inp_len is None:
            return self.cells(inp)[0]
        packed = nn.utils.rnn.pack_padded_sequence(
            inp, torch.as_tensor(inp_len).cpu(), batch_first=True,
            enforce_sorted=False)
        out, _ = nn.utils.rnn.pad_packed_sequence(
            self.cells(packed)[0], batch_first=True,
            total_length=inp.shape[1])
        return out


class StackedRNN(nn.Module):
    """Multi-layer RNN (port of aps_tpu's StackedRNN): an optional input
    projection, then each layer layer_i followed by tanh of its projection
    proj_i (hidden_proj > 0), its layer norm ln_i, and dropout on every
    layer but the last, in that order (StackedLSTMWithState projects
    without tanh and drops out before the norm)."""

    def __init__(self,
                 inp_size: int,
                 hidden: int,
                 num_layers: int = 3,
                 rnn_type: str = "lstm",
                 bidirectional: bool = False,
                 dropout: float = 0.0,
                 input_proj: int = -1,
                 hidden_proj: int = -1,
                 layer_norm: bool = False):
        super(StackedRNN, self).__init__()
        self.num_layers = num_layers
        self.hidden_proj = hidden_proj
        self.layer_norm = layer_norm
        self.input_proj = nn.Linear(inp_size, input_proj) \
            if input_proj > 0 else None
        size = input_proj if input_proj > 0 else inp_size
        for i in range(num_layers):
            layer = SingleRNN(size, hidden, rnn_type=rnn_type,
                              bidirectional=bidirectional)
            self.add_module(f"layer_{i}", layer)
            size = layer.output_size
            if hidden_proj > 0:
                self.add_module(f"proj_{i}", nn.Linear(size, hidden_proj))
                size = hidden_proj
            if layer_norm:
                self.add_module(f"ln_{i}", nn.LayerNorm(size, eps=LN_EPS))
        self.drop = nn.Dropout(dropout) if dropout > 0 else None
        self.output_size = size

    def forward(self, inp: torch.Tensor,
                inp_len: Optional[torch.Tensor] = None) -> torch.Tensor:
        """N x T x D (inp_len N or None) -> N x T x output_size"""
        out = inp if self.input_proj is None else self.input_proj(inp)
        for i in range(self.num_layers):
            out = getattr(self, f"layer_{i}")(out, inp_len)
            if self.hidden_proj > 0:
                out = torch.tanh(getattr(self, f"proj_{i}")(out))
            if self.layer_norm:
                out = getattr(self, f"ln_{i}")(out)
            if self.drop is not None and i != self.num_layers - 1:
                out = self.drop(out)
        return out
