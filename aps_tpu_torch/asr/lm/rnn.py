#!/usr/bin/env python
"""RNN language model (port of aps_tpu/asr/lm/rnn.py, registered
"asr@rnn_lm"). forward(token N x T, hidden) -> (logits N x T x V, hidden),
hidden as aps_tpu_torch.asr.base.rnn.StackedLSTMWithState carries it.

tie_weights is accepted and ignored, as in aps_tpu: its output layer
`dist` is a Linear of its own whatever the flag says (three recipes set it
true), so the converted weights load either way."""

from typing import Optional, Tuple

import torch
from torch import nn

from aps_tpu_torch.asr.base.component import OneHotEmbedding
from aps_tpu_torch.asr.base.rnn import StackedLSTMWithState
from aps_tpu_torch.libs import ApsRegisters


@ApsRegisters.asr.register("asr@rnn_lm")
class TorchRNNLM(nn.Module):
    """Simple RNN LM (the name is aps_tpu's)."""

    def __init__(self,
                 embed_size: int = 256,
                 vocab_size: int = 40,
                 rnn: str = "lstm",
                 dropout: float = 0.2,
                 add_ln: bool = False,
                 proj_size: int = -1,
                 num_layers: int = 3,
                 hidden_size: int = 512,
                 tie_weights: bool = False):
        super(TorchRNNLM, self).__init__()
        self.vocab_size = vocab_size
        self.rnn = rnn
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        if embed_size != vocab_size:
            self.lm_embed = nn.Embedding(vocab_size, embed_size)
        else:
            self.lm_embed = OneHotEmbedding(vocab_size)
        self.pred = StackedLSTMWithState(embed_size,
                                         hidden_size,
                                         num_layers=num_layers,
                                         dropout=dropout,
                                         rnn_type=rnn,
                                         layer_norm=add_ln,
                                         proj_size=proj_size)
        self.dist = nn.Linear(self.pred.output_size, vocab_size)
        self.drop = nn.Dropout(dropout)

    def init_state(self, batch: int, device=None) -> Tuple:
        return self.pred.init_state(batch, device=device)

    def forward(self, token: torch.Tensor, hidden: Optional[Tuple] = None,
                token_len: Optional[torch.Tensor] = None):
        emb = self.drop(self.lm_embed(token))
        out, hidden = self.pred(emb, state=hidden)
        return self.dist(self.drop(out)), hidden
