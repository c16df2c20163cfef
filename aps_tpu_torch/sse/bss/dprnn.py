#!/usr/bin/env python
"""Dual-path RNN separation (port of aps_tpu/sse/bss/dprnn.py: LSTMBlock,
DPRNN, TimeDPRNN "sse@time_dprnn" and FreqDPRNN "sse@freq_dprnn").

The separator cuts N x C x T into chunks of K frames with hop K/2
(frame_signal: the frames past the last whole chunk are dropped), runs
2 x num_layers LSTM blocks, each along the axis that is second and then
swapped with the third (so the blocks alternate between the chunks and the
frames inside a chunk), and overlap-adds the masks back. As in aps_tpu,
the masks of the dropped tail frames are zeros: the last frames of every
output are 0 when (T - K) is not a multiple of K/2. Block 2i is
bidirectional, block 2i+1 as `bidirectional` says."""

from typing import List, Optional

import torch
import torch.nn.functional as tf
from torch import nn

from aps_tpu_torch.asr.base.rnn import SingleRNN
from aps_tpu_torch.asr.transformer.impl import LN_EPS
from aps_tpu_torch.libs import ApsRegisters
from aps_tpu_torch.sse.base import FreqMaskingSSE, MaskNonLinear, SSEBase
from aps_tpu_torch.sse.bss.tcn import NormalizeLayer
from aps_tpu_torch.transform.utils import frame_signal, overlap_add


def chunk_fold(chunks: torch.Tensor, hop: int, T: int) -> torch.Tensor:
    """N x C x L x K chunks -> N x C x T: overlap-added, the frames past the
    last whole chunk zero (torch's fold with output_size=T)."""
    out = overlap_add(chunks, hop)
    if out.shape[-1] < T:
        out = tf.pad(out, (0, T - out.shape[-1]))
    return out[..., :T]


class LSTMBlock(nn.Module):
    """LSTM + dense + layer norm + residual along the L axis of
    N x L x K x C; returns N x K x L x C (the two axes swapped)."""

    def __init__(self, input_size: int, hidden_size: int,
                 bidirectional: bool = True):
        super(LSTMBlock, self).__init__()
        self.single_rnn = SingleRNN(input_size, hidden_size,
                                    rnn_type="lstm",
                                    bidirectional=bidirectional)
        self.dense = nn.Linear(self.single_rnn.output_size, input_size)
        self.lnorm = nn.LayerNorm(input_size, eps=LN_EPS)

    def forward(self, chunk: torch.Tensor) -> torch.Tensor:
        N, L, K, C = chunk.shape
        chunk = chunk.transpose(1, 2).reshape(N * K, L, C)
        out = chunk + self.lnorm(self.dense(self.single_rnn(chunk)))
        return out.reshape(N, K, L, C)


class DPRNN(nn.Module):
    """Alternating intra/inter chunk LSTM blocks + mask head:
    N x C x T -> masks N x S*C x T."""

    def __init__(self, num_bins: int = 256, num_spks: int = 2,
                 num_layers: int = 2, chunk_size: int = 320,
                 rnn_hidden: int = 128, bidirectional: bool = True):
        super(DPRNN, self).__init__()
        self.chunk_size = chunk_size
        self.num_blocks = num_layers * 2
        for i in range(self.num_blocks):
            self.add_module(f"block_{i}", LSTMBlock(
                num_bins, rnn_hidden,
                bidirectional=True if i % 2 == 0 else bidirectional))
        # flax's PReLU starts at 0.01
        self.prelu = nn.PReLU(init=0.01)
        self.dense = nn.Linear(num_bins, num_bins * num_spks)

    def forward(self, inp: torch.Tensor) -> torch.Tensor:
        T = inp.shape[-1]
        hop = self.chunk_size // 2
        # N x C x L x K -> N x L x K x C
        chunks = frame_signal(inp, self.chunk_size, hop).permute(0, 2, 3, 1)
        for i in range(self.num_blocks):
            chunks = getattr(self, f"block_{i}")(chunks)
        # an even number of swaps: N x L x K x S*C -> N x S*C x L x K
        chunks = self.dense(self.prelu(chunks)).permute(0, 3, 1, 2)
        return chunk_fold(chunks, hop, T)


@ApsRegisters.sse.register("sse@time_dprnn")
class TimeDPRNN(SSEBase):
    """Time-domain dual-path RNN: a strided conv encoder (no bias), cLN,
    the dual-path masks, a transposed conv decoder (no bias)."""

    def __init__(self, num_spks: int = 2, num_bins: int = 64,
                 kernel: int = 16, stride: int = 8, chunk_size: int = 100,
                 num_layers: int = 6, bidirectional: bool = True,
                 rnn_hidden: int = 128, non_linear: str = "relu",
                 training_mode: str = "time", enh_transform=None):
        super(TimeDPRNN, self).__init__(enh_transform=enh_transform,
                                        training_mode=training_mode)
        self.num_spks = num_spks
        self.encoder = nn.Conv1d(1, num_bins, kernel, stride=stride,
                                 bias=False)
        self.enc_norm = NormalizeLayer("cLN", num_bins)
        self.separator = DPRNN(num_bins=num_bins, num_spks=num_spks,
                               num_layers=num_layers, chunk_size=chunk_size,
                               rnn_hidden=rnn_hidden,
                               bidirectional=bidirectional)
        self.mask_act = MaskNonLinear(non_linear,
                                      enable="positive_wo_softmax")
        self.decoder = nn.ConvTranspose1d(num_bins, 1, kernel, stride=stride,
                                          bias=False)

    def forward(self, mix: torch.Tensor):
        """mix: N x S -> [N x S', ...] (one tensor for one speaker)"""
        self.check_args(mix, training=True, valid_dim=[2])
        # N x F x T
        w = self.enc_norm(torch.relu(self.encoder(mix[:, None])).transpose(
            1, 2)).transpose(1, 2)
        masks = torch.chunk(self.mask_act(self.separator(w)), self.num_spks,
                            1)
        bss = [self.decoder(w * m)[:, 0] for m in masks]
        return bss[0] if self.num_spks == 1 else bss

    def infer(self, mix: torch.Tensor, mode: str = "time"):
        """mix: S -> [S', ...]; the module should be in eval mode."""
        self.check_args(mix, training=False, valid_dim=[1])
        sep = self.forward(mix[None])
        return sep[0] if self.num_spks == 1 else [s[0] for s in sep]


@ApsRegisters.sse.register("sse@freq_dprnn")
class FreqDPRNN(FreqMaskingSSE):
    """Frequency-domain dual-path RNN over the enh transform's features."""

    def __init__(self, enh_transform: Optional[nn.Module] = None,
                 num_spks: int = 2, num_bins: int = 257,
                 non_linear: str = "relu", chunk_size: int = 64,
                 num_layers: int = 6, rnn_hidden: int = 256,
                 bidirectional: bool = True, training_mode: str = "freq"):
        super(FreqDPRNN, self).__init__(enh_transform=enh_transform,
                                        num_spks=num_spks,
                                        training_mode=training_mode)
        self.separator = DPRNN(num_bins=num_bins, num_spks=num_spks,
                               num_layers=num_layers, chunk_size=chunk_size,
                               rnn_hidden=rnn_hidden,
                               bidirectional=bidirectional)
        self.mask_act = MaskNonLinear(non_linear, enable="common")

    def _tf_mask(self, feats: torch.Tensor) -> List[torch.Tensor]:
        """feats: N x T x F -> [N x F x T, ...]"""
        masks = self.mask_act(self.separator(feats.transpose(1, 2)))
        return list(torch.chunk(masks, self.num_spks, 1))
