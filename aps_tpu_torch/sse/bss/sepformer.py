#!/usr/bin/env python
"""SepFormer in the time and the frequency domain (port of
aps_tpu/sse/bss/sepformer.py: ChunkTransformer, SepFormer, TimeSepFormer
"sse@time_sepformer" and FreqSepFormer "sse@freq_sepformer").

The dual-path layout of aps_tpu_torch/sse/bss/dprnn.py with transformer
blocks (the port's TransformerEncoder, abs pose, no projection) in place
of the LSTM ones. Their self-attention is eligible for the flash kernel of
csrc/attention.cu on the card (aps_tpu_torch/asr/transformer/impl.py: an
abs-pose self-attention takes it at any length, where aps_tpu takes its
TPU kernel from 512 query frames on) whenever no attention dropout is
active: always in eval, in training with att_dropout 0."""

from typing import Dict, List, Optional

import torch
from torch import nn

from aps_tpu_torch.asr.transformer.encoder import TransformerEncoder
from aps_tpu_torch.libs import ApsRegisters
from aps_tpu_torch.sse.base import FreqMaskingSSE, MaskNonLinear, SSEBase
from aps_tpu_torch.sse.bss.dprnn import chunk_fold
from aps_tpu_torch.sse.bss.tcn import NormalizeLayer
from aps_tpu_torch.transform.utils import frame_signal


class ChunkTransformer(nn.Module):
    """A transformer over the axis that is second of N x L x K x C;
    returns N x K x L x C (the two axes swapped)."""

    def __init__(self, arch: str = "xfmr", num_layers: int = 2,
                 arch_kwargs: Optional[Dict] = None):
        super(ChunkTransformer, self).__init__()
        self.chunk_xfmr = TransformerEncoder(arch, -1, num_layers=num_layers,
                                             proj="none", pose="abs",
                                             arch_kwargs=arch_kwargs)

    def forward(self, chunk: torch.Tensor) -> torch.Tensor:
        N, L, K, C = chunk.shape
        chunk = chunk.transpose(1, 2).reshape(N * K, L, C)
        out, _ = self.chunk_xfmr(chunk, None)
        return out.reshape(N, K, L, C)


class SepFormer(nn.Module):
    """Dual-path transformer separator + mask head:
    N x C x T -> masks N x S*C x T."""

    def __init__(self, arch: str, num_bins: int = 256, num_spks: int = 2,
                 num_blocks: int = 2, num_layers: int = 2,
                 chunk_size: int = 320, arch_kwargs: Optional[Dict] = None):
        super(SepFormer, self).__init__()
        arch_kwargs = arch_kwargs or {}
        att_dim = arch_kwargs["att_dim"]
        self.chunk_size = chunk_size
        self.num_xfmrs = num_blocks * 2
        self.linear1 = nn.Linear(num_bins, att_dim)
        for i in range(self.num_xfmrs):
            self.add_module(f"xfmr_{i}", ChunkTransformer(
                arch=arch, num_layers=num_layers, arch_kwargs=arch_kwargs))
        # flax's PReLU starts at 0.01
        self.prelu = nn.PReLU(init=0.01)
        self.linear2 = nn.Linear(att_dim, num_bins)
        self.linear3 = nn.Linear(num_bins, num_bins * num_spks)

    def forward(self, inp: torch.Tensor) -> torch.Tensor:
        T = inp.shape[-1]
        hop = self.chunk_size // 2
        # N x C x L x K -> N x L x K x C
        chunks = frame_signal(inp, self.chunk_size, hop).permute(0, 2, 3, 1)
        chunks = self.linear1(chunks)
        for i in range(self.num_xfmrs):
            chunks = getattr(self, f"xfmr_{i}")(chunks)
        chunks = self.linear2(self.prelu(chunks)).permute(0, 3, 1, 2)
        out = chunk_fold(chunks, hop, T)
        # the mask head: a 1x1 conv over the channels
        return self.linear3(out.transpose(1, 2)).transpose(1, 2)


@ApsRegisters.sse.register("sse@time_sepformer")
class TimeSepFormer(SSEBase):
    """Time-domain SepFormer: a strided conv encoder, cLN, the dual-path
    transformer masks, a transposed conv decoder."""

    def __init__(self, arch: str = "xfmr", stride: int = 8, kernel: int = 16,
                 num_bins: int = 256, num_spks: int = 2,
                 non_linear: str = "relu", num_blocks: int = 2,
                 num_layers: int = 2, chunk_size: int = 320,
                 arch_kwargs: Optional[Dict] = None,
                 training_mode: str = "time", enh_transform=None):
        super(TimeSepFormer, self).__init__(enh_transform=enh_transform,
                                            training_mode=training_mode)
        self.num_spks = num_spks
        self.encoder = nn.Conv1d(1, num_bins, kernel, stride=stride)
        self.enc_norm = NormalizeLayer("cLN", num_bins)
        self.separator = SepFormer(arch, num_bins=num_bins,
                                   num_spks=num_spks, num_blocks=num_blocks,
                                   num_layers=num_layers,
                                   chunk_size=chunk_size,
                                   arch_kwargs=arch_kwargs)
        self.mask_act = MaskNonLinear(non_linear,
                                      enable="positive_wo_softmax")
        self.decoder = nn.ConvTranspose1d(num_bins, 1, kernel, stride=stride)

    def forward(self, mix: torch.Tensor):
        """mix: N x S -> [N x S', ...] (one tensor for one speaker)"""
        self.check_args(mix, training=True, valid_dim=[2])
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


@ApsRegisters.sse.register("sse@freq_sepformer")
class FreqSepFormer(FreqMaskingSSE):
    """Frequency-domain SepFormer over the enh transform's features."""

    def __init__(self, enh_transform: Optional[nn.Module] = None,
                 arch: str = "xfmr", num_bins: int = 257, num_spks: int = 2,
                 non_linear: str = "relu", num_blocks: int = 2,
                 num_layers: int = 2, chunk_size: int = 64,
                 arch_kwargs: Optional[Dict] = None,
                 training_mode: str = "freq"):
        super(FreqSepFormer, self).__init__(enh_transform=enh_transform,
                                            num_spks=num_spks,
                                            training_mode=training_mode)
        self.separator = SepFormer(arch, num_bins=num_bins,
                                   num_spks=num_spks, num_blocks=num_blocks,
                                   num_layers=num_layers,
                                   chunk_size=chunk_size,
                                   arch_kwargs=arch_kwargs)
        self.mask_act = MaskNonLinear(non_linear, enable="common")

    def _tf_mask(self, feats: torch.Tensor) -> List[torch.Tensor]:
        """feats: N x T x F -> [N x F x T, ...]"""
        masks = self.mask_act(self.separator(feats.transpose(1, 2)))
        return list(torch.chunk(masks, self.num_spks, 1))
