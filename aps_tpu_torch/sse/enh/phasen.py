#!/usr/bin/env python
"""PHASEN: the two-stream (amplitude / phase) enhancement network (port of
aps_tpu/sse/enh/phasen.py: GlobalNorm, FTBlock, TSBlock and Phasen
"sse@phasen").

Layout: channel-last N x F x T x C, as in aps_tpu, so that its 1x1 convs
are Linear layers and each BatchNorm normalises the last axis (statistics
over every other one); the 2-D and 1-D convs (SAME padding, odd kernels)
run channel-first between two permutes. GlobalNorm's gamma and beta and
FTBlock's frequency map freq_linear (F x F) are raw parameters
(jax_params). The output is the mixture's spectrum times the amplitude
mask and the unit phase (complex64 N x F x T in mode "freq"), or its
waveform."""

import math
from typing import Optional, Tuple

import torch
from torch import nn

from aps_tpu_torch.asr.base.component import BatchNorm1d
from aps_tpu_torch.asr.base.rnn import SingleRNN
from aps_tpu_torch.const import EPSILON
from aps_tpu_torch.libs import ApsRegisters
from aps_tpu_torch.sse.base import SSEBase


def _bn(channels: int) -> nn.Module:
    # aps_tpu's BatchNorm: epsilon 1e-5, momentum 0.9 (torch: 0.1)
    return BatchNorm1d(channels, eps=1e-5, momentum=0.1)


def _norm_last(bn: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """BatchNorm over the last axis of a channel-last tensor."""
    return bn(x.reshape(-1, x.shape[-1])).view_as(x)


def _conv_last(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """A channel-first 2-D conv on N x F x T x C."""
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def _same_conv2d(cin: int, cout: int, kernel: Tuple[int, int]) -> nn.Module:
    return nn.Conv2d(cin, cout, kernel,
                     padding=(kernel[0] // 2, kernel[1] // 2))


class GlobalNorm(nn.Module):
    """Normalise each sample over (F, T, C), a per-channel affine after."""
    jax_params = ("gamma", "beta")

    def __init__(self, dim: int):
        super(GlobalNorm, self).__init__()
        self.gamma = nn.Parameter(torch.ones(dim))
        self.beta = nn.Parameter(torch.zeros(dim))

    def forward(self, inp: torch.Tensor) -> torch.Tensor:
        mean = inp.mean((1, 2, 3), keepdim=True)
        var = ((inp - mean)**2).mean((1, 2, 3), keepdim=True)
        return self.gamma * (inp - mean) * torch.rsqrt(var + 1e-5) + \
            self.beta


class FTBlock(nn.Module):
    """Frequency transformation block over N x F x T x Ca."""
    jax_params = ("freq_linear",)

    def __init__(self, channel_amp: int, num_bins: int = 257,
                 channel_r: int = 5, conv1d_kernel: int = 9):
        super(FTBlock, self).__init__()
        self.conv1x1_1 = nn.Linear(channel_amp, channel_r)
        self.bn1 = _bn(channel_r)
        self.conv1d = nn.Conv1d(num_bins * channel_r, channel_amp,
                                conv1d_kernel, padding=conv1d_kernel // 2)
        self.bn_att = _bn(channel_amp)
        # a truncated normal of variance ~1 / F, as flax's lecun_normal
        self.freq_linear = nn.Parameter(nn.init.trunc_normal_(
            torch.empty(num_bins, num_bins), std=1 / math.sqrt(num_bins),
            a=-2 / math.sqrt(num_bins), b=2 / math.sqrt(num_bins)))
        self.conv1x1_2 = nn.Linear(2 * channel_amp, channel_amp)
        self.bn2 = _bn(channel_amp)

    def forward(self, inp: torch.Tensor) -> torch.Tensor:
        N, F, T, _ = inp.shape
        out = torch.relu(_norm_last(self.bn1, self.conv1x1_1(inp)))
        # N x T x F*Cr -> (conv over T) -> N x T x Ca
        out = out.transpose(1, 2).reshape(N, T, -1)
        att = self.conv1d(out.transpose(1, 2)).transpose(1, 2)
        att = _norm_last(self.bn_att, att)
        # broadcast over F, then mix the F axis
        out = torch.einsum("gf,nftc->ngtc", self.freq_linear,
                           att[:, None] * inp)
        out = self.conv1x1_2(torch.cat([out, inp], -1))
        return torch.relu(_norm_last(self.bn2, out))


class TSBlock(nn.Module):
    """Two-stream block: the amplitude and the phase stream, each gating
    the other."""

    def __init__(self, channel_amp: int, channel_pha: int,
                 num_bins: int = 257, channel_r: int = 5,
                 conv1d_kernel: int = 9):
        super(TSBlock, self).__init__()
        ftb = lambda: FTBlock(channel_amp, num_bins=num_bins,  # noqa: E731
                              channel_r=channel_r,
                              conv1d_kernel=conv1d_kernel)
        self.ftb1 = ftb()
        self.sa_kernels = [(5, 5), (1, 25), (5, 5)]
        for i, k in enumerate(self.sa_kernels):
            self.add_module(f"sa_conv_{i}",
                            _same_conv2d(channel_amp, channel_amp, k))
            self.add_module(f"sa_bn_{i}", _bn(channel_amp))
        self.ftb2 = ftb()
        self.sp_kernels = [(5, 3), (1, 25)]
        for i, k in enumerate(self.sp_kernels):
            self.add_module(f"sp_conv_{i}",
                            _same_conv2d(channel_pha, channel_pha, k))
            self.add_module(f"sp_bn_{i}", _bn(channel_pha))
        self.att_a = nn.Linear(channel_pha, channel_amp)
        self.att_p = nn.Linear(channel_amp, channel_pha)

    def forward(self, amp: torch.Tensor, pha: torch.Tensor):
        amp = self.ftb1(amp)
        for i in range(len(self.sa_kernels)):
            amp = _conv_last(getattr(self, f"sa_conv_{i}"), amp)
            amp = torch.relu(_norm_last(getattr(self, f"sa_bn_{i}"), amp))
        amp = self.ftb2(amp)
        for i in range(len(self.sp_kernels)):
            pha = _conv_last(getattr(self, f"sp_conv_{i}"), pha)
            pha = torch.relu(_norm_last(getattr(self, f"sp_bn_{i}"), pha))
        amp = torch.tanh(self.att_a(pha)) * amp
        pha = torch.tanh(self.att_p(amp)) * pha
        return amp, pha


@ApsRegisters.sse.register("sse@phasen")
class Phasen(SSEBase):
    """PHASEN on the STFT of the enh transform."""

    def __init__(self,
                 enh_transform: Optional[nn.Module] = None,
                 channel_amp: int = 24,
                 channel_pha: int = 12,
                 num_tsbs: int = 3,
                 num_bins: int = 257,
                 channel_r: int = 5,
                 conv1d_kernel: int = 9,
                 lstm_hidden: int = 256,
                 linear_size: int = 512,
                 training_mode: str = "freq"):
        super(Phasen, self).__init__(enh_transform=enh_transform,
                                     training_mode=training_mode)
        if enh_transform is None:
            raise ValueError("Phasen needs an enh_transform")
        for i, k in enumerate([(7, 1), (1, 7)]):
            self.add_module(f"ca_conv_{i}", _same_conv2d(
                2 if i == 0 else channel_amp, channel_amp, k))
            self.add_module(f"ca_bn_{i}", _bn(channel_amp))
        self.gn0 = GlobalNorm(2)
        self.cp_conv_0 = _same_conv2d(2, channel_pha, (3, 5))
        self.gn1 = GlobalNorm(channel_pha)
        self.cp_conv_1 = _same_conv2d(channel_pha, channel_pha, (25, 1))
        self.num_tsbs = num_tsbs
        for i in range(num_tsbs):
            self.add_module(f"tsb_{i}", TSBlock(
                channel_amp, channel_pha, num_bins=num_bins,
                channel_r=channel_r, conv1d_kernel=conv1d_kernel))
        self.conv1x1_a = nn.Linear(channel_amp, 8)
        self.conv1x1_p = nn.Linear(channel_pha, 2)
        self.blstm = SingleRNN(num_bins * 8, lstm_hidden, rnn_type="lstm",
                               bidirectional=True)
        size = self.blstm.output_size
        for i, out in enumerate([linear_size, linear_size, num_bins]):
            self.add_module(f"lin_{i}", nn.Linear(size, out))
            self.add_module(f"lin_bn_{i}", _bn(out))
            size = out

    def _forward(self, mix: torch.Tensor, mode: str) -> torch.Tensor:
        ctx = self.enh_transform.ctx("forward_stft")
        stft = ctx.forward(mix)
        # N x F x T x 2 channel-last
        inp = torch.stack([stft.real, stft.imag], -1)
        amp = inp
        for i in range(2):
            amp = _conv_last(getattr(self, f"ca_conv_{i}"), amp)
            amp = torch.relu(_norm_last(getattr(self, f"ca_bn_{i}"), amp))
        pha = _conv_last(self.cp_conv_0, self.gn0(inp))
        pha = _conv_last(self.cp_conv_1, self.gn1(pha))
        for i in range(self.num_tsbs):
            amp, pha = getattr(self, f"tsb_{i}")(amp, pha)
        amp = self.conv1x1_a(amp)
        pha = self.conv1x1_p(pha)
        # the unit phase N x F x T x 2
        pha = pha / torch.sqrt(pha[..., 0]**2 + pha[..., 1]**2 +
                               EPSILON)[..., None]
        N, F, T, _ = amp.shape
        out = self.blstm(amp.transpose(1, 2).reshape(N, T, -1))
        for i in range(3):
            out = _norm_last(getattr(self, f"lin_bn_{i}"),
                             getattr(self, f"lin_{i}")(out))
            out = torch.sigmoid(out) if i == 2 else torch.relu(out)
        # mask: N x T x F -> N x F x T
        enh = stft * out.transpose(1, 2) * torch.complex(pha[..., 0],
                                                         pha[..., 1])
        if mode == "freq":
            return enh
        return self.enh_transform.ctx("inverse_stft").inverse(enh)

    def infer_batch(self, mix: torch.Tensor,
                    mode: str = "time") -> torch.Tensor:
        return self._forward(mix, mode)

    def forward(self, mix: torch.Tensor) -> torch.Tensor:
        """mix: N x S -> the enhanced spectrum N x F x T (complex) or
        waveform N x S', as training_mode says."""
        self.check_args(mix, training=True, valid_dim=[2])
        return self._forward(mix, self.training_mode)

    def infer(self, mix: torch.Tensor, mode: str = "time") -> torch.Tensor:
        self.check_args(mix, training=False, valid_dim=[1])
        return self._forward(mix[None], mode)[0]
