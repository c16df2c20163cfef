#!/usr/bin/env python
"""DEMUCS waveform U-net enhancer (port of aps_tpu/sse/enh/demucs.py:
kernel_sampling, workout_train_chunk_length, upsample2 / downsample2 and
DEMUCS "sse@demucs").

As in aps_tpu: the input is divided by its population standard deviation
(torch.std with correction 0) plus EPSILON and the output multiplied back;
the sinc resampler is a cross-correlation with the fixed windowed-sinc
kernel, trimmed at the head (upsampling) or the tail (downsampling); each
decoder layer adds the encoder's output cropped to its own length; the
layers run channel-last (N x T x C), so that the 1x1 layers are Linear
ones. `rescale` is accepted and never read, as in aps_tpu (the reference's
weight rescaling at initialisation has no counterpart there)."""

import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as tf
from torch import nn

from aps_tpu_torch.asr.base.rnn import StackedRNN
from aps_tpu_torch.const import EPSILON
from aps_tpu_torch.libs import ApsRegisters
from aps_tpu_torch.sse.base import SSEBase


def kernel_sampling(zeros: int = 56) -> np.ndarray:
    """The windowed sinc of the 2x resampler (2 * zeros taps)."""
    win = np.hanning(4 * zeros + 1)  # symmetric window
    winodd = win[1::2]
    t = np.linspace(-zeros + 0.5, zeros - 0.5, 2 * zeros)
    return (np.sinc(t) * winodd).astype(np.float32)


def workout_train_chunk_length(inp_len: int,
                               resampling_factor: int = 1,
                               num_encoders: int = 5,
                               kernel: int = 8,
                               stride: int = 2) -> int:
    """The least length >= inp_len that the U-net gives back whole."""
    out_len = inp_len * resampling_factor
    for _ in range(num_encoders):
        out_len = math.ceil((out_len - kernel) / stride) + 1
    for _ in range(num_encoders):
        out_len = (out_len - 1) * stride + kernel
    return math.ceil(out_len / resampling_factor)


@lru_cache(maxsize=8)
def _sinc_kernel(zeros: int, device: torch.device,
                 dtype: torch.dtype) -> torch.Tensor:
    """kernel_sampling's taps as a 1 x 1 x W conv weight, copied to the
    device once (a copy from pageable memory in every call would wait for
    the card's queue)."""
    return torch.from_numpy(kernel_sampling(zeros)).to(device,
                                                       dtype)[None, None]


def _sinc_correlate(x: torch.Tensor, trim: str, zeros: int) -> torch.Tensor:
    """Correlate the last axis with the sinc kernel (zero padded by
    `zeros` on each side), dropping the first ("head") or the last
    ("tail") output."""
    lead = x.shape[:-1]
    out = tf.conv1d(x.reshape(-1, 1, x.shape[-1]),
                    _sinc_kernel(zeros, x.device, x.dtype),
                    padding=zeros)[:, 0]
    out = out[:, 1:] if trim == "head" else out[:, :-1]
    return out.reshape(lead + out.shape[-1:])


def upsample2(x: torch.Tensor, zeros: int = 56) -> torch.Tensor:
    """2x sinc upsampling of the last axis."""
    out = _sinc_correlate(x, "head", zeros)
    return torch.stack([x, out], -1).reshape(x.shape[:-1] + (-1,))


def downsample2(x: torch.Tensor, zeros: int = 56) -> torch.Tensor:
    """2x sinc downsampling of the last axis."""
    if x.shape[-1] % 2:
        x = tf.pad(x, (0, 1))
    xeven, xodd = x[..., ::2], x[..., 1::2]
    return (xeven + _sinc_correlate(xodd, "tail", zeros)) * 0.5


@ApsRegisters.sse.register("sse@demucs")
class DEMUCS(SSEBase):
    """Real-time waveform-domain enhancement (Defossez et al. 2020):
    enc_conv_i / enc_pw_i, the bottleneck LSTM (and its proj when
    bidirectional), dec_pw_i / dec_conv_i."""

    def __init__(self, channel: int = 64, stride: int = 2, kernel: int = 8,
                 resampling_factor: int = 1, num_layers: int = 5,
                 rnn_layers: int = 2, growth: float = 2,
                 bidirectional: bool = False, rescale: float = 0.1,
                 training_mode: str = "time", enh_transform=None):
        super(DEMUCS, self).__init__(enh_transform=enh_transform,
                                     training_mode=training_mode)
        if resampling_factor not in (1, 2, 4):
            raise ValueError("DEMUCS: resampling_factor should be 1, 2 or "
                             f"4, got {resampling_factor}")
        self.stride, self.kernel = stride, kernel
        self.resampling_factor = resampling_factor
        self.num_layers = num_layers
        self.rescale = rescale  # never read, as in aps_tpu
        width = lambda i: int(channel * growth**i)  # noqa: E731
        for i in range(num_layers):
            self.add_module(f"enc_conv_{i}", nn.Conv1d(
                1 if i == 0 else width(i - 1), width(i), kernel,
                stride=stride))
            self.add_module(f"enc_pw_{i}", nn.Linear(width(i), width(i)))
        hidden = width(num_layers - 1)
        self.lstm = StackedRNN(hidden, hidden, num_layers=rnn_layers,
                               rnn_type="lstm", bidirectional=bidirectional)
        self.proj = nn.Linear(2 * hidden, hidden) if bidirectional else None
        for i in range(num_layers):
            ch_in = width(num_layers - 1 - i)
            ch_out = 1 if i == num_layers - 1 else width(num_layers - 2 - i)
            self.add_module(f"dec_pw_{i}", nn.Linear(ch_in, ch_in))
            self.add_module(f"dec_conv_{i}", nn.ConvTranspose1d(
                ch_in, ch_out, kernel, stride=stride))

    def _conv(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """A channel-first conv on N x T x C."""
        return getattr(self, name)(x.transpose(1, 2)).transpose(1, 2)

    def forward(self, mix: torch.Tensor) -> torch.Tensor:
        """mix: N x S -> enh N x S'"""
        self.check_args(mix, training=True, valid_dim=[2])
        std = torch.std(mix, -1, keepdim=True, correction=0)
        sig = mix / (std + EPSILON)
        for _ in range(int(math.log2(self.resampling_factor))):
            sig = upsample2(sig)
        out = sig[..., None]  # N x S x 1
        enc_out = []
        for i in range(self.num_layers):
            out = torch.relu(self._conv(f"enc_conv_{i}", out))
            out = torch.relu(getattr(self, f"enc_pw_{i}")(out))
            enc_out.append(out)
        out = self.lstm(out)
        if self.proj is not None:
            out = self.proj(out)
        for i in range(self.num_layers):
            out = enc_out[-1 - i][:, :out.shape[1]] + out
            out = torch.relu(getattr(self, f"dec_pw_{i}")(out))
            out = self._conv(f"dec_conv_{i}", out)
            if i != self.num_layers - 1:
                out = torch.relu(out)
        enh = out[..., 0]
        for _ in range(int(math.log2(self.resampling_factor))):
            enh = downsample2(enh)
        return enh * std

    def padded_len(self, num_samples: int) -> int:
        return workout_train_chunk_length(
            num_samples, resampling_factor=self.resampling_factor,
            num_encoders=self.num_layers, kernel=self.kernel,
            stride=self.stride)

    def infer_batch(self, mix: torch.Tensor,
                    mode: str = "time") -> torch.Tensor:
        """mix: N x S -> N x S: zero-padded to the length the U-net gives
        back whole, enhanced, cut back."""
        S = mix.shape[-1]
        pad = self.padded_len(S) - S
        inp = tf.pad(mix, (0, pad)) if pad else mix
        return self.forward(inp)[:, :S]

    def infer(self, mix: torch.Tensor, mode: str = "time") -> torch.Tensor:
        """mix: S -> S; the module should be in eval mode."""
        self.check_args(mix, training=False, valid_dim=[1])
        return self.infer_batch(mix[None], mode)[0]
