#!/usr/bin/env python
"""Google's filter-and-sum and complex linear projection front ends (port
of aps_tpu/asr/filter/google.py: UnfactedFsBeamformer, FactedFsBeamformer,
ComplexLinear and CLPFsBeamformer, registered "google_clp").

The two filter-and-sum beamformers work on the raw waveform N x C x S;
the CLP front end on the complex64 STFT N x C x F x T, through a trainable
FixedBeamformer (the parameter beam/weight, (2, B, C, F, 1)) and a complex
linear projection whose real and imaginary Dense layers keep aps_tpu's
names."""

from typing import Optional

import torch
from torch import nn

from aps_tpu_torch.asr.base.component import BatchNorm2d
from aps_tpu_torch.asr.filter.conv import (EnhFrontEnds, lecun_param,
                                           spectra_param)
from aps_tpu_torch.transform.enh import FixedBeamformer
from aps_tpu_torch.transform.utils import frame_signal


class UnfactedFsBeamformer(nn.Module):
    """Unfactored filter-and-sum beamformer on the raw waveform.
    forward(x N x C x S) -> N x F x T."""

    def __init__(self, num_taps: int = 400, win_size: int = 560,
                 num_channels: int = 4, num_filters: int = 256,
                 log_compress: bool = True):
        super(UnfactedFsBeamformer, self).__init__()
        self.num_taps, self.win_size = num_taps, win_size
        self.log_compress = log_compress
        self.filter = lecun_param((num_channels, num_filters, num_taps))
        self.jax_params = ("filter",)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() == 2:
            x = x[None]
        hop = self.win_size - self.num_taps
        # N x C x T x M frames, then N x C x T x M' x taps
        taps = frame_signal(x, self.win_size, hop).unfold(-1, self.num_taps,
                                                          1)
        # convolve and sum over the channels: N x F x T x M'
        f = torch.einsum("cfk,nctmk->nftm", self.filter, taps)
        y = torch.relu(f.amax(-1))
        if self.log_compress:
            y = torch.log(y + 0.01)
        return y


class FactedFsBeamformer(nn.Module):
    """Factored (spatial, then spectral) filter-and-sum beamformer.
    forward(x N x C x S) -> N x P x F x T."""

    def __init__(self, num_taps: int = 81, win_size: int = 560,
                 num_channels: int = 4, spatial_filters: int = 10,
                 spectra_filters: int = 128, spectra_kernels: int = 400,
                 log_compress: bool = True):
        super(FactedFsBeamformer, self).__init__()
        self.num_taps, self.win_size = num_taps, win_size
        self.spectra_kernels = spectra_kernels
        self.log_compress = log_compress
        self.spatial = lecun_param((num_channels, spatial_filters, num_taps))
        self.spectra = lecun_param((spectra_filters, spectra_kernels))
        self.jax_params = ("spatial", "spectra")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() == 2:
            x = x[None]
        hop = self.win_size - self.spectra_kernels
        frames = frame_signal(x, self.win_size, hop)  # N x C x T x M
        pad = (self.num_taps - 1) // 2
        taps = nn.functional.pad(frames, (pad, self.num_taps - 1 - pad))
        taps = taps.unfold(-1, self.num_taps, 1)  # N x C x T x M x taps
        f = torch.einsum("cpk,nctmk->nptm", self.spatial, taps)
        # spectral conv over M: N x P x T x M' x K
        f2 = f.unfold(-1, self.spectra_kernels, 1)
        w = torch.einsum("fk,nptmk->npftm", self.spectra, f2)
        y = torch.relu(w.amax(-1))
        if self.log_compress:
            y = torch.log(y + 0.01)
        return y


class ComplexLinear(nn.Module):
    """A complex linear layer as two real ones, "real" and "imag"."""

    def __init__(self, in_features: int, out_features: int,
                 use_bias: bool = True):
        super(ComplexLinear, self).__init__()
        self.real = nn.Linear(in_features, out_features, bias=use_bias)
        self.imag = nn.Linear(in_features, out_features, bias=use_bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """complex ... x in -> complex ... x out"""
        xr, xi = x.real, x.imag
        return torch.complex(self.real(xr) - self.imag(xi),
                             self.real(xi) + self.imag(xr))


class CLPFsBeamformer(nn.Module):
    """Complex linear projection beamformer in the frequency domain.
    forward(x N x C x F x T complex) -> N x T x P*G."""

    def __init__(self,
                 num_bins: int = 257,
                 weight: Optional[str] = None,
                 batchnorm: bool = True,
                 num_channels: int = 4,
                 spatial_filters: int = 5,
                 spectra_filters: int = 128,
                 spectra_init: str = "random",
                 spectra_complex: bool = True,
                 spatial_maxpool: bool = False):
        super(CLPFsBeamformer, self).__init__()
        if spectra_init not in ["mel", "random"]:
            raise ValueError(f"Unsupported init: {spectra_init}")
        self.beam = FixedBeamformer(spatial_filters, num_channels, num_bins,
                                    weight=weight, requires_grad=True)
        self.spectra_complex = spectra_complex
        if spectra_complex:
            self.proj = ComplexLinear(num_bins, spectra_filters,
                                      use_bias=False)
        else:
            spectra_param(self, num_bins, spectra_filters, spectra_init)
        self.bnorm = BatchNorm2d(spatial_filters, eps=1e-5, momentum=0.1) \
            if batchnorm else None

    def forward(self, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
        if x.dim() == 3:
            x = x[None]
        # N x P x T x F
        b = self.beam(x, trans=True)
        if self.spectra_complex:
            w = self.proj(b)
            w = torch.sqrt(w.real**2 + w.imag**2 + eps)
        else:
            p = torch.sqrt(b.real**2 + b.imag**2 + eps)
            w = torch.relu(p @ self.proj) + eps
        z = torch.log(w)
        if self.bnorm is not None:
            # N x P x T x G, the channel axis 1
            z = self.bnorm(z)
        z = z.transpose(1, 2)
        return z.reshape(*z.shape[:2], -1)


EnhFrontEnds.register("google_clp")(CLPFsBeamformer)
