#!/usr/bin/env python
"""Learned convolutional multi-channel front ends (port of
aps_tpu/asr/filter/conv.py: the EnhFrontEnds registry, "time_invar",
"time_invar_att" and "time_variant").

aps_tpu's per-bin complex products (the reference's grouped complex convs)
are real einsums over (real, imag) pairs; here they are complex64 einsums.
Each complex weight stays the pair of real parameters <name>_real and
<name>_imag, as in aps_tpu, combined with torch.complex in the forward
pass: the converter maps them one to one and an optimizer sees two real
tensors, as optax does. Spectra come in as N x C x F x T complex64 (the enh
transform's encode)."""

import math
from typing import Optional, Tuple

import torch
from torch import nn

from aps_tpu_torch.asr.base.component import BatchNorm1d, BatchNorm2d
from aps_tpu_torch.asr.base.encoder import PyTorchRNNEncoder
from aps_tpu_torch.libs import Register
from aps_tpu_torch.transform.utils import mel_filter

EnhFrontEnds = Register("enh_filter")


def lecun_param(shape: Tuple[int, ...]) -> nn.Parameter:
    """A parameter drawn as flax's lecun_normal draws it (variance 1 /
    fan_in, fan_in the second-last axis times the leading ones); the values
    themselves come from a checkpoint or from training."""
    fan_in = shape[-2] * math.prod(shape[:-2])
    return nn.Parameter(torch.randn(shape) / math.sqrt(fan_in))


def add_cplx_param(module: nn.Module, name: str, shape: Tuple[int, ...]):
    """Register the complex weight `name` as the real parameters
    <name>_real and <name>_imag (aps_tpu's leaves of the same names)."""
    for part in ("real", "imag"):
        setattr(module, f"{name}_{part}", lecun_param(shape))
    module.jax_params = getattr(module, "jax_params", ()) + (
        f"{name}_real", f"{name}_imag")


def cplx_weight(module: nn.Module, name: str) -> torch.Tensor:
    return torch.complex(getattr(module, f"{name}_real"),
                         getattr(module, f"{name}_imag"))


def cabs(x: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """|x| as aps_tpu computes it: sqrt(re^2 + im^2 + eps)."""
    return torch.sqrt(x.real**2 + x.imag**2 + eps)


def spectra_param(module: nn.Module, num_bins: int, num_filters: int,
                  init: str):
    """The F x D spectra projection "proj": the mel filterbank ("mel") or
    random."""
    if init not in ["mel", "random"]:
        raise ValueError(f"Unsupported init: {init}")
    if init == "mel":
        module.proj = nn.Parameter(torch.as_tensor(
            mel_filter(None, num_bins=num_bins, num_mels=num_filters).T,
            dtype=torch.float32))
    else:
        module.proj = lecun_param((num_bins, num_filters))
    module.jax_params = getattr(module, "jax_params", ()) + ("proj",)


class TimeInvariantFilter(nn.Module):
    """Per-bin time-invariant complex beamforming + spectra projection.
    forward(x N x C x F x T complex) -> N x T x B*D."""

    def __init__(self,
                 num_bins: int = 257,
                 weight: Optional[str] = None,
                 num_channels: int = 4,
                 spatial_filters: int = 8,
                 spectra_filters: int = 80,
                 spectra_init: str = "random",
                 batchnorm: bool = True,
                 apply_log: bool = True):
        super(TimeInvariantFilter, self).__init__()
        self.num_channels = num_channels
        self.apply_log = apply_log
        add_cplx_param(self, "beam", (num_bins, spatial_filters,
                                      num_channels))
        spectra_param(self, num_bins, spectra_filters, spectra_init)
        # aps_tpu: BatchNorm over axis 1 (the spatial filters), momentum 0.9
        self.bnorm = BatchNorm2d(spatial_filters, eps=1e-5, momentum=0.1) \
            if batchnorm else None

    def forward(self, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
        N, C, F, T = x.shape
        if C != self.num_channels:
            raise ValueError(f"expected {self.num_channels} channels, "
                             f"got {C}")
        # N x B x F x T
        b = cabs(torch.einsum("fbc,ncft->nbft", cplx_weight(self, "beam"),
                              x), eps=eps)
        f = torch.relu(torch.einsum("nbft,fd->nbtd", b, self.proj))
        if self.apply_log:
            f = torch.log(f + eps)
        if self.bnorm is not None:
            f = self.bnorm(f)
        # N x T x B*D
        return f.transpose(1, 2).reshape(N, T, -1)


EnhFrontEnds.register("time_invar")(TimeInvariantFilter)


class TimeInvariantAttFilter(nn.Module):
    """Time-invariant front end with attention over the beams.
    forward(x N x C x F x T complex) -> N x T x D."""

    def __init__(self,
                 num_bins: int = 257,
                 weight: Optional[str] = None,
                 num_channels: int = 4,
                 spatial_filters: int = 8,
                 spectra_filters: int = 80,
                 spectra_init: str = "random",
                 query_type: str = "rnn",
                 batchnorm: bool = True,
                 apply_log: bool = True):
        super(TimeInvariantAttFilter, self).__init__()
        if query_type not in ["rnn", "conv"]:
            raise ValueError(f"Unsupported query type: {query_type}")
        self.num_channels = num_channels
        self.apply_log = apply_log
        self.pred_q = None
        if query_type == "conv":
            add_cplx_param(self, "query", (num_bins, 1, num_channels))
        else:
            self.pred_q = PyTorchRNNEncoder(num_bins, num_bins, dropout=0.2,
                                            hidden=512)
        add_cplx_param(self, "value", (num_bins, spatial_filters,
                                       num_channels))
        add_cplx_param(self, "key", (num_bins, spatial_filters,
                                     num_channels))
        spectra_param(self, num_bins, spectra_filters, spectra_init)
        # aps_tpu: BatchNorm over the last axis, momentum 0.9
        self.bnorm = BatchNorm1d(spectra_filters, eps=1e-5, momentum=0.1) \
            if batchnorm else None

    def _beam(self, name: str, x: torch.Tensor, eps: float) -> torch.Tensor:
        """-> N x T x F x B"""
        return cabs(torch.einsum("fbc,ncft->ntfb", cplx_weight(self, name),
                                 x), eps=eps)

    def forward(self, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
        N, C, F, T = x.shape
        if C != self.num_channels:
            raise ValueError(f"expected {self.num_channels} channels, "
                             f"got {C}")
        if self.pred_q is None:
            bq = self._beam("query", x, eps)[..., 0]  # N x T x F
        else:
            x_ch0 = cabs(x[:, 0], eps=eps)  # N x F x T
            bq = torch.relu(self.pred_q(x_ch0.transpose(1, 2))[0])
        bv = self._beam("value", x, eps)  # N x T x F x B
        bk = self._beam("key", x, eps)
        s = (bq[..., None] * bk).sum(-2).mean(-2, keepdim=True)  # N x 1 x B
        w = torch.softmax(s, -1)
        v = (w[:, None] * bv).sum(-1)  # N x T x F
        f = torch.relu(v @ self.proj)
        if self.apply_log:
            f = torch.log(f + eps)
        if self.bnorm is not None:
            f = self.bnorm(f.transpose(1, 2)).transpose(1, 2)
        return f


EnhFrontEnds.register("time_invar_att")(TimeInvariantAttFilter)


class TimeVariantFilter(nn.Module):
    """Per-bin time-variant complex filtering over time_reception frames.
    forward(x N x C x F x T complex) -> N x T x B*D."""

    def __init__(self,
                 num_bins: int = 257,
                 num_channels: int = 4,
                 time_reception: int = 11,
                 spatial_filters: int = 8,
                 spectra_filters: int = 80,
                 batchnorm: bool = True):
        super(TimeVariantFilter, self).__init__()
        self.num_channels = num_channels
        self.time_reception = time_reception
        add_cplx_param(self, "filter", (num_bins, spatial_filters,
                                        time_reception, num_channels))
        self.proj = lecun_param((num_bins, spectra_filters))
        self.jax_params += ("proj",)
        self.bnorm = BatchNorm2d(spatial_filters, eps=1e-5, momentum=0.1) \
            if batchnorm else None

    def forward(self, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
        N, C, F, T = x.shape
        if C != self.num_channels:
            raise ValueError(f"expected {self.num_channels} channels, "
                             f"got {C}")
        R = self.time_reception
        pad = (R - 1) // 2
        # N x C x F x T x R reception windows
        xw = nn.functional.pad(x, (pad, R - 1 - pad)).unfold(-1, R, 1)
        b = cabs(torch.einsum("fbrc,ncftr->nbft", cplx_weight(self, "filter"),
                              xw), eps=eps)
        f = torch.einsum("nbft,fd->nbtd", b, self.proj)
        f = torch.log(torch.relu(f) + eps)
        if self.bnorm is not None:
            f = self.bnorm(f)
        return f.transpose(1, 2).reshape(N, T, -1)


EnhFrontEnds.register("time_variant")(TimeVariantFilter)
