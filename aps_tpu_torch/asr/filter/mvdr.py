#!/usr/bin/env python
"""Mask-based MVDR beamforming front end (port of
aps_tpu/asr/filter/mvdr.py: trace, beamform, estimate_covar,
ChannelAttention, MvdrBeamformer and RNNMaskMvdr, registered
"rnn_mask_mvdr").

Spectra are complex64 N x C x F x T. The noise covariance, loaded on its
diagonal with eps, is solved against the speech covariance through the
port's clamped Hermitian Cholesky (aps_tpu_torch.cplx), as aps_tpu solves
it through the real embedding; the covariances, the solve and the
beamforming are torch.einsum and torch.linalg on complex64, outside any
hand-written kernel (none of them is a Pallas kernel in aps_tpu); the
covariances' sums over frames are real products, as aps_tpu's are."""

from typing import Optional

import torch
from torch import nn

from aps_tpu_torch.asr.base.encoder import PyTorchRNNEncoder
from aps_tpu_torch.asr.filter.conv import EnhFrontEnds
from aps_tpu_torch.const import EPSILON
from aps_tpu_torch.cplx import solve_hermitian, trace


def beamform(weight: torch.Tensor, spectrogram: torch.Tensor
             ) -> torch.Tensor:
    """weight: N x C x F, spectrogram: N x C x F x T (complex) -> N x F x T
    (sum_c conj(w) x)."""
    return (weight.conj()[..., None] * spectrogram).sum(1)


def estimate_covar(mask: torch.Tensor, spectrogram: torch.Tensor,
                   eps: float = EPSILON) -> torch.Tensor:
    """mask: N x F x T, spectrogram: N x C x F x T complex -> the masked
    PSD N x F x C x C (the mask's sum over frames at least eps).

    The sum over frames is four real products of the real and imaginary
    parts, as aps_tpu forms it, not one complex product: on the card
    cuBLAS's complex GEMM lost about ten times more digits in these
    covariances than the real products, and the MVDR's solve passes that
    on to the gradients of the mask network (PERF.md, PR 17)."""
    spec = spectrogram.transpose(1, 2)  # N x F x C x T
    mask = mask[:, :, None, :]
    masked = spec * mask
    prod = lambda a, b: torch.einsum("...it,...jt->...ij", a, b)  # noqa
    nominator = torch.complex(
        prod(masked.real, spec.real) + prod(masked.imag, spec.imag),
        prod(masked.imag, spec.real) - prod(masked.real, spec.imag))
    denominator = torch.clamp_min(mask.sum(-1, keepdim=True), eps)
    return nominator / denominator


class ChannelAttention(nn.Module):
    """The reference-channel vector u (N x C) from the speech PSD: the mean
    magnitude of each channel's cross-PSD over the others, projected and
    scored (aps_tpu's Dense_0 and Dense_1)."""

    def __init__(self, num_bins: int, att_dim: int):
        super(ChannelAttention, self).__init__()
        self.linear1 = nn.Linear(num_bins, att_dim)
        self.linear2 = nn.Linear(att_dim, 1)

    def forward(self, Rs: torch.Tensor) -> torch.Tensor:
        """Rs: N x F x C x C complex -> u: N x C"""
        C = Rs.shape[-1]
        eye = torch.eye(C, dtype=torch.bool, device=Rs.device)
        R = torch.where(eye, 0, Rs).sum(-1) / (C - 1)  # N x F x C
        mag = torch.sqrt(R.real**2 + R.imag**2)
        gvec = self.linear2(torch.tanh(self.linear1(mag.transpose(1, 2))))
        return torch.softmax(gvec[..., 0], -1)


class MvdrBeamformer(nn.Module):
    """MVDR beamformer with channel-attention reference selection."""

    def __init__(self, num_bins: int, att_dim: int = 512,
                 mask_norm: bool = True, eps: float = 1e-5):
        super(MvdrBeamformer, self).__init__()
        self.ref = ChannelAttention(num_bins, att_dim)
        self.mask_norm = mask_norm
        self.eps = eps

    def _derive_weight(self, Rs: torch.Tensor, Rn: torch.Tensor,
                       u: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
        """Rs/Rn: N x F x C x C, u: N x C -> weight N x F x C:
        Rn^-1 Rs u / (tr(Rn^-1 Rs) + eps), Rn loaded with eps I."""
        C = Rn.shape[-1]
        Rn = Rn + eps * torch.eye(C, dtype=Rn.dtype, device=Rn.device)
        Rn_inv_Rs = solve_hermitian(Rn, Rs)
        num = (Rn_inv_Rs * u[:, None, None, :]).sum(-1)
        return num / (trace(Rn_inv_Rs) + eps)[..., None]

    def _process_mask(self, mask: Optional[torch.Tensor],
                      x_len: Optional[torch.Tensor]):
        """N x T x F -> N x F x T, zero past each length (and divided by
        its largest entry with mask_norm)."""
        if mask is None:
            return None
        if x_len is not None:
            T = mask.shape[1]
            pad = torch.arange(T, device=mask.device)[None, :] >= \
                torch.as_tensor(x_len, device=mask.device)[:, None]
            mask = torch.where(pad[..., None], 0, mask)
        if self.mask_norm:
            max_abs = mask.abs().amax(1, keepdim=True)
            mask = mask / (max_abs + EPSILON)
        return mask.transpose(1, 2)

    def forward(self, mask_s: torch.Tensor, x: torch.Tensor,
                mask_n: Optional[torch.Tensor] = None,
                x_len: Optional[torch.Tensor] = None) -> torch.Tensor:
        """mask_s (mask_n): N x T x F real, x: N x C x F x T complex ->
        the enhanced spectrum N x T x F complex."""
        mask_s = self._process_mask(mask_s, x_len)
        mask_n = self._process_mask(mask_n, x_len)
        Rs = estimate_covar(mask_s, x)
        Rn = estimate_covar(1 - mask_s if mask_n is None else mask_n, x)
        u = self.ref(Rs)
        weight = self._derive_weight(Rs, Rn, u, eps=self.eps)
        return beamform(weight.transpose(1, 2), x).transpose(1, 2)


class RNNMaskMvdr(nn.Module):
    """An RNN mask estimator (mask_net, sigmoid masks of speech and, with
    mask_net_noise, of noise) and the MVDR beamformer (mvdr_net)."""

    def __init__(self,
                 enh_input_size: int,
                 num_bins: int = 257,
                 rnn_inp_proj: int = -1,
                 rnn: str = "lstm",
                 num_layers: int = 3,
                 dropout: float = 0.0,
                 hidden_size: int = 640,
                 bidirectional: bool = True,
                 mask_net_noise: bool = True,
                 mvdr_att_dim: int = 512,
                 mask_norm: bool = True):
        super(RNNMaskMvdr, self).__init__()
        self.mask_net_noise = mask_net_noise
        self.mask_net = PyTorchRNNEncoder(
            enh_input_size,
            num_bins * 2 if mask_net_noise else num_bins,
            input_proj=rnn_inp_proj,
            rnn=rnn,
            num_layers=num_layers,
            hidden=hidden_size,
            dropout=dropout,
            bidirectional=bidirectional,
            non_linear="sigmoid")
        self.mvdr_net = MvdrBeamformer(num_bins, att_dim=mvdr_att_dim,
                                       mask_norm=mask_norm)

    def forward(self, feats: torch.Tensor, cstft: torch.Tensor,
                inp_len: Optional[torch.Tensor] = None) -> torch.Tensor:
        """feats: N x T x F, cstft: N x C x F x T complex -> the enhanced
        spectrum N x T x F complex."""
        mask, _ = self.mask_net(feats, inp_len)
        if self.mask_net_noise:
            mask_s, mask_n = torch.chunk(mask, 2, -1)
        else:
            mask_s, mask_n = mask, None
        return self.mvdr_net(mask_s, cstft, mask_n=mask_n, x_len=inp_len)


EnhFrontEnds.register("rnn_mask_mvdr")(RNNMaskMvdr)
