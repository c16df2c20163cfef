#!/usr/bin/env python
"""Separation / enhancement model base (port of aps_tpu/sse/base.py:
SSEBase, MaskNonLinear, supported_nonlinear, the name sets and
tf_masking; FreqMaskingSSE holds the inference that aps_tpu's two
frequency-domain masking models each spell out). Spectra are complex64
tensors here, where aps_tpu packs them as real ... x 2 pairs."""

from typing import Optional

import torch
from torch import nn

all_ = ["none", "relu", "tanh", "softplus", "sigmoid", "softmax"]
all_wo_softmax = ["none", "relu", "tanh", "softplus", "sigmoid"]
positive = ["relu", "softplus", "sigmoid", "softmax"]
positive_wo_softmax = ["relu", "softplus", "sigmoid"]
positive_wo_softplus = ["relu", "sigmoid", "softmax"]
common = ["relu", "sigmoid"]
bounded = ["sigmoid", "softmax"]
unbounded = ["none", "relu", "tanh", "softplus"]

supported_nonlinear = {
    "none": lambda x: x,  # [-oo, +oo]
    "relu": torch.relu,  # [0, +oo]
    "tanh": torch.tanh,  # [-1, 1]
    "softplus": nn.functional.softplus,  # [0, +oo]
    "sigmoid": torch.sigmoid,  # [0, 1]
    "softmax": lambda x: torch.softmax(x, dim=0),  # over the speaker axis
}


def tf_masking(mix_stft: torch.Tensor, src_mask: torch.Tensor,
               channel: int = 0) -> torch.Tensor:
    """Apply a real or a complex TF mask.
    mix_stft: N x (C) x F x T complex; src_mask: N x F x T, real or
    complex -> N x F x T complex."""
    if mix_stft.dim() not in (3, 4) or src_mask.dim() != 3:
        raise RuntimeError(f"tf_masking: mixture {tuple(mix_stft.shape)}, "
                           f"mask {tuple(src_mask.shape)}")
    if mix_stft.dim() == 4:
        mix_stft = mix_stft[:, channel]
    return mix_stft * src_mask


class SSEBase(nn.Module):
    """Base class of the separation / enhancement models: training goes
    through forward(), inference through infer(). `training_mode` is "freq"
    or "time"; `enh_transform` is the feature front end of the
    frequency-domain models (aps_tpu_torch.transform.enh)."""

    def __init__(self, enh_transform: Optional[nn.Module] = None,
                 training_mode: str = "freq"):
        super(SSEBase, self).__init__()
        self.enh_transform = enh_transform
        self.training_mode = training_mode

    def check_args(self, mix: torch.Tensor, training: bool = True,
                   valid_dim=(2,)) -> None:
        if mix.dim() not in valid_dim:
            supported = "/".join(str(d) for d in valid_dim)
            raise RuntimeError(
                f"Expects {supported}D tensor "
                f"({'training' if training else 'inference'}), "
                f"got {mix.dim()} instead")

    def infer(self, mix: torch.Tensor, mode: str = "time"):
        raise NotImplementedError


class FreqMaskingSSE(SSEBase):
    """A frequency-domain masking model: the enh transform's STFT and
    features, one TF mask a speaker from _tf_mask (features N x T x F ->
    masks S x N x F x T), the masked STFTs taken back to waveforms. The
    shared inference of aps_tpu's ToyRNN and FreqConvTasNet (their
    _infer)."""

    def __init__(self, enh_transform: Optional[nn.Module] = None,
                 num_spks: int = 2, training_mode: str = "freq"):
        super(FreqMaskingSSE, self).__init__(enh_transform=enh_transform,
                                             training_mode=training_mode)
        if enh_transform is None:
            raise ValueError(f"{type(self).__name__} needs an enh_transform")
        if training_mode not in ("freq", "time"):
            raise ValueError(f"Unsupported training_mode: {training_mode}")
        self.num_spks = num_spks

    def _tf_mask(self, feats: torch.Tensor):
        raise NotImplementedError

    def infer_batch(self, mix: torch.Tensor, mode: str = "time"):
        """mix: N x (C) x S -> separated waveforms N x S' (mode "freq":
        the masks N x F x T), a list of them for several speakers."""
        stft, _ = self.enh_transform.encode(mix, None)
        masks = list(self._tf_mask(self.enh_transform(
            stft, training=self.training)))
        if mode != "freq":
            masks = self.enh_transform.decode(
                [tf_masking(stft, m) for m in masks])
        return masks[0] if self.num_spks == 1 else masks

    def forward(self, mix: torch.Tensor):
        """mix: N x (C) x S -> masks N x F x T or waveforms N x S' (a list
        of them for several speakers), as training_mode says."""
        self.check_args(mix, training=True, valid_dim=[2, 3])
        return self.infer_batch(mix, self.training_mode)

    def infer(self, mix: torch.Tensor, mode: str = "time"):
        """mix: (C) x S -> separated signal(s) (mode "freq": the masks)
        without the batch axis; the module should be in eval mode."""
        self.check_args(mix, training=False, valid_dim=[1, 2])
        sep = self.infer_batch(mix[None], mode)
        return sep[0] if self.num_spks == 1 else [s[0] for s in sep]


class MaskNonLinear(nn.Module):
    """Mask activation with optional scaling/clipping."""

    def __init__(self, non_linear: str, enable: str = "all",
                 scale: float = 1, vmax: Optional[float] = None,
                 vmin: Optional[float] = None):
        super(MaskNonLinear, self).__init__()
        supported_set = {
            "positive": positive,
            "positive_wo_softmax": positive_wo_softmax,
            "positive_wo_softplus": positive_wo_softplus,
            "all": all_,
            "all_wo_softmax": all_wo_softmax,
            "bounded": bounded,
            "unbounded": unbounded,
            "common": common
        }
        if non_linear not in supported_set[enable]:
            raise ValueError(f"Unsupported nonlinear: {non_linear}")
        self.fn = supported_nonlinear[non_linear]
        self.scale, self.vmax, self.vmin = scale, vmax, vmin

    def forward(self, inp: torch.Tensor) -> torch.Tensor:
        if inp.dim() not in (3, 4):
            raise RuntimeError(
                f"MaskNonLinear expects 3/4D tensor, got {inp.dim()}")
        out = self.fn(inp) * self.scale
        if self.vmax is not None:
            out = out.clamp(max=self.vmax)
        if self.vmin is not None:
            out = out.clamp(min=self.vmin)
        return out
