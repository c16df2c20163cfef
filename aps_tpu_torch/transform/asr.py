#!/usr/bin/env python
"""ASR feature transform: waveform -> (normalised) log-mel features.

Port of aps_tpu/transform/asr.py (FeatureTransform / AsrTransform,
CmvnTransform). A feature string whose spectral part is a fusable
"fbank-log" pair always runs through the fused log-mel kernel
(aps_tpu_torch.ops.fbank); the JAX package does so only on a TPU and only
when frame_hop % 8 == 0, a TPU tiling condition that does not apply here.
"cmvn" keeps the masked statistics, so a padded batch normalises exactly as
its utterances would alone. "perturb" and "aug" are identities at inference
and are accepted for config parity; training through them, and every other
token, raises NotImplementedError until the port has them."""

from typing import Optional, Tuple

import torch
from torch import nn

from aps_tpu_torch.const import EPSILON
from aps_tpu_torch.libs import ApsRegisters
from aps_tpu_torch.ops.fbank import fused_logmel
from aps_tpu_torch.transform.utils import (fft_size_of, make_window,
                                           mel_filter, num_frames)


class CmvnTransform(nn.Module):
    """Utterance-level mean/variance normalisation over time."""

    def __init__(self,
                 norm_mean: bool = True,
                 norm_var: bool = True,
                 per_band: bool = True,
                 eps: float = 1e-5):
        super(CmvnTransform, self).__init__()
        self.norm_mean = norm_mean
        self.norm_var = norm_var
        self.per_band = per_band
        self.eps = eps

    def forward(self, feats: torch.Tensor,
                num_frames: Optional[torch.Tensor] = None) -> torch.Tensor:
        """feats: N x (C) x T x F, normalised over T (per band) or T and F;
        num_frames (N) restricts the statistics to the valid frames."""
        if not self.norm_mean and not self.norm_var:
            return feats
        axes = (-2,) if self.per_band else (-1, -2)
        if num_frames is None:
            if self.norm_mean:
                feats = feats - feats.mean(axes, keepdim=True)
                var = (feats**2).mean(axes, keepdim=True)
            else:
                var = feats.var(axes, keepdim=True, unbiased=False)
            if self.norm_var:
                feats = feats / torch.sqrt(var + self.eps)
            return feats
        T = feats.shape[-2]
        mask = torch.arange(T, device=feats.device)[None] < \
            num_frames.to(feats.device)[:, None]
        shape = [feats.shape[0]] + [1] * (feats.dim() - 3) + [T, 1]
        mask = mask.reshape(shape).to(feats.dtype)
        denom = mask.sum(axes, keepdim=True) * \
            (1 if self.per_band else feats.shape[-1])
        denom = torch.clamp_min(denom, 1.0)
        mean = (feats * mask).sum(axes, keepdim=True) / denom
        if self.norm_mean:
            feats = feats - mean
            var = (feats**2 * mask).sum(axes, keepdim=True) / denom
        else:
            var = ((feats - mean)**2 * mask).sum(axes, keepdim=True) / denom
        if self.norm_var:
            feats = feats / torch.sqrt(var + self.eps)
        return feats


@ApsRegisters.transform.register("asr")
class FeatureTransform(nn.Module):
    """String-programmed ASR feature pipeline, e.g. "fbank-log-cmvn".
    Takes the keyword arguments of aps_tpu's FeatureTransform."""

    def __init__(self,
                 feats: str = "fbank-log-cmvn",
                 frame_len: int = 400,
                 frame_hop: int = 160,
                 window: str = "hamm",
                 center: bool = False,
                 round_pow_of_two: bool = True,
                 stft_normalized: bool = False,
                 stft_mode: str = "librosa",
                 audio_norm: bool = True,
                 pre_emphasis: float = 0.97,
                 use_power: bool = False,
                 sr: int = 16000,
                 speed_perturb: str = "0.9,1.0,1.1",
                 log_lower_bound: float = 0,
                 num_mels: int = 80,
                 mel_matrix: str = "",
                 mel_coeff_norm: bool = False,
                 min_freq: int = 0,
                 max_freq: Optional[int] = None,
                 num_ceps: int = 13,
                 lifter: float = 0,
                 aug_prob: float = 0,
                 aug_adaptive_args: Tuple[float, float] = (0, 0),
                 aug_maxp_time: float = 1.0,
                 aug_mask_zero: bool = True,
                 aug_time_args: Tuple[int, int] = (40, 1),
                 aug_freq_args: Tuple[int, int] = (30, 1),
                 norm_mean: bool = True,
                 norm_var: bool = True,
                 norm_per_band: bool = True,
                 gcmvn: str = "",
                 subsampling_factor: int = 1,
                 lctx: int = 1,
                 rctx: int = 1,
                 delta_ctx: int = 2,
                 delta_order: int = 2,
                 delta_as_channel: bool = False,
                 requires_grad: bool = False,
                 eps: float = EPSILON):
        super(FeatureTransform, self).__init__()
        if not feats:
            raise ValueError("FeatureTransform: 'feats' can not be empty")
        if not audio_norm:
            raise NotImplementedError("audio_norm=False (int16 rescale) is "
                                      "not ported yet")
        self.feats = feats
        self.frame_len = frame_len
        self.frame_hop = frame_hop
        self.round_pow_of_two = round_pow_of_two
        self.stft_mode = stft_mode
        self.center = center
        self.pre_emphasis = pre_emphasis
        self.stft_normalized = stft_normalized
        self.use_power = use_power
        self.log_lower_bound = log_lower_bound
        self.subsampling_factor = subsampling_factor
        self.eps = eps
        self.steps = []
        self.cmvn = None
        self.feats_dim = 0
        toks = feats.split("-")
        i = 0
        while i < len(toks):
            tok = toks[i]
            if tok == "fbank":
                fusable = (i + 1 < len(toks) and toks[i + 1] == "log"
                           and not center and not requires_grad
                           and not mel_matrix and pre_emphasis >= 0)
                if not fusable:
                    raise NotImplementedError(
                        f"{feats}: only a fusable fbank-log pair (no "
                        "centering, fixed mel matrix) is ported yet")
                self.window = make_window(window, frame_len,
                                          round_pow_of_two, stft_mode)
                self.mel = mel_filter(frame_len,
                                      round_pow_of_two=round_pow_of_two,
                                      sr=sr,
                                      num_mels=num_mels,
                                      fmin=min_freq,
                                      fmax=max_freq,
                                      norm=mel_coeff_norm).T
                self.fft_size = fft_size_of(
                    frame_len, round_pow_of_two or stft_mode == "kaldi")
                self.feats_dim = num_mels
                self.steps.append("fbank-log")
                i += 2
                continue
            if tok == "cmvn":
                if self.cmvn is not None:
                    raise NotImplementedError(f"{feats}: cmvn twice")
                if gcmvn:
                    raise NotImplementedError("global cmvn (gcmvn) is not "
                                              "ported yet")
                self.cmvn = CmvnTransform(norm_mean=norm_mean,
                                          norm_var=norm_var,
                                          per_band=norm_per_band,
                                          eps=eps)
                self.steps.append("cmvn")
            elif tok in ("perturb", "aug"):
                self.steps.append(tok)
            else:
                raise NotImplementedError(
                    f"token {tok} of {feats} is not ported yet")
            i += 1
        if "fbank-log" not in self.steps:
            raise NotImplementedError(f"{feats}: the port needs an "
                                      "fbank-log front end")

    def dim(self) -> int:
        return self.feats_dim

    def _num_frames(self, inp_len):
        if inp_len is None:
            return None
        nf = num_frames(inp_len, self.frame_len, self.frame_hop,
                        self.round_pow_of_two, self.stft_mode, self.center)
        return nf // self.subsampling_factor

    def _fbank_log(self, wav: torch.Tensor) -> torch.Tensor:
        shape = wav.shape
        if wav.dim() > 2:
            wav = wav.reshape(-1, shape[-1])
        out = fused_logmel(wav,
                           self.window,
                           self.fft_size,
                           self.frame_hop,
                           mel=self.mel,
                           pre_emphasis=self.pre_emphasis,
                           normalized=self.stft_normalized,
                           use_power=self.use_power,
                           log_lower_bound=self.log_lower_bound,
                           log_eps=self.eps)
        if len(shape) > 2:
            out = out.reshape(shape[:-1] + out.shape[-2:])
        return out

    def forward(self, inp_pad: torch.Tensor, inp_len=None,
                training: bool = False):
        """inp_pad: N x (C x) S waveform, inp_len: N or None ->
        (feats N x (C x) T x F, num_frames N or None)."""
        if training and ("perturb" in self.steps or "aug" in self.steps):
            raise NotImplementedError("speed perturbation and SpecAugment "
                                      "are not ported yet")
        feats = inp_pad
        nf = self._num_frames(inp_len)
        if nf is not None:
            nf = torch.clamp_max(torch.as_tensor(nf),
                                 num_frames(inp_pad.shape[-1],
                                            self.frame_len, self.frame_hop,
                                            self.round_pow_of_two,
                                            self.stft_mode, self.center))
        for step in self.steps:
            if step == "fbank-log":
                feats = self._fbank_log(feats)
            elif step == "cmvn":
                feats = self.cmvn(feats, num_frames=nf)
        return feats, nf


AsrTransform = FeatureTransform
