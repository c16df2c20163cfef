#!/usr/bin/env python
"""Spectral feature transform of the separation and enhancement models
(port of aps_tpu/transform/enh.py: StftCtx and FeatureTransform,
registered as "enh").

The STFT is a complex64 tensor N x (C) x F x T at the transform's
boundary, where aps_tpu packs it as a real N x (C) x F x T x 2 pair (its
TPU runtime has no complex64): encode gives it, the model masks it, decode
takes it back to waveforms, and a task computes its targets through the
StftCtx that ctx() returns. The magnitude features go through the port's
ASR transform with skip_stft, as in aps_tpu.

Not ported yet: the "ipd" token (inter-channel phase differences) and the
directional features and fixed beamformers of the multi-channel front end
(Queue 1 item 14 of ROADMAP.md); asking for them raises
NotImplementedError."""

from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch
from torch import nn

from aps_tpu_torch.const import EPSILON
from aps_tpu_torch.libs import ApsRegisters
from aps_tpu_torch.transform.asr import FeatureTransform as AsrTransform
from aps_tpu_torch.transform.utils import (fft_size_of, forward_stft,
                                           inverse_stft, num_frames)

MULTI_CHANNEL = ("the multi-channel front end (ipd, DfTransform, "
                 "FixedBeamformer) is not ported yet: ROADMAP.md Queue 1 "
                 "item 14")


@dataclass(frozen=True)
class StftCtx:
    """The (i)STFT of one configuration, shared by transforms and tasks."""
    frame_len: int
    frame_hop: int
    window: str = "sqrthann"
    center: bool = False
    round_pow_of_two: bool = True
    normalized: bool = False
    mode: str = "librosa"

    @property
    def num_bins(self) -> int:
        return fft_size_of(self.frame_len, self.round_pow_of_two
                           or self.mode == "kaldi") // 2 + 1

    def _kwargs(self, return_polar: bool):
        return dict(window=self.window, center=self.center,
                    round_pow_of_two=self.round_pow_of_two,
                    normalized=self.normalized, mode=self.mode,
                    return_polar=return_polar)

    def forward(self, wav: torch.Tensor,
                return_polar: bool = False) -> torch.Tensor:
        """N x (C) x S -> N x (C) x F x T complex (return_polar: x 2
        magnitude and phase)."""
        return forward_stft(wav, self.frame_len, self.frame_hop,
                            pre_emphasis=0, **self._kwargs(return_polar))

    def inverse(self, transform: torch.Tensor,
                return_polar: bool = False) -> torch.Tensor:
        """(N) x F x T complex -> N x S"""
        return inverse_stft(transform, self.frame_len, self.frame_hop,
                            **self._kwargs(return_polar))

    def num_frames(self, wav_len):
        if wav_len is None:
            return None
        return num_frames(wav_len, self.frame_len, self.frame_hop,
                          self.round_pow_of_two, self.mode, self.center)

    __call__ = forward


class DfTransform(nn.Module):
    """Directional features of a circular array (aps_tpu's DfTransform):
    not ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(MULTI_CHANNEL)


class FixedBeamformer(nn.Module):
    """A bank of fixed beamformers (aps_tpu's FixedBeamformer): not ported
    yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(MULTI_CHANNEL)


@ApsRegisters.transform.register("enh")
class FeatureTransform(nn.Module):
    """Spectral feature transform of the SSE models; takes the keyword
    arguments of aps_tpu's.

      encode(wav, wav_len) -> (STFT N x (C) x F x T complex, num_frames)
      forward(stft)        -> features N x T x D (the reference channel's
                              magnitude pipeline, e.g. log, cmvn)
      decode([stft, ...])  -> [wav N x S, ...]
      ctx(name)            -> the StftCtx a task computes its targets with
    """

    def __init__(self,
                 feats: str = "spectrogram-log-cmvn",
                 frame_len: int = 512,
                 frame_hop: int = 256,
                 window: str = "sqrthann",
                 round_pow_of_two: bool = True,
                 stft_normalized: bool = False,
                 stft_mode: str = "librosa",
                 center: bool = False,
                 ref_channel: int = 0,
                 use_power: bool = False,
                 sr: int = 16000,
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
                 ipd_index: str = "",
                 cos_ipd: bool = True,
                 sin_ipd: bool = False,
                 eps: float = EPSILON):
        super(FeatureTransform, self).__init__()
        toks = feats.split("-") if feats else []
        if "ipd" in toks:
            raise NotImplementedError(f"{feats}: {MULTI_CHANNEL}")
        self.ref_channel = ref_channel
        self.stft = StftCtx(frame_len=frame_len,
                            frame_hop=frame_hop,
                            window=window,
                            center=center,
                            round_pow_of_two=round_pow_of_two,
                            normalized=stft_normalized,
                            mode=stft_mode)
        self.mag_transform = None
        self.feats_dim = 0
        if toks:
            self.mag_transform = AsrTransform(
                feats=feats,
                frame_len=frame_len,
                frame_hop=frame_hop,
                window=window,
                round_pow_of_two=round_pow_of_two,
                stft_normalized=stft_normalized,
                stft_mode=stft_mode,
                center=center,
                use_power=use_power,
                sr=sr,
                log_lower_bound=log_lower_bound,
                num_mels=num_mels,
                mel_matrix=mel_matrix,
                mel_coeff_norm=mel_coeff_norm,
                min_freq=min_freq,
                max_freq=max_freq,
                num_ceps=num_ceps,
                lifter=lifter,
                aug_prob=aug_prob,
                aug_adaptive_args=aug_adaptive_args,
                aug_mask_zero=aug_mask_zero,
                aug_time_args=aug_time_args,
                aug_freq_args=aug_freq_args,
                norm_mean=norm_mean,
                norm_var=norm_var,
                norm_per_band=norm_per_band,
                gcmvn=gcmvn,
                subsampling_factor=subsampling_factor,
                lctx=lctx,
                rctx=rctx,
                delta_ctx=delta_ctx,
                delta_order=delta_order,
                delta_as_channel=delta_as_channel,
                requires_grad=requires_grad,
                eps=eps)
            self.feats_dim = self.mag_transform.feats_dim

    def ctx(self, name: str = "forward_stft") -> StftCtx:
        if name not in ("forward_stft", "inverse_stft"):
            raise ValueError(f"Unknown task context: {name}")
        return self.stft

    def dim(self) -> int:
        return self.feats_dim

    def num_frames(self, wav_len):
        return self.stft.num_frames(wav_len)

    def encode(self, wav_pad: torch.Tensor, wav_len=None):
        """wav: N x (C) x S -> (STFT N x (C) x F x T complex, num_frames)"""
        return self.stft.forward(wav_pad), self.num_frames(wav_len)

    def decode(self, stft: List[torch.Tensor]) -> List[torch.Tensor]:
        """[N x F x T complex, ...] -> [N x S, ...]"""
        return [self.stft.inverse(s) for s in stft]

    def forward(self, stft: torch.Tensor,
                training: bool = False) -> torch.Tensor:
        """stft: N x (C) x F x T complex -> feats N x T x D"""
        if self.mag_transform is None:
            raise RuntimeError("enh transform without features (feats "
                               "is empty)")
        if stft.dim() == 4 and self.ref_channel >= 0:
            stft = stft[:, self.ref_channel]
        feats, _ = self.mag_transform(stft, None, training=training,
                                      skip_stft=True)
        return feats


EnhTransform = FeatureTransform
