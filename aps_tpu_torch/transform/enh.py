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

The multi-channel front end: the "ipd" token appends the inter-channel
phase differences of the pairs in ipd_index (cos, cos and sin, or the
wrapped raw difference), and RefChannelTransform, IpdTransform (the raw
difference), DfTransform (directional features of the "7@" array) and
FixedBeamformer (a bank of complex beamformers) are aps_tpu's modules on
complex64. cos and sin of the difference come from x_l conj(x_r) divided
by max(|x_l| |x_r|, eps), as aps_tpu's PackedIpdTransform computes them by
the trig identity, so a zero bin gives 0 (not cos 0 = 1); the raw
difference takes torch.angle of each channel (aps_tpu's PhaseTransform).

Sequence parallelism (`seq_split`, set by the trainer under
tensor_parallel with sequence_parallel): encode runs the STFT of the
model rank's frames only, read from the whole waveform, and gathers them
along time; the features, the model and decode see every frame."""

import math
from dataclasses import dataclass
from typing import List, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from aps_tpu_torch.const import EPSILON
from aps_tpu_torch.libs import ApsRegisters
from aps_tpu_torch.parallel.mesh import gather_frames, split_frames
from aps_tpu_torch.transform.asr import FeatureTransform as AsrTransform
from aps_tpu_torch.transform.utils import (_stft_geometry, fft_size_of,
                                           forward_stft, inverse_stft,
                                           num_frames)

MATH_PI = math.pi


def _pairs(index: str) -> Tuple[List[int], List[int]]:
    """"1,0;2,0" -> ([1, 2], [0, 0])"""
    pair = [tuple(map(int, p.split(","))) for p in index.split(";")]
    return [t[0] for t in pair], [t[1] for t in pair]


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

    def forward_split(self, wav: torch.Tensor, split) -> torch.Tensor:
        """forward(wav) with the frames split over the model ranks of a
        parallel.SeqSplit and gathered along time."""
        _, win = _stft_geometry(self.frame_len, self.round_pow_of_two,
                                self.mode)
        cut = split_frames(wav, win, self.frame_hop, self.center, split)
        if cut is None:
            return self.forward(wav)
        local, frames, total = cut
        kwargs = dict(self._kwargs(False), center=False)
        stft = forward_stft(local, self.frame_len, self.frame_hop,
                            pre_emphasis=0, **kwargs)
        return gather_frames(stft, -1, frames, total, split.group)

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


class RefChannelTransform(nn.Module):
    """Select a reference channel (a no-op for an input of another rank
    than input_dim, or when ref_channel < 0)."""

    def __init__(self, ref_channel: int = 0, input_dim: int = 4):
        super(RefChannelTransform, self).__init__()
        self.ref_channel = ref_channel
        self.input_dim = input_dim

    def forward(self, inp: torch.Tensor) -> torch.Tensor:
        if inp.dim() != self.input_dim or self.ref_channel < 0:
            return inp
        return inp[:, self.ref_channel]


class IpdTransform(nn.Module):
    """The inter-channel phase differences of the pairs in ipd_index
    ("1,0;2,0": channel 1 against 0, 2 against 0), wrapped into (-pi, pi]:
    forward(phase N x C x T x F) -> N x T x MF. cos and sin of the
    difference come from the STFT through cos_sin_ipd."""

    def __init__(self, ipd_index: str = "1,0"):
        super(IpdTransform, self).__init__()
        self.index_l, self.index_r = _pairs(ipd_index)

    def forward(self, p: torch.Tensor) -> torch.Tensor:
        if p.dim() == 3:
            p = p[None]
        N, C, T, _ = p.shape
        if C == 1:
            raise ValueError("IpdTransform needs more than one channel")
        # N x T x C x F
        p = p.transpose(1, 2)
        dif = p[..., self.index_l, :] - p[..., self.index_r, :]
        ipd = torch.where(dif > MATH_PI, dif - MATH_PI * 2, dif)
        ipd = torch.where(ipd <= -MATH_PI, ipd + MATH_PI * 2, ipd)
        return ipd.reshape(N, T, -1)


def cos_sin_ipd(stft: torch.Tensor, index_l: List[int], index_r: List[int],
                sin: bool = False, eps: float = EPSILON) -> torch.Tensor:
    """stft: N x C x F x T complex -> N x T x MF: cos (and then sin) of the
    phase difference of each pair, Re (Im) of x_l conj(x_r) over
    max(|x_l| |x_r|, eps)."""
    if stft.dim() == 3:
        stft = stft[None]
    N, C, F, T = stft.shape
    if C == 1:
        raise ValueError("IPD features need more than one channel")
    # N x T x C x F
    x = stft.permute(0, 3, 1, 2)
    xl, xr = x[..., index_l, :], x[..., index_r, :]
    prod = xl * xr.conj()
    mag = torch.clamp_min(xl.abs() * xr.abs(), eps)
    ipd = prod.real / mag
    if sin:
        ipd = torch.cat([ipd, prod.imag / mag], 2)
    return ipd.reshape(N, T, -1)


class DfTransform(nn.Module):
    """Directional (angle) features of a circular array (aps_tpu's
    DfTransform). geometric "7@": 7 microphones, one at the centre and six
    on a circle of radius 4.25 cm. num_doas == 1: the direction of arrival
    of each utterance is given; else num_doas directions spread evenly.
    forward(phase N x C x T x F, doa N or a list of them) -> N x T x F
    (F times the list's length) or N x D x T x F."""

    def __init__(self, geometric: str = "7@", sr: int = 16000,
                 velocity: int = 340, num_bins: int = 257,
                 num_doas: int = 1,
                 af_index: str = "1,0;2,0;3,0;4,0;5,0;6,0"):
        super(DfTransform, self).__init__()
        if geometric not in ["7@"]:
            raise RuntimeError(f"Unsupported array geometric: {geometric}")
        self.velocity = velocity
        self.num_doas = num_doas
        self.index_l, self.index_r = _pairs(af_index)
        self.omega = torch.tensor([
            math.pi * sr * f / (num_bins - 1) for f in range(num_bins)
        ], dtype=torch.float32)[None, :]

    def _oracle_phase_delay(self, doa: torch.Tensor) -> torch.Tensor:
        """doa: N -> phi: N x (D) x C x F (phases of the delays)."""
        if self.num_doas != 1:
            grid = torch.linspace(0, MATH_PI * 2, self.num_doas + 1,
                                  device=doa.device)[:-1]
            doa = grid.repeat(doa.shape[0], 1)
        R = 0.0425
        zero = torch.zeros_like(doa)
        tau = R * torch.stack([
            zero, -torch.cos(doa), -torch.cos(MATH_PI / 3 - doa),
            -torch.cos(2 * MATH_PI / 3 - doa),
            torch.cos(doa),
            torch.cos(MATH_PI / 3 - doa),
            torch.cos(2 * MATH_PI / 3 - doa)
        ], -1) / self.velocity
        return tau[..., None] * (-self.omega.to(doa.device))

    def _compute_af(self, ipd: torch.Tensor,
                    doa: torch.Tensor) -> torch.Tensor:
        """ipd: N x M x T x F, doa: N -> af: N x (D) x T x F"""
        d = self._oracle_phase_delay(doa)
        if self.num_doas == 1:
            dif = d[:, self.index_l] - d[:, self.index_r]
            return torch.cos(ipd - dif[..., None, :]).mean(1)
        dif = d[:, :, self.index_l] - d[:, :, self.index_r]
        return torch.cos(ipd[:, None] - dif[..., None, :]).mean(2)

    def forward(self, p: torch.Tensor,
                doa: Union[torch.Tensor, List[torch.Tensor]]
                ) -> torch.Tensor:
        if p.dim() == 3:
            p = p[None]
        ipd = p[:, self.index_l] - p[:, self.index_r]
        if isinstance(doa, (list, tuple)):
            if self.num_doas != 1:
                raise RuntimeError("known_doa=False: pass a single doa "
                                   "tensor")
            return torch.cat([self._compute_af(ipd, d) for d in doa], -1)
        return self._compute_af(ipd, doa)


class FixedBeamformer(nn.Module):
    """A bank of num_beams complex beamformers, optionally trainable
    (aps_tpu's FixedBeamformer). The weights are the real array
    (2, B, C, F, 1), real and imaginary parts, read from `weight` (a .npy
    of (2, B, C, F)) or drawn uniformly in +-sqrt(6 / (C F)); trainable
    (requires_grad), they are the parameter "weight", as in aps_tpu.
    Without a file and frozen, aps_tpu draws them from
    jax.random.PRNGKey(0), which a torch draw cannot reproduce: the port
    draws from a torch generator seeded 0, and a caller that needs
    aps_tpu's values assigns them to `weight` (no caller in either package
    builds such a bank)."""

    def __init__(self, num_beams: int, num_channels: int, num_bins: int,
                 weight: Optional[str] = None, requires_grad: bool = False):
        super(FixedBeamformer, self).__init__()
        if weight:
            w = np.load(weight)
            if w.shape[1] != num_beams:
                raise RuntimeError(
                    f"Beam number mismatch: {w.shape[1]} vs {num_beams}")
            w = torch.as_tensor(w, dtype=torch.float32)[..., None]
        else:
            bound = math.sqrt(6.0 / (num_channels * num_bins))
            gen = torch.Generator().manual_seed(0)
            w = torch.rand((2, num_beams, num_channels, num_bins, 1),
                           generator=gen) * 2 * bound - bound
        if requires_grad:
            self.weight = nn.Parameter(w)
            self.jax_params = ("weight",)
        else:
            self.register_buffer("weight", w, persistent=False)

    def forward(self, x: torch.Tensor, beam: Optional[torch.Tensor] = None,
                squeeze: bool = False, trans: bool = False) -> torch.Tensor:
        """x: N x C x F x T complex -> N x B x F x T (w^H x of each beam;
        beam, N indices: N x F x T of each utterance's beam)."""
        w = torch.complex(self.weight[0], self.weight[1]).conj()
        if beam is None:
            out = (x[:, None] * w).sum(2)
        else:
            out = (x * w[beam]).sum(1)
        if squeeze:
            out = out.squeeze()
        if trans:
            out = out.transpose(-1, -2)
        return out


@ApsRegisters.transform.register("enh")
class FeatureTransform(nn.Module):
    """Spectral feature transform of the SSE models; takes the keyword
    arguments of aps_tpu's.

      encode(wav, wav_len) -> (STFT N x (C) x F x T complex, num_frames)
      forward(stft)        -> features N x T x D (the reference channel's
                              magnitude pipeline, e.g. log, cmvn, then
                              the IPD features of the "ipd" token)
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
        feats_mag = "-".join(t for t in toks if t != "ipd")
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
        # sequence parallelism's split of the frames (the trainer sets it)
        self.seq_split = None
        if feats_mag:
            self.mag_transform = AsrTransform(
                feats=feats_mag,
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
        # the "ipd" token: (index_l, index_r) of the channel pairs
        self.ipd_pairs = None
        self.cos_ipd, self.sin_ipd, self.eps = cos_ipd, sin_ipd, eps
        if "ipd" in toks and ipd_index:
            self.ipd_pairs = _pairs(ipd_index)
            # the wrapped raw difference of the channels' phases
            self.raw_ipd = None if cos_ipd else IpdTransform(ipd_index)
            self.feats_dim += len(self.ipd_pairs[0]) * self.stft.num_bins * (
                2 if cos_ipd and sin_ipd else 1)

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
        if self.seq_split is not None:
            return self.stft.forward_split(wav_pad, self.seq_split), \
                self.num_frames(wav_len)
        return self.stft.forward(wav_pad), self.num_frames(wav_len)

    def decode(self, stft: List[torch.Tensor]) -> List[torch.Tensor]:
        """[N x F x T complex, ...] -> [N x S, ...]"""
        return [self.stft.inverse(s) for s in stft]

    def forward(self, stft: torch.Tensor,
                training: bool = False) -> torch.Tensor:
        """stft: N x (C) x F x T complex -> feats N x T x D"""
        if self.mag_transform is None and self.ipd_pairs is None:
            raise RuntimeError("enh transform without features (feats "
                               "is empty)")
        feats = []
        if self.mag_transform is not None:
            x = stft
            if x.dim() == 4 and self.ref_channel >= 0:
                x = x[:, self.ref_channel]
            feats.append(self.mag_transform(x, None, training=training,
                                            skip_stft=True)[0])
        if self.ipd_pairs is not None:
            feats.append(self.ipd(stft))
        return torch.cat(feats, -1)

    def ipd(self, stft: torch.Tensor) -> torch.Tensor:
        """stft: N x C x F x T complex -> IPD features N x T x MF"""
        if self.raw_ipd is None:
            return cos_sin_ipd(stft, *self.ipd_pairs, sin=self.sin_ipd,
                               eps=self.eps)
        # phase N x C x T x F
        return self.raw_ipd(torch.angle(stft).transpose(-1, -2))


EnhTransform = FeatureTransform
