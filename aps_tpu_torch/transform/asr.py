#!/usr/bin/env python
"""ASR feature transform: waveform -> (normalised) log-mel or log
spectrogram features.

Port of aps_tpu/transform/asr.py (FeatureTransform / AsrTransform,
RescaleTransform, SpeedPerturbTransform, CmvnTransform,
SpecAugTransform, and the chain SpectrogramTransform, MagnitudeTransform,
TFTransposeTransform, PowerTransform that the "spectrogram" token stands
for, with LogTransform for "log"). A feature string whose spectral part is
a fusable "fbank-log" pair always runs through the fused log-mel kernel
(aps_tpu_torch.ops.fbank); the JAX package does so only on a TPU and only
when frame_hop % 8 == 0, a TPU tiling condition that does not apply here.
"spectrogram" is the magnitude (use_power: the power) of forward_stft,
N x (C) x T x F. "cmvn" keeps the masked statistics, so a padded batch
normalises exactly as its utterances would alone. audio_norm: false
rescales the waveform to the int16 range first. "perturb" and "aug" are
identities at inference; in training they draw from the transform's
`generator` (the trainer sets one on its device) through perturb.draw and
specaug.draw, which a check may replace to feed in draws of its own.
forward(..., skip_stft=True) takes an STFT the caller made (the enh
transform's) through the steps after the spectrogram, as aps_tpu's does.
A string without a spectrum ("abs-mel-log-cmvn", the features of a
multi-channel front end's enhanced magnitude) takes features N x (C) x T x F
and their frame counts: "abs" is |x| + eps and "mel" the product with the
mel filterbank (a fixed one, and on features only: "spectrogram-mel"
raises). "delta" appends delta_order orders of deltas over delta_ctx
frames each side (edges clamped at the padded batch's ends, as in
aps_tpu), concatenated on the feature axis, N x T x F*(order+1), or with
delta_as_channel stacked on a new axis 1, N x (order+1) x T x F, the layout
a channel-first conv2d encoder reads as its in_channels. feats_dim grows
by (order+1) either way, as in aps_tpu. The other tokens (mfcc, splice,
...) and gcmvn raise NotImplementedError until the port has them."""

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from aps_tpu_torch.const import EPSILON, MAX_INT16
from aps_tpu_torch.libs import ApsRegisters
from aps_tpu_torch.ops import fbank
from aps_tpu_torch.transform.augment import perturb_speed, tf_mask
from aps_tpu_torch.transform.utils import (fft_size_of, forward_stft,
                                           make_window, mel_filter,
                                           num_frames, speed_perturb_filter,
                                           splice_feature)


class RescaleTransform(nn.Module):
    """[-1, 1] samples -> int16 scale: round(wav * 32767), half to even
    (as jnp.round)."""

    def __init__(self, rescale: float = MAX_INT16 * 1.0):
        super(RescaleTransform, self).__init__()
        self.rescale = rescale

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        return torch.round(wav * self.rescale)


class SpeedPerturbTransform(nn.Module):
    """Random speed perturbation by polyphase resampling, one branch (a
    factor) a batch, drawn uniformly over the factors; the last branch is
    the identity. The buffer keeps S samples: a slower copy is cut, a
    faster one zero-padded; output_length gives each utterance's length
    after it."""

    def __init__(self, sr: int = 16000, perturb: str = "0.9,1.0,1.1"):
        super(SpeedPerturbTransform, self).__init__()
        dst_sr = [int(f * sr) for f in map(float, perturb.split(","))]
        if not dst_sr:
            raise ValueError("No perturb options for doing speed perturb")
        if sr not in dst_sr:
            raise ValueError(f"Keep 1.0 in perturb options: {perturb}")
        self.weights = [torch.from_numpy(speed_perturb_filter(sr, fs))
                        for fs in dst_sr if fs != sr]
        self.ratios = [(w.shape[1], w.shape[0]) for w in self.weights]
        self._banks = {}  # device -> the filter banks there

    @property
    def identity(self) -> int:
        return len(self.weights)

    def output_length(self, inp_len, choice: int):
        """Lengths after perturbation with branch `choice`."""
        if inp_len is None:
            return None
        src, dst = (list(self.ratios) + [(1, 1)])[choice]
        return (inp_len // src) * dst

    def draw(self, generator: Optional[torch.Generator] = None) -> int:
        """A branch, uniform over the factors. The resampler's shape
        depends on it, so it is read back to the host."""
        device = generator.device if generator is not None else None
        return int(torch.randint(self.identity + 1, (1,),
                                 generator=generator, device=device))

    def forward(self, wav: torch.Tensor, choice: int) -> torch.Tensor:
        """wav: N x S -> N x S at the speed of branch `choice`."""
        if choice == self.identity:
            return wav
        banks = self._banks.get(wav.device)
        if banks is None:
            banks = self._banks[wav.device] = [
                w.to(wav.device) for w in self.weights]
        S = wav.shape[-1]
        out = perturb_speed(wav, banks[choice].to(wav.dtype))
        if out.shape[-1] >= S:
            return out[..., :S].contiguous()
        return F.pad(out, (0, S - out.shape[-1]))


class SpecAugTransform(nn.Module):
    """SpecAugment: a coin for each utterance with probability p, then
    time and frequency masks. maxp_time < 1 caps each time mask at that
    fraction of the frames. The masked entries become 0 (mask_zero) or
    the mean of the whole padded batch."""

    def __init__(self,
                 p: float = 0.5,
                 adaptive_args: Tuple[float, float] = (0.0, 0.0),
                 time_args: Tuple[int, int] = (40, 1),
                 freq_args: Tuple[int, int] = (30, 1),
                 maxp_time: float = 1.0,
                 mask_zero: bool = True):
        super(SpecAugTransform, self).__init__()
        self.p = p
        self.pm = adaptive_args[0]
        ps = adaptive_args[1]
        if maxp_time < 1.0:
            ps = min(ps, maxp_time) if ps > 0 else maxp_time
        self.ps = ps
        self.time_args = tuple(time_args)
        self.freq_args = tuple(freq_args)
        self.mask_zero = mask_zero

    def draw(self, x: torch.Tensor,
             generator: Optional[torch.Generator] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(mask N x T x F, coin N) for features x: N x (C x) T x F, drawn
        on x's device."""
        N, T, F = x.shape[0], x.shape[-2], x.shape[-1]
        mask = tf_mask(N, (T, F),
                       pm=self.pm,
                       ps=self.ps,
                       max_bands=self.freq_args[0],
                       max_frame=self.time_args[0],
                       num_freq_masks=self.freq_args[1],
                       num_time_masks=self.time_args[1],
                       generator=generator,
                       device=x.device)
        coin = torch.rand((N,), generator=generator, device=x.device) < self.p
        return mask, coin

    def forward(self, x: torch.Tensor,
                draws: Tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
        mask, coin = draws
        mask = torch.where(coin[:, None, None], mask.to(x.dtype),
                           torch.ones((), dtype=x.dtype, device=x.device))
        if x.dim() == 4:
            mask = mask[:, None]
        if self.mask_zero:
            return x * mask
        return torch.where(mask == 0, x.mean(), x)


class DeltaTransform(nn.Module):
    """Delta features: each order is the regression over ctx frames each
    side of the order before it."""

    def __init__(self, ctx: int = 2, order: int = 2,
                 delta_as_channel: bool = False):
        super(DeltaTransform, self).__init__()
        scale = torch.arange(-ctx, ctx + 1, dtype=torch.float32)
        self.register_buffer("scale", scale / (scale**2).sum(),
                             persistent=False)
        self.ctx = ctx
        self.order = order
        self.delta_as_channel = delta_as_channel

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        """N x T x F -> N x T x F*(order+1), or N x (order+1) x T x F."""
        delta = [feats]
        for _ in range(self.order):
            splice = splice_feature(delta[-1], lctx=self.ctx, rctx=self.ctx,
                                    op="stack")
            delta.append((splice * self.scale).sum(-1))
        if self.delta_as_channel:
            return torch.stack(delta, 1)
        return torch.cat(delta, -1)


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
        self.feats = feats
        # [-1, 1] samples -> int16 scale ahead of every other step
        self.rescale = None if audio_norm else RescaleTransform()
        self.frame_len = frame_len
        self.frame_hop = frame_hop
        self.round_pow_of_two = round_pow_of_two
        self.stft_mode = stft_mode
        self.center = center
        self.pre_emphasis = pre_emphasis
        self.stft_normalized = stft_normalized
        self.use_power = use_power
        self.window_name = window
        self.log_lower_bound = log_lower_bound
        self.subsampling_factor = subsampling_factor
        self.eps = eps
        self.steps = []
        self.cmvn = None
        self.perturb = None
        self.specaug = None
        self.delta = None
        # the training draws' generator (the trainer sets one on its
        # device); None draws from torch's default generator
        self.generator = None
        self.feats_dim = 0
        self._fbank_ops = {}  # device -> fbank.Operands, made at its first use
        toks = feats.split("-")
        i = 0
        while i < len(toks):
            tok = toks[i]
            if tok == "fbank":
                fusable = (i + 1 < len(toks) and toks[i + 1] == "log"
                           and not center and not requires_grad
                           and not mel_matrix and pre_emphasis >= 0)
                if not fusable or "spectrogram" in self.steps:
                    raise NotImplementedError(
                        f"{feats}: only one spectrum, a spectrogram or a "
                        "fusable fbank-log pair (no centering, fixed mel "
                        "matrix), is ported yet")
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
            if tok == "spectrogram":
                if "spectrogram" in self.steps or "fbank-log" in self.steps:
                    raise NotImplementedError(f"{feats}: only one spectrum "
                                              "is ported yet")
                self.feats_dim = fft_size_of(
                    frame_len, round_pow_of_two or stft_mode == "kaldi") \
                    // 2 + 1
                self.steps.append(tok)
            elif tok == "log" or tok == "abs":
                self.steps.append(tok)
            elif tok == "mel":
                if requires_grad or mel_matrix or "spectrogram" in \
                        self.steps or "fbank-log" in self.steps:
                    raise NotImplementedError(
                        f"{feats}: mel is ported on features only (no "
                        "spectrum before it), with a fixed filterbank")
                # a buffer outside the state_dict (aps_tpu keeps the
                # fixed filterbank out of its variables)
                self.register_buffer("mel_proj", torch.as_tensor(mel_filter(
                    frame_len,
                    round_pow_of_two=round_pow_of_two,
                    sr=sr,
                    num_mels=num_mels,
                    fmin=min_freq,
                    fmax=max_freq,
                    norm=mel_coeff_norm).T, dtype=torch.float32),
                    persistent=False)
                self.feats_dim = num_mels
                self.steps.append(tok)
            elif tok == "cmvn":
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
            elif tok == "perturb":
                self.perturb = SpeedPerturbTransform(sr=sr,
                                                     perturb=speed_perturb)
                self.steps.append(tok)
            elif tok == "aug":
                self.specaug = SpecAugTransform(
                    p=aug_prob,
                    adaptive_args=aug_adaptive_args,
                    time_args=aug_time_args,
                    freq_args=aug_freq_args,
                    maxp_time=aug_maxp_time,
                    mask_zero=aug_mask_zero)
                self.steps.append(tok)
            elif tok == "delta":
                if self.delta is not None:
                    raise NotImplementedError(f"{feats}: delta twice")
                self.delta = DeltaTransform(ctx=delta_ctx, order=delta_order,
                                            delta_as_channel=delta_as_channel)
                self.feats_dim *= 1 + delta_order
                self.steps.append(tok)
            else:
                raise NotImplementedError(
                    f"token {tok} of {feats} is not ported yet")
            i += 1

    @property
    def accept_raw(self) -> bool:
        """True if the pipeline starts from the raw waveform (as
        aps_tpu's, from the feats string)."""
        return any(t in ("spectrogram", "fbank", "mfcc")
                   for t in self.feats.split("-"))

    def dim(self) -> int:
        return self.feats_dim

    def _num_frames(self, inp_len, choice: Optional[int] = None):
        if inp_len is None or not self.accept_raw:
            return inp_len
        if self.perturb is not None and choice is not None:
            inp_len = self.perturb.output_length(inp_len, choice)
        nf = num_frames(inp_len, self.frame_len, self.frame_hop,
                        self.round_pow_of_two, self.stft_mode, self.center)
        return nf // self.subsampling_factor

    def fbank_operands(self, device: torch.device) -> fbank.Operands:
        """The window, the mel matrix and the kernel's tables on a device,
        copied there at the first call for it."""
        ops = self._fbank_ops.get(device)
        if ops is None:
            ops = self._fbank_ops[device] = fbank.operands(
                self.window, self.fft_size, self.mel, self.stft_normalized,
                device)
        return ops

    def _fbank_log(self, wav: torch.Tensor) -> torch.Tensor:
        shape = wav.shape
        if wav.dim() > 2:
            wav = wav.reshape(-1, shape[-1])
        out = fbank.fused_logmel(wav,
                                 self.fbank_operands(wav.device),
                                 self.frame_hop,
                                 pre_emphasis=self.pre_emphasis,
                                 use_power=self.use_power,
                                 log_lower_bound=self.log_lower_bound,
                                 log_eps=self.eps)
        if len(shape) > 2:
            out = out.reshape(shape[:-1] + out.shape[-2:])
        return out

    def _spectrogram(self, stft: torch.Tensor) -> torch.Tensor:
        """N x (C x) F x T complex -> N x (C x) T x F magnitude (power)."""
        mag = stft.abs().transpose(-1, -2)
        return mag**2 if self.use_power else mag

    def forward(self, inp_pad: torch.Tensor, inp_len=None,
                training: bool = False, skip_stft: bool = False):
        """inp_pad: N x (C x) S waveform, inp_len: N or None ->
        (feats N x (C x) T x F, num_frames N or None). In training the
        branch and the masks come from perturb.draw and specaug.draw.
        skip_stft: inp_pad is an STFT, N x (C x) F x T complex, that goes
        through the steps after the spectrogram; cmvn then takes its
        statistics over every frame and inp_len comes back as it is (as in
        aps_tpu)."""
        choice, nf = None, None
        feats = inp_pad
        if skip_stft:
            if "spectrogram" not in self.steps:
                raise ValueError(f"{self.feats}: skip_stft needs a "
                                 "spectrogram front end")
            steps = self.steps[self.steps.index("spectrogram"):]
        else:
            steps = self.steps
            if training and self.perturb is not None:
                choice = self.perturb.draw(self.generator)
            if self.rescale is not None:
                feats = self.rescale(feats)
            nf = self._num_frames(inp_len, choice)
            if nf is not None:
                nf = torch.clamp_max(
                    torch.as_tensor(nf),
                    num_frames(inp_pad.shape[-1], self.frame_len,
                               self.frame_hop, self.round_pow_of_two,
                               self.stft_mode, self.center)
                    if self.accept_raw else inp_pad.shape[-2])
        for step in steps:
            if step == "perturb":
                if choice is not None:
                    feats = self.perturb(feats, choice)
            elif step == "fbank-log":
                feats = self._fbank_log(feats)
            elif step == "spectrogram":
                if not skip_stft:
                    feats = forward_stft(
                        feats, self.frame_len, self.frame_hop,
                        window=self.window_name,
                        round_pow_of_two=self.round_pow_of_two,
                        pre_emphasis=self.pre_emphasis,
                        normalized=self.stft_normalized, center=self.center,
                        mode=self.stft_mode)
                feats = self._spectrogram(feats)
            elif step == "abs":
                feats = feats.abs() + self.eps
            elif step == "mel":
                feats = feats @ self.mel_proj
            elif step == "log":
                if self.log_lower_bound > 0:
                    feats = torch.log(self.log_lower_bound + feats)
                else:
                    feats = torch.log(torch.clamp_min(feats, self.eps))
            elif step == "cmvn":
                feats = self.cmvn(feats, num_frames=nf)
            elif step == "delta":
                feats = self.delta(feats)
            elif step == "aug" and training and self.specaug.p > 0:
                feats = self.specaug(
                    feats, self.specaug.draw(feats, self.generator))
        return feats, (inp_len if skip_stft else nf)


AsrTransform = FeatureTransform
