#!/usr/bin/env python
"""ASR feature transform: waveform -> (normalised) features, programmed by a
string of tokens such as "perturb-fbank-log-cmvn-aug".

Port of aps_tpu/transform/asr.py: FeatureTransform / AsrTransform and its
layers RescaleTransform, PreEmphasisTransform ("emph"),
SpeedPerturbTransform ("perturb"), SpectrogramTransform (the STFT, with
center, normalized and both modes), MagnitudeTransform,
TFTransposeTransform ("trans"), PowerTransform ("pow"), MelTransform
("mel", with mel_matrix and a learnable filterbank), LogTransform ("log",
with lower_bound), AbsTransform ("abs"), DiscreteCosineTransform ("dct",
with num_ceps and lifter), CmvnTransform ("cmvn", utterance-level or
global from gcmvn), SpecAugTransform ("aug"), SpliceTransform ("splice",
with subsampling) and DeltaTransform ("delta"). A spectral token stands for
a chain, as in aps_tpu: "spectrogram" is STFT -> magnitude -> transpose ->
power (squared with use_power), N x (C) x T x F; "fbank" adds the mel
filterbank and "mfcc" the log and the DCT after it.

An "fbank" followed by "log" without centering, a learnable filterbank or a
mel_matrix runs through the fused log-mel kernel K1 (aps_tpu_torch.ops.
fbank); the JAX package does so only on a TPU and only when frame_hop % 8
== 0, a TPU tiling condition that does not apply here. Every other chain
is the layers above in plain PyTorch (aps_tpu runs no kernel there
either); its STFT is torch.fft on complex64 (transform/utils.py).

The layers carry aps_tpu's module names (layers_<i>, the index of the
layer in aps_tpu's list), so that a learnable filterbank's `filters` maps
onto aps_tpu's parameter (convert.py). A global CMVN keeps its mean and
standard deviation as buffers of the module's state, read from a (2, D)
.npy or a Kaldi .ark of statistics (loader/kaldi_io.py); a missing file
warns and leaves zeros and ones, as in aps_tpu. "cmvn" otherwise keeps the
masked statistics, so a padded batch normalises exactly as its utterances
would alone. audio_norm: false rescales the waveform to the int16 range
first. "perturb" and "aug" are identities at inference; in training they
draw from the transform's `generator` (the trainer sets one on its device)
through perturb.draw and specaug.draw, which a check may replace to feed
in draws of its own. forward(..., skip_stft=True) takes an STFT the caller
made (the enh transform's) through the steps after the STFT, as aps_tpu's
does. A string without a spectrum ("abs-mel-log-cmvn", the features of a
multi-channel front end's enhanced magnitude) takes features N x (C) x T x
F and their frame counts. "delta" appends delta_order orders of deltas
over delta_ctx frames each side (edges clamped at the padded batch's
ends), on the feature axis or, with delta_as_channel, on a new axis 1;
feats_dim grows by (order+1) either way, as in aps_tpu. "splice" stacks
lctx and rctx neighbours on the feature axis and keeps every
subsampling_factor-th frame; the frame counts are divided by
subsampling_factor whatever the tokens, as in aps_tpu.

Sequence parallelism (`seq_split`, a parallel.SeqSplit the trainer sets
under tensor_parallel with sequence_parallel): the frame-local steps
from the spectrum on (the STFT chain or K1's fused span, and the
magnitude, power, mel, log, abs and dct steps after it) run on the model
rank's frames only, read from the whole waveform, and are gathered along
time after them; every step after that (cmvn, aug, splice, delta) sees
all frames, so utterance-level cmvn is that of the whole utterance.
Speed perturbation runs before, on the whole waveform, with the model
group's shared draw."""

import warnings
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from aps_tpu_torch.const import EPSILON, MAX_INT16
from aps_tpu_torch.libs import ApsRegisters
from aps_tpu_torch.ops import fbank
from aps_tpu_torch.parallel.mesh import gather_frames, split_frames
from aps_tpu_torch.transform.augment import perturb_speed, tf_mask
from aps_tpu_torch.transform.utils import (_stft_geometry, dct_matrix,
                                           fft_size_of, forward_stft,
                                           make_window, mel_filter,
                                           num_frames, speed_perturb_filter,
                                           splice_feature)

# steps that act on each frame alone: sequence parallelism splits them
FRAME_LOCAL = ("spectrogram", "magnitude", "trans", "pow", "mel", "log",
               "abs", "dct")


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


class PreEmphasisTransform(nn.Module):
    """Utterance-level pre-emphasis of the waveform ("emph"; the STFT's own
    is per frame)."""

    def __init__(self, pre_emphasis: float = 0):
        super(PreEmphasisTransform, self).__init__()
        self.pre_emphasis = pre_emphasis

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        if self.pre_emphasis <= 0:
            return wav
        rest = wav[..., 1:] - self.pre_emphasis * wav[..., :-1]
        return torch.cat([wav[..., :1], rest], -1)


class SpectrogramTransform(nn.Module):
    """STFT: N x (C) x S -> N x (C) x F x T complex64 (forward_stft)."""

    def __init__(self,
                 frame_len: int,
                 frame_hop: int,
                 window: str = "hamm",
                 round_pow_of_two: bool = True,
                 normalized: bool = False,
                 pre_emphasis: float = 0.97,
                 onesided: bool = True,
                 center: bool = False,
                 mode: str = "librosa"):
        super(SpectrogramTransform, self).__init__()
        self.frame_len = frame_len
        self.frame_hop = frame_hop
        self.window = window
        self.round_pow_of_two = round_pow_of_two
        self.normalized = normalized
        self.pre_emphasis = pre_emphasis
        self.onesided = onesided
        self.center = center
        self.mode = mode

    def dim(self) -> int:
        return fft_size_of(self.frame_len, self.round_pow_of_two
                           or self.mode == "kaldi") // 2 + 1

    def num_frames(self, wav_len):
        return num_frames(wav_len, self.frame_len, self.frame_hop,
                          self.round_pow_of_two, self.mode, self.center)

    def forward(self, wav: torch.Tensor,
                center: Optional[bool] = None) -> torch.Tensor:
        """center: the module's unless given (False on samples padded
        already)."""
        return forward_stft(wav,
                            self.frame_len,
                            self.frame_hop,
                            window=self.window,
                            round_pow_of_two=self.round_pow_of_two,
                            pre_emphasis=self.pre_emphasis,
                            normalized=self.normalized,
                            onesided=self.onesided,
                            center=self.center if center is None else center,
                            mode=self.mode)


class MagnitudeTransform(nn.Module):
    """|x| of a complex spectrum (sqrt(|x|^2 + eps) with eps > 0)."""

    def __init__(self, eps: float = 0):
        super(MagnitudeTransform, self).__init__()
        self.eps = eps

    def forward(self, spec: torch.Tensor) -> torch.Tensor:
        if self.eps > 0:
            return torch.sqrt(spec.real**2 + spec.imag**2 + self.eps)
        return spec.abs()


class TFTransposeTransform(nn.Module):
    """Swap two axes (time and frequency by default)."""

    def __init__(self, axis1: int = -1, axis2: int = -2):
        super(TFTransposeTransform, self).__init__()
        self.axis1, self.axis2 = axis1, axis2

    def forward(self, tensor: torch.Tensor) -> torch.Tensor:
        return tensor.transpose(self.axis1, self.axis2)


class AbsTransform(nn.Module):
    """|x| + eps."""

    def __init__(self, eps: float = 1e-6):
        super(AbsTransform, self).__init__()
        self.eps = eps

    def forward(self, tensor: torch.Tensor) -> torch.Tensor:
        return tensor.abs() + self.eps


class PowerTransform(nn.Module):
    """x ** power (the identity at power 1)."""

    def __init__(self, power: float = 2):
        super(PowerTransform, self).__init__()
        self.power = power

    def forward(self, tensor: torch.Tensor) -> torch.Tensor:
        return tensor if self.power == 1 else tensor**self.power


class MelTransform(nn.Module):
    """Mel filterbank projection: ... x F -> ... x num_mels. The filters
    (num_mels x F) are mel_filter's or a mel_matrix .npy's; with
    requires_grad they are a parameter named `filters`, as aps_tpu's
    (convert.py maps it through jax_params), else a buffer outside the
    state (aps_tpu keeps the fixed filterbank out of its variables)."""

    def __init__(self,
                 frame_len: int,
                 round_pow_of_two: bool = True,
                 sr: int = 16000,
                 num_mels: int = 80,
                 fmin: float = 0.0,
                 fmax: Optional[float] = None,
                 coeff_norm: bool = False,
                 mel_matrix: str = "",
                 requires_grad: bool = False):
        super(MelTransform, self).__init__()
        if mel_matrix:
            filters = np.load(mel_matrix)
        else:
            filters = mel_filter(frame_len,
                                 round_pow_of_two=round_pow_of_two,
                                 sr=sr,
                                 num_mels=num_mels,
                                 fmin=fmin,
                                 fmax=fmax,
                                 norm=coeff_norm)
        filters = torch.as_tensor(np.asarray(filters), dtype=torch.float32)
        self.num_mels = num_mels
        self.requires_grad = requires_grad
        if requires_grad:
            self.filters = nn.Parameter(filters)
            self.jax_params = ("filters",)
        else:
            # F x M, made contiguous once
            self.register_buffer("proj", filters.t().contiguous(),
                                 persistent=False)

    def dim(self) -> int:
        return self.num_mels

    def forward(self, linear: torch.Tensor) -> torch.Tensor:
        if self.requires_grad:
            return linear @ self.filters.t()
        return linear @ self.proj


class LogTransform(nn.Module):
    """log(max(x, eps)), or log(lower_bound + x) with lower_bound > 0."""

    def __init__(self, eps: float = 1e-5, lower_bound: float = 0.0):
        super(LogTransform, self).__init__()
        self.eps = eps
        self.lower_bound = lower_bound

    def forward(self, linear: torch.Tensor) -> torch.Tensor:
        if self.lower_bound > 0:
            return torch.log(self.lower_bound + linear)
        return torch.log(torch.clamp_min(linear, self.eps))


class DiscreteCosineTransform(nn.Module):
    """log-mel -> MFCC: the orthonormal DCT-II (dct_matrix, with the
    lifter), ... x num_mels -> ... x num_ceps."""

    def __init__(self, num_ceps: int = 13, num_mels: int = 80,
                 lifter: float = 0):
        super(DiscreteCosineTransform, self).__init__()
        self.num_ceps = num_ceps
        self.register_buffer(
            "proj", torch.from_numpy(np.ascontiguousarray(
                dct_matrix(num_ceps, num_mels, lifter=lifter).T)),
            persistent=False)

    def dim(self) -> int:
        return self.num_ceps

    def forward(self, log_mel: torch.Tensor) -> torch.Tensor:
        return log_mel @ self.proj


class SpliceTransform(nn.Module):
    """Splice lctx and rctx neighbouring frames (edges clamped) onto the
    feature axis, then keep every subsampling_factor-th frame of the
    whole ones."""

    def __init__(self, lctx: int = 0, rctx: int = 0,
                 subsampling_factor: int = 1):
        super(SpliceTransform, self).__init__()
        self.lctx = max(lctx, 0)
        self.rctx = max(rctx, 0)
        self.subsampling_factor = subsampling_factor

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        feats = splice_feature(feats, lctx=self.lctx, rctx=self.rctx)
        sf = self.subsampling_factor
        if sf != 1:
            end = (feats.shape[-2] // sf) * sf
            feats = feats[..., :end:sf, :]
        return feats


def load_gcmvn(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """(mean, std) of global CMVN statistics: a (2, D) .npy of [mean; std],
    or a Kaldi .ark holding a 2 x (D + 1) matrix of sums, squares and the
    frame count (in float64, as aps_tpu)."""
    if path.endswith(".ark"):
        from aps_tpu_torch.loader.kaldi_io import read_kaldi_mat
        stats = read_kaldi_mat(path).astype(np.float64)
        cnt = stats[0, -1]
        mean = stats[0, :-1] / cnt
        std = np.sqrt(stats[1, :-1] / cnt - mean**2)
        return mean, std
    stats = np.load(path)
    return stats[0], stats[1]


class CmvnTransform(nn.Module):
    """Mean/variance normalisation over time: utterance-level, or global
    with gcmvn, a (2, D) .npy of [mean; std] or a Kaldi .ark of CMVN
    statistics (sums, squares and the count). The global statistics are
    buffers of the module's state, gmean and gstd; a missing file warns
    and leaves zeros and ones of `dim`, as aps_tpu does."""

    def __init__(self,
                 norm_mean: bool = True,
                 norm_var: bool = True,
                 per_band: bool = True,
                 gcmvn: str = "",
                 dim: int = 1,
                 eps: float = 1e-5):
        super(CmvnTransform, self).__init__()
        self.norm_mean = norm_mean
        self.norm_var = norm_var
        self.per_band = per_band
        self.eps = eps
        self.gcmvn = gcmvn
        if gcmvn:
            try:
                mean, std = load_gcmvn(gcmvn)
            except FileNotFoundError:
                warnings.warn(f"{gcmvn} not found (no impact when loading "
                              "from checkpoint later) ...")
                mean, std = np.zeros(dim), np.ones(dim)
            self.register_buffer("gmean", torch.as_tensor(
                np.asarray(mean), dtype=torch.float32))
            self.register_buffer("gstd", torch.as_tensor(
                np.asarray(std), dtype=torch.float32))
            # aps_tpu keeps no variable for them: convert.py carries them
            # in a collection of their own
            self.port_constants = ("gmean", "gstd")

    def forward(self, feats: torch.Tensor,
                num_frames: Optional[torch.Tensor] = None) -> torch.Tensor:
        """feats: N x (C) x T x F, normalised over T (per band) or T and F;
        num_frames (N) restricts the statistics to the valid frames. With
        global statistics every frame is normalised by them."""
        if not self.norm_mean and not self.norm_var:
            return feats
        if self.gcmvn:
            if self.norm_mean:
                feats = feats - self.gmean
            if self.norm_var:
                feats = feats / self.gstd
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
    """String-programmed ASR feature pipeline, e.g. "fbank-log-cmvn" (see
    the module docstring). Takes the keyword arguments of aps_tpu's
    FeatureTransform."""

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
        # the training draws' generator (the trainer sets one on its
        # device); None draws from torch's default generator
        self.generator = None
        # sequence parallelism's split of the frames (the trainer sets it)
        self.seq_split = None
        self.feats_dim = 0
        # step names and their layers, in order; `fused` is the span of
        # steps that K1 replaces (the fbank chain and the log after it)
        self.steps: List[str] = []
        self._layers: List[nn.Module] = []
        self.fused = None
        self.spectra_index = -1
        self._fbank_ops = {}  # device -> fbank.Operands, made at its first use
        stft_kwargs = dict(window=window,
                           round_pow_of_two=round_pow_of_two,
                           normalized=stft_normalized,
                           pre_emphasis=pre_emphasis,
                           center=center,
                           mode=stft_mode)
        mel_kwargs = dict(round_pow_of_two=round_pow_of_two,
                          sr=sr,
                          fmin=min_freq,
                          fmax=max_freq,
                          num_mels=num_mels,
                          coeff_norm=mel_coeff_norm,
                          mel_matrix=mel_matrix,
                          requires_grad=requires_grad)
        # aps_tpu's list of layers starts with its RescaleTransform
        index = [0 if audio_norm else 1]

        def add(name: str, layer: nn.Module) -> nn.Module:
            self.add_module(f"layers_{index[0]}", layer)
            index[0] += 1
            self.steps.append(name)
            self._layers.append(layer)
            return layer

        toks = feats.split("-")
        for i, tok in enumerate(toks):
            if tok == "perturb":
                add(tok, SpeedPerturbTransform(sr=sr, perturb=speed_perturb))
            elif tok == "emph":
                add(tok, PreEmphasisTransform(pre_emphasis=pre_emphasis))
            elif tok in ("spectrogram", "fbank", "mfcc"):
                first = self.spectra_index = len(self.steps)
                stft = add("spectrogram", SpectrogramTransform(
                    frame_len, frame_hop, **stft_kwargs))
                add("magnitude", MagnitudeTransform())
                add("trans", TFTransposeTransform())
                add("pow", PowerTransform(power=2 if use_power else 1))
                self.feats_dim = stft.dim()
                if tok != "spectrogram":
                    self.feats_dim = add("mel", MelTransform(
                        frame_len, **mel_kwargs)).dim()
                if tok == "mfcc":
                    add("log", LogTransform(eps=eps,
                                            lower_bound=log_lower_bound))
                    self.feats_dim = add("dct", DiscreteCosineTransform(
                        num_ceps=num_ceps, num_mels=num_mels,
                        lifter=lifter)).dim()
                if (tok == "fbank" and self.fused is None
                        and toks[i + 1:i + 2] == ["log"] and not center
                        and not requires_grad and not mel_matrix
                        and pre_emphasis >= 0):
                    self.fused = (first, first + 6)
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
            elif tok == "trans":
                add(tok, TFTransposeTransform())
            elif tok == "pow":
                add(tok, PowerTransform())
            elif tok == "mel":
                self.feats_dim = add(tok, MelTransform(frame_len,
                                                       **mel_kwargs)).dim()
            elif tok == "log":
                add(tok, LogTransform(eps=eps, lower_bound=log_lower_bound))
            elif tok == "abs":
                add(tok, AbsTransform(eps=eps))
            elif tok == "dct":
                self.feats_dim = add(tok, DiscreteCosineTransform(
                    num_ceps=num_ceps, num_mels=num_mels,
                    lifter=lifter)).dim()
            elif tok == "cmvn":
                add(tok, CmvnTransform(norm_mean=norm_mean,
                                       norm_var=norm_var,
                                       per_band=norm_per_band,
                                       gcmvn=gcmvn,
                                       dim=self.feats_dim,
                                       eps=eps))
            elif tok == "aug":
                add(tok, SpecAugTransform(p=aug_prob,
                                          adaptive_args=aug_adaptive_args,
                                          time_args=aug_time_args,
                                          freq_args=aug_freq_args,
                                          maxp_time=aug_maxp_time,
                                          mask_zero=aug_mask_zero))
            elif tok == "splice":
                add(tok, SpliceTransform(
                    lctx=lctx, rctx=rctx,
                    subsampling_factor=subsampling_factor))
                self.feats_dim *= 1 + lctx + rctx
            elif tok == "delta":
                add(tok, DeltaTransform(ctx=delta_ctx, order=delta_order,
                                        delta_as_channel=delta_as_channel))
                self.feats_dim *= 1 + delta_order
            else:
                raise RuntimeError(f"Unknown token {tok} in {feats}")

    def _first(self, kind):
        return next((layer for layer in self._layers
                     if isinstance(layer, kind)), None)

    @property
    def perturb(self) -> Optional[SpeedPerturbTransform]:
        return self._first(SpeedPerturbTransform)

    @property
    def specaug(self) -> Optional[SpecAugTransform]:
        return self._first(SpecAugTransform)

    @property
    def cmvn(self) -> Optional[CmvnTransform]:
        return self._first(CmvnTransform)

    @property
    def delta(self) -> Optional[DeltaTransform]:
        return self._first(DeltaTransform)

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

    def _frames(self, inp_pad: torch.Tensor, inp_len,
                choice: Optional[int]):
        """Valid frames of each utterance, at most those of the padded
        batch (None without lengths)."""
        nf = self._num_frames(inp_len, choice)
        if nf is None:
            return None
        return torch.clamp_max(
            torch.as_tensor(nf),
            num_frames(inp_pad.shape[-1], self.frame_len, self.frame_hop,
                       self.round_pow_of_two, self.stft_mode, self.center)
            if self.accept_raw else inp_pad.shape[-2])

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

    def _frame_steps(self, feats: torch.Tensor, beg: int, end: int,
                     center: Optional[bool] = None) -> torch.Tensor:
        """Frame-local steps [beg, end) from the spectrum on: K1 over the
        fused span, the layers elsewhere."""
        for i in range(beg, end):
            if self.fused is not None and self.fused[0] <= i < self.fused[1]:
                if i == self.fused[0]:
                    feats = self._fbank_log(feats)
            elif self.steps[i] == "spectrogram" and center is not None:
                feats = self._layers[i](feats, center=center)
            else:
                feats = self._layers[i](feats)
        return feats

    def _spectra(self, wav: torch.Tensor, beg: int, end: int
                 ) -> torch.Tensor:
        """The frame-local steps [beg, end) on a waveform; under sequence
        parallelism on the model rank's frames, gathered along time."""
        split = self.seq_split
        cut = None
        if split is not None:
            _, win = _stft_geometry(self.frame_len, self.round_pow_of_two,
                                    self.stft_mode)
            cut = split_frames(wav, win, self.frame_hop, self.center, split)
        if cut is None:
            return self._frame_steps(wav, beg, end)
        local, frames, total = cut
        out = self._frame_steps(local, beg, end, center=False)
        # the spectrum has time last; each transpose moves it
        axis = -2 if self.steps[beg:end].count("trans") % 2 else -1
        return gather_frames(out, axis, frames, total, split.group)

    def forward(self, inp_pad: torch.Tensor, inp_len=None,
                training: bool = False, skip_stft: bool = False):
        """inp_pad: N x (C x) S waveform, inp_len: N or None ->
        (feats N x (C x) T x F, num_frames N or None). In training the
        branch and the masks come from perturb.draw and specaug.draw.
        skip_stft: inp_pad is an STFT, N x (C x) F x T complex, that goes
        through the steps after the STFT (the layered chain, also where K1
        would run); cmvn then takes its statistics over every frame and
        inp_len comes back as it is (as in aps_tpu)."""
        choice = None
        feats = inp_pad
        if skip_stft:
            if self.spectra_index < 0:
                raise ValueError(f"{self.feats}: skip_stft needs a "
                                 "spectral front end")
            first = self.spectra_index + 1
        else:
            first = 0
            if self.rescale is not None:
                feats = self.rescale(feats)
        i = first
        while i < len(self.steps):
            if self.steps[i] == "spectrogram":
                end = i + 1
                while end < len(self.steps) and \
                        self.steps[end] in FRAME_LOCAL:
                    end += 1
                feats = self._spectra(feats, i, end)
                i = end
                continue
            step, layer = self.steps[i], self._layers[i]
            i += 1
            if step == "perturb":
                if training:
                    choice = layer.draw(self.generator)
                    feats = layer(feats, choice)
            elif step == "cmvn":
                feats = layer(feats, num_frames=None if skip_stft else
                              self._frames(inp_pad, inp_len, choice))
            elif step == "aug":
                if training and layer.p > 0:
                    feats = layer(feats, layer.draw(feats, self.generator))
            else:
                feats = layer(feats)
        if skip_stft:
            return feats, inp_len
        return feats, self._frames(inp_pad, inp_len, choice)


AsrTransform = FeatureTransform
