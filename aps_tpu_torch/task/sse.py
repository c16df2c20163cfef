#!/usr/bin/env python
"""Separation / enhancement tasks (port of aps_tpu/task/sse.py: SepTask,
TimeDomainTask, SisnrTask "sse@sisnr", SnrTask "sse@snr", WaTask
"sse@wa", FreqSaTask with LinearFreqSaTask "sse@freq_linear_sa" and
MelFreqSaTask "sse@freq_mel_sa", TimeSaTask with LinearTimeSaTask
"sse@time_linear_sa" and MelTimeSaTask "sse@time_mel_sa",
ComplexMappingTask "sse@complex_mapping" and ComplexMaskingTask
"sse@complex_masking").

The spectra are complex64 (aps_tpu_torch.transform.enh.StftCtx); the
phase-sensitive target's cos(ref phase - mix phase) is Re(ref conj(mix))
over the product of the magnitudes, the value aps_tpu forms by the trig
identity from its packed pairs. Every magnitude is sqrt(re^2 + im^2 +
EPSILON), as aps_tpu's. With dpcl_weight > 0, a model with dpcl_embed
(chimera++) and more than one speaker, the spectral approximation adds
the deep-clustering loss: dpcl_weight x DPCL + (1 - dpcl_weight) x the
mask loss, reported as "loss", "dpcl" and "mask".

The complex tasks reduce the real and the imaginary parts of the
complex64 spectra or masks as aps_tpu reduces its packed N x F x T x 2
pairs: the distance of each part (and of the magnitudes, when asked) per
bin, averaged over T and summed over F.

Every mean over the batch is the global batch's in a data-parallel step
(aps_tpu_torch.distributed.global_mean): this rank's sum over the global
count."""

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from aps_tpu_torch.const import EPSILON
from aps_tpu_torch.distributed import global_mean
from aps_tpu_torch.libs import ApsRegisters
from aps_tpu_torch.task.base import Task
from aps_tpu_torch.task.objf import (DpclObjfComputer, hybrid_permu_objf,
                                     sisnr_objf, snr_objf)
from aps_tpu_torch.transform.enh import StftCtx
from aps_tpu_torch.transform.utils import mel_filter

__all__ = [
    "SisnrTask", "SnrTask", "WaTask", "LinearFreqSaTask", "MelFreqSaTask",
    "LinearTimeSaTask", "MelTimeSaTask", "ComplexMappingTask",
    "ComplexMaskingTask"
]


def _l1(a, b):
    return (a - b).abs()


def _l2(a, b):
    return (a - b)**2


def _parse_weight(weight):
    if weight is None:
        return None
    if isinstance(weight, str):
        return [float(w) for w in weight.split(",")]
    return list(weight)


def _magnitude(stft: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(stft.real**2 + stft.imag**2 + EPSILON)


class SepTask(Task):
    """Base class for separation & enhancement tasks."""

    def __init__(self, nnet: nn.Module, weight: Optional[str] = None,
                 description: str = "unknown"):
        super(SepTask, self).__init__(nnet, description=description)
        self.weight = weight

    def branch_weight(self):
        return _parse_weight(self.weight)

    def objf(self, out, ref):
        raise NotImplementedError

    def transform(self, tensor):
        return tensor


class TimeDomainTask(SepTask):
    """Waveform-level loss task."""

    def __init__(self, nnet: nn.Module, num_spks: int = 2,
                 permute: bool = True, **kwargs):
        super(TimeDomainTask, self).__init__(nnet, **kwargs)
        self.num_spks = num_spks
        self.permute = permute

    def forward(self, egs: Dict) -> Dict:
        """egs: {mix: N x (C) x S, ref: N x S or [N x S, ...]}."""
        ref = egs["ref"]
        out = self.nnet(egs["mix"])
        if not isinstance(out, (list, tuple)):
            out, ref = [out], [ref]
        loss = hybrid_permu_objf(list(out), list(ref), self.objf,
                                 weight=self.branch_weight(),
                                 permute=self.permute,
                                 permu_num_spks=self.num_spks)
        return {"loss": global_mean(loss)}


@ApsRegisters.task.register("sse@sisnr")
class SisnrTask(TimeDomainTask):
    """Negative SiSNR objective."""

    def __init__(self, nnet: nn.Module, zero_mean: bool = True,
                 non_nagetive: bool = False, **kwargs):
        super(SisnrTask, self).__init__(nnet, **kwargs)
        self.zero_mean = zero_mean
        self.non_nagetive = non_nagetive

    def objf(self, out, ref):
        return -sisnr_objf(out, ref, zero_mean=self.zero_mean,
                           non_nagetive=self.non_nagetive)


@ApsRegisters.task.register("sse@snr")
class SnrTask(TimeDomainTask):
    """Negative SNR objective."""

    def __init__(self, nnet: nn.Module, snr_max: float = -1,
                 non_nagetive: bool = False, **kwargs):
        super(SnrTask, self).__init__(nnet, **kwargs)
        self.snr_max = snr_max
        self.non_nagetive = non_nagetive

    def objf(self, out, ref):
        return -snr_objf(out, ref, non_nagetive=self.non_nagetive,
                         snr_max=self.snr_max)


@ApsRegisters.task.register("sse@wa")
class WaTask(TimeDomainTask):
    """Waveform approximation: the L1 or L2 distance summed over samples."""

    def __init__(self, nnet: nn.Module, objf_name: str = "L1", **kwargs):
        super(WaTask, self).__init__(nnet, **kwargs)
        self.objf_name = objf_name

    def objf(self, out, ref):
        fn = _l1 if self.objf_name == "L1" else _l2
        return fn(out, ref).sum(-1)


class _MelMixin:
    """The mel projection of the mel spectral approximations."""

    def _init_mel(self, power_mag: bool, num_bins: int, num_mels: int,
                  mel_log: bool, mel_scale: float, mel_norm: bool, sr: int,
                  fmax: int):
        self.power_mag = power_mag
        self.mel_log = mel_log
        mel = mel_filter(None, num_bins=num_bins, sr=sr, num_mels=num_mels,
                         fmax=fmax, norm=mel_norm)
        self.register_buffer("mel", torch.from_numpy(mel) * mel_scale,
                             persistent=False)

    def transform(self, tensor):
        if self.power_mag:
            tensor = tensor**2
        # N x F x T -> N x M x T
        mel = torch.einsum("mf,nft->nmt", self.mel, tensor)
        if self.mel_log:
            mel = torch.log(1 + mel)
        return mel

    def objf(self, out, ref):
        return _l2(out, ref).mean(-1).sum(-1)


class FreqSaTask(SepTask):
    """Frequency-domain spectral approximation: the masks (masking) or the
    magnitudes the model gives against the references' magnitudes, phase
    sensitive and truncated as set."""

    def __init__(self,
                 nnet: nn.Module,
                 phase_sensitive: bool = False,
                 truncated: float = -1,
                 permute: bool = True,
                 masking: bool = True,
                 num_spks: int = 2,
                 dpcl_weight: float = 0,
                 **kwargs):
        super(FreqSaTask, self).__init__(nnet, **kwargs)
        self.phase_sensitive = phase_sensitive
        self.truncated = truncated
        self.permute = permute
        self.masking = masking
        self.num_spks = num_spks
        self.dpcl_weight = dpcl_weight

    def _ref_mag(self, mix_stft, mix_mag, ref_stft):
        """The (t)PSA target magnitude of one reference."""
        ref_mag = _magnitude(ref_stft)
        if self.phase_sensitive:
            dot = (ref_stft * mix_stft.conj()).real
            cos_dif = dot / torch.clamp_min(ref_mag * mix_mag, EPSILON)
            ref_mag = ref_mag * torch.clamp_min(cos_dif, 0)
        if self.truncated > 0:
            ref_mag = torch.minimum(ref_mag, self.truncated * mix_mag)
        return ref_mag

    def forward(self, egs: Dict) -> Dict:
        if not self.masking and self.truncated > 0:
            raise ValueError("masking = False conflicts with truncated > 0")
        mix, ref = egs["mix"], egs["ref"]
        mask = self.nnet(mix)
        ctx = self.nnet.enh_transform.ctx("forward_stft")
        mix_stft = ctx.forward(mix[:, 0] if mix.dim() == 3 else mix)
        mix_mag = _magnitude(mix_stft)
        if not isinstance(mask, (list, tuple)):
            mask, ref = [mask], [ref]
        ref_stft = [ctx.forward(r) for r in ref]
        ref_mag = [self._ref_mag(mix_stft, mix_mag, r) for r in ref_stft]
        out = [m * mix_mag for m in mask] if self.masking else list(mask)
        loss = hybrid_permu_objf(out, ref_mag, self.objf,
                                 transform=self.transform,
                                 weight=self.branch_weight(),
                                 permute=self.permute,
                                 permu_num_spks=self.num_spks)
        mask_loss = global_mean(loss)
        if self.dpcl_weight > 0 and hasattr(self.nnet, "dpcl_embed") \
                and self.num_spks > 1:
            raw_mag = torch.stack([_magnitude(r) for r in ref_stft], -1)
            dpcl_loss = DpclObjfComputer()(self.nnet.dpcl_embed(mix),
                                           raw_mag, mix_mag, mean=True)
            return {
                "loss": self.dpcl_weight * dpcl_loss +
                (1 - self.dpcl_weight) * mask_loss,
                "dpcl": dpcl_loss,
                "mask": mask_loss
            }
        return {"loss": mask_loss}


@ApsRegisters.task.register("sse@freq_linear_sa")
class LinearFreqSaTask(FreqSaTask):
    """Linear spectral approximation (MSA or tPSA)."""

    def __init__(self, nnet: nn.Module, objf_name: str = "L2", **kwargs):
        super(LinearFreqSaTask, self).__init__(nnet, **kwargs)
        self.objf_name = objf_name

    def objf(self, out, ref):
        fn = _l1 if self.objf_name == "L1" else _l2
        # out/ref: N x F x T: mean over T, sum over F
        return fn(out, ref).mean(-1).sum(-1)


@ApsRegisters.task.register("sse@freq_mel_sa")
class MelFreqSaTask(_MelMixin, FreqSaTask):
    """Mel-domain spectral approximation."""

    def __init__(self,
                 nnet: nn.Module,
                 power_mag: bool = False,
                 num_bins: int = 257,
                 num_mels: int = 80,
                 mel_log: bool = False,
                 mel_scale: float = 1,
                 mel_norm: bool = False,
                 sr: int = 16000,
                 fmax: int = 8000,
                 **kwargs):
        super(MelFreqSaTask, self).__init__(nnet, **kwargs)
        self._init_mel(power_mag, num_bins, num_mels, mel_log, mel_scale,
                       mel_norm, sr, fmax)


class TimeSaTask(SepTask):
    """Time-domain output, spectral-approximation loss: the magnitudes of
    the separated and the reference waveforms through the task's own
    STFT."""

    def __init__(self,
                 nnet: nn.Module,
                 frame_len: int = 512,
                 frame_hop: int = 256,
                 center: bool = False,
                 window: str = "sqrthann",
                 round_pow_of_two: bool = True,
                 stft_normalized: bool = False,
                 pre_emphasis: float = 0,
                 permute: bool = True,
                 num_spks: int = 2,
                 **kwargs):
        super(TimeSaTask, self).__init__(nnet, **kwargs)
        self.ctx = StftCtx(frame_len=frame_len,
                           frame_hop=frame_hop,
                           window=window,
                           center=center,
                           round_pow_of_two=round_pow_of_two,
                           normalized=stft_normalized)
        self.pre_emphasis = pre_emphasis
        self.permute = permute
        self.num_spks = num_spks

    def _stft_mag(self, wav: torch.Tensor) -> torch.Tensor:
        if self.pre_emphasis > 0:
            wav = torch.cat([
                wav[:, :1], wav[:, 1:] - self.pre_emphasis * wav[:, :-1]
            ], 1)
        return _magnitude(self.ctx.forward(wav))

    def forward(self, egs: Dict) -> Dict:
        mix, ref = egs["mix"], egs["ref"]
        spk = self.nnet(mix)
        if not isinstance(spk, (list, tuple)):
            spk, ref = [spk], [ref]
        loss = hybrid_permu_objf([self._stft_mag(s) for s in spk],
                                 [self._stft_mag(r) for r in ref],
                                 self.objf,
                                 transform=self.transform,
                                 weight=self.branch_weight(),
                                 permute=self.permute,
                                 permu_num_spks=self.num_spks)
        return {"loss": global_mean(loss)}


@ApsRegisters.task.register("sse@time_linear_sa")
class LinearTimeSaTask(TimeSaTask):

    def __init__(self, nnet: nn.Module, objf_name: str = "L2", **kwargs):
        super(LinearTimeSaTask, self).__init__(nnet, **kwargs)
        self.objf_name = objf_name

    def objf(self, out, ref):
        fn = _l1 if self.objf_name == "L1" else _l2
        return fn(out, ref).mean(-1).sum(-1)


@ApsRegisters.task.register("sse@time_mel_sa")
class MelTimeSaTask(_MelMixin, TimeSaTask):

    def __init__(self,
                 nnet: nn.Module,
                 power_mag: bool = False,
                 num_bins: int = 257,
                 num_mels: int = 80,
                 mel_log: bool = False,
                 mel_scale: float = 1,
                 mel_norm: bool = False,
                 sr: int = 16000,
                 fmax: int = 7690,
                 **kwargs):
        super(MelTimeSaTask, self).__init__(nnet, **kwargs)
        self._init_mel(power_mag, num_bins, num_mels, mel_log, mel_scale,
                       mel_norm, sr, fmax)


@ApsRegisters.task.register("sse@complex_mapping")
class ComplexMappingTask(SepTask):
    """Complex spectral mapping: the model's complex spectra against the
    references' STFT, L1 or L2 on the real and the imaginary parts (and on
    the magnitudes, add_magnitude_loss)."""

    def __init__(self, nnet: nn.Module, num_spks: int = 2,
                 permute: bool = True, objf_name: str = "L1",
                 add_magnitude_loss: bool = True, **kwargs):
        super(ComplexMappingTask, self).__init__(nnet, **kwargs)
        self.num_spks = num_spks
        self.permute = permute
        self.objf_name = objf_name
        self.add_magnitude_loss = add_magnitude_loss

    def _ctx(self) -> StftCtx:
        return self.nnet.enh_transform.ctx("forward_stft")

    def objf(self, out, ref):
        """out, ref: N x F x T complex -> N"""
        fn = _l1 if self.objf_name == "L1" else _l2
        loss = fn(out.real, ref.real) + fn(out.imag, ref.imag)
        if self.add_magnitude_loss:
            loss = loss + fn(_magnitude(out), _magnitude(ref))
        return loss.mean(-1).sum(-1)

    def _loss(self, out, ref) -> Dict:
        loss = hybrid_permu_objf(out, ref, self.objf,
                                 weight=self.branch_weight(),
                                 permute=self.permute,
                                 permu_num_spks=self.num_spks)
        return {"loss": global_mean(loss)}

    def forward(self, egs: Dict) -> Dict:
        mix, ref = egs["mix"], egs["ref"]
        out = self.nnet(mix)
        if not isinstance(out, (list, tuple)):
            out, ref = [out], [ref]
        ctx = self._ctx()
        return self._loss(list(out), [ctx.forward(r) for r in ref])


@ApsRegisters.task.register("sse@complex_masking")
class ComplexMaskingTask(ComplexMappingTask):
    """Complex ratio masks: the masked mixture against the references'
    STFT, or (compress_masks) the masks against the references' cIRM
    compressed as k (1 - e) / (1 + e), e = exp(-c max(crm, lower_bound)),
    each part on its own."""

    def __init__(self, nnet: nn.Module,
                 compress_param: Tuple[float, float, float] = (10, 0.1, -100),
                 compress_masks: bool = False, objf_name: str = "L2",
                 add_magnitude_loss: bool = False, **kwargs):
        super(ComplexMaskingTask, self).__init__(
            nnet, objf_name=objf_name,
            add_magnitude_loss=add_magnitude_loss, **kwargs)
        self.compress_param = tuple(compress_param)
        self.compress_masks = compress_masks

    def _compress_mask(self, mix_stft: torch.Tensor,
                       ref: torch.Tensor) -> torch.Tensor:
        k, c, lower_bound = self.compress_param
        ref_stft = self._ctx().forward(ref)
        denominator = mix_stft.real**2 + mix_stft.imag**2 + EPSILON
        crm = mix_stft.conj() * ref_stft

        def compress(part):
            exp = torch.exp(-c * torch.clamp_min(part / denominator,
                                                 lower_bound))
            return k * (1 - exp) / (1 + exp)

        return torch.complex(compress(crm.real), compress(crm.imag))

    def forward(self, egs: Dict) -> Dict:
        ref = egs["ref"]
        out = self.nnet(egs["mix"])
        if not isinstance(out, (list, tuple)):
            out, ref = [out], [ref]
        mix = self._ctx().forward(egs["mix"])
        if self.compress_masks:
            ref = [self._compress_mask(mix, r) for r in ref]
            out = list(out)
        else:
            ref = [self._ctx().forward(r) for r in ref]
            out = [mix * o for o in out]
        return self._loss(out, ref)
