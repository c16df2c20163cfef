#!/usr/bin/env python
"""Host-side audio simulation: speaker mixing, RIR convolution, SNR scaling
(the port's own copy of aps_tpu/loader/simu.py, plain numpy and scipy).

The command-line option grammar and the output contract of run_simu are
aps_tpu's, so simu_cfg files drive both packages alike, and a seeded
process gives the same mixtures. Every ingredient of a mixture (speaker,
point noise, isotropic noise) becomes a `Placement`: a rendered
multi-channel image, an onset, and a gain solved from the requested
SNR/SDR against a reference power; `mixdown` pastes the placements into
one buffer. It runs in the dataloader, on the host."""

import argparse
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from aps_tpu_torch.const import EPSILON
from aps_tpu_torch.io.audio import add_room_response, read_audio
from aps_tpu_torch.opts import StrToBoolAction

__all__ = ["snr_gain", "coeff_snr", "run_simu", "make_argparse"]


def snr_gain(sig_pow: float, ref_pow: float, snr: float) -> float:
    """Gain g for `mix = ref + g * sig` such that
    10*log10(ref_pow / (sig_pow * g^2)) == snr."""
    if sig_pow == 0:
        return 0.0
    return float(np.sqrt(ref_pow / (sig_pow * 10.0**(snr / 10) + EPSILON)))


# alias kept for config-driven simulation (loader/se/config.py)
coeff_snr = snr_gain


@dataclass
class Placement:
    """One rendered source ready to paste into the mixture."""
    image: np.ndarray  # C x D
    begin: int
    power: float  # channel-0 mean square (early/wet per render options)
    gain: float = 1.0

    @property
    def channels(self) -> int:
        return self.image.shape[0]


def render(wav: np.ndarray,
           begin: int = 0,
           rir: Optional[np.ndarray] = None,
           channel: int = -1,
           length: Optional[int] = None,
           loop: bool = False,
           sr: int = 16000) -> Placement:
    """Crop/loop a mono source to fit, reverberate it when an RIR is given,
    and measure its power. `length` is the mixture length; when set, the
    image is bounded to [begin, length) (loop=True tiles short sources)."""
    if length is not None:
        span = length - begin
        if loop and wav.shape[-1] < span:
            wav = np.pad(wav, (0, span - wav.shape[-1]), mode="wrap")
        wav = wav[..., :span]
    if rir is None:
        image = np.atleast_2d(wav)
        power = float(np.mean(image[0]**2)) if image.shape[-1] else 0.0
        return Placement(image=image, begin=begin, power=power)
    rir = np.atleast_2d(rir)
    if channel >= 0:
        rir = rir[channel:channel + 1]
    image, _, power = add_room_response(wav, rir, sr=sr)
    return Placement(image=image, begin=begin, power=float(power))


def mixdown(placements: List[Placement], channels: int,
            length: int) -> np.ndarray:
    """Sum gain-scaled placements into a C x length buffer."""
    buf = np.zeros((channels, length), dtype=np.float32)
    for p in placements:
        end = min(length, p.begin + p.image.shape[-1])
        buf[..., p.begin:end] += p.gain * p.image[..., :end - p.begin]
    return buf


def _csv_floats(arg: str) -> Optional[List[float]]:
    return [float(v) for v in arg.split(",")] if arg else None


def _csv_ints(arg: str, default: int, count: int) -> List[int]:
    vals = _csv_floats(arg)
    return [int(v) for v in vals] if vals else [default] * count


def load_audio(src_args: str, beg=None, end=None, sr: int = 16000):
    """Comma-separated paths (+ optional per-path sample ranges) -> waves."""
    if not src_args:
        return None
    paths = src_args.split(",")
    begs = [int(v) for v in beg.split(",")] if beg else [0] * len(paths)
    ends = [int(v) for v in end.split(",")] if end else [None] * len(paths)
    return [
        read_audio(p, sr=sr, beg=b, end=e)
        for p, b, e in zip(paths, begs, ends)
    ]


def _speaker_placements(args, sr: int) -> Tuple[List[Placement], int]:
    """Speakers: first one is the 0 dB reference, the rest are SDR-scaled
    against it. Returns (placements, mixture length)."""
    spk = load_audio(args.src_spk, sr=sr)
    rir = load_audio(args.src_rir, sr=sr)
    if rir and len(rir) != len(spk):
        raise RuntimeError("--src-rir count mismatches --src-spk")
    sdr = _csv_floats(args.src_sdr)
    if len(spk) > 1 and not sdr:
        raise RuntimeError("--src-sdr needed for multiple --src-spk")
    if sdr and len(sdr) != len(spk) - 1:
        raise RuntimeError("--src-sdr count must be #speakers - 1")
    begin = _csv_ints(args.src_begin, 0, len(spk))
    length = max(b + s.shape[-1] for b, s in zip(begin, spk))
    placed = [
        render(s, begin=b, rir=rir[i] if rir else None,
               channel=args.dump_channel, sr=sr)
        for i, (s, b) in enumerate(zip(spk, begin))
    ]
    for p, level in zip(placed[1:], sdr or []):
        p.gain = snr_gain(p.power, placed[0].power, level)
    return placed, length


def _noise_placements(args, length: int, ref_power: float,
                      sr: int) -> List[Placement]:
    """Point-source noises, SNR-scaled against the speaker-sum power."""
    if not args.point_noise:
        return []
    offsets = args.point_noise_offset or None
    ends = ",".join(
        str(int(v) + length) for v in offsets.split(",")) if offsets else None
    noise = load_audio(args.point_noise, beg=offsets, end=ends, sr=sr)
    rir = load_audio(args.point_noise_rir, sr=sr)
    if rir and len(rir) != len(noise):
        raise RuntimeError("--point-noise-rir count mismatch")
    snr = _csv_floats(args.point_noise_snr)
    if not snr or len(snr) != len(noise):
        raise RuntimeError("--point-noise-snr count mismatch")
    begin = _csv_ints(args.point_noise_begin, 0, len(noise))
    placed = []
    for i, (n, b) in enumerate(zip(noise, begin)):
        p = render(n, begin=b, rir=rir[i] if rir else None,
                   channel=args.dump_channel, length=length,
                   loop=args.point_noise_repeat, sr=sr)
        p.gain = snr_gain(p.power, ref_power, snr[i])
        placed.append(p)
    return placed


def _isotropic_chunk(args, length: int, channels: int, ref_power: float,
                     sr: int) -> Optional[np.ndarray]:
    """Isotropic (diffuse) noise: a pre-recorded multi-channel slice, SNR
    set by its channel-0 power; the channel-0 slice is added everywhere."""
    if not args.isotropic_noise:
        return None
    beg = args.isotropic_noise_offset
    iso = load_audio(args.isotropic_noise, beg=str(beg),
                     end=str(beg + length), sr=sr)[0]
    snr = _csv_floats(args.isotropic_noise_snr)
    if not snr:
        raise RuntimeError("--isotropic-noise-snr required")
    iso = np.atleast_2d(iso)
    if channels == 1 and iso.shape[0] > 1:
        if args.dump_channel < 0:
            raise RuntimeError("1ch mixture vs multi-channel iso noise")
        iso = iso[args.dump_channel:args.dump_channel + 1]
    elif channels > 1 and iso.shape[0] != channels:
        raise RuntimeError("Channel mismatch mixture vs iso noise")
    chunk = iso[0, :length]
    return snr_gain(float(np.mean(chunk**2)), ref_power, snr[0]) * chunk


def run_simu(args):
    """Run one simulation from command-line style options; returns
    (mix S|CxS, [spk_ref S, ...], noise S|None)."""
    speakers, length = _speaker_placements(args, args.sr)
    channels = speakers[0].channels
    spk_sum = mixdown(speakers, channels, length)
    spk_power = float(np.mean(spk_sum[0]**2))

    noises = _noise_placements(args, length, spk_power, args.sr)
    if noises and noises[0].channels != channels:
        if channels == 1:
            for p in noises:
                p.image = p.image[:1]
        else:
            raise RuntimeError("Channel mismatch speaker vs point noise")
    noise = mixdown(noises, channels, length) if noises else None

    iso = _isotropic_chunk(args, length, channels, spk_power, args.sr)
    if iso is not None:
        if noise is None:
            noise = np.zeros((1, length), dtype=np.float32)
        noise[..., :iso.shape[-1]] += iso

    mix = spk_sum if noise is None else spk_sum + noise
    scale = args.norm_factor / (np.max(np.abs(mix)) + EPSILON)
    refs = [
        scale * mixdown([p], channels, length)[0] for p in speakers
    ]
    return (mix.squeeze() * scale, refs,
            None if noise is None else noise[0] * scale)


def make_argparse() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Command to do audio data simulation",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("--src-spk", type=str, required=True,
                        help="Source speakers, e.g., spk1.wav,spk2.wav")
    parser.add_argument("--src-rir", type=str, default="",
                        help="RIRs for each source speaker")
    parser.add_argument("--src-sdr", type=str, default="",
                        help="SDR for each speaker (vs speaker 0)")
    parser.add_argument("--src-begin", type=str, default="",
                        help="Begin samples in the mixture")
    parser.add_argument("--point-noise", type=str, default="",
                        help="Point-source noises")
    parser.add_argument("--point-noise-rir", type=str, default="",
                        help="RIRs of the point-source noises")
    parser.add_argument("--point-noise-snr", type=str, default="",
                        help="SNR of the point-source noises")
    parser.add_argument("--point-noise-begin", type=str, default="",
                        help="Begin samples of the noises in the mixture")
    parser.add_argument("--point-noise-offset", type=str, default="",
                        help="Read noise from this offset position")
    parser.add_argument("--point-noise-repeat", action=StrToBoolAction,
                        default=False, nargs="?", const=True,
                        help="Repeat the point-source noise or not")
    parser.add_argument("--isotropic-noise", type=str, default="",
                        help="Isotropic noise")
    parser.add_argument("--isotropic-noise-snr", type=str, default="",
                        help="SNR of the isotropic noise")
    parser.add_argument("--isotropic-noise-offset", type=int, default=0,
                        help="Read noise from this offset position")
    parser.add_argument("--dump-channel", type=int, default=-1,
                        help="Channel index to dump (-1 = all)")
    parser.add_argument("--norm-factor", type=float, default=0.9,
                        help="Normalization factor of the final output")
    parser.add_argument("--sr", type=int, default=16000,
                        help="Sample rate")
    return parser
