#!/usr/bin/env python
"""JSON-config online simulation loader for SSE (port of
aps_tpu/loader/se/config.py, registered "se@config"; same arguments and
egs contract, except that the sharding of the utterance order takes rank
and world_size explicitly).

Per-mixture json specs reference hdf5 slices ("/path.hdf5:key:beg:end")
for speakers, RIRs and noises; mixing happens on the host. h5py is
imported when the first slice is read, as in aps_tpu. The draws (whether a
mixture gets its RIRs and noises) come from numpy's global generator, as
in aps_tpu, so a seeded process gives the same mixtures in both
packages."""

import gzip
import json
from typing import Dict, Iterable, List, Tuple

import numpy as np

from aps_tpu_torch.const import EPSILON, MAX_INT16
from aps_tpu_torch.io.audio import add_room_response
from aps_tpu_torch.libs import ApsRegisters
from aps_tpu_torch.loader.se.chunk import WaveChunkDataLoader
from aps_tpu_torch.loader.simu import coeff_snr


@ApsRegisters.loader.register("se@config")
def DataLoader(train: bool = True,
               rank: int = 0,
               world_size: int = 1,
               simu_cfg: str = "",
               single_channel: bool = False,
               max_num_speakers: int = 2,
               hdf5_key: str = "wav",
               sr: int = 16000,
               early_reverb: bool = False,
               noise_reference: bool = True,
               rir_prob: float = 1.0,
               isotropic_noise_prob: float = 1.0,
               directional_noise_prob: float = 1.0,
               chunk_size: int = 64000,
               max_batch_size: int = 16,
               num_workers: int = 4) -> Iterable[Dict]:
    """Mixtures simulated from the json (or json.gz) simu_cfg; outside
    training a probability above 0 becomes 1."""

    def prob_cfg(prob):
        return prob if train else (1 if prob > 0 else 0)

    dataset = ConfigSimulationDataset(
        simu_cfg,
        single_channel=single_channel,
        max_num_speakers=max_num_speakers,
        hdf5_key=hdf5_key,
        sr=sr,
        early_reverb=early_reverb,
        noise_reference=noise_reference,
        rir_prob=prob_cfg(rir_prob),
        isotropic_noise_prob=prob_cfg(isotropic_noise_prob),
        directional_noise_prob=prob_cfg(directional_noise_prob))
    return WaveChunkDataLoader(dataset,
                               train=train,
                               chunk_size=chunk_size,
                               batch_size=max_batch_size,
                               num_workers=num_workers,
                               rank=rank,
                               world_size=world_size)


class ConfigSimulationDataset(object):
    """Online simulation dataset configured by json: each entry specifies
    speakers (hdf5 slice + rir + sdr + offset), directional noises and
    isotropic noise (the json grammar of aps_tpu/loader/se/config.py)."""

    def __init__(self,
                 simu_cfg: str,
                 single_channel: bool = False,
                 max_num_speakers: int = 2,
                 hdf5_key: str = "wav",
                 sr: int = 16000,
                 early_reverb: bool = False,
                 noise_reference: bool = True,
                 rir_prob: float = 1.0,
                 isotropic_noise_prob: float = 1.0,
                 directional_noise_prob: float = 1.0):
        self.simu_cfg = self._load_cfg(simu_cfg)
        self.sr = sr
        self.key = hdf5_key
        self.container = {}
        self.force_single = single_channel
        self.early_reverb = early_reverb
        self.max_spks = max_num_speakers
        self.rir_prob = rir_prob
        self.iso_noise_prob = isotropic_noise_prob
        self.dir_noise_prob = directional_noise_prob
        self.noise_ref = noise_reference

    def _load_cfg(self, simu_cfg: str) -> List:
        if simu_cfg.endswith("gz"):
            with gzip.open(simu_cfg, "r") as fp:
                return json.loads(fp.read())
        with open(simu_cfg, "r") as fp:
            return json.load(fp)

    def _load_audio(self, cfg: str, dtype: str, offset: int = 0,
                    length: int = -1) -> np.ndarray:
        assert dtype in ["rir", "spk", "dir", "iso"]
        import h5py
        ark_addr, _, beg, end = cfg.split(":")
        beg, end = int(beg), int(end)
        if ark_addr not in self.container:
            self.container[ark_addr] = h5py.File(ark_addr, "r")[self.key]
        chunk = self.container[ark_addr]
        beg += offset
        if length > 0:
            end = min(end, beg + length)
        audio = chunk[..., beg:end]
        if self.force_single and dtype in ["rir", "iso"]:
            audio = audio[0:1] if audio.ndim == 2 else audio[None, ...]
        return audio.astype(np.float32) / MAX_INT16

    def _conv_speaker_with_rir(self, cfg: Dict, add_rir: bool = True):
        spk = self._load_audio(cfg["utt"], "spk")
        if add_rir and "rir" in cfg:
            rir = self._load_audio(cfg["rir"], "rir")
            reverb, early, power = add_room_response(
                spk, rir, early_energy=self.early_reverb, sr=self.sr,
                early_revb_duration=0.05)
            if self.early_reverb:
                return reverb, early, power
            return reverb, reverb[0], power
        if spk.ndim == 1:
            spk = spk[None, ...]
        return spk, spk[0], np.mean(spk**2)

    def _conv_zero_with_rir(self, shape: Tuple, add_rir: bool = True):
        early = np.zeros(shape[-1], dtype=np.float32)
        if add_rir and not self.force_single:
            reverb = np.zeros(shape, dtype=np.float32)
        else:
            reverb = np.zeros((1, shape[-1]), dtype=np.float32)
        return reverb, early, 0

    def _mix_speakers(self, spk_stats: List, cfg: List, shape: Tuple,
                      ref_power: float):
        ref_revb, ref_early = [], []
        num_spks = len(spk_stats)
        for i, cur_cfg in enumerate(cfg):
            reverb, early, power = spk_stats[i]
            cur_len = early.shape[-1]
            pad = np.zeros(shape, dtype=np.float32)
            early_pad = np.zeros(shape[-1], dtype=np.float32)
            if i == 0:
                pad[:, :cur_len] = reverb[:, :shape[-1]][:, :cur_len]
                early_pad[:cur_len] = early[:shape[-1]][:cur_len]
            else:
                scale = coeff_snr(power, ref_power, cur_cfg["sdr"])
                beg = cur_cfg["offset"]
                end = min(beg + cur_len, shape[-1])
                pad[:, beg:end] = scale * reverb[:, :end - beg]
                early_pad[beg:end] = scale * early[:end - beg]
            ref_revb.append(pad)
            ref_early.append(early_pad)
        for i in range(len(cfg), num_spks):
            pad = np.zeros(shape, dtype=np.float32)
            r = spk_stats[i][0]
            pad[:, :r.shape[-1]] = r[:, :shape[-1]]
            ref_revb.append(pad)
            e = np.zeros(shape[-1], dtype=np.float32)
            e[:spk_stats[i][1].shape[-1]] = spk_stats[i][1][:shape[-1]]
            ref_early.append(e)
        return sum(ref_revb), ref_early

    def _load_isotropic_noise(self, cfg: Dict, shape: Tuple,
                              ref_power: float):
        out = np.zeros(shape, dtype=np.float32)
        if "isotropic_noise" in cfg and np.random.binomial(
                1, self.iso_noise_prob):
            icfg = cfg["isotropic_noise"]
            mix_len = shape[-1]
            iso = self._load_audio(icfg["utt"], "iso",
                                   offset=icfg["truncated"], length=mix_len)
            pad_size = mix_len - iso.shape[-1]
            if pad_size > 0:
                iso = np.pad(iso, ((0, 0), (0, pad_size)), mode="wrap")
            else:
                iso = iso[:, :mix_len]
            scale = coeff_snr(np.mean(iso[0]**2), ref_power, icfg["snr"])
            out += scale * iso[:shape[0]]
        return out

    def _load_directional_noise(self, cfg: Dict, shape: Tuple,
                                ref_power: float,
                                add_rir: bool = True) -> np.ndarray:
        out = np.zeros(shape, dtype=np.float32)
        if "directional_noise" in cfg and np.random.binomial(
                1, self.dir_noise_prob):
            for dir_cfg in cfg["directional_noise"]:
                seg = [tuple(map(int, t.split(":")))
                       for t in dir_cfg["truncated"].split(",")]
                seg_len = [e - b for b, e in seg]
                mix_beg = list(map(int, str(dir_cfg["offset"]).split(",")))
                for i in range(len(seg_len)):
                    cut = self._load_audio(dir_cfg["utt"], "dir",
                                           offset=seg[i][0],
                                           length=seg_len[i])
                    if cut.ndim == 2:
                        cut = cut[0]
                    if add_rir and "rir" in dir_cfg:
                        rir = self._load_audio(dir_cfg["rir"], "rir")
                        revb, _, power = add_room_response(cut, rir,
                                                           sr=self.sr)
                    else:
                        revb = cut[None, ...]
                        power = np.mean(cut**2)
                    scale = coeff_snr(power, ref_power, dir_cfg["snr"])
                    end = min(mix_beg[i] + seg_len[i], shape[-1])
                    out[:, mix_beg[i]:end] += \
                        scale * revb[:shape[0], :end - mix_beg[i]]
        return out

    def _prepare_egs(self, mix, ref: List[np.ndarray], dir_noise, iso_noise,
                     inf_norm: float = 0.8):
        mix = mix + dir_noise + iso_noise
        scale = 1 if inf_norm == 0 else inf_norm / (
            np.max(np.abs(mix[0])) + EPSILON)
        if self.noise_ref:
            ref.append(dir_noise[0] + iso_noise[0])
        if self.force_single:
            mix = mix[0]
        ref = [r * scale for r in ref]
        if len(ref) == 1:
            ref = ref[0]
        return {"mix": mix * scale, "ref": ref}

    def _simu(self, cfg: Dict) -> Dict:
        num_ch = cfg.get("rir_channels", cfg.get("num_channels", 1))
        shape = (1 if self.force_single else num_ch, cfg["length"])
        add_rir = bool(np.random.binomial(1, self.rir_prob))
        spk_stats = [
            self._conv_speaker_with_rir(c, add_rir=add_rir)
            for c in cfg["speakers"]
        ]
        for _ in range(self.max_spks - cfg["num_speakers"]):
            spk_stats.append(self._conv_zero_with_rir(shape, add_rir=add_rir))
        ref_power = spk_stats[0][-1]
        mix, ref = self._mix_speakers(spk_stats, cfg["speakers"], shape,
                                      ref_power)
        iso_noise = self._load_isotropic_noise(cfg, shape, ref_power)
        dir_noise = self._load_directional_noise(cfg, shape, ref_power,
                                                 add_rir=add_rir)
        egs = self._prepare_egs(mix, ref, dir_noise, iso_noise,
                                inf_norm=cfg.get("inf_norm", 0.8))
        egs["key"] = cfg["key"]
        return egs

    def __len__(self) -> int:
        return len(self.simu_cfg)

    def __getitem__(self, index):
        return self._simu(self.simu_cfg[index])
