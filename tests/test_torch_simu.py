#!/usr/bin/env python
"""PyTorch port, on-the-fly simulation: io.audio.add_room_response,
loader/simu.py's run_simu, and the se@simu_cmd, am@simu_cmd and se@config
loaders, bit-equal to aps_tpu's under the same seeds (numpy's global
generator for se@config's draws, Python's `random` for the chunks); and
the doa_scp / emb_scp inputs of se@chunk."""

import json
import random
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from aps_tpu import libs as jax_libs  # noqa: E402
from aps_tpu.io import audio as jax_audio  # noqa: E402
from aps_tpu.loader import simu as jax_simu  # noqa: E402
from aps_tpu_torch.io import audio  # noqa: E402
from aps_tpu_torch.io import write_audio  # noqa: E402
from aps_tpu_torch.libs import aps_dataloader  # noqa: E402
from aps_tpu_torch.loader import simu  # noqa: E402

SR = 8000


def _rir(rng, channels: int, taps: int = 400) -> np.ndarray:
    """A decaying random room response with its peak a few taps in."""
    decay = np.exp(-np.arange(taps) / 60.0)
    rir = rng.standard_normal((channels, taps)) * decay * 0.3
    rir[:, 7] += 1.0
    return rir.astype(np.float32)


def _write_sources(root: Path, channels: int = 2):
    """Speakers, a point noise and an isotropic noise as wavs; a multi-
    channel RIR for each speaker and the noise."""
    rng = np.random.default_rng(11)
    paths = {}
    for name, S in (("spk0", 6000), ("spk1", 5200), ("noise", 3000)):
        wav = 0.3 * rng.standard_normal(S).astype(np.float32)
        paths[name] = root / f"{name}.wav"
        write_audio(str(paths[name]), wav, sr=SR)
    iso = 0.2 * rng.standard_normal((channels, 12000)).astype(np.float32)
    paths["iso"] = root / "iso.wav"
    write_audio(str(paths["iso"]), iso, sr=SR)
    for name in ("rir0", "rir1", "rirn"):
        paths[name] = root / f"{name}.wav"
        write_audio(str(paths[name]), _rir(rng, channels), sr=SR)
    return paths


def _commands(paths) -> list:
    """simu.py option lines: one speaker; two with SDR and RIRs; a point
    noise looped, offset and reverberated; an isotropic noise; channel 0
    dumped."""
    p = {k: str(v) for k, v in paths.items()}
    base = f"--sr {SR} --norm-factor 0.8"
    return [
        f"{base} --src-spk {p['spk0']}",
        f"{base} --src-spk {p['spk0']},{p['spk1']} --src-sdr 3 "
        f"--src-begin 0,700 --src-rir {p['rir0']},{p['rir1']}",
        f"{base} --src-spk {p['spk0']},{p['spk1']} --src-sdr -2 "
        f"--point-noise {p['noise']} --point-noise-snr 5 "
        f"--point-noise-begin 300 --point-noise-repeat true",
        f"{base} --src-spk {p['spk1']} --src-rir {p['rir1']} "
        f"--point-noise {p['noise']} --point-noise-rir {p['rirn']} "
        f"--point-noise-snr 0 --point-noise-offset 200 "
        f"--isotropic-noise {p['iso']} --isotropic-noise-snr 10 "
        f"--isotropic-noise-offset 100",
        f"{base} --src-spk {p['spk0']},{p['spk1']} --src-sdr 1 "
        f"--src-rir {p['rir0']},{p['rir1']} --dump-channel 0 "
        f"--isotropic-noise {p['iso']} --isotropic-noise-snr 4",
    ]


@pytest.mark.parametrize("early", [False, True])
def test_add_room_response_matches_jax(early):
    """The reverberant image (every channel), the early image (the direct
    path kept 50 ms) and the power, equal to aps_tpu's."""
    rng = np.random.default_rng(3)
    spk = rng.standard_normal(4000).astype(np.float32)
    rir = _rir(rng, 3)
    got = audio.add_room_response(spk, rir, early_energy=early, sr=SR)
    want = jax_audio.add_room_response(spk, rir, early_energy=early, sr=SR)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[0].shape == (3, 4000)
    if early:
        np.testing.assert_array_equal(got[1], want[1])
    else:
        assert got[1] is None and want[1] is None
    assert got[2] == want[2]
    with pytest.raises(RuntimeError, match="convolve"):
        audio.add_room_response(rir, rir)


def test_run_simu_matches_jax(tmp_path):
    """run_simu on each option line: the mixture, every speaker's reference
    and the noise, bit-equal to aps_tpu's; the gains solve the asked SNR."""
    paths = _write_sources(tmp_path)
    for line in _commands(paths):
        got = simu.run_simu(simu.make_argparse().parse_args(line.split()))
        want = jax_simu.run_simu(
            jax_simu.make_argparse().parse_args(line.split()))
        np.testing.assert_array_equal(got[0], want[0], err_msg=line)
        assert len(got[1]) == len(want[1])
        for g, w in zip(got[1], want[1]):
            np.testing.assert_array_equal(g, w, err_msg=line)
        if want[2] is None:
            assert got[2] is None
        else:
            np.testing.assert_array_equal(got[2], want[2], err_msg=line)
    gain = simu.snr_gain(2.0, 8.0, 3.0)
    assert gain == jax_simu.snr_gain(2.0, 8.0, 3.0)
    assert 10 * np.log10(8.0 / (2.0 * gain**2)) == pytest.approx(3.0, 1e-5)
    assert simu.coeff_snr is simu.snr_gain


def _simu_cfg(root: Path, paths) -> Path:
    """Six mixtures of two speakers and noise (the option lines with both,
    so that every batch stacks alike)."""
    lines = _commands(paths)
    cfg = root / "simu.cfg"
    cfg.write_text("".join(f"m{i} {lines[(2, 4)[i % 2]]}\n"
                           for i in range(6)))
    return cfg


@pytest.mark.parametrize("noise_label", [False, True])
def test_se_simu_cmd_loader_matches_jax(tmp_path, noise_label):
    """se@simu_cmd's batches (mixtures simulated from the option lines,
    cut into chunks with Python's generator seeded alike) equal aps_tpu's,
    in validation order and two shuffled training epochs."""
    paths = _write_sources(tmp_path, channels=1)
    cfg = _simu_cfg(tmp_path, paths)
    kwargs = dict(fmt="se@simu_cmd", simu_cfg=str(cfg), sr=SR,
                  noise_label=noise_label, chunk_size=4000, max_batch_size=2,
                  num_workers=0)
    num_batches = 0
    for train, epoch in ((False, 0), (True, 0), (True, 1)):
        sides = []
        for package in (aps_dataloader, jax_libs.aps_dataloader):
            loader = package(train=train, **kwargs)
            loader.set_epoch(epoch)
            random.seed(50 + epoch)
            sides.append(list(loader))
        ours, theirs = sides
        assert len(ours) == len(theirs) >= 2
        for got, want in zip(ours, theirs):
            assert sorted(got) == sorted(want)
            np.testing.assert_array_equal(got["mix"], want["mix"])
            refs = want["ref"] if isinstance(want["ref"], list) else \
                [want["ref"]]
            got_refs = got["ref"] if isinstance(got["ref"], list) else \
                [got["ref"]]
            assert len(got_refs) == len(refs)
            for g, w in zip(got_refs, refs):
                np.testing.assert_array_equal(g, w)
        num_batches += len(ours)
    assert num_batches >= 6


def test_am_simu_cmd_loader_matches_jax(tmp_path):
    """am@simu_cmd's batches (the simulated mixtures keyed by utterance,
    padded as am@raw's) equal aps_tpu's; SimuCmdReader reads by key and by
    index alike."""
    from aps_tpu_torch.loader.am.simu_cmd import SimuCmdReader
    paths = _write_sources(tmp_path, channels=1)
    lines = _commands(paths)
    cfg = tmp_path / "simu.cfg"
    with open(cfg, "w") as fd, open(tmp_path / "text", "w") as text, \
            open(tmp_path / "utt2dur", "w") as dur:
        for i in range(12):
            fd.write(f"u{i} {lines[i % 4]}\n")
            text.write(f"u{i} w{i % 5} w{(i + 2) % 5}\n")
            dur.write(f"u{i} {0.75 + 0.01 * i}\n")
    vocab = {f"w{i}": i + 1 for i in range(5)}
    vocab.update({"<unk>": 0, "<sos>": 6, "<eos>": 7})
    kwargs = dict(fmt="am@simu_cmd", simu_cfg=str(cfg), vocab_dict=vocab,
                  text=str(tmp_path / "text"),
                  utt2dur=str(tmp_path / "utt2dur"), tokenizer="word",
                  max_batch_size=4, min_batch_size=2, adapt_dur=0.5,
                  min_dur=0.1)
    for train, epoch in ((False, 0), (True, 1)):
        ours = aps_dataloader(train=train, **kwargs)
        theirs = jax_libs.aps_dataloader(train=train, **kwargs)
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        ours, theirs = list(ours), list(theirs)
        assert len(ours) == len(theirs) > 1
        for got, want in zip(ours, theirs):
            assert sorted(got) == sorted(want)
            for key, val in want.items():
                np.testing.assert_array_equal(np.asarray(got[key]),
                                              np.asarray(val), err_msg=key)
    reader = SimuCmdReader(str(cfg))
    np.testing.assert_array_equal(reader["u5"], reader[5])


def _hdf5_sources(root: Path, channels: int = 2):
    """Speakers, noises and RIRs in three hdf5 files (dataset "wav", int16
    scale) and the per-mixture json specs that slice them."""
    import h5py
    rng = np.random.default_rng(17)
    spk = (3000 * rng.standard_normal(30000)).astype(np.float32)
    noise = (2000 * rng.standard_normal((channels, 40000))).astype(
        np.float32)
    rirs = np.concatenate([_rir(rng, channels) * 32767 for _ in range(4)],
                          -1)
    for name, data in (("spk", spk), ("noise", noise), ("rir", rirs)):
        with h5py.File(root / f"{name}.h5", "w") as fd:
            fd.create_dataset("wav", data=data)
    h5 = {name: str(root / f"{name}.h5") for name in ("spk", "noise", "rir")}

    def sl(name, beg, end):
        return f"{h5[name]}:wav:{beg}:{end}"

    specs = []
    for i in range(5):
        beg = 2000 * i
        cfg = {
            "key": f"c{i}", "length": 7000, "num_speakers": 2 - i % 2,
            "rir_channels": channels, "inf_norm": 0.8,
            "speakers": [{"utt": sl("spk", beg, beg + 6000),
                          "rir": sl("rir", 0, 400)}],
            "isotropic_noise": {"utt": sl("noise", 0, 40000),
                                "truncated": 500 * i, "snr": 8},
            "directional_noise": [{"utt": sl("noise", 0, 40000),
                                   "truncated": "100:2100,3000:4000",
                                   "offset": "200,4000", "snr": 5,
                                   "rir": sl("rir", 800, 1200)}],
        }
        if i % 2 == 0:
            cfg["speakers"].append({"utt": sl("spk", beg + 9000,
                                               beg + 14000),
                                    "rir": sl("rir", 400, 800), "sdr": 2,
                                    "offset": 900})
        specs.append(cfg)
    cfg_path = root / "simu.json"
    cfg_path.write_text(json.dumps(specs))
    return cfg_path


@pytest.mark.parametrize("single_channel", [False, True])
def test_se_config_loader_matches_jax(tmp_path, single_channel):
    """se@config's mixtures (RIR and noise draws from numpy's global
    generator, probabilities below 1 in training) and its batches equal
    aps_tpu's with numpy and Python seeded alike."""
    cfg = _hdf5_sources(tmp_path)
    kwargs = dict(fmt="se@config", simu_cfg=str(cfg), sr=SR,
                  single_channel=single_channel, rir_prob=0.7,
                  isotropic_noise_prob=0.6, directional_noise_prob=0.5,
                  early_reverb=True, chunk_size=3000, max_batch_size=2,
                  num_workers=0)
    for train, epoch in ((False, 0), (True, 0), (True, 1)):
        sides = []
        for package in (aps_dataloader, jax_libs.aps_dataloader):
            loader = package(train=train, **kwargs)
            loader.set_epoch(epoch)
            np.random.seed(70 + epoch)
            random.seed(80 + epoch)
            sides.append(list(loader))
        ours, theirs = sides
        assert len(ours) == len(theirs) >= 2
        for got, want in zip(ours, theirs):
            assert sorted(got) == sorted(want)
            np.testing.assert_array_equal(got["mix"], want["mix"])
            assert got["mix"].ndim == (2 if single_channel else 3)
            for g, w in zip(got["ref"], want["ref"]):
                np.testing.assert_array_equal(g, w)
    from aps_tpu.loader.se.config import ConfigSimulationDataset as Jax
    from aps_tpu_torch.loader.se.config import ConfigSimulationDataset
    for i in range(2):
        np.random.seed(90 + i)
        got = ConfigSimulationDataset(str(cfg), sr=SR)[i]
        np.random.seed(90 + i)
        want = Jax(str(cfg), sr=SR)[i]
        assert got["key"] == want["key"] == f"c{i}"
        np.testing.assert_array_equal(got["mix"], want["mix"])
        for g, w in zip(got["ref"], want["ref"]):
            np.testing.assert_array_equal(g, w)


def test_se_chunk_doa_and_emb_match_jax(tmp_path):
    """se@chunk with doa_scp (two speakers' angles) and emb_scp (an
    embedding .npy an utterance): each chunk carries its utterance's values,
    the batches equal aps_tpu's."""
    rng = np.random.default_rng(23)
    scps = {name: open(tmp_path / f"{name}.scp", "w")
            for name in ("mix", "ref", "doa1", "doa2", "emb")}
    for n in range(5):
        S = 6000 + 1500 * n
        for name in ("mix", "ref"):
            path = tmp_path / f"{name}{n}.wav"
            write_audio(str(path),
                        0.2 * rng.standard_normal(S).astype(np.float32),
                        sr=SR)
            scps[name].write(f"u{n} {path}\n")
        scps["doa1"].write(f"u{n} {10.5 * n}\n")
        scps["doa2"].write(f"u{n} {-20.0 + n}\n")
        emb = tmp_path / f"emb{n}.npy"
        np.save(emb, rng.standard_normal(8).astype(np.float32))
        scps["emb"].write(f"u{n} {emb}\n")
    for fd in scps.values():
        fd.close()
    kwargs = dict(fmt="se@chunk", mix_scp=str(tmp_path / "mix.scp"),
                  ref_scp=str(tmp_path / "ref.scp"),
                  doa_scp=f"{tmp_path / 'doa1.scp'},{tmp_path / 'doa2.scp'}",
                  emb_scp=str(tmp_path / "emb.scp"), sr=SR, chunk_size=4000,
                  max_batch_size=3, num_workers=0)
    for train in (False, True):
        sides = []
        for package in (aps_dataloader, jax_libs.aps_dataloader):
            loader = package(train=train, **kwargs)
            random.seed(5)
            sides.append(list(loader))
        ours, theirs = sides
        assert len(ours) == len(theirs) >= 2
        for got, want in zip(ours, theirs):
            assert sorted(got) == sorted(want) == ["#utt", "doa", "emb",
                                                   "mix", "ref"]
            for key in ("mix", "ref", "emb"):
                np.testing.assert_array_equal(got[key], want[key])
            assert got["emb"].shape == (3, 8)
            assert len(got["doa"]) == 2
            for g, w in zip(got["doa"], want["doa"]):
                np.testing.assert_array_equal(g, w)
                assert g.shape == (3,)
