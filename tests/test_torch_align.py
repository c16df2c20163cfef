#!/usr/bin/env python
"""PyTorch port, the last commands of cmd/: align (CTC forced alignment of
an asr@ctc checkpoint), compute_gmvn, archive_wav / extract_wav (shards
and segments) and check_audio, each run with --device cpu where it has a
device, against aps_tpu's command run on the same files (loaded with
importlib and handed the namespace the port's parser made); and
plot_feature against aps_tpu/plot.py."""

import importlib
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from aps_tpu_torch.cmd import (align, archive_wav, check_audio,  # noqa: E402
                               compute_gmvn, extract_wav)
from aps_tpu_torch.io import write_audio  # noqa: E402

from test_torch_ctc_decode import TRANSFORM, jax_command  # noqa: E402
from test_torch_ctc_decode import workspace  # noqa: E402,F401

REPO = Path(__file__).resolve().parents[1]
# Viterbi scores: sums of float32 log-probs of two packages' logits over
# the frames (printed with three decimals)
SCORE_ATOL = 2e-3
# global statistics of float32 features summed over every frame
GMVN_RTOL = 1e-4


def _run_both(name: str, port, argv, monkeypatch):
    """Run the port's command and aps_tpu's on the same arguments.
    archive_wav's workers take a function of the module by name, so that
    one is imported from cmd/ under its own name."""
    monkeypatch.syspath_prepend(str(REPO / "cmd"))
    args = port.make_parser().parse_args(argv("port"))
    out = port.run(args)
    jax_args = port.make_parser().parse_args(argv("jax"))
    module = importlib.import_module(name) if name == "archive_wav" else \
        jax_command(name)
    module.run(jax_args)
    return out


def _ali_lines(path: Path):
    rows = {}
    for line in path.read_text().splitlines():
        key, score, *ali = line.split()
        rows[key] = (float(score), ali)
    return rows


def test_align_matches_jax(workspace, tmp_path, monkeypatch):  # noqa: F811
    """align --device cpu: the same keys (one utterance without a
    transcript is skipped) and frame labels, scores within SCORE_ATOL,
    aps_tpu's line format; the labels collapse to the transcript."""
    text = tmp_path / "text"
    text.write_text("u0 w1 w2 w2\nu1 w3\nu3 w4 w5 w6\n")

    def argv(tag):
        return [workspace["scp"], str(text), str(tmp_path / f"ali.{tag}"),
                "--am", workspace["am"], "--dict", workspace["dict"],
                "--device", "cpu"]

    out = _run_both("align", align, argv, monkeypatch)
    got = _ali_lines(tmp_path / "ali.port")
    want = _ali_lines(tmp_path / "ali.jax")
    assert sorted(got) == sorted(want) == ["u0", "u1", "u3"]
    for key in got:
        assert got[key][1] == want[key][1], key
        assert abs(got[key][0] - want[key][0]) <= SCORE_ATOL, key
        assert f"{out[key]['score']:.3f}" == f"{got[key][0]:.3f}"
    blank = str(align.CtcApi(11).blank)
    seq = [a for i, a in enumerate(got["u0"][1])
           if a != blank and (i == 0 or a != got["u0"][1][i - 1])]
    assert seq == ["1", "2", "2"]


def test_align_refuses_a_model_without_ctc_logits(workspace,  # noqa: F811
                                                  tmp_path, monkeypatch):
    """A model without ctc_logits raises a ValueError naming the method
    before any utterance (and before the output is opened)."""

    class Evaluator(object):
        def __init__(self, *args, **kwargs):
            self.nnet = torch.nn.Linear(2, 2)
            self.device = torch.device("cpu")
            self.conf = {"nnet_conf": {"vocab_size": 12}}

    monkeypatch.setattr(align, "NnetEvaluator", Evaluator)
    out = tmp_path / "ali"
    with pytest.raises(ValueError, match="ctc_logits"):
        align.main([workspace["scp"], "text", str(out), "--am", "x",
                    "--device", "cpu"])
    assert not out.exists()


@pytest.fixture
def wavs(tmp_path):
    """A wav.scp of five utterances of 0.4 to 1.2 s, a segments file of
    two of them and a training config with an fbank-log-cmvn-aug
    transform."""
    rng = np.random.default_rng(21)
    scp = tmp_path / "wav.scp"
    with open(scp, "w") as fd:
        for i, n in enumerate((6400, 12000, 9000, 19200, 8000)):
            path = tmp_path / f"w{i}.wav"
            write_audio(str(path), 0.1 * rng.standard_normal(n))
            fd.write(f"w{i} {path}\n")
    seg = tmp_path / "segments"
    seg.write_text("w1-a w1 0.00 0.30\nw1-b w1 0.25 0.70\n"
                   "w3-a w3 0.10 1.05\n")
    conf = tmp_path / "train.yaml"
    conf.write_text(json.dumps({"asr_transform": dict(
        TRANSFORM, feats="perturb-fbank-log-cmvn-aug", aug_prob=0.5)}))
    return {"scp": scp, "segments": seg, "conf": conf}


@pytest.mark.parametrize("extra", [[], ["--segment", "SEG", "--num-utts",
                                        "1"]])
def test_compute_gmvn_matches_jax(wavs, tmp_path, monkeypatch, extra):
    """compute_gmvn --device cpu (perturb, cmvn and aug left out): the
    same (2, D) float32 statistics as aps_tpu's within GMVN_RTOL, on whole
    utterances and on segments with --num-utts; --num-jobs 2 spawns two
    CPU workers that give the same statistics."""
    extra = [str(wavs["segments"]) if a == "SEG" else a for a in extra]

    def argv(tag):
        return [str(wavs["scp"]), str(tmp_path / f"gmvn.{tag}.npy"),
                "--conf", str(wavs["conf"]), "--device", "cpu"] + extra

    got = _run_both("compute_gmvn", compute_gmvn, argv, monkeypatch)
    want = np.load(tmp_path / "gmvn.jax.npy")
    saved = np.load(tmp_path / "gmvn.port.npy")
    assert saved.dtype == want.dtype == np.float32
    assert saved.shape == want.shape == (2, 16)
    np.testing.assert_array_equal(saved, got)
    np.testing.assert_allclose(saved, want, rtol=GMVN_RTOL,
                               atol=GMVN_RTOL * np.abs(want).max())
    if extra:
        return
    # the workers' partial sums add in another order
    jobs = compute_gmvn.main(argv("two") + ["--num-jobs", "2"])
    np.testing.assert_allclose(jobs, saved, rtol=GMVN_RTOL,
                               atol=GMVN_RTOL * np.abs(want).max())


@pytest.mark.parametrize("extra", [[], ["--num-arks", "2", "--num-jobs",
                                        "2"],
                                   ["--segment", "SEG", "--num-arks", "2"]])
def test_archive_and_extract_match_jax(wavs, tmp_path, monkeypatch, extra):
    """archive_wav: the same archives byte for byte and the same scp lines
    (the paths aside), shards and segments included; extract_wav of the
    port's archive: the same wav files as aps_tpu's extract_wav of its
    own, whole and by segment."""
    extra = [str(wavs["segments"]) if a == "SEG" else a for a in extra]
    for tag in ("port", "jax"):
        (tmp_path / tag).mkdir()

    def argv(tag):
        return [str(wavs["scp"]), str(tmp_path / tag / "a.ark"),
                str(tmp_path / tag / "a.scp")] + extra

    _run_both("archive_wav", archive_wav, argv, monkeypatch)
    arks = sorted(p.name for p in (tmp_path / "port").glob("*.ark"))
    assert arks == sorted(p.name for p in (tmp_path / "jax").glob("*.ark"))
    for name in arks:
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes(), name
    scps = [(tmp_path / tag / "a.scp").read_text().replace(
        str(tmp_path / tag), "") for tag in ("port", "jax")]
    assert scps[0] == scps[1] and len(scps[0].splitlines()) in (3, 5)

    def ext_argv(tag):
        return [str(tmp_path / "port" / "a.scp"), str(tmp_path / f"x.{tag}")]

    _run_both("extract_wav", extract_wav, ext_argv, monkeypatch)
    files = sorted(p.name for p in (tmp_path / "x.port").iterdir())
    assert files == sorted(p.name for p in (tmp_path / "x.jax").iterdir())
    for name in files:
        assert (tmp_path / "x.port" / name).read_bytes() == \
            (tmp_path / "x.jax" / name).read_bytes(), name
    if "--segment" in extra:
        return

    def seg_argv(tag):
        return [str(wavs["scp"]), str(tmp_path / f"s.{tag}"), "--segment",
                str(wavs["segments"])]

    assert _run_both("extract_wav", extract_wav, seg_argv, monkeypatch) == 3
    for name in ("w1-a.wav", "w1-b.wav", "w3-a.wav"):
        assert (tmp_path / "s.port" / name).read_bytes() == \
            (tmp_path / "s.jax" / name).read_bytes(), name


def test_check_audio_matches_jax(wavs, tmp_path, monkeypatch):
    """check_audio: a file that is no wav is a bad utterance; utt2dur of
    the others is aps_tpu's, line for line."""
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"not a RIFF file at all")
    scp = tmp_path / "bad.scp"
    scp.write_text(wavs["scp"].read_text() + f"bad {bad}\n")

    def argv(tag):
        return [str(scp), "--utt2dur", str(tmp_path / f"utt2dur.{tag}")]

    assert _run_both("check_audio", check_audio, argv, monkeypatch) == 1
    got = (tmp_path / "utt2dur.port").read_text()
    assert got == (tmp_path / "utt2dur.jax").read_text()
    assert got.splitlines()[0] == "w0 0.4000"


def test_plot_feature_matches_jax(tmp_path):
    """plot_feature writes the same PNG as aps_tpu's, from numpy and from a
    tensor."""
    pytest.importorskip("matplotlib")
    from aps_tpu.plot import plot_feature as jax_plot
    from aps_tpu_torch.plot import plot_feature
    feats = np.random.default_rng(2).standard_normal((50, 16)).astype(
        np.float32)
    jax_plot(feats, str(tmp_path / "jax.png"), title="fbank")
    plot_feature(feats, str(tmp_path / "port.png"), title="fbank")
    plot_feature(torch.from_numpy(feats), str(tmp_path / "tensor.png"),
                 title="fbank")
    want = (tmp_path / "jax.png").read_bytes()
    assert want[:4] == b"\x89PNG"
    assert (tmp_path / "port.png").read_bytes() == want
    assert (tmp_path / "tensor.png").read_bytes() == want
