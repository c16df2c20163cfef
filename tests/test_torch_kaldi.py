#!/usr/bin/env python
"""PyTorch port, kaldi feature archives: loader/kaldi_io.py (archives,
compressed matrices, scripts) byte for byte and array for array against
aps_tpu's module, both ways; the am@kaldi loader's batches against
aps_tpu's; train_am from am@kaldi; and cmd.decode from a feats.scp against
aps_tpu's cmd/decode.py on the same converted weights."""

import importlib.util
import io
import json
import pickle
import re
import struct
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from __graft_entry__ import _build_flagship  # noqa: E402
from aps_tpu import libs as jax_libs  # noqa: E402
from aps_tpu.loader import kaldi_io as jax_kaldi_io  # noqa: E402
from aps_tpu_torch.cmd import decode  # noqa: E402
from aps_tpu_torch.convert import to_state_dict, to_variables  # noqa: E402
from aps_tpu_torch.flagship import build_flagship, flagship_conf  # noqa
from aps_tpu_torch.libs import aps_dataloader  # noqa: E402
from aps_tpu_torch.loader import kaldi_io  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
VOCAB = 24
SOS, EOS = VOCAB - 3, VOCAB - 2
FEAT_DIM = 80
# output layers scaled so candidates are well apart (random weights)
PEAKY = 4.0
METHODS = ["", "CM", "CM2", "CM3"]


def _feats(seed: int, T: int) -> np.ndarray:
    """A T x 80 log-mel-like matrix: a slope over the bands plus noise."""
    rng = np.random.default_rng(seed)
    base = np.linspace(-6.0, 2.0, FEAT_DIM, dtype=np.float32)
    return (base + rng.standard_normal((T, FEAT_DIM))).astype(np.float32)


def _write_ark(package, ark: Path, scp: Path, mats, compress: str):
    with package.ArchiveWriter(str(ark), str(scp), compress=compress) as w:
        for key, mat in mats.items():
            w.write(key, mat)


@pytest.mark.parametrize("compress", METHODS)
def test_archives_match_jax_both_ways(tmp_path, compress):
    """ArchiveWriter (plain float32 and the three compressed formats) writes
    aps_tpu's bytes and scp lines; each package reads what either wrote to
    the same arrays (ScriptReader, ArchiveReader, read_kaldi_mat at an
    offset), and a vector rides along uncompressed."""
    mats = {f"u{i}": _feats(i, 37 + 11 * i) for i in range(3)}
    mats["v0"] = np.arange(5, dtype=np.float32) / 3
    files = {}
    for name, package in (("port", kaldi_io), ("jax", jax_kaldi_io)):
        ark, scp = tmp_path / f"{name}.ark", tmp_path / f"{name}.scp"
        _write_ark(package, ark, scp, mats, compress)
        files[name] = (ark, scp)
    port_ark, port_scp = files["port"]
    jax_ark, jax_scp = files["jax"]
    assert port_ark.read_bytes() == jax_ark.read_bytes()
    assert port_scp.read_text().replace("port.ark", "jax.ark") == \
        jax_scp.read_text()
    for reader in (kaldi_io, jax_kaldi_io):
        for ark, scp in files.values():
            by_key = reader.ScriptReader(str(scp))
            in_order = list(reader.ArchiveReader(str(ark)))
            assert [k for k, _ in in_order] == list(mats)
            for key, mat in in_order:
                want = jax_kaldi_io.ScriptReader(str(jax_scp))[key]
                np.testing.assert_array_equal(mat, want)
                np.testing.assert_array_equal(by_key[key], want)
                assert mat.dtype == np.float32 and mat.shape == \
                    mats[key].shape
            location = scp.read_text().split()[1]
            np.testing.assert_array_equal(
                reader.read_kaldi_mat(location),
                jax_kaldi_io.read_kaldi_mat(location))
    if not compress:
        got = kaldi_io.ScriptReader(str(port_scp))
        for key, mat in mats.items():
            np.testing.assert_array_equal(got[key], mat)
    else:
        # the codec's step: range / 65535 (CM2), range / 255 (CM3) and a
        # percentile segment / 63 (CM)
        got = kaldi_io.ScriptReader(str(port_scp))["u1"]
        want = mats["u1"]
        step = {"CM": 0.5, "CM2": 1e-3, "CM3": 0.05}[compress]
        assert np.abs(got - want).max() <= step


def test_double_matrices_and_single_object_files(tmp_path):
    """DM and DV objects read as float32 in both packages; a file holding
    one object (no key) reads through read_kaldi_mat."""
    rng = np.random.default_rng(5)
    mat = rng.standard_normal((4, 3))
    vec = rng.standard_normal(6)
    buf = io.BytesIO()
    buf.write(b"\0BDM \4" + struct.pack("<i", 4) + b"\4" +
              struct.pack("<i", 3) + mat.astype("<f8").tobytes())
    buf.write(b"\0BDV \4" + struct.pack("<i", 6) +
              vec.astype("<f8").tobytes())
    for package in (kaldi_io, jax_kaldi_io):
        buf.seek(0)
        got_mat = package.read_binary_mat(buf)
        got_vec = package.read_binary_mat(buf)
        np.testing.assert_array_equal(got_mat, mat.astype(np.float32))
        np.testing.assert_array_equal(got_vec, vec.astype(np.float32))
        assert got_mat.dtype == got_vec.dtype == np.float32
    single = tmp_path / "one.mat"
    with open(single, "wb") as fd:
        kaldi_io.write_binary_mat(fd, mat)
    np.testing.assert_array_equal(kaldi_io.read_kaldi_mat(str(single)),
                                  jax_kaldi_io.read_kaldi_mat(str(single)))
    with pytest.raises(RuntimeError, match="Unsupported"):
        kaldi_io.read_binary_mat(io.BytesIO(b"\0BXX "))


def _write_corpus(root: Path, num_utts: int = 12, compress: str = "CM"):
    """feats.scp (compressed), text, utt2num_frames and a dict."""
    rng = np.random.default_rng(7)
    mats = {f"u{n}": _feats(100 + n, 60 + 9 * n) for n in range(num_utts)}
    _write_ark(kaldi_io, root / "feats.ark", root / "feats.scp", mats,
               compress)
    words = [f"w{i}" for i in range(VOCAB - 4)]
    vocab = ["<unk>"] + words + ["<sos>", "<eos>"]
    (root / "dict").write_text("".join(f"{w} {i}\n"
                                       for i, w in enumerate(vocab)))
    with open(root / "text", "w") as text, \
            open(root / "utt2num_frames", "w") as dur:
        for key, mat in mats.items():
            text.write(f"{key} {' '.join(rng.choice(words, 3))}\n")
            dur.write(f"{key} {mat.shape[0]}\n")
    return mats


def test_am_kaldi_loader_matches_jax_package(tmp_path):
    """am@kaldi gives aps_tpu's batches on the same archive: validation
    order and two shuffled training epochs, the frames padded on the time
    axis to aps_tpu's grid (quantize_len(n, floor=50, multiple=8,
    factor=1.2)), bit-equal arrays of the same dtypes."""
    mats = _write_corpus(tmp_path)
    vocab = dict(line.split() for line in
                 (tmp_path / "dict").read_text().splitlines())
    vocab = {k: int(v) for k, v in vocab.items()}
    kwargs = dict(fmt="am@kaldi", vocab_dict=vocab, max_batch_size=4,
                  min_batch_size=2, adapt_dur=80, tokenizer="word",
                  feats_scp=str(tmp_path / "feats.scp"),
                  text=str(tmp_path / "text"),
                  utt2num_frames=str(tmp_path / "utt2num_frames"))
    num_batches = 0
    for train, epoch in ((False, 0), (True, 0), (True, 1)):
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
                assert np.asarray(got[key]).dtype == np.asarray(val).dtype
            src = got["src_pad"]
            assert src.ndim == 3 and src.shape[-1] == FEAT_DIM
            assert src.shape[1] % 8 == 0 and src.shape[1] >= 50
        num_batches += len(ours)
    assert num_batches >= 6
    assert len(mats) == 12


def _feature_conf():
    """The toy flagship fed with features: no asr_transform, the conv2d
    projection takes the 80 bands."""
    conf = flagship_conf(VOCAB, small=True)
    del conf["asr_transform"]
    return conf


def _write_am(root: Path) -> Path:
    """A features AM checkpoint: flax-initialised weights (output layers
    scaled), written as aps_tpu's trainer writes them."""
    nnet = _build_flagship(vocab_size=VOCAB, small=True)
    object.__setattr__(nnet, "asr_transform", None)
    x = jnp.zeros((2, 120, FEAT_DIM))
    variables = nnet.init({"params": jax.random.PRNGKey(3)}, x,
                          jnp.asarray([120, 100]),
                          jnp.zeros((2, 4), jnp.int32), jnp.asarray([4, 4]),
                          training=False)
    variables = jax.tree_util.tree_map(np.array, dict(variables))
    variables["params"]["decoder"]["output"]["kernel"] *= PEAKY
    variables["params"]["ctc_head"]["kernel"] *= PEAKY
    model = build_flagship(flagship_conf(VOCAB, small=True))
    model.asr_transform = None
    model.load_state_dict(to_state_dict(variables, model))
    cpt = root / "am"
    cpt.mkdir()
    conf = dict(_feature_conf(), task="asr@ctc_xent", task_conf={},
                data_conf={}, trainer_conf={})
    (cpt / "train.yaml").write_text(json.dumps(conf))
    params = to_variables(model)
    with open(cpt / "best.ckpt", "wb") as fd:
        pickle.dump({"params": {"nnet": params["params"]},
                     "mstate": {"batch_stats": params["batch_stats"]},
                     "epoch": 1}, fd)
    return cpt


def _jax_decode():
    spec = importlib.util.spec_from_file_location(
        "jax_cmd_decode_kaldi", REPO / "cmd" / "decode.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("compress", ["", "CM"])
def test_decode_from_feats_scp_matches_jax(tmp_path, compress):
    """cmd.decode reads a feats.scp for a model that takes features (the
    transform runs no K1) and writes aps_tpu's cmd/decode.py's best lines
    and nbest (scores within the file's rounding), on the same converted
    weights."""
    mats = {f"u{i}": _feats(200 + i, 90 + 23 * i) for i in range(3)}
    _write_ark(kaldi_io, tmp_path / "feats.ark", tmp_path / "feats.scp",
               mats, compress)
    cpt = _write_am(tmp_path)
    argv = ["--am", str(cpt), "--beam-size", "4", "--nbest", "3",
            "--ctc-weight", "0.4", "--max-len", "10", "--device", "cpu"]
    outs = []
    for name, run in (("port", decode.run), ("jax", _jax_decode().run)):
        best, nbest = tmp_path / f"best.{name}", tmp_path / f"nbest.{name}"
        args = decode.make_parser().parse_args(
            [str(tmp_path / "feats.scp"), str(best), "--dump-nbest",
             str(nbest)] + argv)
        stats = run(args)
        outs.append((best.read_text(), nbest.read_text()))
        if name == "port":
            assert stats["utts"] == 3 and stats["audio_secs"] == 0
    assert outs[0][0] == outs[1][0]
    assert len(outs[0][0].splitlines()) == 3
    got, want = (text.splitlines() for text in (outs[0][1], outs[1][1]))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if "\t" not in w:
            assert g == w
            continue
        (sg, ng, tg), (sw, nw, tw) = g.split("\t"), w.split("\t")
        assert (ng, tg) == (nw, tw)
        assert abs(float(sg) - float(sw)) <= 2e-3


def test_train_am_from_kaldi_features(tmp_path):
    """train_am on am@kaldi (the toy feature flagship, two epochs on the
    compressed archive): the loss falls and the checkpoint decodes from the
    feats.scp."""
    from aps_tpu_torch.cmd import train_am
    _write_corpus(tmp_path)
    data = dict(feats_scp=str(tmp_path / "feats.scp"),
                text=str(tmp_path / "text"),
                utt2num_frames=str(tmp_path / "utt2num_frames"))
    conf = dict(_feature_conf(), task="asr@ctc_xent",
                task_conf={"ctc_weight": 0.2, "lsm_factor": 0.1},
                data_conf=dict(fmt="am@kaldi",
                               loader=dict(min_batch_size=2, adapt_dur=80,
                                           tokenizer="word"),
                               train=data, valid=data),
                trainer_conf=dict(optimizer="adam",
                                  optimizer_kwargs={"lr": 1e-3},
                                  lr_scheduler="reduce_lr",
                                  lr_scheduler_kwargs={}, clip_gradient=5))
    (tmp_path / "train.yaml").write_text(json.dumps(conf))
    cpt = tmp_path / "exp"
    train_am.main(["--conf", str(tmp_path / "train.yaml"), "--dict",
                   str(tmp_path / "dict"), "--checkpoint", str(cpt),
                   "--batch-size", "4", "--epochs", "2", "--seed", "7",
                   "--device", "cpu", "--prog-interval", "2"])
    log = (cpt / "trainer.log").read_text()
    losses = [float(re.search(r"\) = ([0-9.]+)", line).group(1))
              for line in log.splitlines() if "/valid:" in line]
    assert len(losses) == 3 and losses[-1] < losses[0], losses
    tag = "best" if (cpt / "best.ckpt").is_file() else "last"
    stats = decode.main([str(tmp_path / "feats.scp"),
                         str(tmp_path / "best.txt"), "--am", str(cpt),
                         "--am-tag", tag, "--dict", str(tmp_path / "dict"),
                         "--beam-size", "2", "--max-len", "5", "--device",
                         "cpu"])
    assert stats["utts"] == 12
