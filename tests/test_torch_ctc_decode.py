#!/usr/bin/env python
"""PyTorch port, decoding asr@ctc against aps_tpu on JAX's CPU: CtcApi's
prefix beam search and Viterbi alignment on the same numpy logits, and the
decode and decode_batch commands with --device cpu on an asr@ctc checkpoint
(the wave padded onto aps_tpu's length grid, the logits read at their
valid frames) against aps_tpu's cmd/decode.py and cmd/decode_batch.py."""

import importlib.util
import json
import pickle
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from aps_tpu.asr.beam_search.ctc import CtcApi as JaxCtcApi  # noqa: E402
from aps_tpu_torch.asr.beam_search.ctc import CtcApi  # noqa: E402
from aps_tpu_torch.cmd import decode, decode_batch  # noqa: E402
from aps_tpu_torch.io import write_audio  # noqa: E402
from aps_tpu_torch.libs import aps_asr_nnet, aps_transform  # noqa: E402

from test_torch_transducer import _scale, _seeded, _wavs  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
VOCAB = 12
BLANK = VOCAB - 1
# CTC prefix scores: float64 sums of float32 log-probs over the frames
SCORE_ATOL = 1e-4
TRANSFORM = dict(feats="fbank-log-cmvn", frame_len=400, frame_hop=160,
                 window="hamm", num_mels=16)
NNET = dict(input_size=16, vocab_size=VOCAB, enc_type="xfmr",
            enc_kwargs=dict(num_layers=1, proj="conv2d",
                            proj_kwargs=dict(conv_channels=4, num_layers=2),
                            pose="rel",
                            pose_kwargs=dict(dropout=0.0, lradius=8,
                                             rradius=8),
                            arch_kwargs=dict(att_dim=16, nhead=2,
                                             feedforward_dim=32,
                                             att_dropout=0.0,
                                             ffn_dropout=0.0)))


def _logits(seed, T, V=VOCAB, peaky=3.0):
    rng = np.random.default_rng(seed)
    return (peaky * rng.standard_normal((T, V))).astype(np.float32)


def _same(got, want):
    assert [h["trans"] for h in got] == [h["trans"] for h in want]
    for a, b in zip(got, want):
        assert abs(a["score"] - b["score"]) <= SCORE_ATOL, (a, b)


@pytest.mark.parametrize("kw", [
    dict(beam_size=4, nbest=3),
    dict(beam_size=8, nbest=8, len_norm=False),
    dict(beam_size=1, nbest=1, sos=9, eos=10),
    dict(beam_size=16, nbest=4),
])
def test_ctc_beam_search_matches_jax(kw):
    """The prefix beam search over T x V logits (numpy in, a tensor in):
    the same n-best token lists, scores within SCORE_ATOL."""
    logits = _logits(len(kw) + kw["beam_size"], 30)
    want = JaxCtcApi(BLANK).beam_search(jnp.asarray(logits), **kw)
    for x in (logits, torch.from_numpy(logits)):
        _same(CtcApi(BLANK).beam_search(x, **kw), want)
    assert len(want) == kw["nbest"]


@pytest.mark.parametrize("seq", [[3, 3, 5], [1, 2, 3, 4, 5, 6], [7], []])
def test_ctc_viterbi_align_matches_jax(seq):
    """The forced alignment of a label sequence (a repeated label, one
    that fills half the frames, a single one, none): the same frame labels
    and score."""
    logits = _logits(len(seq), 13)
    want = JaxCtcApi(BLANK).viterbi_align(jnp.asarray(logits),
                                          np.array(seq, dtype=np.int64))
    got = CtcApi(BLANK).viterbi_align(torch.from_numpy(logits), seq)
    assert got["align"] == want["align"] and len(got["align"]) == 13
    assert abs(got["score"] - want["score"]) <= 1e-5
    collapsed = [a for i, a in enumerate(got["align"])
                 if a != BLANK and (i == 0 or a != got["align"][i - 1])]
    assert collapsed == seq


def test_ctc_viterbi_align_refuses_a_long_target():
    logits = _logits(0, 5)
    for api in (CtcApi(BLANK), JaxCtcApi(BLANK)):
        with pytest.raises(ValueError, match="Invalid target length"):
            api.viterbi_align(logits, [1, 2, 3])


def jax_command(name: str):
    spec = importlib.util.spec_from_file_location(f"jax_cmd_{name}",
                                                  REPO / "cmd" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """An asr@ctc checkpoint (the encoder's output layer gives the V
    logits, scaled up), its dict and a wav.scp of utterances of 0.7 to 1.3
    s (three lengths of aps_tpu's grid)."""
    root = tmp_path_factory.mktemp("ctc_cmds")
    port = aps_asr_nnet("asr@ctc")(
        asr_transform=aps_transform("asr")(**TRANSFORM), **NNET).eval()
    variables = _scale(port, _seeded(port, 3),
                       "encoder/outp/kernel", 4.0)
    cpt = root / "am"
    cpt.mkdir()
    conf = {"nnet": "asr@ctc", "nnet_conf": NNET,
            "asr_transform": TRANSFORM, "task": "asr@ctc",
            "task_conf": {"blank": BLANK}, "data_conf": {},
            "trainer_conf": {}}
    (cpt / "train.yaml").write_text(json.dumps(conf))
    with open(cpt / "best.ckpt", "wb") as fd:
        pickle.dump({"params": {"nnet": variables["params"]},
                     "mstate": {"batch_stats": variables.get(
                         "batch_stats", {})}, "epoch": 1}, fd)
    with open(root / "dict", "w") as fd:
        fd.write("<unk> 0\n")
        for i in range(1, BLANK):
            fd.write(f"w{i} {i}\n")
    with open(root / "wav.scp", "w") as scp:
        for i, wav in enumerate(_wavs(16, (11200, 16000, 20800, 12000))):
            write_audio(str(root / f"u{i}.wav"), wav)
            scp.write(f"u{i} {root / f'u{i}.wav'}\n")
    return {"am": str(cpt), "dict": str(root / "dict"),
            "scp": str(root / "wav.scp"), "port": port}


def test_ctc_model_is_the_encoder_output_layer(workspace):
    port = workspace["port"]
    assert port.ctc_head is None
    assert port.encoder.outp.out_features == VOCAB


@pytest.mark.parametrize("command,extra", [
    ("decode", ["--beam-size", "4"]),
    ("decode", ["--beam-size", "2", "--nbest", "2", "--dump-nbest", "-"]),
    ("decode_batch", ["--batch-size", "2", "--beam-size", "4"]),
])
def test_ctc_commands_match_jax(workspace, tmp_path, monkeypatch, command,
                                extra):
    """decode and decode_batch --device cpu on the asr@ctc checkpoint
    against aps_tpu's commands with the same arguments: the same
    transcripts (decode_batch decodes its batches one utterance after
    another, as aps_tpu's does)."""
    argv = ["--am", workspace["am"], "--dict", workspace["dict"],
            "--device", "cpu"] + extra
    port = decode if command == "decode" else decode_batch
    monkeypatch.syspath_prepend(str(REPO / "cmd"))
    outs = []
    for name, run in (("port", port.run),
                      ("jax", jax_command(command).run)):
        best = tmp_path / f"best.{name}"
        args = port.make_parser().parse_args([workspace["scp"], str(best)] +
                                             argv)
        args.data_parallel = False
        run(args)
        outs.append(sorted(best.read_text().splitlines()))
    assert outs[0] == outs[1] and len(outs[0]) == 4
    assert any(len(line.split("\t")[1]) for line in outs[0])
