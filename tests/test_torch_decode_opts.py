#!/usr/bin/env python
"""PyTorch port, the decoding and separation options: bfloat16 decoding
(the batched search and decode_batch --dtype bfloat16; the single search,
which drops the key as aps_tpu's does), cov_penalty in the transformer
search under both methods, separate --dtype bfloat16 of a
frequency-domain model, and chunked separation of multi-channel input;
each against aps_tpu on the same inputs and converted weights."""

import importlib.util
import json
import pickle
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from aps_tpu import libs as jax_libs  # noqa: E402
from aps_tpu.asr.beam_search import transformer as jax_search  # noqa
from aps_tpu_torch.asr.beam_search import transformer as search  # noqa
from aps_tpu_torch.cmd import decode, decode_batch, separate  # noqa: E402
from aps_tpu_torch.convert import to_state_dict  # noqa: E402
from aps_tpu_torch.libs import aps_sse_nnet, aps_transform  # noqa: E402
from test_torch_lm import EOS, SOS, am, workspace  # noqa: E402,F401
from test_torch_lm import lm_files, lms  # noqa: E402,F401
from test_torch_sse_time import one_thread, zoo_pair  # noqa: E402,F401
from test_torch_sse_zoo import ENH, MODELS  # noqa: E402
from test_torch_ts import write_checkpoint  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
# beam scores: length-normalised sums of log-probs in float32
SCORE_ATOL = 1e-3
SEARCH = dict(sos=SOS, eos=EOS, beam_size=4, nbest=3, ctc_weight=0.4,
              max_len=12, allow_partial=True)


# bfloat16 decodes of the two packages: both round the same weights and
# the same encoder output to bfloat16 and compute in float32 from there
# (JAX promotes the products with the float32 activations), so they part
# only as float32 sums in another order do, and where an entry they round
# lies within that of a bfloat16 rounding boundary and goes to the next
# value on one side (some 1e-5 of a score at these sizes). A float32-sized
# gate, a fifth of SCORE_ATOL; the float32 search lies 1e-3 to 1e-2 from the
# bfloat16 one and must fail it
BF16_SCORE_ATOL = 2e-4


def _batch(am):
    _, _, _, wav, lens = am
    return [wav[i, :n] for i, n in enumerate(lens)]


def test_bf16_batched_search_matches_jax(am):
    """beam_search_batch with dtype bfloat16: aps_tpu's best hypotheses,
    every rank's score within BF16_SCORE_ATOL of aps_tpu's bfloat16 one;
    the float32 search's best scores lie outside that gate (the cast took
    place) and the CTC table stays float32 (the float32 search is
    unchanged)."""
    nnet, variables, model, _, _ = am
    batch = _batch(am)
    want16 = jax_search.beam_search_batch(nnet, variables, batch,
                                          dtype="bfloat16", **SEARCH)
    want32 = jax_search.beam_search_batch(nnet, variables, batch, **SEARCH)
    got16 = search.beam_search_batch(model, batch, dtype="bfloat16",
                                     device="cpu", **SEARCH)
    got32 = search.beam_search_batch(model, batch, device="cpu", **SEARCH)
    for g16, g32, w16, w32 in zip(got16, got32, want16, want32):
        assert g16[0]["trans"] == w16[0]["trans"]
        assert len(g16) == len(w16)
        for g, w in zip(g16, w16):
            assert abs(g["score"] - w["score"]) <= BF16_SCORE_ATOL
        for g, w in zip(g32, w32):
            assert g["trans"] == w["trans"]
            assert abs(g["score"] - w["score"]) <= SCORE_ATOL
        # the control: the float32 search fails the bfloat16 gate
        assert abs(g32[0]["score"] - w16[0]["score"]) > BF16_SCORE_ATOL
    # the model's own weights stay float32 and unrounded
    assert all(p.dtype == torch.float32 for p in model.parameters())


def test_bf16_commands(am, workspace, tmp_path):
    """decode_batch --dtype bfloat16 writes the batched bfloat16 search's
    best lines (aps_tpu's beam_search_batch at the command's padding,
    within BF16_SCORE_ATOL, where aps_tpu's float32 search lies outside
    it); decode --dtype bfloat16 gives what aps_tpu's
    cmd/decode.py gives, the float32 search (its single search drops the
    key)."""
    nnet, variables, _, _, lens = am
    argv = ["--am", workspace["am"], "--dict", workspace["dict"],
            "--beam-size", "4", "--nbest", "3", "--ctc-weight", "0.4",
            "--max-len", "12", "--allow-partial", "true", "--dtype",
            "bfloat16", "--device", "cpu"]
    stats = decode_batch.main([workspace["scp"], str(tmp_path / "b16"),
                               "--batch-size", "2"] + argv)
    pad_to = decode_batch.quantize_dur(int(max(lens)))
    kw = dict(SEARCH, pad_to=pad_to)
    want16 = jax_search.beam_search_batch(nnet, variables, _batch(am),
                                          dtype="bfloat16", **kw)
    want32 = jax_search.beam_search_batch(nnet, variables, _batch(am), **kw)
    for i, (w16, w32) in enumerate(zip(want16, want32)):
        got = stats["scores"][f"u{i}"]
        assert abs(got - w16[0]["score"]) <= BF16_SCORE_ATOL
        assert abs(w32[0]["score"] - w16[0]["score"]) > BF16_SCORE_ATOL
    spec = importlib.util.spec_from_file_location(
        "jax_cmd_decode_opts", REPO / "cmd" / "decode.py")
    jax_decode = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_decode)
    outs = []
    for name, run in (("port", decode.run), ("jax", jax_decode.run)):
        best = tmp_path / f"one.{name}"
        run(decode.make_parser().parse_args([workspace["scp"], str(best)] +
                                            argv))
        outs.append(best.read_text())
    assert outs[0] == outs[1]
    f32 = decode.main([workspace["scp"], str(tmp_path / "one.f32")] +
                      argv[:-4] + ["--device", "cpu"])
    one16 = decode.main([workspace["scp"], str(tmp_path / "one.b16")] +
                        argv)
    assert one16["scores"] == f32["scores"]


@pytest.mark.parametrize("method", ["v1", "v2"])
def test_cov_penalty_in_the_transformer_search_matches_jax(am, method):
    """cov_penalty > 0 in the transformer search, as aps_tpu runs it: its
    coverage is gathered but never grows, so v1 adds 0 (the scores of the
    search without it) and v2 adds log 0 = -inf to every hypothesis (every
    score -inf, the hypotheses in lane order); batched and single."""
    nnet, variables, model, _, _ = am
    batch = _batch(am)
    cov = dict(SEARCH, cov_penalty=0.5, cov_method=method, cov_threshold=0.3)
    want = jax_search.beam_search_batch(nnet, variables, batch, **cov)
    got = search.beam_search_batch(model, batch, device="cpu", **cov)
    plain = search.beam_search_batch(model, batch, device="cpu", **SEARCH)
    singles = [(search.beam_search(model, x, device="cpu", **cov),
                jax_search.beam_search(nnet, variables, jnp.asarray(x),
                                       **cov)) for x in batch]
    for g, w, p, (g1, w1) in zip(got, want, plain, singles):
        assert [h["trans"] for h in g] == [h["trans"] for h in w]
        assert [h["trans"] for h in g1] == [h["trans"] for h in w1]
        if method == "v1":
            for a, b, c in zip(g, w, p):
                assert abs(a["score"] - b["score"]) <= SCORE_ATOL
                assert a["score"] == c["score"]
        else:
            assert all(h["score"] == -np.inf for h in g + w + g1 + w1)


def _separators(cpt: Path, dtype: str):
    spec = importlib.util.spec_from_file_location(
        "jax_cmd_separate_opts", REPO / "cmd" / "separate.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return (separate.Separator(str(cpt), device="cpu", dtype=dtype),
            module.Separator(str(cpt), dtype=dtype))


def _assert_waves_close(got, want, rtol):
    got = got if isinstance(got, list) else [got]
    want = want if isinstance(want, (list, tuple)) else [want]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w, dtype=np.float32)
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=rtol * float(np.abs(w).max()))


# a separated waveform of a float32 pass with bfloat16-valued weights and
# input, against aps_tpu's: the same arithmetic in another order, within
# this share of its largest sample
SEP_RTOL = 1e-4


def test_separate_bf16_of_a_frequency_domain_model_matches_jax(tmp_path):
    """separate --dtype bfloat16 of sse@freq_xfmr: aps_tpu casts the
    weights and the input to bfloat16 and promotes to float32 at the STFT
    (its only bfloat16 operands, read with jax.make_jaxpr, are the frames
    against the float32 DFT matrices and the weights converted to float32
    where they are used); the port's separation within SEP_RTOL of
    aps_tpu's, time mode and freq mode, moved off the float32 one; the
    command runs with the flag."""
    name, conf = MODELS["freq_xfmr"]
    _, variables, _ = zoo_pair(name, conf, enh=ENH, seed=2)
    cpt = write_checkpoint(tmp_path / "cpt", name, conf, variables)
    rng = np.random.default_rng(6)
    mix = (0.2 * rng.standard_normal(3000)).astype(np.float32)
    port16, jax16 = _separators(cpt, "bfloat16")
    port32, _ = _separators(cpt, "float32")
    got = port16.run(mix)
    _assert_waves_close(got, jax16.run(mix), SEP_RTOL)
    _assert_waves_close(np.asarray(port16.run(mix, mode="freq")),
                        np.asarray(jax16.run(mix, mode="freq")), SEP_RTOL)
    f32 = port32.run(mix)
    assert max(float(np.abs(a - b).max()) for a, b in zip(got, f32)) > 1e-5
    assert all(p.dtype == torch.float32 for p in port16.nnet.parameters())
    from aps_tpu_torch.io import write_audio
    write_audio(str(tmp_path / "mix.wav"), mix, sr=8000)
    (tmp_path / "mix.scp").write_text(f"m0 {tmp_path / 'mix.wav'}\n")
    stats = separate.main([str(tmp_path / "mix.scp"), str(tmp_path / "sep"),
                           "--checkpoint", str(cpt), "--sr", "8000",
                           "--dtype", "bfloat16", "--device", "cpu"])
    assert stats["utts"] == 1
    assert (tmp_path / "sep" / "spk2" / "m0.wav").is_file()


# sse@base_rnn behind a 3-channel enh_transform (log spectrogram and the
# cos-IPD of two pairs): C x S in, one waveform a speaker out
MC_ENH = dict(feats="spectrogram-log-cmvn-ipd", frame_len=64, frame_hop=32,
              window="hann", ipd_index="0,1;0,2", cos_ipd=True)
MC_CONF = dict(input_size=33 * 3, num_bins=33, num_spks=2, hidden=12,
               num_layers=2, dropout=0.0, bidirectional=True,
               mask_non_linear="relu")


def _multichannel_checkpoint(root: Path) -> Path:
    jnet = jax_libs.aps_sse_nnet("sse@base_rnn")(
        enh_transform=jax_libs.aps_transform("enh")(**MC_ENH), **MC_CONF)
    mix = jnp.zeros((2, 3, 1600))
    variables = jax.tree_util.tree_map(np.array, dict(jax.jit(
        lambda m: jnet.init(jax.random.PRNGKey(4), m, training=False))(mix)))
    net = aps_sse_nnet("sse@base_rnn")(
        enh_transform=aps_transform("enh")(**MC_ENH), **MC_CONF)
    net.load_state_dict(to_state_dict(variables, net))
    root.mkdir()
    (root / "train.yaml").write_text(json.dumps(dict(
        nnet="sse@base_rnn", nnet_conf=MC_CONF, enh_transform=MC_ENH,
        task="sse@sisnr", task_conf={}, data_conf={}, trainer_conf={})))
    with open(root / "best.ckpt", "wb") as fd:
        pickle.dump({"params": {"nnet": variables["params"]}}, fd)
    return root


def test_chunked_separation_of_multichannel_input_matches_jax(tmp_path):
    """separate --chunk-len/--chunk-hop of a 3-channel mixture (C x S
    chunks over the sample axis, the last one zero-padded, stitched with
    the permutation fixed on the overlaps): aps_tpu's Separator's result
    within SEP_RTOL, whole-utterance too; sse@rnn_enh_ml's chunks give
    masks, which aps_tpu's stitcher cannot take (a broadcasting
    ValueError) and the port refuses with a ValueError."""
    cpt = _multichannel_checkpoint(tmp_path / "mc")
    rng = np.random.default_rng(8)
    src = (0.2 * rng.standard_normal(5000)).astype(np.float32)
    mix = np.stack([np.roll(src, d) + 0.05 * rng.standard_normal(5000)
                    for d in (0, 2, 5)]).astype(np.float32)
    port, theirs = _separators(cpt, "float32")
    for kw in (dict(chunk_len=1600, chunk_hop=1200), {}):
        got = port.run(mix, **kw)
        assert all(g.shape == (5000,) for g in got)
        _assert_waves_close(got, theirs.run(mix, **kw), SEP_RTOL)
    from aps_tpu_torch.io import write_audio
    write_audio(str(tmp_path / "mc.wav"), mix, sr=8000)
    (tmp_path / "mc.scp").write_text(f"m0 {tmp_path / 'mc.wav'}\n")
    stats = separate.main([str(tmp_path / "mc.scp"), str(tmp_path / "sep"),
                           "--checkpoint", str(cpt), "--sr", "8000",
                           "--chunk-len", "1600", "--chunk-hop", "1200",
                           "--device", "cpu"])
    assert stats["utts"] == 1
    from test_torch_chime4 import ML_ENH, ML_NNET, _ml_pair
    _, variables, _, ml_mix = _ml_pair(0)
    ml = tmp_path / "ml"
    ml.mkdir()
    (ml / "train.yaml").write_text(json.dumps(dict(
        nnet="sse@rnn_enh_ml", nnet_conf=ML_NNET, enh_transform=ML_ENH,
        task="sse@enh_ml", task_conf={}, data_conf={}, trainer_conf={})))
    with open(ml / "best.ckpt", "wb") as fd:
        pickle.dump({"params": variables["params"]}, fd)
    port, theirs = _separators(ml, "float32")
    with pytest.raises(ValueError, match="no sample axis"):
        port.run(ml_mix[0], chunk_len=1600, chunk_hop=1200)
    with pytest.raises(ValueError, match="broadcast"):
        theirs.run(ml_mix[0], chunk_len=1600, chunk_hop=1200)
