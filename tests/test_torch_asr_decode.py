#!/usr/bin/env python
"""PyTorch port, the whole decode slice: the small flagship (Conformer AED
+ CTC, __graft_entry__._build_flagship(small=True)) with weights converted
from aps_tpu, against aps_tpu on the same inputs — encoder pass,
incremental decoder steps, batched joint CTC/attention beam search — plus
the weight round trip and a jax-free CPU decode through decode_batch."""

import json
import pickle
import subprocess
import sys
from pathlib import Path
from typing import NamedTuple

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from __graft_entry__ import _build_flagship  # noqa: E402
from aps_tpu.asr.beam_search import transformer as jax_search  # noqa: E402
from aps_tpu.io import write_audio  # noqa: E402
from aps_tpu_torch.asr.beam_search import transformer as search  # noqa
from aps_tpu_torch.convert import to_state_dict, to_variables  # noqa: E402
from aps_tpu_torch.flagship import build_flagship, flagship_conf  # noqa

REPO = Path(__file__).resolve().parents[1]
VOCAB = 64
# encoder outputs / logits of a 2-layer width-64 model in float32: the
# same math in another summation order (measured ~1e-5)
ENC_ATOL = 1e-4
# beam scores are length-normalised sums of ~30 log-probs
SCORE_ATOL = 1e-4
# output layers are scaled on both sides so candidates are well apart and
# near-ties cannot flip the ranking (BENCHMARKS.md, random-init decodes)
PEAKY = 4.0


@pytest.fixture(scope="module")
def flagship():
    """(flax model, numpy variables, port model, waveforms, lengths)."""
    rng = np.random.default_rng(21)
    lens = np.array([32000, 26000])
    wav = np.zeros((2, 32000), dtype=np.float32)
    for i, n in enumerate(lens):
        wav[i, :n] = 0.1 * rng.standard_normal(n)
    nnet = _build_flagship(vocab_size=VOCAB, small=True)
    variables = nnet.init({"params": jax.random.PRNGKey(0)},
                          jnp.asarray(wav), jnp.asarray(lens),
                          jnp.zeros((2, 4), jnp.int32),
                          jnp.asarray([4, 4]), training=False)
    variables = jax.tree_util.tree_map(np.array, dict(variables))
    params = variables["params"]
    params["decoder"]["output"]["kernel"] *= PEAKY
    params["ctc_head"]["kernel"] *= PEAKY
    stats = variables["batch_stats"]

    def perturb(tree):
        for key, val in tree.items():
            if isinstance(val, dict):
                perturb(val)
            elif key == "mean":
                tree[key] = (0.1 * rng.standard_normal(val.shape)).astype(
                    np.float32)
            else:
                tree[key] = (1 + 0.2 * rng.random(val.shape)).astype(
                    np.float32)

    perturb(stats)
    model = build_flagship(flagship_conf(VOCAB, small=True)).eval()
    model.load_state_dict(to_state_dict(variables, model))
    return nnet, variables, model, wav, lens


def test_decode_enc_matches_jax(flagship):
    nnet, variables, model, wav, lens = flagship
    want = nnet.apply(variables, jnp.asarray(wav), jnp.asarray(lens),
                      method="decode_enc")
    with torch.no_grad():
        got = model.decode_enc(torch.from_numpy(wav), torch.from_numpy(lens))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    for g, w in ((got[0], want[0]), (got[2], want[2])):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ENC_ATOL)


def test_decode_step_inc_matches_jax(flagship):
    """Three incremental decoder steps over beam-folded lanes (2 utterances
    x 3 beams) with the beam-shared cross-attention K/V."""
    nnet, variables, model, wav, lens = flagship
    K, L = 3, 8
    enc, enc_len, _ = nnet.apply(variables, jnp.asarray(wav),
                                 jnp.asarray(lens), method="decode_enc")
    mem_kv = nnet.apply(variables, enc, method="decode_prep_kv")
    cache = nnet.apply(variables, 2 * K, L, method="decode_init_cache")
    toks = np.random.default_rng(2).integers(0, VOCAB - 1, size=(2 * K, 3))
    toks[:, 0] = VOCAB - 3
    with torch.no_grad():
        enc_t = torch.from_numpy(np.array(enc))
        len_t = torch.from_numpy(np.array(enc_len)).repeat_interleave(K)
        kv_t = model.decode_prep_kv(enc_t)
        cache_t = model.decode_init_cache(2 * K, L)
        for t in range(3):
            want, cache = nnet.apply(variables, jnp.repeat(enc, K, axis=0),
                                     jnp.asarray(toks[:, t]), cache, t,
                                     enc_len=jnp.repeat(enc_len, K),
                                     mem_kv=mem_kv,
                                     method="decode_step_inc")
            got, cache_t = model.decode_step_inc(enc_t,
                                                 torch.from_numpy(toks[:, t]),
                                                 cache_t, t, enc_len=len_t,
                                                 mem_kv=kv_t)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=ENC_ATOL)


@pytest.mark.parametrize("ctc_weight,extra", [
    (0.4, {}),
    (0.4, {"unk": 5}),
    (0.0, {"eos_threshold": 1.0, "unk": 5}),
])
def test_beam_search_batch_matches_jax(flagship, ctc_weight, extra):
    """n-best tokens and scores of the batched search, max_len 32."""
    nnet, variables, model, wav, lens = flagship
    batch = [wav[i, :n] for i, n in enumerate(lens)]
    kw = dict(sos=VOCAB - 3, eos=VOCAB - 2, beam_size=4, nbest=4,
              max_len=32, ctc_weight=ctc_weight, allow_partial=True,
              **extra)
    want = jax_search.beam_search_batch(nnet, variables, batch, **kw)
    got = search.beam_search_batch(model, batch, **kw)
    assert len(got) == len(want) == 2
    for hyps_g, hyps_w in zip(got, want):
        assert len(hyps_g) == len(hyps_w) == 4
        for g, w in zip(hyps_g, hyps_w):
            assert g["trans"] == w["trans"]
            assert extra.get("unk") not in g["trans"]
            assert abs(g["score"] - w["score"]) <= SCORE_ATOL


@pytest.mark.parametrize("pre_norm", [True, False])
def test_decoder_step_inc_pre_norm_matches_jax(pre_norm):
    """TorchTransformerDecoder.step_inc with pre- and post-norm layers (the
    flagship decoder is post-norm; pre-norm adds the final LayerNorm)."""
    from aps_tpu.asr.transformer.decoder import \
        TorchTransformerDecoder as JaxDecoder
    from aps_tpu_torch.asr.transformer.decoder import TorchTransformerDecoder
    arch = dict(att_dim=32, nhead=2, feedforward_dim=64, pre_norm=pre_norm)
    rng = np.random.default_rng(9)
    N, T, L = 3, 11, 6
    enc = rng.standard_normal((N, T, 32)).astype(np.float32)
    enc_len = np.array([T, 7, 4])
    toks = rng.integers(0, 20, size=(N, 3))
    jdec = JaxDecoder(vocab_size=20, arch_kwargs=arch, num_layers=2)
    cache = jnp.zeros((2, N, L, 32))
    variables = jdec.init(jax.random.PRNGKey(3), jnp.asarray(enc),
                          jnp.asarray(toks[:, 0]), cache, 0,
                          enc_len=jnp.asarray(enc_len),
                          method="step_inc")
    variables = jax.tree_util.tree_map(np.array, dict(variables))
    tdec = TorchTransformerDecoder(20, arch_kwargs=arch, num_layers=2).eval()
    tdec.load_state_dict(to_state_dict(variables, tdec))
    tcache = tdec.init_cache(N, L)
    with torch.no_grad():
        for t in range(3):
            want, cache = jdec.apply(variables, jnp.asarray(enc),
                                     jnp.asarray(toks[:, t]), cache, t,
                                     enc_len=jnp.asarray(enc_len),
                                     method="step_inc")
            got, tcache = tdec.step_inc(torch.from_numpy(enc),
                                        torch.from_numpy(toks[:, t]),
                                        tcache, t,
                                        enc_len=torch.from_numpy(enc_len))
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=ENC_ATOL)


def test_beam_search_end_detect_matches_jax(flagship):
    """End detection with the eos logit boosted so hypotheses finish early:
    utterances stop (and freeze) at different steps, as in aps_tpu."""
    nnet, variables, _, wav, lens = flagship
    boosted = jax.tree_util.tree_map(np.array, variables)
    boosted["params"]["decoder"]["output"]["kernel"][:, VOCAB - 2] *= 3.0
    model = build_flagship(flagship_conf(VOCAB, small=True)).eval()
    model.load_state_dict(to_state_dict(boosted, model))
    batch = [wav[i, :n] for i, n in enumerate(lens)]
    kw = dict(sos=VOCAB - 3, eos=VOCAB - 2, beam_size=4, nbest=2,
              max_len=32, ctc_weight=0.4, end_detect=True)
    want = jax_search.beam_search_batch(nnet, boosted, batch, **kw)
    got = search.beam_search_batch(model, batch, **kw)
    assert any(len(h) for h in want)
    for hyps_g, hyps_w in zip(got, want):
        assert len(hyps_g) == len(hyps_w)
        for g, w in zip(hyps_g, hyps_w):
            assert g["trans"] == w["trans"] and g["trans"][-1] == VOCAB - 2
            assert abs(g["score"] - w["score"]) <= SCORE_ATOL


def test_weights_round_trip(flagship):
    """flax -> port -> flax is exact; the converter refuses unmapped and
    missing keys."""
    _, variables, model, _, _ = flagship
    back = to_variables(model)
    flat_a = jax.tree_util.tree_leaves_with_path(variables)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, val in flat_a:
        np.testing.assert_array_equal(flat_b[path], val)
    extra = dict(back, params=dict(back["params"], stray={"w": np.ones(2)}))
    with pytest.raises(KeyError, match="unmapped"):
        to_state_dict(extra, model)
    missing = dict(back, params={k: v for k, v in back["params"].items()
                                 if k != "ctc_head"})
    with pytest.raises(KeyError, match="missing"):
        to_state_dict(missing, model)


class OptimizerState(NamedTuple):
    """Stands for optimizer state pickled by reference to its class."""
    mu: np.ndarray
    count: int


def test_decode_batch_cli_runs_without_jax(flagship, tmp_path):
    """`aps_tpu_torch.cmd.decode_batch` on an aps_tpu-format checkpoint
    (written without jax), on the CPU because --device cpu asks for it, in
    a fresh interpreter: 2 transcript lines, jax and aps_tpu never
    imported."""
    _, _, model, wav, lens = flagship
    cpt = tmp_path / "cpt"
    cpt.mkdir()
    conf = dict(flagship_conf(VOCAB, small=True), task="asr@ctc_xent",
                task_conf={}, data_conf={}, trainer_conf={})
    (cpt / "train.yaml").write_text(json.dumps(conf))
    variables = to_variables(model)
    with open(cpt / "best.ckpt", "wb") as fd:
        # a trainer checkpoint also holds optimizer state of classes the
        # decoder cannot (and must not) import
        pickle.dump({"params": {"nnet": variables["params"]},
                     "mstate": {"batch_stats": variables["batch_stats"]},
                     "opt_state": OptimizerState(np.zeros(3), 7),
                     "epoch": 3}, fd)
    with open(tmp_path / "dict", "w") as fd:
        for i in range(VOCAB - 3):
            fd.write(f"{'<unk>' if i == 0 else f'w{i}'} {i}\n")
        fd.write(f"<sos> {VOCAB - 3}\n<eos> {VOCAB - 2}\n")
    with open(tmp_path / "wav.scp", "w") as scp:
        for i, n in enumerate(lens):
            write_audio(str(tmp_path / f"u{i}.wav"), wav[i, :n])
            scp.write(f"u{i} {tmp_path / f'u{i}.wav'}\n")
    best = tmp_path / "best.txt"
    argv = [str(tmp_path / "wav.scp"), str(best), "--am", str(cpt),
            "--dict", str(tmp_path / "dict"), "--beam-size", "4",
            "--ctc-weight", "0.4", "--max-len", "20", "--batch-size", "2",
            "--device", "cpu"]
    code = ("import sys\n"
            "import aps_tpu_torch\n"
            "from aps_tpu_torch.cmd import decode_batch\n"
            f"decode_batch.main({argv!r})\n"
            "assert 'jax' not in sys.modules, 'jax was imported'\n"
            "assert not [m for m in sys.modules if m.split('.')[0] == "
            "'aps_tpu'], 'aps_tpu was imported'\n"
            "print('NO-JAX-OK')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO-JAX-OK" in proc.stdout
    lines = best.read_text().splitlines()
    assert sorted(ln.split("\t")[0] for ln in lines) == ["u0", "u1"]


def test_decode_batch_refuses_an_lm(tmp_path):
    """The batched search fuses NN LMs only: an n-gram file given to --lm
    raises (naming decode and lm_rescore) instead of being ignored."""
    from aps_tpu_torch.cmd import decode_batch
    (tmp_path / "lm.arpa").write_text("\\data\\\nngram 1=1\n")
    argv = [str(tmp_path / "wav.scp"), str(tmp_path / "best.txt"), "--am",
            str(tmp_path), "--lm", str(tmp_path / "lm.arpa")]
    with pytest.raises(NotImplementedError, match="--lm .*lm_rescore"):
        decode_batch.main(argv)


def _port_modules():
    pkg = REPO / "aps_tpu_torch"
    for path in sorted(pkg.rglob("*.py")):
        rel = path.relative_to(REPO).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield path, ".".join(parts)


def test_port_imports_neither_jax_nor_aps_tpu():
    """After importing every module of aps_tpu_torch and chip_smoke in a
    fresh interpreter, neither jax nor any aps_tpu module is loaded."""
    names = [name for _, name in _port_modules()] + ["chip_smoke"]
    assert "aps_tpu_torch.cmd.train_am" in names and len(names) > 40
    for new in ("cmd.separate", "cmd.train_ss", "sse.bss.tcn", "ops.tcn",
                "task.sse", "loader.se.chunk", "eval.sse", "ops.attention",
                "cmd.decode", "cmd.lm_rescore", "cmd.train_lm",
                "cmd.compute_wer", "cmd.text_tokenize", "asr.lm.rnn",
                "asr.lm.transformer", "asr.lm.ngram", "asr.base.rnn",
                "asr.beam_search.lm", "loader.lm.utt", "loader.lm.bptt",
                "tokenizer.subword", "tokenizer.bpe", "metric.asr",
                "metric.reporter", "transform.enh", "sse.toy", "metric.sse",
                "metric.stoi", "cmd.compute_ss_metric", "cplx",
                "asr.base.encoder", "asr.filter.conv", "asr.filter.google",
                "asr.filter.mvdr", "asr.enh_att", "sse.unsuper.rnn",
                "task.ml", "asr.att", "asr.ctc", "asr.base.attention",
                "asr.base.decoder", "asr.base.component",
                "asr.beam_search.att", "trainer.ss", "sse.bss.dprnn",
                "sse.bss.dccrn", "sse.bss.dense_unet", "sse.bss.sepformer",
                "sse.bss.transformer", "sse.bss.chimera", "sse.enh.demucs",
                "sse.enh.dcunet", "sse.enh.dfsmn", "sse.enh.phasen",
                "transform.streaming", "streaming_asr.utils",
                "streaming_asr.base.encoder",
                "streaming_asr.transformer.impl",
                "streaming_asr.transformer.encoder", "streaming_asr.ctc",
                "streaming_asr.transducers", "rt_sse.base",
                "rt_sse.enh.dfsmn", "rt_sse.enh.transformer", "deploy",
                "cmd.export", "cmd.rt_ctc", "cmd.rt_enh"):
        assert f"aps_tpu_torch.{new}" in names
    code = ("import importlib, sys\n"
            f"for name in {names!r}:\n"
            "    importlib.import_module(name)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'aps_tpu'))\n"
            "assert not bad, bad\n"
            "print('IMPORTED', len(sys.modules))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "IMPORTED" in proc.stdout


def test_port_sources_name_no_aps_tpu_import():
    """No source of the port, nor chip_smoke.py, has an import of aps_tpu
    (aps_tpu_torch passes the word boundary) or of jax."""
    import re
    pattern = re.compile(
        r"^\s*(import\s+(aps_tpu|jax|flax|optax)\b(?!_)"
        r"|from\s+(aps_tpu|jax|flax|optax)(\.[\w.]+)?\s+import\b)", re.M)
    assert pattern.search("from aps_tpu.const import X")
    assert pattern.search("    import aps_tpu.const")
    assert not pattern.search("from aps_tpu_torch.const import X")
    paths = [path for path, _ in _port_modules()] + [REPO / "chip_smoke.py"]
    for path in paths:
        found = pattern.search(path.read_text())
        assert found is None, f"{path}: {found.group(0)}"


def test_pick_device_is_the_card_unless_the_cpu_is_asked_for(monkeypatch):
    """The default device is the card and raises when torch sees none; the
    CPU only on explicit request."""
    from aps_tpu_torch.cmd import (decode, decode_batch, export,
                                   lm_rescore, rt_ctc, rt_enh, separate,
                                   train_am, train_lm, train_ss)
    from aps_tpu_torch.eval.wrapper import pick_device
    assert pick_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pick_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pick_device("cuda", 1)
    with pytest.raises(ValueError):
        pick_device("tpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert pick_device() == torch.device("cuda:0")
    assert pick_device("cuda", 2) == torch.device("cuda:2")
    for parser in (decode_batch.make_parser(), train_am.make_parser(),
                   separate.make_parser(), train_ss.make_parser(),
                   decode.make_parser(), lm_rescore.make_parser(),
                   train_lm.make_parser(), export.make_parser(),
                   rt_ctc.make_parser(), rt_enh.make_parser()):
        assert parser.get_default("device") == "cuda"


def test_entry_points_refuse_to_run_without_a_card(flagship, tmp_path):
    """decode_batch and train_am with their default device raise on a
    machine without a card instead of carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    from aps_tpu_torch.cmd import decode_batch, train_am
    _, _, model, _, _ = flagship
    cpt = tmp_path / "cpt"
    cpt.mkdir()
    conf = dict(flagship_conf(VOCAB, small=True), task="asr@ctc_xent",
                task_conf={}, data_conf={}, trainer_conf={})
    (cpt / "train.yaml").write_text(json.dumps(conf))
    variables = to_variables(model)
    with open(cpt / "best.ckpt", "wb") as fd:
        pickle.dump({"params": variables["params"],
                     "mstate": {"batch_stats": variables["batch_stats"]}},
                    fd)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        decode_batch.main([str(tmp_path / "wav.scp"),
                           str(tmp_path / "best.txt"), "--am", str(cpt)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_am.main(["--conf", str(cpt / "train.yaml"), "--dict",
                       str(tmp_path / "dict"), "--checkpoint",
                       str(tmp_path / "out")])
