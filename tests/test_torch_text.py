#!/usr/bin/env python
"""PyTorch port, text and scoring tools against aps_tpu on the same
inputs: the word, char and subword (JSON BPE) tokenizers, train_bpe,
TextPostProcessor, the WER metric and the compute_wer and text_tokenize
commands (aps_tpu's commands run in-process from cmd/*.py with the
arguments the port's parser gave)."""

import argparse
import importlib.util
from pathlib import Path

import pytest

pytest.importorskip("torch")

from aps_tpu.eval.asr import TextPostProcessor as JaxPost  # noqa: E402
from aps_tpu.metric import asr as jax_metric  # noqa: E402
from aps_tpu.tokenizer import bpe as jax_bpe  # noqa: E402
from aps_tpu.libs import aps_tokenizer as jax_tokenizer  # noqa: E402
from aps_tpu_torch.cmd import compute_wer, text_tokenize  # noqa: E402
from aps_tpu_torch.eval.asr import TextPostProcessor  # noqa: E402
from aps_tpu_torch.libs import aps_tokenizer  # noqa: E402
from aps_tpu_torch.metric import asr as metric  # noqa: E402
from aps_tpu_torch.tokenizer import bpe  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
CORPUS = [
    "the cat sat on the mat",
    "the dog sat on the log",
    "a cat and a dog",
    "the mat and the log sat there",
    "there the cat ran",
]


def jax_command(name: str):
    """cmd/<name>.py of aps_tpu as a module (its run(args) is called with
    the namespace the port's parser made)."""
    spec = importlib.util.spec_from_file_location(f"jax_cmd_{name}",
                                                  REPO / "cmd" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def bpe_json(tmp_path_factory):
    path = tmp_path_factory.mktemp("bpe") / "bpe.json"
    jax_bpe.train_bpe(CORPUS, vocab_size=30).save(str(path))
    return str(path)


@pytest.mark.parametrize("unit,kwargs", [
    ("word", {}),
    ("word", {"filter_words": ["the"]}),
    ("char", {}),
    ("char", {"space": "<sp>", "filter_words": ["a"]}),
    ("char", {"space": ""}),
    ("subword", {}),
    ("subword", {"filter_words": ["dog"]}),
])
def test_tokenizers_match_jax(unit, kwargs, bpe_json):
    if unit == "subword":
        kwargs = dict(kwargs, spm=bpe_json)
    port = aps_tokenizer(unit)(**kwargs)
    ref = jax_tokenizer(unit)(**kwargs)
    for line in CORPUS + ["unseen words here"]:
        for utt in (line, line.split()):
            enc = port.encode(utt)
            assert enc == ref.encode(utt)
            assert port.decode(enc) == ref.decode(enc)
            assert port.decode(" ".join(enc)) == ref.decode(" ".join(enc))


def test_sentencepiece_model_raises_as_in_jax(tmp_path):
    """A .model file is not a JSON BPE model, and sentencepiece is not
    installed: both packages raise the same ImportError."""
    model = tmp_path / "sp.model"
    model.write_bytes(b"\x0a\x0b binary sentencepiece")
    errors = []
    for make in (aps_tokenizer("subword"), jax_tokenizer("subword")):
        with pytest.raises(ImportError) as info:
            make(spm=str(model))
        errors.append(str(info.value))
    assert errors[0] == errors[1]
    assert "sentencepiece" in errors[0]


@pytest.mark.parametrize("vocab_size,min_pair_freq", [(30, 2), (60, 1)])
def test_train_bpe_gives_the_same_merges(vocab_size, min_pair_freq,
                                          tmp_path):
    port = bpe.train_bpe(CORPUS, vocab_size=vocab_size,
                         min_pair_freq=min_pair_freq)
    ref = jax_bpe.train_bpe(CORPUS, vocab_size=vocab_size,
                            min_pair_freq=min_pair_freq)
    assert port.merges == ref.merges and port.vocab == ref.vocab
    port.save(str(tmp_path / "port.json"))
    ref.save(str(tmp_path / "ref.json"))
    assert (tmp_path / "port.json").read_bytes() == \
        (tmp_path / "ref.json").read_bytes()
    assert bpe.is_bpe_json(str(tmp_path / "ref.json"))
    loaded = bpe.BpeModel.load(str(tmp_path / "ref.json"))
    for line in CORPUS:
        assert loaded.encode(line) == ref.encode(line)
        assert loaded.decode(loaded.encode(line)) == line


def _dict_file(path: Path, units) -> str:
    with open(path, "w") as fd:
        for i, unit in enumerate(["<unk>"] + list(units)):
            fd.write(f"{unit} {i}\n")
    return str(path)


@pytest.mark.parametrize("kind", ["word", "char", "subword"])
@pytest.mark.parametrize("show_unk", ["<unk>", "<UNK>"])
def test_text_post_processor_matches_jax(kind, show_unk, bpe_json,
                                         tmp_path):
    """TextPostProcessor with dict=, space= (char units) and spm= (subword
    units) gives aps_tpu's strings, <unk> shown as show_unk."""
    kwargs = {}
    if kind == "word":
        units = sorted({w for line in CORPUS for w in line.split()})
    elif kind == "char":
        units = sorted({c for line in CORPUS for c in line if c != " "}) + \
            ["<space>"]
        kwargs["space"] = "<space>"
    else:
        units = jax_bpe.BpeModel.load(bpe_json).vocab
        units = [u for u in units if u != "<unk>"]
        kwargs["spm"] = bpe_json
    dict_path = _dict_file(tmp_path / "dict", units)
    port = TextPostProcessor(dict_path, show_unk=show_unk, **kwargs)
    ref = JaxPost(dict_path, show_unk=show_unk, **kwargs)
    for seq in ([1, 2, 3, 0, 4], list(range(1, len(units) + 1)), [0], []):
        assert port.run(seq) == ref.run(seq)
    no_dict = TextPostProcessor("")
    assert no_dict.run([3, 1]) == JaxPost("").run([3, 1]) == "3 1"


@pytest.mark.parametrize("hyp,ref", [
    ("a b c d", "a b c d"),
    ("a x c", "a b c d"),
    ("a b b c d e", "a b c d"),
    ("", "a b"),
    ("a b", ""),
])
def test_wer_matches_jax(hyp, ref):
    h, r = hyp.split(), ref.split()
    assert metric.wer(h, r) == jax_metric.wer(h, r)
    assert metric.edit_distance_ops(h, r) == jax_metric.edit_distance_ops(h, r)


def test_permute_wer_matches_jax():
    hyps = [["a", "b", "c"], ["x", "y"]]
    refs = [["x", "y", "z"], ["a", "b"]]
    assert metric.permute_wer(hyps, refs) == \
        jax_metric.permute_wer(hyps, refs)
    with pytest.raises(RuntimeError):
        metric.permute_wer(hyps, refs[:1])


def _write(path: Path, lines) -> str:
    path.write_text("".join(f"{ln}\n" for ln in lines))
    return str(path)


@pytest.fixture
def transcripts(tmp_path):
    ref1 = _write(tmp_path / "ref1", ["u1 the cat sat", "u2 a dog ran",
                                      "u3 on the mat", "u4 x"])
    hyp1 = _write(tmp_path / "hyp1", ["u1 the cat sat", "u2 a dig ran on",
                                      "u3 the mat", "u4 y"])
    ref2 = _write(tmp_path / "ref2", ["u1 dog", "u2 cat", "u3 mat", "u4 y"])
    hyp2 = _write(tmp_path / "hyp2", ["u1 cat", "u2 dog", "u3 mat", "u4 x"])
    utt2class = _write(tmp_path / "utt2class", ["u1 A", "u2 B", "u3 A",
                                                "u4 B"])
    return tmp_path, {"hyp1": hyp1, "ref1": ref1, "hyp2": hyp2,
                      "ref2": ref2, "utt2class": utt2class}


@pytest.mark.parametrize("argv", [
    ["{hyp1}", "{ref1}"],
    ["{hyp1}", "{ref1}", "--cer", "true"],
    ["{hyp1}", "{ref1}", "--per-utt", "{out}", "--utt2class", "{utt2class}"],
    ["{hyp1},{hyp2}", "{ref1},{ref2}", "--reduce", "sum"],
    ["{hyp1},{hyp2}", "{ref1},{ref2}", "--reduce", "min", "--per-utt",
     "{out}"],
    ["{hyp1}", "{ref1}", "--details", "true", "--cer", "true"],
])
def test_compute_wer_matches_jax(argv, transcripts, capsys):
    """The report (stdout) and the per-utterance file, line for line."""
    root, files = transcripts
    outs = []
    for name, run in (("port", compute_wer.run),
                      ("jax", jax_command("compute_wer").run)):
        out = root / f"per_utt.{name}"
        args = compute_wer.make_parser().parse_args(
            [a.format(out=out, **files) for a in argv])
        run(args)
        report = capsys.readouterr().out
        outs.append((report, out.read_text() if out.exists() else None))
    assert outs[0] == outs[1]
    assert "Report" in outs[0][0]


@pytest.mark.parametrize("argv", [
    ["--unit", "word", "--dump-vocab", "{vocab}", "--filter-units", "sat"],
    ["--unit", "char", "--space", "<space>", "--dump-vocab", "{vocab}",
     "--add-sos-eos", "false"],
    ["--unit", "char", "--text-format", "raw", "--space", ""],
    ["--unit", "subword", "--spm", "{bpe}", "--dump-vocab", "{vocab}",
     "--add-units", "<unk>,<noise>"],
    ["--unit", "word", "--text-format", "raw", "--filter-words", "the,a",
     "--dump-vocab", "{vocab}"],
])
def test_text_tokenize_matches_jax(argv, bpe_json, tmp_path):
    """The token file and the dumped vocabulary, byte for byte."""
    raw = "--text-format" in argv and "raw" in argv
    lines = CORPUS if raw else [f"utt{i} {ln}" for i, ln in enumerate(CORPUS)]
    text = _write(tmp_path / "text", lines + [""])
    outs = []
    for name, run in (("port", text_tokenize.run),
                      ("jax", jax_command("text_tokenize").run)):
        token, vocab = tmp_path / f"token.{name}", tmp_path / f"vocab.{name}"
        args = text_tokenize.make_parser().parse_args(
            [text, str(token)] +
            [a.format(vocab=vocab, bpe=bpe_json) for a in argv])
        run(args)
        outs.append((token.read_bytes(),
                     vocab.read_bytes() if vocab.exists() else None))
    assert outs[0] == outs[1]
    assert outs[0][0]


def test_text_commands_take_the_jax_arguments():
    """Every option of aps_tpu's compute_wer and text_tokenize parsers is
    an option of the port's, with the same default."""
    for name, module in (("compute_wer", compute_wer),
                         ("text_tokenize", text_tokenize)):
        source = (REPO / "cmd" / f"{name}.py").read_text()
        parser = module.make_parser()
        for action in parser._actions:
            for opt in action.option_strings:
                if opt in ("-h", "--help"):
                    continue
                assert f'"{opt}"' in source, (name, opt)
        opts = {o for a in parser._actions for o in a.option_strings}
        import re
        for opt in re.findall(r'add_argument\("(--[\w-]+)"', source):
            assert opt in opts, (name, opt)
        assert isinstance(parser, argparse.ArgumentParser)
