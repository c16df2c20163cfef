#!/usr/bin/env python
"""PyTorch port on the card: the inference commands state their
precision, and the trainer skips a batch on a device out-of-memory error.

decode, decode_batch, lm_rescore and separate run their body with
cuBLAS's and cuDNN's TF32 flags off (float32) and restore them after:
each test sets both flags on, reads them inside the search (the LM's
step) or the separator's forward, and again after the command returned.

This file imports no jax, so it also runs on a machine that has the card
but not the JAX stack:

    python -m pytest tests/test_torch_commands_cuda.py --noconftest -q

Every test needs the card: they carry the `cuda` marker and skip without
one."""

import json
import pickle
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from aps_tpu_torch.cmd import (decode, decode_batch, lm_rescore,  # noqa
                               separate)
from aps_tpu_torch.convert import to_variables  # noqa: E402
from aps_tpu_torch.flagship import build_flagship, flagship_conf  # noqa
from aps_tpu_torch.io import write_audio  # noqa: E402
from aps_tpu_torch.libs import aps_asr_nnet, aps_sse_nnet, aps_task  # noqa
from aps_tpu_torch.trainer.dp import DataParallelTrainer  # noqa: E402

pytestmark = pytest.mark.cuda
VOCAB = 40
SOS, EOS = VOCAB - 3, VOCAB - 2
LM_CONF = dict(embed_size=16, vocab_size=VOCAB - 1, rnn="lstm",
               num_layers=2, hidden_size=32, dropout=0.0)
TCN_CONF = dict(L=20, N=32, X=2, R=2, B=32, H=64, num_spks=2, norm="BN")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the commands' precision flags "
                    "and the device OOM exist on a CUDA device only)")
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = matmul.allow_tf32, cudnn.allow_tf32
    matmul.allow_tf32 = cudnn.allow_tf32 = True
    yield torch.device("cuda:0")
    matmul.allow_tf32, cudnn.allow_tf32 = saved


def flags():
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)


def _checkpoint(cpt: Path, conf: dict, model) -> str:
    cpt.mkdir()
    (cpt / "train.yaml").write_text(json.dumps(conf))
    variables = to_variables(model)
    blob = {"params": variables.pop("params"), "epoch": 1}
    if variables:
        blob["mstate"] = variables
    with open(cpt / "best.ckpt", "wb") as fd:
        pickle.dump(blob, fd)
    return str(cpt)


@pytest.fixture
def workspace(tmp_path):
    """A toy flagship AM, an RNN LM, two 1 s waveforms and the dict."""
    torch.manual_seed(3)
    am = build_flagship(flagship_conf(VOCAB, small=True)).eval()
    conf = dict(flagship_conf(VOCAB, small=True), task="asr@ctc_xent",
                task_conf={}, data_conf={}, trainer_conf={})
    am_dir = _checkpoint(tmp_path / "am", conf, am)
    lm = aps_asr_nnet("asr@rnn_lm")(**LM_CONF)
    lm_dir = _checkpoint(tmp_path / "lm", {
        "nnet": "asr@rnn_lm", "nnet_conf": LM_CONF, "task": "asr@lm",
        "task_conf": {}, "data_conf": {}, "trainer_conf": {}, "sos": SOS,
        "eos": EOS}, lm)
    with open(tmp_path / "dict", "w") as fd:
        fd.write("<unk> 0\n")
        for i in range(1, SOS):
            fd.write(f"w{i} {i}\n")
        fd.write(f"<sos> {SOS}\n<eos> {EOS}\n")
    rng = np.random.default_rng(0)
    with open(tmp_path / "wav.scp", "w") as scp:
        for i in range(2):
            write_audio(str(tmp_path / f"u{i}.wav"),
                        0.1 * rng.standard_normal(16000))
            scp.write(f"u{i} {tmp_path / f'u{i}.wav'}\n")
    return tmp_path, am_dir, lm_dir


def _record_lm_steps(monkeypatch):
    """The TF32 flags at every step of the LM in the search."""
    from aps_tpu_torch.asr.beam_search import lm as lm_module
    seen = []
    real = lm_module.RnnLmAdapter.step

    def step(self, state, tok_prev, t):
        seen.append(flags())
        return real(self, state, tok_prev, t)

    monkeypatch.setattr(lm_module.RnnLmAdapter, "step", step)
    return seen


@pytest.mark.parametrize("command", ["decode", "decode_batch"])
def test_decode_commands_run_at_float32_and_restore(card, workspace,
                                                    monkeypatch, command):
    root, am_dir, lm_dir = workspace
    seen = _record_lm_steps(monkeypatch)
    module = {"decode": decode, "decode_batch": decode_batch}[command]
    stats = module.main([str(root / "wav.scp"), str(root / "best"), "--am",
                         am_dir, "--dict", str(root / "dict"), "--lm",
                         lm_dir, "--lm-weight", "0.3", "--beam-size", "4",
                         "--ctc-weight", "0.4", "--max-len", "8"])
    assert stats["utts"] == 2 and seen
    assert set(seen) == {(False, False)}
    assert flags() == (True, True)


def test_lm_rescore_runs_at_float32_and_restores(card, workspace,
                                                 monkeypatch):
    root, _, lm_dir = workspace
    (root / "nbest").write_text("2\nu0\n-1.0\t2\tw1 w2\n-2.0\t1\tw3\n")
    seen = []
    real = lm_rescore.nn_lm_score

    def score(*args, **kwargs):
        seen.append(flags())
        return real(*args, **kwargs)

    monkeypatch.setattr(lm_rescore, "nn_lm_score", score)
    lm_rescore.main([str(root / "nbest"), str(root / "best"), "--lm",
                     lm_dir, "--dict", str(root / "dict")])
    assert set(seen) == {(False, False)} and len(seen) == 2
    assert flags() == (True, True)
    assert (root / "best").read_text().startswith("u0\t")


def test_separate_runs_at_float32_and_restores(card, tmp_path, monkeypatch):
    torch.manual_seed(4)
    model = aps_sse_nnet("sse@time_tcn")(**TCN_CONF)
    cpt = _checkpoint(tmp_path / "cpt", dict(
        nnet="sse@time_tcn", nnet_conf=TCN_CONF, task="sse@sisnr",
        task_conf={"num_spks": 2}, data_conf={}, trainer_conf={}), model)
    rng = np.random.default_rng(1)
    with open(tmp_path / "mix.scp", "w") as scp:
        for i in range(2):
            write_audio(str(tmp_path / f"m{i}.wav"),
                        0.1 * rng.standard_normal(8000), sr=8000)
            scp.write(f"m{i} {tmp_path / f'm{i}.wav'}\n")
    seen = []
    real_init = separate.Separator.__init__

    def init(self, *args, **kwargs):
        real_init(self, *args, **kwargs)
        forward = self.forward

        def recorded(*fargs, **fkwargs):
            seen.append(flags())
            return forward(*fargs, **fkwargs)

        self.forward = recorded

    monkeypatch.setattr(separate.Separator, "__init__", init)
    for batch in ("1", "2"):
        seen.clear()
        stats = separate.main([str(tmp_path / "mix.scp"),
                               str(tmp_path / f"sep{batch}"), "--checkpoint",
                               cpt, "--sr", "8000", "--batch-size", batch])
        assert stats["utts"] == 2 and seen
        assert set(seen) == {(False, False)}
        assert flags() == (True, True)


def test_trainer_skips_a_batch_on_device_oom(card, tmp_path):
    """A forward that asks for more device memory than the card has: the
    step is skipped, the parameters do not move, and the next step
    trains."""
    lm = aps_asr_nnet("asr@rnn_lm")(**LM_CONF)
    task = aps_task("asr@lm", lm)
    trainer = DataParallelTrainer(task, device=card, checkpoint=tmp_path,
                                  optimizer="adam",
                                  optimizer_kwargs={"lr": 1e-3})
    before = {k: v.clone() for k, v in trainer.task.state_dict().items()}
    src = np.full((2, 8), EOS, dtype=np.int64)
    src[:, 0] = SOS
    egs = {"src": src, "tgt": np.full((2, 8), 5, dtype=np.int64),
           "len": np.array([8, 8])}
    real = lm.forward
    free, _ = torch.cuda.mem_get_info(card)

    def greedy(*args, **kwargs):
        out = real(*args, **kwargs)
        torch.empty(int(free * 2), dtype=torch.uint8, device=card)
        return out

    lm.forward = greedy
    assert trainer.train_one_step(egs) is False
    for key, val in trainer.task.state_dict().items():
        assert torch.equal(val, before[key]), key
    assert len(trainer.optimizer.state) == 0
    assert "device OOM on batch" in (tmp_path / "trainer.log").read_text()
    lm.forward = real
    assert trainer.train_one_step(egs) is True
    assert any(not torch.equal(v, before[k])
               for k, v in trainer.task.state_dict().items())


def test_frequency_domain_commands_on_the_card(card, tmp_path, monkeypatch):
    """wham/run.sh stages 2 to 4 with a toy sse@base_rnn on the card:
    train_ss takes its steps under the recipe's TF32 (the flags read inside
    the model) and restores the flags; separate (time, batched and --mode
    freq) runs at float32 and restores them; compute_ss_metric scores what
    it wrote."""
    import yaml

    from aps_tpu_torch.cmd import compute_ss_metric, train_ss
    from aps_tpu_torch.sse.toy import ToyRNN
    rng = np.random.default_rng(2)
    scps = {name: open(tmp_path / f"{name}.scp", "w")
            for name in ("mix", "s1", "s2")}
    t = np.arange(12800) / 16000
    for n in range(4):
        a = 0.3 * np.sin(2 * np.pi * (300 + 50 * n) * t)
        b = 0.3 * np.sin(2 * np.pi * (2000 + 70 * n) * t)
        mix = a + b + 0.01 * rng.standard_normal(t.size)
        for name, sig in (("mix", mix), ("s1", a), ("s2", b)):
            path = tmp_path / f"{name}{n}.wav"
            write_audio(str(path), sig.astype(np.float32), sr=16000)
            scps[name].write(f"u{n} {path}\n")
    for fd in scps.values():
        fd.close()
    recipe = Path(__file__).resolve().parents[1] / "examples" / "sse" / \
        "wham" / "conf" / "1b_bss_c_16k_max.yaml"
    conf = yaml.safe_load(recipe.read_text())
    conf["nnet_conf"].update(hidden=32, num_layers=2)
    conf["data_conf"]["loader"]["chunk_size"] = 12800
    data = {"mix_scp": str(tmp_path / "mix.scp"),
            "ref_scp": f"{tmp_path / 's1.scp'},{tmp_path / 's2.scp'}"}
    conf["data_conf"]["train"] = conf["data_conf"]["valid"] = data
    (tmp_path / "train.yaml").write_text(json.dumps(conf))
    seen = []
    real = ToyRNN.infer_batch

    def recorded(self, *args, **kwargs):
        seen.append(flags())
        return real(self, *args, **kwargs)

    monkeypatch.setattr(ToyRNN, "infer_batch", recorded)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    trainer = train_ss.main(["--conf", str(tmp_path / "train.yaml"),
                             "--checkpoint", str(tmp_path / "cpt"),
                             "--batch-size", "2", "--epochs", "1"])
    assert trainer.device.type == "cuda" and trainer.cur_step == 2
    # the recipe's matmul_precision bfloat16: TF32 inside the steps
    assert set(seen) == {(True, True)}
    assert flags() == (False, False)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    for name, extra in (("time", []), ("batched", ["--batch-size", "2"]),
                        ("freq", ["--mode", "freq"])):
        seen.clear()
        stats = separate.main([str(tmp_path / "mix.scp"),
                               str(tmp_path / name), "--checkpoint",
                               str(tmp_path / "cpt"), "--sr", "16000"]
                              + extra)
        assert stats["utts"] == 4 and seen
        assert set(seen) == {(False, False)} and flags() == (True, True)
    masks = np.load(tmp_path / "freq" / "u0.npy")
    assert masks.shape == (2, 257, 51) and np.isfinite(masks).all()
    compute_ss_metric.main([f"{tmp_path / 'time' / 'spk1.scp'},"
                            f"{tmp_path / 'time' / 'spk2.scp'}",
                            f"{tmp_path / 's1.scp'},{tmp_path / 's2.scp'}",
                            "--per-utt", str(tmp_path / "per_utt")])
    values = [float(ln.split()[1]) for ln in
              (tmp_path / "per_utt").read_text().splitlines()]
    assert len(values) == 4 and np.isfinite(values).all()
