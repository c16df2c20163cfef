#!/usr/bin/env python
"""PyTorch port, frequency-domain separation as a whole: sse@base_rnn and
sse@freq_tcn in both training modes and through infer, the six tasks of
the slice (loss and every gradient against jax.grad), the converter's
round trip, the four WHAM! recipes from their YAML, and the train_ss,
separate (time and --mode freq, batched) and compute_ss_metric commands
against cmd/separate.py and cmd/compute_ss_metric.py."""

import copy
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from aps_tpu import libs as jax_libs  # noqa: E402
from aps_tpu_torch.cmd import compute_ss_metric, separate, train_ss  # noqa
from aps_tpu_torch.conf import load_ss_conf  # noqa: E402
from aps_tpu_torch.convert import (to_gradients, to_state_dict,  # noqa: E402
                                   to_variables)
from aps_tpu_torch.io import read_audio, write_audio  # noqa: E402
from aps_tpu_torch.libs import aps_sse_nnet, aps_task, aps_transform  # noqa

from test_torch_train import (ZERO_F32, assert_trees_close,  # noqa: E402
                              float64_gradients)

REPO = Path(__file__).resolve().parents[1]
SR = 16000
ENH = dict(feats="spectrogram-log-cmvn", frame_len=64, frame_hop=32,
           window="sqrthann", center=True)
BINS = 33
MODELS = {
    "sse@base_rnn": dict(input_size=BINS, num_bins=BINS, num_spks=2,
                         hidden=12, num_layers=2, dropout=0.0,
                         bidirectional=True, mask_non_linear="relu"),
    "sse@freq_tcn": dict(in_features=BINS, num_bins=BINS, B=2, N=2,
                         conv_channels=16, proj_channels=8),
}
# model outputs (masks of O(1), waveforms of O(0.1)): float32 through two
# recurrent or TCN layers, an STFT and its inverse; relative to the largest
# entry where that is above 1
OUT_ATOL = 1e-5
# the loss relative to itself; each gradient leaf relative to its own
# largest entry. A PReLU slope's gradient is a scalar summed over every
# position: against a float64 pass of the port, the float32 passes land
# up to 1.5e-4 (port) and 1.7e-4 (aps_tpu) of it away (sse@time_mel_sa on
# sse@freq_tcn); the other leaves within 7e-6
LOSS_RTOL = 1e-5
GRAD_RTOL = 5e-4
# waveforms written as 16-bit files: one quantisation step
WAV_ATOL = 1e-5 + 1.0 / 32768


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this file runs: oneDNN's CPU LSTM, which
    torch takes for nn.LSTM, spins its threads and slows down 100-fold
    when other processes load the cores (as the suite's other workers
    do): 8 s a pass against 0.01 s with one thread, measured so."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _leaves(tree, prefix=""):
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(val, dict):
            yield from _leaves(val, path)
        else:
            yield path, np.asarray(val)


def _mixtures(seed, N=3, S=800):
    """Two sources of modulated tones and noise, and their sum."""
    rng = np.random.default_rng(seed)
    t = np.arange(S) / SR
    ref = []
    for spk in range(2):
        f0 = rng.uniform(300, 900, (N, 1)) * (1 + 2 * spk)
        ref.append((0.3 * np.sin(2 * np.pi * f0 * t) *
                    (0.6 + 0.4 * np.sin(2 * np.pi * 7 * t)) +
                    0.02 * rng.standard_normal((N, S))).astype(np.float32))
    return {"mix": ref[0] + ref[1], "ref": ref}


def _pair(name, mode, seed=0, **extra):
    """(flax model, its variables as numpy, the port's model with the same
    weights; BatchNorm statistics moved off their initial values)."""
    conf = dict(MODELS[name], training_mode=mode, **extra)
    jnet = jax_libs.aps_sse_nnet(name)(
        enh_transform=jax_libs.aps_transform("enh")(**ENH), **conf)
    mix = jnp.asarray(_mixtures(seed)["mix"])
    variables = jax.tree_util.tree_map(
        np.array, dict(jnet.init(jax.random.PRNGKey(seed), mix,
                                 training=False)))
    rng = np.random.default_rng(seed + 1)
    for path, val in _leaves(variables):
        if path.startswith("batch_stats"):
            val[...] = 0.1 * rng.standard_normal(val.shape) \
                if path.endswith("mean") else 1 + 0.2 * rng.random(val.shape)
        elif path.endswith("bias"):
            val += 0.05 * rng.standard_normal(val.shape).astype(val.dtype)
    net = aps_sse_nnet(name)(enh_transform=aps_transform("enh")(**ENH),
                             **conf)
    net.load_state_dict(to_state_dict(variables, net))
    return jnet, variables, net


def _close(got, want, atol):
    if not isinstance(want, (list, tuple)):
        got, want = [got], [want]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = g.detach().numpy() if torch.is_tensor(g) else np.asarray(g)
        w = np.asarray(w)
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=atol * max(1, np.abs(w).max()))


@pytest.mark.parametrize("name", sorted(MODELS))
@pytest.mark.parametrize("mode", ["freq", "time"])
def test_model_matches_jax(name, mode):
    """The eval-mode forward (masks N x F x T or waveforms), infer of one
    mixture in time and freq mode, mask_predict, and the converter's round
    trip."""
    jnet, variables, net = _pair(name, mode)
    net.eval()
    mix = _mixtures(2)["mix"]
    with torch.no_grad():
        got = net(torch.from_numpy(mix))
        _close(got, jnet.apply(variables, jnp.asarray(mix), training=False),
               OUT_ATOL)
        assert got[0].shape == ((3, BINS, 26) if mode == "freq" else
                                (3, 800))
        for infer_mode in ("time", "freq"):
            _close(net.infer(torch.from_numpy(mix[1]), mode=infer_mode),
                   jnet.apply(variables, jnp.asarray(mix[1]), infer_mode,
                              method="infer"), OUT_ATOL)
    back = to_variables(net)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(variables)
    for (path, a), (_, b) in zip(sorted(_leaves(back)),
                                 sorted(_leaves(variables))):
        np.testing.assert_array_equal(a, b, err_msg=path)
    if name == "sse@base_rnn":
        feats = np.random.default_rng(3).standard_normal(
            (2, 9, BINS)).astype(np.float32)
        with torch.no_grad():
            _close(net.mask_predict(torch.from_numpy(feats)),
                   jnet.apply(variables, jnp.asarray(feats),
                              method="mask_predict"), OUT_ATOL)


def test_models_refuse_what_aps_tpu_refuses():
    enh = aps_transform("enh")(**ENH)
    with pytest.raises(ValueError, match="softmax"):
        aps_sse_nnet("sse@base_rnn")(enh_transform=enh, num_spks=1,
                                     mask_non_linear="softmax")
    with pytest.raises(ValueError, match="Unsupported nonlinear"):
        aps_sse_nnet("sse@freq_tcn")(enh_transform=enh,
                                     non_linear="softmax")
    with pytest.raises(ValueError, match="enh_transform"):
        aps_sse_nnet("sse@base_rnn")()
    with pytest.raises(RuntimeError, match="Expects 1/2D"):
        aps_sse_nnet("sse@base_rnn")(enh_transform=enh).infer(
            torch.zeros(1, 2, 800))


# task, model, its training mode, task_conf
TASKS = [
    ("sse@snr", "sse@base_rnn", "time", {"snr_max": 30}),
    ("sse@snr", "sse@base_rnn", "time", {"non_nagetive": True}),
    ("sse@wa", "sse@base_rnn", "time", {"objf": "L1"}),
    ("sse@wa", "sse@base_rnn", "time", {"objf": "L2", "permute": False}),
    ("sse@freq_linear_sa", "sse@base_rnn", "freq",
     {"phase_sensitive": True, "truncated": 1}),
    ("sse@freq_linear_sa", "sse@freq_tcn", "freq", {"objf": "L1"}),
    ("sse@freq_mel_sa", "sse@base_rnn", "freq",
     {"num_bins": BINS, "num_mels": 8, "mel_log": True, "power_mag": True,
      "phase_sensitive": True}),
    ("sse@time_linear_sa", "sse@base_rnn", "time",
     {"frame_len": 64, "frame_hop": 32, "center": True,
      "pre_emphasis": 0.97}),
    ("sse@time_mel_sa", "sse@freq_tcn", "time",
     {"num_bins": BINS, "num_mels": 8, "frame_len": 64, "frame_hop": 16,
      "mel_scale": 2.0, "mel_norm": True}),
]


@pytest.mark.parametrize("task_name,name,mode,task_conf", TASKS)
def test_task_loss_and_gradients_match_jax(task_name, name, mode,
                                           task_conf):
    """One training-mode pass (BatchNorm on its batch statistics): the loss
    and the gradient of every parameter against jax.value_and_grad, and
    the batch statistics after it."""
    jnet, variables, net = _pair(name, mode, seed=len(task_conf))
    jtask = jax_libs.aps_task(task_name, jnet, num_spks=2,
                              **copy.deepcopy(task_conf))
    task = aps_task(task_name, net, num_spks=2, **copy.deepcopy(task_conf))
    egs = _mixtures(5)
    jegs = jax.tree_util.tree_map(jnp.asarray, egs)
    params = {"nnet": variables["params"]}
    stats = {"nnet": variables.get("batch_stats", {})}

    def loss_fn(params):
        out, new = jtask.apply({"params": params, "batch_stats": stats},
                               jegs, training=True, mutable=["batch_stats"])
        return out["loss"], new

    (loss, new), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    exact = float64_gradients(task, egs)
    task.train()
    out = task({"mix": torch.from_numpy(egs["mix"]),
                "ref": [torch.from_numpy(r) for r in egs["ref"]]})
    assert sorted(out) == ["loss"]
    out["loss"].backward()
    np.testing.assert_allclose(out["loss"].item(), float(loss),
                               rtol=LOSS_RTOL)
    # a leaf whose float64 gradient is below ZERO_F32 of the model's
    # largest entry sits at float32's resolution: freq_tcn's ScaleLinear
    # scales, which feed a batch norm (cancelled but for its eps: 3e-8 to
    # 1.6e-6 of the largest entry in float64), where both packages'
    # float32 gradients lie 1e-2 to 2.3 of the leaf's own largest entry
    # from the float64 pass; every other leaf within 7e-6
    zeros = assert_trees_close(to_gradients(net), grads["nnet"],
                               rtol=GRAD_RTOL, exact=exact, zero=ZERO_F32)
    assert all(z.endswith("ScaleLinear_0/scale") for z in zeros), zeros
    if "batch_stats" in variables:
        assert_trees_close(to_variables(net)["batch_stats"],
                           new["batch_stats"]["nnet"], rtol=1e-5)


def test_freq_sa_task_refuses_truncation_without_masks():
    _, _, net = _pair("sse@base_rnn", "freq")
    task = aps_task("sse@freq_linear_sa", net, truncated=1, masking=False)
    egs = _mixtures(1)
    with pytest.raises(ValueError, match="conflicts"):
        task({"mix": torch.from_numpy(egs["mix"]),
              "ref": [torch.from_numpy(r) for r in egs["ref"]]})


# ---------------------------------------------------------------------------
# the WHAM! recipes and the commands of wham/run.sh stages 2 to 4
# ---------------------------------------------------------------------------
WHAM = sorted(p.stem for p in (REPO / "examples/sse/wham/conf").glob("*"))
NUM_UTTS = 5


def _write_corpus(root: Path):
    """NUM_UTTS two-speaker mixtures at 16 kHz, 1.0 to 1.4 s, with their
    sources: root/{mix,s1,s2}.scp."""
    rng = np.random.default_rng(40)
    scps = {name: open(root / f"{name}.scp", "w")
            for name in ("mix", "s1", "s2")}
    for n in range(NUM_UTTS):
        S = int(SR * (1.0 + 0.1 * n))
        t = np.arange(S) / SR
        a = 0.3 * np.sin(2 * np.pi * rng.uniform(200, 400) * t)
        b = 0.3 * np.sin(2 * np.pi * rng.uniform(1500, 2500) * t) * \
            (0.5 + 0.5 * np.sin(2 * np.pi * 3 * t))
        a += 0.01 * rng.standard_normal(S)
        for name, sig in (("mix", a + b), ("s1", a), ("s2", b)):
            path = root / f"{name}_{n}.wav"
            write_audio(str(path), sig.astype(np.float32), sr=SR)
            scps[name].write(f"utt{n} {path}\n")
    for fd in scps.values():
        fd.close()


def _recipe(exp: str, root: Path) -> Path:
    """conf/<exp>.yaml as written, its data pointed at the corpus, and only
    sizes patched: 2 layers of 16 units, chunks of 0.8 s (a whole number
    of hops, as the recipe's 64000 samples are: 1b's waveforms come back
    (T - 1) * hop samples long)."""
    conf = load_ss_conf(str(REPO / "examples/sse/wham/conf" / f"{exp}.yaml"))
    conf["nnet_conf"].update(hidden=16, num_layers=2)
    assert conf["data_conf"]["loader"]["chunk_size"] % 256 == 0
    conf["data_conf"]["loader"]["chunk_size"] = 50 * 256
    data = {"mix_scp": str(root / "mix.scp"),
            "ref_scp": f"{root / 's1.scp'},{root / 's2.scp'}"}
    conf["data_conf"]["train"] = conf["data_conf"]["valid"] = data
    path = root / f"{exp}.yaml"
    path.write_text(json.dumps(conf))
    return path


@pytest.fixture(scope="module")
def wham(tmp_path_factory):
    """The corpus and the four recipes trained one epoch (a few CPU steps)
    each through the port's train_ss: {exp: checkpoint directory}."""
    root = tmp_path_factory.mktemp("wham")
    _write_corpus(root)
    cpts = {}
    for exp in WHAM:
        cpt = root / exp
        trainer = train_ss.main([
            "--conf", str(_recipe(exp, root)), "--checkpoint", str(cpt),
            "--batch-size", "2", "--epochs", "1", "--device", "cpu"])
        cpts[exp] = (cpt, trainer)
    return root, cpts


def test_the_four_wham_recipes_train_as_written(wham):
    """sse@base_rnn (BLSTM, the spectrogram-log-cmvn enh transform) under
    sse@freq_linear_sa (tPSA, 1a) and sse@wa (L1 waveforms, 1b), the
    recipes' optimizer, schedule, clipping and TF32 precision: finite
    losses, parameters moved, checkpoints aps_tpu loads."""
    from aps_tpu.eval.wrapper import load_checkpoint as jax_load
    _, cpts = wham
    assert WHAM == ["1a_bss_c_16k_max", "1a_bss_n_16k_max",
                    "1b_bss_c_16k_max", "1b_bss_n_16k_max"]
    for exp, (cpt, trainer) in cpts.items():
        task = trainer.task
        assert type(task).__name__ == ("LinearFreqSaTask" if "1a" in exp
                                       else "WaTask")
        assert trainer.matmul_precision == "bfloat16"
        assert trainer.cur_step >= 2
        losses = [float(v) for v in trainer.reporter.stats["loss"]] or [0]
        assert all(np.isfinite(losses))
        log = (cpt / "trainer.log").read_text()
        assert "Epoch 1" in log or "epoch 1" in log.lower()
        stats = jax_load(str(cpt))
        assert type(stats["nnet"]).__name__ == "ToyRNN"
        assert (task.objf_name == "L1") == ("1b" in exp)


def _jax_command(name):
    """cmd/<name>.py of the JAX package as a module (cmd/ is a directory of
    scripts, and `cmd` is a module of the standard library)."""
    spec = importlib.util.spec_from_file_location(
        f"aps_tpu_cmd_{name}", REPO / "cmd" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _read_sep(sep_dir: Path, key: str):
    return [read_audio(str(sep_dir / f"spk{i}" / f"{key}.wav"), sr=SR)
            for i in (1, 2)]


@pytest.mark.parametrize("exp", ["1a_bss_c_16k_max", "1b_bss_n_16k_max"])
def test_separate_matches_jax_separator(wham, exp, tmp_path):
    """`separate --device cpu` on the trained checkpoint, as run.sh stage
    3 calls it (batch 1, the length grid), with the grid off, batched, and
    with --mode freq, against cmd/separate.py's Separator: run (grid and
    exact length), run(mode="freq") and, for the time-mode recipe,
    run_batch (the BLSTM's reverse direction reads the padding, so only
    the same padding agrees). A freq-mode recipe's batch is separated in
    time mode, as aps_tpu's model separates the same padded batch."""
    root, cpts = wham
    cpt = str(cpts[exp][0])
    common = [str(root / "mix.scp"), "--checkpoint", cpt, "--sr", str(SR),
              "--device", "cpu"]
    runs = {"single": [], "exact": ["--pad-grid", "1"],
            "batched": ["--batch-size", "3"], "freq": ["--mode", "freq"]}
    for name, extra in runs.items():
        argv = common[:1] + [str(tmp_path / name)] + common[1:] + extra
        stats = separate.main(argv)
        assert stats["utts"] == NUM_UTTS
    mixes = {f"utt{n}": read_audio(str(root / f"mix_{n}.wav"), sr=SR)
             for n in range(NUM_UTTS)}
    jsep = _jax_command("separate").Separator(cpt)
    for n, (key, mix) in enumerate(sorted(mixes.items())):
        for run, kwargs in (("single", {}), ("exact", {"pad_grid": 1.0})):
            if run == "exact" and n >= 2:
                continue  # aps_tpu compiles a program for each length
            want = jsep.run(mix, **kwargs)
            for g, w in zip(_read_sep(tmp_path / run, key), want):
                w = np.asarray(w)
                assert g.shape == w.shape
                np.testing.assert_allclose(g, w, atol=WAV_ATOL)
        if n >= 2:
            continue
        want = np.stack([np.asarray(m) for m in jsep.run(mix, mode="freq")])
        got = np.load(tmp_path / "freq" / f"{key}.npy")
        assert got.shape == want.shape == (2, 257, mix.shape[-1] // 256 + 1)
        _close(got, want, OUT_ATOL)
    assert (tmp_path / "single" / "spk1.scp").read_text().count("\n") == \
        NUM_UTTS
    assert not list((tmp_path / "freq").glob("*.scp"))
    keys = sorted(mixes)
    for group in (keys[:3], keys[3:]):
        srcs = [mixes[k] for k in group]
        if "1b" in exp:
            want = jsep.run_batch(srcs)
        else:
            from aps_tpu.loader.utils import quantize_len
            S = quantize_len(max(len(s) for s in srcs), floor=16000,
                             factor=1.25)
            batch = np.stack([np.pad(s, (0, S - len(s))) for s in srcs])
            out = jsep.nnet.apply(jsep.variables, jnp.asarray(batch),
                                  "time", False, method="_infer")
            want = [[np.asarray(o[b, :len(s)]) for o in out]
                    for b, s in enumerate(srcs)]
        for key, per_utt in zip(group, want):
            for g, w in zip(_read_sep(tmp_path / "batched", key), per_utt):
                np.testing.assert_allclose(g, np.asarray(w), atol=WAV_ATOL)


@pytest.mark.parametrize("metric", ["sisnr", "snr", "sdr", "stoi"])
def test_compute_ss_metric_matches_jax_command(wham, metric, tmp_path,
                                               capsys):
    """run.sh stage 4 on the separated wavs of 1b: the port's command and
    cmd/compute_ss_metric.py print the same report line for line and write
    the same per-utterance values and permutations."""
    root, cpts = wham
    sep = tmp_path / "sep"
    separate.main([str(root / "mix.scp"), str(sep), "--checkpoint",
                   str(cpts["1b_bss_c_16k_max"][0]), "--sr", str(SR),
                   "--device", "cpu"])
    jax_cmd = _jax_command("compute_ss_metric")
    reports = []
    for side, fn in (("port", compute_ss_metric.run), ("jax", jax_cmd.run)):
        args = compute_ss_metric.make_parser().parse_args([
            f"{sep / 'spk1.scp'},{sep / 'spk2.scp'}",
            f"{root / 's1.scp'},{root / 's2.scp'}", "--metric", metric,
            "--per-utt", str(tmp_path / f"{side}.utt"), "--utt-ali",
            str(tmp_path / f"{side}.ali")])
        capsys.readouterr()
        fn(args)
        reports.append(capsys.readouterr().out.splitlines())
    assert reports[0] == reports[1]
    assert reports[0][1].endswith(f"{NUM_UTTS} utterances")
    for ext in ("utt", "ali"):
        ours = (tmp_path / f"port.{ext}").read_text()
        assert ours == (tmp_path / f"jax.{ext}").read_text()
        assert ours.count("\n") == NUM_UTTS


def test_compute_ss_metric_single_speaker_and_pesq(wham, capsys):
    """One stream scored without a permutation; pesq raises ImportError
    without pypesq, as in aps_tpu."""
    root, _ = wham
    argv = [str(root / "s1.scp"), str(root / "s1.scp"), "--metric", "snr"]
    compute_ss_metric.main(argv)
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "SNR (dB) Report: "
    with pytest.raises(ImportError, match="pypesq"):
        compute_ss_metric.main(argv[:2] + ["--metric", "pesq"])
