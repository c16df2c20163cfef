#!/usr/bin/env python
"""PyTorch port, the time-domain separation models of the SSE zoo:
sse@time_dprnn and sse@freq_dprnn, sse@demucs (the sinc resampler, infer's
padding), sse@time_sepformer and sse@freq_sepformer against aps_tpu with
converted weights (eval and training-mode outputs, a task's loss and every
gradient against jax.value_and_grad, the batch statistics, the converter's
round trip), and the recipes wsj0_2mix/1b and dns_is2020/1a, and the
Conv-TasNet recipes wsj0_2mix/1a and librimix/1a and 1b, from their YAML
through train_ss and separate against cmd/separate.py's Separator.

The helpers here (zoo_pair, check_model, check_task, ...) serve the other
two files of the zoo, test_torch_sse_cplx.py and test_torch_sse_zoo.py."""

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
from aps_tpu_torch.cmd import separate, train_ss  # noqa: E402
from aps_tpu_torch.conf import load_ss_conf  # noqa: E402
from aps_tpu_torch.convert import (to_gradients, to_state_dict,  # noqa: E402
                                   to_variables)
from aps_tpu_torch.io import read_audio, write_audio  # noqa: E402
from aps_tpu_torch.libs import aps_sse_nnet, aps_task, aps_transform  # noqa

from test_torch_train import ZERO_F32, assert_trees_close  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
SR = 8000
# model outputs (masks of O(1), waveforms of O(0.1-1)) in float32 through a
# few recurrent, conv or attention layers: relative to the largest entry
# where that is above 1
OUT_ATOL = 2e-5
# the loss relative to itself; each gradient leaf relative to its own
# largest entry; a leaf whose float64 gradient is below ZERO of the
# model's largest gradient entry is rounding noise, held to ZERO_F32 of it
# (assert_trees_close)
LOSS_RTOL = 1e-5
GRAD_RTOL = 5e-4
ZERO = 1e-5
# running statistics: 0.9 old + 0.1 batch statistic, relative to the leaf's
# largest entry
STATS_RTOL = 1e-5
# waveforms written as 16-bit files: one quantisation step
WAV_ATOL = 2e-5 + 1.0 / 32768


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while the file runs: oneDNN's CPU LSTM slows
    down 100-fold when other processes load the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def leaves(tree, prefix=""):
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(val, dict):
            yield from leaves(val, path)
        else:
            yield path, np.asarray(val)


def mixtures(seed, N=2, S=1200, sr=SR, spks=2):
    """`spks` sources of modulated tones and noise, and their sum."""
    rng = np.random.default_rng(seed)
    t = np.arange(S) / sr
    ref = []
    for spk in range(spks):
        f0 = rng.uniform(150, 450, (N, 1)) * (1 + 2 * spk)
        ref.append((0.3 * np.sin(2 * np.pi * f0 * t) *
                    (0.6 + 0.4 * np.sin(2 * np.pi * 7 * t)) +
                    0.02 * rng.standard_normal((N, S))).astype(np.float32))
    return {"mix": sum(ref), "ref": ref if spks > 1 else ref[0]}


def zoo_pair(name, conf, enh=None, seed=0, S=1200):
    """(flax model, its variables as numpy, the port's model with the same
    weights). Batch statistics are moved off (0, 1) and biases off 0."""
    jenh = {} if enh is None else {
        "enh_transform": jax_libs.aps_transform("enh")(**enh)}
    tenh = {} if enh is None else {
        "enh_transform": aps_transform("enh")(**enh)}
    jnet = jax_libs.aps_sse_nnet(name)(**jenh, **copy.deepcopy(conf))
    mix = jnp.asarray(mixtures(seed, S=S)["mix"])
    variables = jax.tree_util.tree_map(
        np.array, dict(jax.jit(lambda m: jnet.init(
            jax.random.PRNGKey(seed), m, training=False))(mix)))
    rng = np.random.default_rng(seed + 1)
    for path, val in leaves(variables):
        if path.startswith("batch_stats"):
            val[...] = 0.1 * rng.standard_normal(val.shape) \
                if path.endswith("mean") else 1 + 0.2 * rng.random(val.shape)
        elif path.endswith("bias"):
            val += 0.05 * rng.standard_normal(val.shape).astype(val.dtype)
    net = aps_sse_nnet(name)(**tenh, **copy.deepcopy(conf))
    net.load_state_dict(to_state_dict(variables, net))
    return jnet, variables, net


def close(got, want, atol=OUT_ATOL):
    """got (the port's; complex64 spectra and masks as (real, imag) pairs,
    aps_tpu's packing) within atol of want, relative to want's largest
    entry where that is above 1."""
    if not isinstance(want, (list, tuple)):
        got, want = [got], [want]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if torch.is_tensor(g) and g.is_complex():
            g = torch.view_as_real(g)
        g = g.detach().numpy() if torch.is_tensor(g) else np.asarray(g)
        if torch.is_tensor(w):
            w = torch.view_as_real(w) if w.is_complex() else w
            w = w.detach().numpy()
        w = np.asarray(w)
        assert g.shape == w.shape, (g.shape, w.shape)
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=atol * max(1, np.abs(w).max()))


def check_round_trip(net, variables):
    back = to_variables(net)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(variables)
    for (path, a), (_, b) in zip(sorted(leaves(back)),
                                 sorted(leaves(variables))):
        np.testing.assert_array_equal(a, b, err_msg=path)


def check_model(jnet, variables, net, mix, modes=("time", "freq"),
                atol=OUT_ATOL):
    """The eval-mode forward, infer of one mixture in each mode and the
    converter's round trip; returns the port's eval output."""
    net.eval()
    with torch.no_grad():
        got = net(torch.from_numpy(mix))
    close(got, jax.jit(lambda v, m: jnet.apply(v, m, training=False))(
        variables, jnp.asarray(mix)), atol)
    for mode in modes:
        with torch.no_grad():
            sep = net.infer(torch.from_numpy(mix[1]), mode=mode)
        close(sep, jax.jit(lambda v, m: jnet.apply(
            v, m, mode, method="infer"))(variables, jnp.asarray(mix[1])),
              atol)
    check_round_trip(net, variables)
    return got


def check_task(jnet, variables, net, task_name, task_conf, egs,
               out_atol=OUT_ATOL, grad_rtol=GRAD_RTOL, referee_atol=None,
               loss_rtol=LOSS_RTOL):
    """A training-mode pass: the model's output (BatchNorm on its batch
    statistics), the task's loss and every gradient leaf against
    jax.value_and_grad, the batch statistics after it. Returns the port's
    task output. With referee_atol the two float32 passes (outputs, loss,
    gradients) are each held to a float64 pass of the port instead of to
    each other: a model whose float32 passes drift from float64 by more
    than the bounds of the direct comparison."""
    jtask = jax_libs.aps_task(task_name, jnet, **copy.deepcopy(task_conf))
    task = aps_task(task_name, net, **copy.deepcopy(task_conf))
    jegs = jax.tree_util.tree_map(jnp.asarray, egs)
    stats = variables.get("batch_stats", {})
    mutable = ["batch_stats"]
    # the output in training mode, on a copy (its statistics move)
    train_net = copy.deepcopy(net).train()
    with torch.no_grad():
        got = train_net(torch.from_numpy(egs["mix"]))
    want, _ = jax.jit(lambda v, m: jnet.apply(
        v, m, training=True, mutable=mutable))(variables, jegs["mix"])
    if referee_atol is None:
        close(got, want, out_atol)
    else:
        with torch.no_grad():
            exact = copy.deepcopy(net).double().train()(
                torch.from_numpy(egs["mix"]).double())
        close(got, exact, referee_atol)
        close(want, exact, referee_atol)

    def loss_fn(params):
        out, new = jtask.apply({"params": params,
                                "batch_stats": {"nnet": stats}},
                               jegs, training=True, mutable=mutable)
        return out["loss"], (out, new)

    (loss, (jout, new)), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))({"nnet": variables["params"]})
    ref = egs["ref"]

    def tensors(dtype):
        cast = lambda v: torch.from_numpy(v.astype(dtype))  # noqa: E731
        return {"mix": cast(egs["mix"]),
                "ref": [cast(r) for r in ref] if isinstance(ref, list)
                else cast(ref)}

    exact_task = copy.deepcopy(task).double().train()
    exact_out = exact_task(tensors(np.float64))
    exact_out["loss"].backward()
    exact = to_gradients(exact_task.nnet)
    task.train()
    out = task(tensors(np.float32))
    assert sorted(out) == sorted(jout)
    out["loss"].backward()
    if referee_atol is None:
        for key in out:
            np.testing.assert_allclose(out[key].item(), float(jout[key]),
                                       rtol=loss_rtol, err_msg=key)
        assert_trees_close(to_gradients(net), grads["nnet"], rtol=grad_rtol,
                           exact=exact, zero=ZERO)
    else:
        # each float32 side against the float64 pass: the loss within
        # loss_rtol, each gradient leaf within grad_rtol of its own largest
        # entry plus ZERO_F32 of the model's largest (a leaf near 0 in
        # float64 sits at float32's resolution of the largest)
        top = max(float(np.abs(v).max()) for _, v in leaves(exact))
        for side_out, side_grads in ((out, to_gradients(net)),
                                     (jout, grads["nnet"])):
            for key in out:
                val = side_out[key]
                val = val.item() if torch.is_tensor(val) else float(val)
                np.testing.assert_allclose(val,
                                           exact_out[key].item(),
                                           rtol=loss_rtol, err_msg=key)
            assert_trees_close(side_grads, exact, rtol=grad_rtol,
                               atol=ZERO_F32 * top)
    if stats:
        assert_trees_close(to_variables(net)["batch_stats"],
                           new["batch_stats"]["nnet"], rtol=STATS_RTOL)
    return out


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------
ENH = dict(feats="spectrogram-log-cmvn", frame_len=64, frame_hop=32,
           window="sqrthann", center=True)
BINS = 33
MODELS = {
    # S = 1200: 299 encoder frames, chunks of 10 with hop 5 cover 295 of
    # them: the last four frames of every mask are 0 (the dropped tail)
    "sse@time_dprnn": (dict(num_spks=2, num_bins=8, kernel=8, stride=4,
                            chunk_size=10, num_layers=2, rnn_hidden=6),
                       None),
    "sse@freq_dprnn": (dict(num_spks=2, num_bins=BINS, chunk_size=6,
                            num_layers=1, rnn_hidden=6,
                            bidirectional=False), ENH),
    "sse@demucs": (dict(channel=4, stride=4, kernel=8, resampling_factor=4,
                        num_layers=3, rnn_layers=2, growth=2,
                        bidirectional=False), None),
    "sse@time_sepformer": (dict(num_bins=8, kernel=8, stride=4,
                                num_blocks=1, num_layers=1, chunk_size=16,
                                arch_kwargs=dict(att_dim=16, nhead=2,
                                                 feedforward_dim=24,
                                                 att_dropout=0.0,
                                                 ffn_dropout=0.0)), None),
    "sse@freq_sepformer": (dict(num_bins=BINS, num_blocks=1, num_layers=1,
                                chunk_size=8,
                                arch_kwargs=dict(att_dim=16, nhead=2,
                                                 feedforward_dim=24,
                                                 att_dropout=0.0,
                                                 ffn_dropout=0.0)), ENH),
}


def _pair(name, seed=0, **extra):
    conf, enh = MODELS[name]
    return zoo_pair(name, dict(conf, **extra), enh=enh, seed=seed)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_model_matches_jax(name):
    """The eval forward, infer (time and, for a frequency-domain model,
    freq) and the converter's round trip."""
    jnet, variables, net = _pair(name)
    mix = mixtures(2)["mix"]
    got = check_model(jnet, variables, net, mix,
                      modes=("time", "freq") if MODELS[name][1] else
                      ("time",))
    if name == "sse@time_dprnn":
        # the masks of the 4 encoder frames past the last whole chunk are
        # 0: the decoder gives 0 from sample 295 * 4 on, but for the
        # overlap of the last live frame's 8 taps
        for sep in got:
            assert sep.shape == (2, 1200)
            assert torch.all(sep[:, 296 * 4:] == 0)
            assert torch.all(sep[:, :295 * 4].abs().amax(-1) > 0)


# task, model, task_conf
TASKS = [
    ("sse@sisnr", "sse@time_dprnn", {"num_spks": 2, "zero_mean": False}),
    ("sse@freq_linear_sa", "sse@freq_dprnn",
     {"num_spks": 2, "phase_sensitive": True, "truncated": 1}),
    ("sse@wa", "sse@demucs", {"num_spks": 1, "permute": False,
                              "objf": "L1"}),
    ("sse@sisnr", "sse@time_sepformer", {"num_spks": 2}),
    ("sse@freq_linear_sa", "sse@freq_sepformer", {"num_spks": 2}),
]


@pytest.mark.parametrize("task_name,name,task_conf", TASKS)
def test_task_loss_and_gradients_match_jax(task_name, name, task_conf):
    S = 1200
    if name == "sse@demucs":
        # a length the U-net gives back whole, as the recipe's chunk is
        from aps_tpu_torch.sse.enh.demucs import workout_train_chunk_length
        S = workout_train_chunk_length(S, 4, 3, 8, 4)
    jnet, variables, net = _pair(name, seed=3)
    egs = mixtures(5, S=S, spks=task_conf["num_spks"])
    check_task(jnet, variables, net, task_name, task_conf, egs)


def test_demucs_resampler_and_infer_padding():
    """upsample2 / downsample2 against aps_tpu's (the sinc kernel, its
    trims, an odd length), workout_train_chunk_length, the population std
    (correction 0) and `rescale`, a field neither package reads."""
    from aps_tpu.sse.enh import demucs as jax_demucs
    from aps_tpu_torch.sse.enh import demucs
    rng = np.random.default_rng(9)
    for S in (401, 400):
        x = rng.standard_normal((2, S)).astype(np.float32)
        close(demucs.upsample2(torch.from_numpy(x)),
              jax_demucs.upsample2(jnp.asarray(x)), 1e-6)
        close(demucs.downsample2(torch.from_numpy(x)),
              jax_demucs.downsample2(jnp.asarray(x)), 1e-6)
    for args in ((32085, 4, 5, 8, 4), (1200, 4, 3, 8, 4), (999, 1, 5, 8, 2)):
        assert demucs.workout_train_chunk_length(*args) == \
            jax_demucs.workout_train_chunk_length(*args)
    conf, _ = MODELS["sse@demucs"]
    jnet, variables, net = zoo_pair("sse@demucs", dict(conf, rescale=7.0))
    _, _, plain = zoo_pair("sse@demucs", conf)
    mix = mixtures(4, N=1, S=1000)["mix"][0]
    net.eval()
    plain.eval()
    with torch.no_grad():
        got = net.infer(torch.from_numpy(mix))
        assert torch.equal(got, plain.infer(torch.from_numpy(mix)))
    assert got.shape == (1000,)
    close(got, jnet.apply(variables, jnp.asarray(mix), method="infer"))


def test_sepformer_takes_the_flash_path(monkeypatch):
    """A chunk transformer's abs self-attention goes through
    flash_attention (the plain version on a CPU tensor, K2 on the card) at
    the chunk's length, once a layer and block, in eval and in training
    without attention dropout; with att_dropout it takes the dense path."""
    from aps_tpu_torch.asr.transformer import impl
    calls = []
    real = impl.flash_attention

    def counted(q, *args, **kwargs):
        calls.append(tuple(q.shape))
        return real(q, *args, **kwargs)

    monkeypatch.setattr(impl, "flash_attention", counted)
    mix = torch.from_numpy(mixtures(1)["mix"])
    conf, _ = MODELS["sse@time_sepformer"]
    for att_dropout, training, want in ((0.0, False, 2), (0.0, True, 2),
                                        (0.1, True, 0), (0.1, False, 2)):
        arch = dict(conf["arch_kwargs"], att_dropout=att_dropout)
        net = aps_sse_nnet("sse@time_sepformer")(
            **dict(conf, arch_kwargs=arch)).train(training)
        calls.clear()
        net(mix)
        assert len(calls) == want, (att_dropout, training, calls)
    # 299 frames in chunks of 16 with hop 8: 36 chunks; the first block runs
    # over the chunks (N K = 32 sequences of 36), the second inside them
    assert calls == [(32, 2, 36, 8), (72, 2, 16, 8)]


def test_models_refuse_what_aps_tpu_refuses():
    with pytest.raises(RuntimeError, match="Expects 2D"):
        aps_sse_nnet("sse@time_dprnn")(num_bins=8, chunk_size=4,
                                       num_layers=1)(torch.zeros(1, 2, 64))
    with pytest.raises(ValueError, match="enh_transform"):
        aps_sse_nnet("sse@freq_dprnn")()
    with pytest.raises(ValueError, match="resampling_factor"):
        aps_sse_nnet("sse@demucs")(resampling_factor=3)


# ---------------------------------------------------------------------------
# wsj0_2mix/1b, dns_is2020/1a and the Conv-TasNet recipes: train_ss from the
# YAML, separate against cmd/separate.py
# ---------------------------------------------------------------------------
NUM_UTTS = 4
RECIPES = {
    # recipe -> (sample rate, number of references, nnet_conf sizes, the
    # loader's chunk: 0.4 s, for DEMUCS the length its U-net gives back
    # whole, as the recipe's 32085 samples are)
    "wsj0_2mix/1b": (8000, 2, dict(num_bins=8, chunk_size=10, num_layers=1,
                                   rnn_hidden=6), 3200),
    "dns_is2020/1a": (16000, 1, dict(channel=4, num_layers=3), 6405),
    # sse@time_tcn (IN, scaling_param) at one repeat of two blocks, L as
    # written (librimix: 40 samples; 1a also sets matmul_precision
    # bfloat16, TF32 on a card and nothing on the CPU)
    "wsj0_2mix/1a": (8000, 2, dict(N=8, B=8, H=12, X=2, R=1), 3200),
    "librimix/1a": (16000, 2, dict(N=8, B=8, H=12, X=2, R=1), 6400),
    "librimix/1b": (16000, 2, dict(N=8, B=8, H=12, X=2, R=1), 6400),
}
# the model each recipe's checkpoint builds in aps_tpu
RECIPE_MODELS = {"wsj0_2mix/1b": "TimeDPRNN", "dns_is2020/1a": "DEMUCS",
                 "wsj0_2mix/1a": "TimeConvTasNet",
                 "librimix/1a": "TimeConvTasNet",
                 "librimix/1b": "TimeConvTasNet"}


def write_corpus(root: Path, sr: int, spks: int, num_utts=NUM_UTTS):
    """num_utts mixtures of 0.5 to 0.65 s with their references:
    root/mix.scp and root/s<i>.scp."""
    rng = np.random.default_rng(40)
    names = ["mix"] + [f"s{i + 1}" for i in range(spks)]
    scps = {name: open(root / f"{name}.scp", "w") for name in names}
    for n in range(num_utts):
        S = int(sr * (0.5 + 0.05 * n))
        t = np.arange(S) / sr
        srcs = [0.3 * np.sin(2 * np.pi * rng.uniform(200, 400) * t),
                0.3 * np.sin(2 * np.pi * rng.uniform(1500, 2500) * t) *
                (0.5 + 0.5 * np.sin(2 * np.pi * 3 * t))]
        srcs[0] += 0.01 * rng.standard_normal(S)
        sigs = [("mix", srcs[0] + srcs[1])]
        sigs += [(f"s{i + 1}", srcs[i]) for i in range(spks)]
        for name, sig in sigs:
            path = root / f"{name}_{n}.wav"
            write_audio(str(path), sig.astype(np.float32), sr=sr)
            scps[name].write(f"utt{n} {path}\n")
    for fd in scps.values():
        fd.close()


def recipe_yaml(recipe: str, root: Path, sizes: dict, chunk: int) -> Path:
    """examples/sse/<recipe>.yaml as written, its data pointed at the corpus
    and only sizes patched."""
    exp, name = recipe.split("/")
    conf = load_ss_conf(str(REPO / "examples/sse" / exp / "conf" /
                            f"{name}.yaml"))
    conf["nnet_conf"].update(sizes)
    conf["data_conf"]["loader"]["chunk_size"] = chunk
    refs = sorted(root.glob("s*.scp"))
    data = {"mix_scp": str(root / "mix.scp"),
            "ref_scp": ",".join(str(r) for r in refs)}
    conf["data_conf"]["train"] = conf["data_conf"]["valid"] = data
    path = root / f"{name}.yaml"
    path.write_text(json.dumps(conf))
    return path


def train_recipe(recipe: str, root: Path, sizes: dict, chunk: int):
    """train_ss --device cpu, one epoch of batch 2: (checkpoint, trainer)."""
    cpt = root / "exp"
    trainer = train_ss.main([
        "--conf", str(recipe_yaml(recipe, root, sizes, chunk)),
        "--checkpoint", str(cpt), "--batch-size", "2", "--epochs", "1",
        "--device", "cpu"])
    return cpt, trainer


def jax_command(name):
    """cmd/<name>.py of the JAX package as a module."""
    spec = importlib.util.spec_from_file_location(
        f"aps_tpu_cmd_{name}", REPO / "cmd" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def read_sep(sep_dir: Path, key: str, spks: int, sr: int):
    if spks == 1:
        return [read_audio(str(sep_dir / f"{key}.wav"), sr=sr)]
    return [read_audio(str(sep_dir / f"spk{i}" / f"{key}.wav"), sr=sr)
            for i in range(1, spks + 1)]


def as_written(wav, tmp: Path, sr: int) -> np.ndarray:
    """A waveform as a 16-bit file holds it (clipped to [-1, 1))."""
    path = tmp / "as_written.wav"
    write_audio(str(path), np.asarray(wav), sr=sr)
    return read_audio(str(path), sr=sr)


def check_separate(root: Path, cpt: Path, sr: int, spks: int, tmp: Path,
                   batch_check=None):
    """run.sh stage 3 (`separate --device cpu`, batch 1 on the length grid)
    and a batched run, against cmd/separate.py's Separator.run and, for the
    batch, `batch_check(jsep, srcs)` (each row's expected outputs)."""
    runs = {"single": [], "batched": ["--batch-size", "2"]}
    for run, extra in runs.items():
        stats = separate.main([str(root / "mix.scp"), str(tmp / run),
                               "--checkpoint", str(cpt), "--sr", str(sr),
                               "--device", "cpu"] + extra)
        assert stats["utts"] == NUM_UTTS
    jsep = jax_command("separate").Separator(str(cpt))
    mixes = [read_audio(str(root / f"mix_{n}.wav"), sr=sr)
             for n in range(NUM_UTTS)]
    for n, mix in enumerate(mixes):
        want = jsep.run(mix)
        want = want if isinstance(want, (list, tuple)) else [want]
        for g, w in zip(read_sep(tmp / "single", f"utt{n}", spks, sr), want):
            assert g.shape == np.asarray(w).shape == mix.shape
            np.testing.assert_allclose(g, as_written(w, tmp, sr),
                                       atol=WAV_ATOL)
    scp = tmp / "single" / ("wav.scp" if spks == 1 else "spk1.scp")
    assert scp.read_text().count("\n") == NUM_UTTS
    if batch_check is None:
        return
    for group in ((0, 1), (2, 3)):
        want = batch_check(jsep, [mixes[n] for n in group])
        for n, per_utt in zip(group, want):
            per_utt = per_utt if isinstance(per_utt, list) else [per_utt]
            for g, w in zip(read_sep(tmp / "batched", f"utt{n}", spks, sr),
                            per_utt):
                np.testing.assert_allclose(g, as_written(w, tmp, sr),
                                           atol=WAV_ATOL)


@pytest.mark.parametrize("recipe", sorted(RECIPES))
def test_recipe_trains_and_separates(recipe, tmp_path):
    """The recipe's model, task, optimizer, schedule, clipping and
    precision through train_ss (finite losses, a checkpoint aps_tpu
    loads), then separate against aps_tpu's Separator on that checkpoint:
    batch 1 as run.sh stage 3 runs it (DEMUCS through infer, which pads
    the input to workout_train_chunk_length), and batched: TimeDPRNN and
    TimeConvTasNet as aps_tpu's run_batch, DEMUCS through infer on each
    padded row (aps_tpu's
    run_batch calls the model without infer's padding, which loses the
    tail: the port pads)."""
    from aps_tpu.eval.wrapper import load_checkpoint as jax_load
    from aps_tpu.loader.utils import quantize_len
    from aps_tpu_torch.sse.enh.demucs import workout_train_chunk_length
    sr, spks, sizes, chunk = RECIPES[recipe]
    if spks == 1:
        assert workout_train_chunk_length(32085, 4, 5, 8, 4) == 32085
        assert workout_train_chunk_length(chunk, 4, 3, 8, 4) == chunk
    root = tmp_path / "data"
    root.mkdir()
    write_corpus(root, sr, spks)
    cpt, trainer = train_recipe(recipe, root, sizes, chunk)
    task = trainer.task
    assert type(task).__name__ == ("SisnrTask" if spks == 2 else "WaTask")
    assert trainer.cur_step >= 2
    assert all(np.isfinite(float(v)) for v in trainer.reporter.stats["loss"])
    nnet = jax_load(str(cpt))["nnet"]
    assert type(nnet).__name__ == RECIPE_MODELS[recipe]

    def batch_check(jsep, srcs):
        if spks == 2:
            return jsep.run_batch(srcs)
        S = quantize_len(max(len(s) for s in srcs), floor=16000,
                         factor=1.25)
        return [np.asarray(jsep.nnet.apply(
            jsep.variables, jnp.asarray(np.pad(s, (0, S - len(s)))),
            method="infer"))[:len(s)] for s in srcs]

    check_separate(root, cpt, sr, spks, tmp_path, batch_check)
