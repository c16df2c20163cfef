#!/usr/bin/env python
"""PyTorch port, the separation slice as a whole: sisnr_objf and the
permutation-invariant objectives against aps_tpu; task sse@sisnr on a small
Conv-TasNet with converted weights (loss, every gradient, batch statistics
and two clip + Adam steps against optax); the se@chunk loader's batches; and
the separate and train_ss commands on a tiny corpus, against cmd/separate.py's
Separator."""

import copy
import importlib.util
import json
import pickle
import random
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from aps_tpu import libs as jax_libs  # noqa: E402
from aps_tpu.task import objf as jax_objf  # noqa: E402
from aps_tpu_torch.convert import (to_gradients, to_state_dict,  # noqa: E402
                                   to_variables)
from aps_tpu_torch.io import read_audio, write_audio  # noqa: E402
from aps_tpu_torch.libs import (aps_dataloader, aps_sse_nnet,  # noqa: E402
                                aps_task, aps_trainer)
from aps_tpu_torch.task import objf  # noqa: E402

from test_torch_train import (ZERO_F32, assert_trees_close,  # noqa: E402
                              float64_gradients)

REPO = Path(__file__).resolve().parents[1]
NNET_CONF = dict(L=20, N=32, X=2, R=2, B=32, H=64, num_spks=2)
# SiSNR in dB of O(1) random signals: float32 sums of 4000 terms, then log10
OBJF_ATOL = 1e-4
# the loss is a mean of SiSNR values (~ -30 dB at random weights)
LOSS_RTOL = 1e-5
# a gradient leaf sums the batch's contributions in another order; its
# bound is relative to the leaf's largest entry (at least 1)
GRAD_RTOL = 2e-4
STATS_RTOL = 1e-5
# parameters after two Adam steps of rate 1e-3
STEP_ATOL = 2e-5
# separated waveforms written as 16-bit files: one quantisation step
WAV_ATOL = 1e-5 + 1.0 / 32768


def _leaves(tree, prefix=""):
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(val, dict):
            yield from _leaves(val, path)
        else:
            yield path, np.asarray(val)


@pytest.mark.parametrize("zero_mean,non_nagetive", [(True, False),
                                                    (False, False),
                                                    (True, True)])
def test_sisnr_objf_matches_jax(zero_mean, non_nagetive):
    rng = np.random.default_rng(1)
    s = rng.standard_normal((5, 4000)).astype(np.float32)
    x = (0.7 * s + 0.5 * rng.standard_normal((5, 4000)) + 0.1).astype(
        np.float32)
    got = objf.sisnr_objf(torch.from_numpy(x), torch.from_numpy(s),
                          zero_mean=zero_mean, non_nagetive=non_nagetive)
    want = jax_objf.sisnr_objf(jnp.asarray(x), jnp.asarray(s),
                               zero_mean=zero_mean,
                               non_nagetive=non_nagetive)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=OBJF_ATOL)
    with pytest.raises(RuntimeError, match="Shape mismatch"):
        objf.sisnr_objf(torch.zeros(2, 5), torch.zeros(2, 6))


def _neg_sisnr(package):
    return lambda o, r: -package.sisnr_objf(o, r)


@pytest.mark.parametrize("num_spks", [1, 2, 3])
def test_permutation_invariant_objf_matches_jax(num_spks):
    """The minimum over permutations in itertools order, with the winning
    permutation's index, on sources given in a shuffled order."""
    rng = np.random.default_rng(num_spks)
    ref = [rng.standard_normal((4, 2000)).astype(np.float32)
           for _ in range(num_spks)]
    order = rng.permutation(num_spks)
    out = [(ref[i] + 0.3 * rng.standard_normal((4, 2000))).astype(np.float32)
           for i in order]
    tout, tref = ([torch.from_numpy(a) for a in side] for side in (out, ref))
    jout, jref = ([jnp.asarray(a) for a in side] for side in (out, ref))
    if num_spks == 1:
        got = objf.permu_invarint_objf(tout, tref, _neg_sisnr(objf))
        want = jax_objf.permu_invarint_objf(jout, jref, _neg_sisnr(jax_objf))
    else:
        got, index = objf.permutation_invariant_objf(
            tout, tref, _neg_sisnr(objf), return_permutation=True)
        want, jindex = jax_objf.permu_invarint_objf(
            jout, jref, _neg_sisnr(jax_objf), return_permutation=True)
        np.testing.assert_array_equal(index.numpy(), np.asarray(jindex))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=OBJF_ATOL)
    assert (got < -5).all()  # the right pairing was found
    with pytest.raises(ValueError, match="#inp vs #ref"):
        objf.permu_invarint_objf(tout, tref + tref, _neg_sisnr(objf))


@pytest.mark.parametrize("permute,weight", [(True, None), (True, [0.6, 0.4]),
                                            (False, None),
                                            (False, [0.2, 0.3, 0.5])])
def test_hybrid_permu_objf_matches_jax(permute, weight):
    """PIT over the first two branches plus a weighted third (a noise
    output), and the plain weighted sum."""
    rng = np.random.default_rng(7)
    ref = [rng.standard_normal((3, 1500)).astype(np.float32)
           for _ in range(3)]
    out = [(r + 0.4 * rng.standard_normal(r.shape)).astype(np.float32)
           for r in (ref[1], ref[0], ref[2])]
    got = objf.hybrid_permu_objf(
        [torch.from_numpy(a) for a in out],
        [torch.from_numpy(a) for a in ref], _neg_sisnr(objf), weight=weight,
        permute=permute, permu_num_spks=2)
    want = jax_objf.hybrid_permu_objf(
        [jnp.asarray(a) for a in out], [jnp.asarray(a) for a in ref],
        _neg_sisnr(jax_objf), weight=weight, permute=permute,
        permu_num_spks=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=OBJF_ATOL)
    batch = objf.multiple_objf([torch.from_numpy(a) for a in out],
                               [torch.from_numpy(a) for a in ref],
                               _neg_sisnr(objf), batchmean=True)
    assert batch.dim() == 0
    with pytest.raises(RuntimeError, match="references"):
        objf.hybrid_permu_objf([torch.zeros(1, 4)], [], _neg_sisnr(objf))


def make_batch(seed, N=3, S=4010):
    rng = np.random.default_rng(seed)
    t = np.arange(S) / 8000
    ref = []
    for spk in range(2):
        f0 = rng.uniform(150, 400, (N, 1)) * (1 + spk)
        ref.append((0.3 * np.sin(2 * np.pi * f0 * t) +
                    0.02 * rng.standard_normal((N, S))).astype(np.float32))
    return {"mix": ref[0] + ref[1], "ref": ref}


@pytest.fixture(scope="module")
def slice_pair():
    """(flax task, its variables as numpy with shifted statistics, the
    port's task with the same weights, a batch)."""
    jnnet = jax_libs.aps_sse_nnet("sse@time_tcn")(**NNET_CONF)
    jtask = jax_libs.aps_task("sse@sisnr", jnnet, num_spks=2, permute=True)
    egs = make_batch(11)
    jegs = jax.tree_util.tree_map(jnp.asarray, egs)
    variables = jtask.init(jax.random.PRNGKey(0), jegs, training=True)
    variables = jax.tree_util.tree_map(np.array, dict(variables))
    rng = np.random.default_rng(5)
    for path, val in _leaves(variables["batch_stats"]):
        val[...] = 0.1 * rng.standard_normal(val.shape) \
            if path.endswith("mean") else 1 + 0.2 * rng.random(val.shape)
    task = aps_task("sse@sisnr", aps_sse_nnet("sse@time_tcn")(**NNET_CONF),
                    num_spks=2, permute=True)
    task.nnet.load_state_dict(to_state_dict(
        {"params": variables["params"]["nnet"],
         "batch_stats": variables["batch_stats"]["nnet"]}, task.nnet))
    return jtask, variables, task, egs


def jax_loss_and_grads(jtask, variables, egs):
    jegs = jax.tree_util.tree_map(jnp.asarray, egs)

    def loss_fn(params):
        out, new_state = jtask.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jegs, training=True, mutable=["batch_stats"])
        return out["loss"], new_state

    (loss, new_state), grads = jax.value_and_grad(
        loss_fn, has_aux=True)(variables["params"])
    return loss, new_state["batch_stats"], grads


def _to_torch(egs):
    return {"mix": torch.from_numpy(egs["mix"]),
            "ref": [torch.from_numpy(r) for r in egs["ref"]]}


def test_sisnr_task_step_matches_jax(slice_pair):
    """Loss, every parameter gradient and the batch_stats after one
    training-mode pass of sse@sisnr."""
    jtask, variables, task, egs = slice_pair
    task = copy.deepcopy(task).train()
    stats = task(_to_torch(egs))
    stats["loss"].backward()
    loss, want_stats, want_grads = jax_loss_and_grads(jtask, variables, egs)
    assert sorted(stats) == ["loss"]
    np.testing.assert_allclose(stats["loss"].item(), float(loss),
                               rtol=LOSS_RTOL)
    # a leaf whose float64 gradient is below ZERO_F32 of the model's
    # largest entry sits at float32's resolution (its entries sum terms as
    # large as that entry): the ScaleLinear scales that feed a batch norm
    # (cancelled but for its eps: 2e-11 to 3e-9 of the largest entry in
    # float64), three batch norms' scales behind them (up to 2e-6) and the
    # decoder's bias before the SiSNR (4.5e-16). Against the float64 pass
    # both packages' float32 gradients lie 2e-3 to 8e2 of such a leaf's own
    # largest entry away, the other leaves' within GRAD_RTOL
    zeros = assert_trees_close(to_gradients(task.nnet), want_grads["nnet"],
                               rtol=GRAD_RTOL,
                               exact=float64_gradients(slice_pair[2], egs),
                               zero=ZERO_F32)
    assert zeros == [
        "conv/block_0_0/ScaleLinear_0/scale",
        "conv/block_0_1/NormalizeLayer_0/BatchNorm_0/scale",
        "conv/block_0_1/ScaleLinear_0/scale",
        "conv/block_1_0/NormalizeLayer_0/BatchNorm_0/scale",
        "conv/block_1_0/ScaleLinear_0/scale",
        "conv/block_1_1/NormalizeLayer_0/BatchNorm_0/scale",
        "conv/block_1_1/ScaleLinear_0/scale", "decoder/bias"], zeros
    assert_trees_close(to_variables(task.nnet)["batch_stats"],
                       want_stats["nnet"], rtol=STATS_RTOL)
    before = dict(_leaves(variables["batch_stats"]["nnet"]))
    after = dict(_leaves(want_stats["nnet"]))
    assert all(np.abs(after[k] - before[k]).max() > 1e-4 for k in before)


def test_sisnr_task_eval_matches_jax(slice_pair):
    jtask, variables, task, egs = slice_pair
    task = copy.deepcopy(task).eval()
    with torch.no_grad():
        stats = task(_to_torch(egs))
    want = jtask.apply(variables, jax.tree_util.tree_map(jnp.asarray, egs),
                       training=False)
    np.testing.assert_allclose(stats["loss"].item(), float(want["loss"]),
                               rtol=LOSS_RTOL)


TRAINER_CONF = dict(
    optimizer="adam",
    # eps well above the gradients' rounding noise (see test_torch_train.py)
    optimizer_kwargs={"lr": 1e-3, "eps": 1e-3, "weight_decay": 1e-5},
    lr_scheduler="reduce_lr",
    lr_scheduler_kwargs={"min_lr": 1e-8, "patience": 1, "factor": 0.5},
    clip_gradient=10.0,
    report_metrics=["loss"],
)


def test_two_trainer_steps_match_optax(slice_pair, tmp_path):
    """Two steps of the port's trainer on sse@sisnr == clip_by_global_norm
    -> adam at rate 1 scaled by the rate, as aps_tpu's trainer builds them
    from the same optimizer_kwargs (weight_decay has no effect there)."""
    jtask, variables, task, _ = slice_pair
    trainer = aps_trainer("dp")(copy.deepcopy(task), device="cpu",
                                checkpoint=tmp_path, reduction_tag="#utt",
                                **TRAINER_CONF)
    tx = optax.chain(optax.clip_by_global_norm(10.0),
                     optax.adam(1.0, eps=1e-3))
    params, state = variables["params"], variables["batch_stats"]
    opt_state = tx.init(params)
    for step in range(2):
        egs = make_batch(20 + step)
        assert trainer.train_one_step(dict(egs, **{"#utt": 3}))
        loss, state, grads = jax_loss_and_grads(
            jtask, {"params": params, "batch_stats": state}, egs)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(
            params, jax.tree_util.tree_map(lambda u: u * 1e-3, updates))
        np.testing.assert_allclose(float(trainer.reporter.stats["norm"][-1]),
                                   float(optax.global_norm(grads)),
                                   rtol=1e-4)
        np.testing.assert_allclose(float(trainer.reporter.stats["loss"][-1]),
                                   float(loss), rtol=1e-4)
    got = to_variables(trainer.task.nnet)
    assert_trees_close(got["params"], params["nnet"], atol=STEP_ATOL)
    assert_trees_close(got["batch_stats"], state["nnet"], rtol=STATS_RTOL)
    moved = dict(_leaves(variables["params"]["nnet"]))
    after = dict(_leaves(got["params"]))
    assert max(np.abs(after[k] - moved[k]).max() for k in moved) > 1e-3


def _write_corpus(root: Path, num_utts: int = 6, sr: int = 8000):
    """Two-speaker mixtures of tones with a little noise, 0.9 to 2.4 s."""
    rng = np.random.default_rng(40)
    scps = {name: open(root / f"{name}.scp", "w")
            for name in ("mix", "spk1", "spk2")}
    for n in range(num_utts):
        S = int(sr * (0.9 + 0.3 * n))
        t = np.arange(S) / sr
        a = 0.3 * np.sin(2 * np.pi * rng.uniform(200, 400) * t)
        b = 0.3 * np.sin(2 * np.pi * rng.uniform(500, 800) * t)
        a += 0.01 * rng.standard_normal(S)
        for name, sig in (("mix", a + b), ("spk1", a), ("spk2", b)):
            path = root / f"{name}_{n}.wav"
            write_audio(str(path), sig.astype(np.float32), sr=sr)
            scps[name].write(f"utt{n} {path}\n")
    for fd in scps.values():
        fd.close()


def _data_conf(root: Path):
    data = dict(mix_scp=str(root / "mix.scp"),
                ref_scp=f"{root / 'spk1.scp'},{root / 'spk2.scp'}")
    return dict(fmt="se@chunk", loader=dict(chunk_size=4000, sr=8000),
                train=data, valid=data)


def test_se_chunk_loader_matches_jax_package(tmp_path):
    """The port's se@chunk loader gives aps_tpu's batches on the same
    corpus with Python's generator seeded alike: validation order and two
    shuffled training epochs, bit-equal arrays."""
    _write_corpus(tmp_path)
    conf = _data_conf(tmp_path)
    kwargs = dict(fmt=conf["fmt"], max_batch_size=3, **conf["loader"],
                  **conf["train"])
    num_batches = 0
    for train, epoch in ((False, 0), (True, 0), (True, 1)):
        sides = []
        for package in (aps_dataloader, jax_libs.aps_dataloader):
            loader = package(train=train, **kwargs)
            loader.set_epoch(epoch)
            random.seed(100 + epoch)
            sides.append(list(loader))
        ours, theirs = sides
        assert len(ours) == len(theirs) > 1
        for got, want in zip(ours, theirs):
            assert sorted(got) == sorted(want) == ["#utt", "mix", "ref"]
            assert got["#utt"] == want["#utt"] == 3
            np.testing.assert_array_equal(got["mix"], want["mix"])
            assert got["mix"].shape == (3, 4000)
            assert got["mix"].dtype == np.float32
            for g, w in zip(got["ref"], want["ref"]):
                np.testing.assert_array_equal(g, w)
        num_batches += len(ours)
    assert num_batches >= 6
    # an embedding a mixture rides along with its chunks, as in aps_tpu
    with open(tmp_path / "emb.scp", "w") as scp:
        for key in [ln.split()[0] for ln in
                    (tmp_path / "mix.scp").read_text().splitlines()]:
            np.save(tmp_path / f"{key}.npy",
                    np.full(4, len(key), dtype=np.float32))
            scp.write(f"{key} {tmp_path / f'{key}.npy'}\n")
    kwargs["emb_scp"] = str(tmp_path / "emb.scp")
    got = next(iter(aps_dataloader(train=False, **kwargs)))
    want = next(iter(jax_libs.aps_dataloader(train=False, **kwargs)))
    assert sorted(got) == sorted(want) == ["#utt", "emb", "mix", "ref"]
    np.testing.assert_array_equal(got["emb"], want["emb"])
    assert got["emb"].shape == (3, 4)
    with pytest.raises(RuntimeError, match="mix_scp"):
        aps_dataloader(fmt="se@chunk")


def _write_checkpoint(cpt: Path, variables, conf):
    cpt.mkdir()
    full = dict(nnet="sse@time_tcn", nnet_conf=conf, task="sse@sisnr",
                task_conf={}, data_conf={}, trainer_conf={})
    (cpt / "train.yaml").write_text(json.dumps(full))
    with open(cpt / "best.ckpt", "wb") as fd:
        pickle.dump({"params": {"nnet": variables["params"]["nnet"]},
                     "mstate": {"batch_stats":
                                variables["batch_stats"]},
                     "epoch": 2}, fd)


def _jax_separator():
    """cmd/separate.py of the JAX package as a module (cmd/ is a directory
    of scripts, and `cmd` is a module of the standard library)."""
    spec = importlib.util.spec_from_file_location(
        "aps_tpu_cmd_separate", REPO / "cmd" / "separate.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.Separator


def _read_sep(sep_dir: Path, key: str):
    return [read_audio(str(sep_dir / f"spk{i}" / f"{key}.wav"), sr=8000)
            for i in (1, 2)]


def test_separate_command_matches_jax_separator(slice_pair, tmp_path):
    """`aps_tpu_torch.cmd.separate --device cpu` in a fresh interpreter
    (which must not import jax or aps_tpu), per utterance, batched and
    chunked with stitching, on an aps_tpu-format checkpoint: the wavs equal
    what cmd/separate.py's Separator gives (run, run_batch), and the
    unfolded module agrees with the folded forward."""
    _, variables, _, _ = slice_pair
    _write_corpus(tmp_path)
    cpt = tmp_path / "cpt"
    _write_checkpoint(cpt, variables, NNET_CONF)
    common = ["--checkpoint", str(cpt), "--sr", "8000", "--device", "cpu"]
    runs = {
        "single": [],
        "batched": ["--batch-size", "4"],
        "chunked": ["--chunk-len", "4000", "--chunk-hop", "3000"],
        "canonical": ["--fused", "false", "--pad-grid", "1"],
    }
    code = "import sys\nfrom aps_tpu_torch.cmd import separate\n"
    for name, extra in runs.items():
        argv = [str(tmp_path / "mix.scp"), str(tmp_path / name)] + common + \
            extra
        code += f"stats = separate.main({argv!r})\n" \
            "assert stats['utts'] == 6 and stats['audio_secs'] > 9, stats\n"
    code += ("bad = [m for m in sys.modules if m == 'jax' or "
             "m.split('.')[0] == 'aps_tpu']\n"
             "assert not bad, bad\nprint('SEPARATED-WITHOUT-JAX')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "SEPARATED-WITHOUT-JAX" in proc.stdout
    assert "using fused eval forward" in proc.stderr

    separator = _jax_separator()(str(cpt))
    mixes = {f"utt{n}": read_audio(str(tmp_path / f"mix_{n}.wav"), sr=8000)
             for n in range(6)}
    lines = (tmp_path / "single" / "spk2.scp").read_text().splitlines()
    assert [ln.split()[0] for ln in lines] == sorted(mixes)
    for key, mix in mixes.items():
        want = separator.run(mix)
        for g, w in zip(_read_sep(tmp_path / "single", key), want):
            assert g.shape == np.asarray(w).shape == mix.shape
            np.testing.assert_allclose(g, np.asarray(w), atol=WAV_ATOL)
        want = separator.run(mix, chunk_len=4000, chunk_hop=3000)
        for g, w in zip(_read_sep(tmp_path / "chunked", key), want):
            assert g.shape == mix.shape
            np.testing.assert_allclose(g, np.asarray(w), atol=WAV_ATOL)
    keys = sorted(mixes)
    for group in (keys[:4], keys[4:]):
        want = separator.run_batch([mixes[k] for k in group])
        for key, per_utt in zip(group, want):
            for g, w in zip(_read_sep(tmp_path / "batched", key), per_utt):
                np.testing.assert_allclose(g, np.asarray(w), atol=WAV_ATOL)
    # without the fold and without the length grid: aps_tpu's module on the
    # exact length
    unfused = _jax_separator()(str(cpt), fused=False)
    for key in keys[:2]:
        want = unfused.run(mixes[key], pad_grid=1.0)
        for g, w in zip(_read_sep(tmp_path / "canonical", key), want):
            np.testing.assert_allclose(g[:len(w)], np.asarray(w),
                                       atol=WAV_ATOL)


def test_separate_refuses_what_is_not_ported(slice_pair, tmp_path):
    """A multi-channel mixture (no multi-channel model is ported) and the
    TPU's length planner (--max-programs) are refused."""
    from aps_tpu_torch.cmd import separate
    _, variables, _, _ = slice_pair
    cpt = tmp_path / "cpt"
    _write_checkpoint(cpt, variables, NNET_CONF)
    write_audio(str(tmp_path / "stereo.wav"),
                np.zeros((2, 4000), dtype=np.float32), sr=8000)
    (tmp_path / "mix.scp").write_text(f"u0 {tmp_path / 'stereo.wav'}\n")
    argv = [str(tmp_path / "mix.scp"), str(tmp_path / "sep"), "--checkpoint",
            str(cpt), "--device", "cpu", "--sr", "8000"]
    with pytest.raises(NotImplementedError, match="multi-channel"):
        separate.main(argv)
    with pytest.raises(SystemExit):
        separate.main(argv + ["--max-programs", "2"])


def test_train_ss_command_and_checkpoint(tmp_path):
    """`aps_tpu_torch.cmd.train_ss --device cpu` in a fresh interpreter
    trains two epochs of sse@sisnr on a tiny corpus without importing jax;
    the checkpoint loads in aps_tpu and in the port, both give the same
    separation, and trainer.log names the optimizer key without effect."""
    _write_corpus(tmp_path, num_utts=8)
    conf = dict(nnet="sse@time_tcn", nnet_conf=NNET_CONF, task="sse@sisnr",
                task_conf=dict(num_spks=2, permute=True),
                data_conf=_data_conf(tmp_path),
                trainer_conf=dict(TRAINER_CONF, no_impr=6))
    (tmp_path / "train.yaml").write_text(json.dumps(conf))
    cpt = tmp_path / "cpt"
    argv = ["--conf", str(tmp_path / "train.yaml"), "--checkpoint", str(cpt),
            "--batch-size", "4", "--epochs", "2", "--seed", "7", "--device",
            "cpu"]
    code = ("import sys\n"
            "from aps_tpu_torch.cmd import train_ss\n"
            f"trainer = train_ss.main({argv!r})\n"
            "assert trainer.cur_epoch == 2 and trainer.cur_step > 4\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.split('.')[0] == 'aps_tpu']\n"
            "assert not bad, bad\n"
            "print('TRAINED-WITHOUT-JAX')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "TRAINED-WITHOUT-JAX" in proc.stdout
    log = (cpt / "trainer.log").read_text()
    assert "weight_decay have no effect" in log
    losses = [float(line.split(") = ")[1].split("(")[0])
              for line in log.splitlines() if "/valid:" in line]
    assert len(losses) == 3 and losses[-1] < losses[0], losses

    from aps_tpu.eval.wrapper import load_checkpoint as jax_load
    from aps_tpu_torch.eval.wrapper import load_checkpoint
    mix = read_audio(str(tmp_path / "mix_3.wav"), sr=8000)[None, :8010]
    ours = load_checkpoint(str(cpt), "last")
    theirs = jax_load(str(cpt), "last")
    assert ours["epoch"] == theirs["epoch"] == 2
    with torch.no_grad():
        got = ours["nnet"](torch.from_numpy(mix))
    want = theirs["nnet"].apply(theirs["variables"], jnp.asarray(mix),
                                training=False)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


def test_sse_commands_refuse_to_run_without_a_card(tmp_path):
    """separate and train_ss with their default device raise on a machine
    without a card instead of carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    from aps_tpu_torch.cmd import separate, train_ss
    assert separate.make_parser().get_default("device") == "cuda"
    assert train_ss.make_parser().get_default("device") == "cuda"
    net = aps_sse_nnet("sse@time_tcn")(**NNET_CONF)
    tree = to_variables(net)
    _write_checkpoint(tmp_path / "cpt",
                      {"params": {"nnet": tree["params"]},
                       "batch_stats": {"nnet": tree["batch_stats"]}},
                      NNET_CONF)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        separate.main([str(tmp_path / "mix.scp"), str(tmp_path / "sep"),
                       "--checkpoint", str(tmp_path / "cpt")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_ss.main(["--conf", str(tmp_path / "train.yaml"),
                       "--checkpoint", str(tmp_path / "out")])


def test_dumped_conf_reads_alike_as_json_and_yaml(tmp_path):
    """train.yaml as the trainer writes it: JSON text whose small floats
    PyYAML (aps_tpu's loader) reads as floats too, not as strings."""
    import yaml

    from aps_tpu_torch.conf import dump_conf, load_yaml
    conf = {"trainer_conf": {"optimizer_kwargs": {"lr": 1e-3,
                                                  "weight_decay": 1e-5},
                             "lr_scheduler_kwargs": {"min_lr": 1e-8}},
            "nnet_conf": {"eps": -2.5e-10, "big": 1e20, "n": 3,
                          "name": "run-1e-05"}}
    text = dump_conf(conf)
    (tmp_path / "train.yaml").write_text(text)
    assert load_yaml(tmp_path / "train.yaml") == conf
    assert yaml.full_load(text) == conf
    (tmp_path / "plain.yaml").write_text("a:\n  lr: 1.0e-3\n  tag: best\n")
    assert load_yaml(tmp_path / "plain.yaml") == {"a": {"lr": 1e-3,
                                                        "tag": "best"}}
