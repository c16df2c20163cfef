#!/usr/bin/env python
"""PyTorch port, data parallelism across processes: the facade
(aps_tpu_torch.distributed), the data axis (aps_tpu_torch.parallel), the
batch norms' global statistics, the tasks' global denominators, the dp
trainer under a process group, train_am with --distributed, the sharded
batched search and decode_batch --data-parallel, and pipeline_depth; and
the model axis: tensor_parallel 2 with sequence_parallel on the two ranks
(one data index, two model ranks) at the flagship's width 256, against
the one process and against aps_tpu's trainer on a 1 x 2 mesh, its
checkpoint, resume, batch trimming, the split front end and the draws.

Two gloo ranks on the CPU are launched once for the module (this file run
as a script, `worker` mode); they run every case and write what they hold,
and the tests hold it against the port's one-process run on the same
global batch and against aps_tpu's DataParallelTrainer on a 2-device CPU
mesh. A second launch has one rank raise, and the other must fail within
its timeout. Run alone:

    python -m pytest tests/test_torch_distributed.py -q
"""

import copy
import json
import os
import pickle
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from aps_tpu_torch.parallel import (fit_batch_to_mesh,  # noqa: E402
                                    rank_rows)

REPO = Path(__file__).resolve().parents[1]
WORLD = 2
VOCAB = 64
TASK_CONF = dict(ctc_weight=0.2, blank=VOCAB - 1, lsm_factor=0.1)
TRAINER_CONF = dict(
    optimizer="adam",
    # eps well above the gradients' rounding noise (tests/test_torch_train)
    optimizer_kwargs={"lr": 1e-3, "eps": 1e-3},
    lr_scheduler="warmup_noam_lr",
    lr_scheduler_period="step",
    lr_scheduler_kwargs={"peak_lr": 2e-3, "warmup": 2},
    clip_gradient=5.0,
    report_metrics=["loss", "accu", "@ctc", "xent"],
)
SEP_TRAINER_CONF = dict(TRAINER_CONF, report_metrics=["loss"])
TCN_CONF = dict(L=20, N=16, X=2, R=1, B=16, H=32, num_spks=2, norm="BN")
# two ranks against one process on the same global batch, both in
# float64: the all-reduced sums and the global batch-norm statistics add
# in another order, and Adam (eps 1e-3) turns a float32 gradient's
# rounding (~1e-8 in a bias that starts at 0 and feeds a batch norm) into
# a ~1e-5 share of that leaf's update, so float64 shows the arithmetic of
# the split (a per-rank statistic or denominator moves a leaf by ~1e-2 of
# it); each leaf within REL of its own largest entry
REL = 1e-6
# reported stats (loss, accu, @ctc, xent) of the global batch
STATS_REL = 1e-5
# against aps_tpu's trainer: PERF.md section 2's training bounds
# (tests/test_torch_train.py: parameters after two Adam steps, running
# statistics relative to the leaf's largest entry)
STEP_ATOL = 2e-5
STATS_RTOL = 1e-5
# n-best scores of the sharded search against the plain one
SCORE_REL = 1e-5
# seconds a rank waits for a dead peer in the failure case
DEAD_TIMEOUT = 20
# tensor and sequence parallelism over the two ranks: one data index, two
# model ranks
TP_KW = dict(tensor_parallel=WORLD, sequence_parallel=True)
# the sequence-parallel front end against the unsplit one: the same
# frames through the same plain functions (float32)
SP_ATOL = 1e-5


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def no_dropout_conf():
    from aps_tpu_torch.flagship import flagship_conf
    conf = flagship_conf(VOCAB, small=True, enc_att_dropout=0.0)
    nnet_conf = conf["nnet_conf"]
    nnet_conf["enc_kwargs"]["arch_kwargs"]["ffn_dropout"] = 0.0
    nnet_conf["dec_kwargs"]["arch_kwargs"].update(att_dropout=0.0,
                                                  ffn_dropout=0.0)
    return conf


def tp_conf(draws: bool = False):
    """The flagship at its full width (att_dim 256, where aps_tpu's min_dim
    of 256 shards the attention and feed-forward projections), 2 encoder
    layers and 1 decoder layer; every dropout off, or (draws) the
    defaults' dropouts with speed perturbation and SpecAugment."""
    from aps_tpu_torch.flagship import flagship_conf
    conf = flagship_conf(VOCAB, small=False,
                         enc_att_dropout=None if draws else 0.0)
    nnet_conf = conf["nnet_conf"]
    nnet_conf["enc_kwargs"]["num_layers"] = 2
    nnet_conf["dec_kwargs"]["num_layers"] = 1
    if draws:
        conf["asr_transform"].update(feats="perturb-fbank-log-cmvn-aug",
                                     aug_prob=1.0)
    else:
        nnet_conf["enc_kwargs"]["arch_kwargs"]["ffn_dropout"] = 0.0
        nnet_conf["dec_kwargs"]["arch_kwargs"].update(att_dropout=0.0,
                                                      ffn_dropout=0.0)
    return conf


def asr_batch(seed, src_len, tgt_len):
    """A padded batch: 0.1 x noise in each row's first src_len samples,
    tgt_len random tokens."""
    rng = np.random.default_rng(seed)
    S, L = max(src_len), max(tgt_len)
    src = np.zeros((len(src_len), S), dtype=np.float32)
    for i, n in enumerate(src_len):
        src[i, :n] = 0.1 * rng.standard_normal(n)
    tgt = rng.integers(0, VOCAB - 3, (len(tgt_len), L))
    for i, n in enumerate(tgt_len):
        tgt[i, n:] = -1
    return {"src_pad": src, "src_len": np.array(src_len),
            "tgt_pad": tgt, "tgt_len": np.array(tgt_len),
            "#utt": len(src_len), "#tok": int(sum(tgt_len)) + len(tgt_len)}


def sep_batch(seed, N=4, S=4010):
    rng = np.random.default_rng(seed)
    t = np.arange(S) / 8000
    ref = []
    for spk in range(2):
        f0 = rng.uniform(150, 400, (N, 1)) * (1 + spk)
        ref.append((0.3 * np.sin(2 * np.pi * f0 * t) +
                    0.02 * rng.standard_normal((N, S))).astype(np.float32))
    return {"mix": ref[0] + ref[1], "ref": ref, "#utt": N}


def make_inputs():
    """Everything the ranks and the one-process runs share: seeded
    weights (state dicts as numpy), the batches, the search's batch."""
    from aps_tpu_torch.flagship import build_flagship
    from aps_tpu_torch.libs import aps_sse_nnet
    torch.manual_seed(3)
    asr = build_flagship(no_dropout_conf())
    tcn = aps_sse_nnet("sse@time_tcn")(**TCN_CONF)
    tp = build_flagship(tp_conf())
    # global batches of 4: the two ranks' halves hold 13 and 5 tokens,
    # 18 and 10 with eos (and different lengths)
    asr_batches = [asr_batch(20 + i, [8000, 7000, 6250, 4500],
                             [7, 6, 3, 2]) for i in range(2)]
    rng = np.random.default_rng(21)
    search = [(0.1 * rng.standard_normal(n)).astype(np.float32)
              for n in (16000, 13000, 10000)]
    return {
        "asr": {k: v.numpy() for k, v in asr.state_dict().items()},
        "tcn": {k: v.numpy() for k, v in tcn.state_dict().items()},
        "asr_batches": asr_batches,
        # 5 rows: the trainer keeps the first 4
        "odd_batch": asr_batch(30, [8000, 7500, 6250, 4500, 4000],
                               [7, 6, 3, 2, 5]),
        "sep_batches": [sep_batch(40 + i) for i in range(2)],
        "search": search,
        "tp_asr": {k: v.numpy() for k, v in tp.state_dict().items()},
        # 23, 20, 17 and 13 frames: an odd count for the split front end
        "tp_batches": [asr_batch(60 + i, [4100, 3500, 3000, 2600],
                                 [5, 4, 3, 2]) for i in range(3)],
        # 5 rows: trimmed to the whole world (data x model), 4
        "tp_odd": asr_batch(70, [4100, 3900, 3000, 2600, 2500],
                            [5, 4, 3, 2, 4]),
    }


def asr_task(inputs, reduction, dtype=torch.float64):
    from aps_tpu_torch.flagship import build_flagship
    from aps_tpu_torch.libs import aps_task
    nnet = build_flagship(no_dropout_conf())
    nnet.load_state_dict({k: torch.from_numpy(v)
                          for k, v in inputs["asr"].items()})
    return aps_task("asr@ctc_xent", nnet, reduction=reduction,
                    **TASK_CONF).to(dtype)


def tp_task(inputs, dtype=torch.float64, draws=False):
    from aps_tpu_torch.flagship import build_flagship
    from aps_tpu_torch.libs import aps_task
    nnet = build_flagship(tp_conf(draws))
    nnet.load_state_dict({k: torch.from_numpy(v)
                          for k, v in inputs["tp_asr"].items()})
    return aps_task("asr@ctc_xent", nnet, reduction="batchmean",
                    **TASK_CONF).to(dtype)


def sep_task(inputs, dtype=torch.float64):
    from aps_tpu_torch.libs import aps_sse_nnet, aps_task
    nnet = aps_sse_nnet("sse@time_tcn")(**TCN_CONF)
    nnet.load_state_dict({k: torch.from_numpy(v)
                          for k, v in inputs["tcn"].items()})
    return aps_task("sse@sisnr", nnet, num_spks=2, permute=True).to(dtype)


def cast(egs, dtype):
    """The batch's float arrays (also in lists) in the task's dtype."""
    def one(val):
        if isinstance(val, list):
            return [one(v) for v in val]
        if isinstance(val, np.ndarray) and val.dtype.kind == "f":
            return val.astype(dtype)
        return val
    return {k: one(v) for k, v in egs.items()}


def run_steps(task, batches, cpt, conf, keep_after=0, **kwargs):
    """The dp trainer's steps over `batches` (each one scheduled step, the
    batch in the task's float type) -> its variables, reported stats and
    the files in its checkpoint directory after save_checkpoint; with
    keep_after k, (the result after k steps, the result at the end)."""
    from aps_tpu_torch.trainer.dp import DataParallelTrainer
    trainer = DataParallelTrainer(task, device="cpu", checkpoint=cpt,
                                  **conf, **kwargs)
    dtype = next(task.parameters()).detach().numpy().dtype

    def result():
        stats = {k: [float(v) for v in vals]
                 for k, vals in trainer.reporter.stats.items()}
        # the whole weights (under tensor parallelism gathered), copied:
        # the converter's arrays may share the parameters' memory
        return {"variables": copy.deepcopy(trainer.variables()),
                "stats": stats,
                "files": sorted(os.listdir(cpt)), "sharded": sorted(
                    trainer.tp_plan), "steps": trainer.cur_step}

    kept = None
    for egs in batches:
        assert trainer.train_one_step(cast(egs, dtype))
        trainer.cur_step += 1
        trainer.lr_scheduler.step()
        if trainer.cur_step == keep_after:
            kept = result()
    trainer.save_checkpoint(1)
    return result() if kept is None else (kept, result())


def search_model(inputs):
    from aps_tpu_torch.flagship import build_flagship
    model = build_flagship(no_dropout_conf())
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in inputs["asr"].items()})
    with torch.no_grad():
        # peaky output layers: non-trivial n-best lists
        model.decoder.output.weight.mul_(4)
        model.ctc_head.weight.mul_(4)
    return model.eval()


SEARCH_KW = dict(sos=VOCAB - 3, eos=VOCAB - 2, beam_size=4, nbest=4,
                 max_len=24, ctc_weight=0.4, allow_partial=True)


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------
def _train_am_argv(work: Path, rank: int, port: int):
    return ["--conf", str(work / "am" / "train.yaml"), "--dict",
            str(work / "am" / "dict"), "--checkpoint",
            str(work / f"am_cpt{rank}"), "--batch-size", "4", "--epochs",
            "1", "--seed", "7", "--device", "cpu", "--distributed", "gloo",
            "--coordinator-address", f"localhost:{port}",
            "--num-processes", str(WORLD), "--process-id", str(rank)]


def worker(case: str, rank: int, port: int, work: Path) -> None:
    from aps_tpu_torch import distributed
    if case == "die":
        distributed.init("gloo", f"localhost:{port}", WORLD, rank,
                         timeout=DEAD_TIMEOUT)
        if rank == 1:
            raise RuntimeError("rank 1 fails before the collective")
        beg = time.monotonic()
        try:
            distributed.all_reduce(1.0)
        finally:
            print(f"WAITED {time.monotonic() - beg:.1f}", flush=True)
        return
    ports = json.loads((work / "ports.json").read_text())
    inputs = pickle.loads((work / "inputs.pkl").read_bytes())
    distributed.init("gloo", f"localhost:{ports[0]}", WORLD, rank)
    out = {"facade": (
        distributed.rank(), distributed.world_size(),
        distributed.local_rank(), distributed.num_devices(),
        distributed.all_reduce(rank + 1.0),
        distributed.all_reduce(np.array([rank, 1.0]), average=False),
        distributed.gather_objects(f"r{rank}"))}
    for reduction in ("mean", "batchmean"):
        out[reduction] = run_steps(asr_task(inputs, reduction),
                                   inputs["asr_batches"],
                                   work / f"{reduction}{rank}", TRAINER_CONF)
        # float32, for aps_tpu's trainer
        out[f"{reduction}32"] = run_steps(
            asr_task(inputs, reduction, torch.float32),
            inputs["asr_batches"], work / f"{reduction}32{rank}",
            TRAINER_CONF)
    out["odd"] = run_steps(asr_task(inputs, "mean"), [inputs["odd_batch"]],
                           work / f"odd{rank}", TRAINER_CONF)
    out["sisnr"] = run_steps(sep_task(inputs), inputs["sep_batches"],
                             work / f"sisnr{rank}", SEP_TRAINER_CONF)
    out["sisnr32"] = run_steps(sep_task(inputs, torch.float32),
                               inputs["sep_batches"], work / f"sisnr32{rank}",
                               SEP_TRAINER_CONF)
    from aps_tpu_torch.asr.beam_search.transformer import beam_search_batch
    from aps_tpu_torch.parallel import sharded_map
    nnet = search_model(inputs)
    out["search"] = sharded_map(
        lambda rows, pad: beam_search_batch(nnet, rows, pad_to=pad,
                                            **SEARCH_KW), inputs["search"])
    out.update(tp_cases(inputs, work, rank))
    distributed.shutdown()
    from aps_tpu_torch.cmd import decode_batch, train_am
    train_am.main(_train_am_argv(work, rank, ports[1]))
    decode_batch.main([
        str(work / "am" / "wav.scp"), str(work / f"dp_best{rank}.txt"),
        "--am", str(work / "am_cpt0"), "--am-tag", "last", "--dict",
        str(work / "am" / "dict"), "--beam-size", "4", "--ctc-weight",
        "0.4", "--batch-size", "5", "--device", "cpu", "--data-parallel",
        "--distributed", "gloo", "--coordinator-address",
        f"localhost:{ports[2]}", "--num-processes", str(WORLD),
        "--process-id", str(rank)])
    (work / f"rank{rank}.pkl").write_bytes(pickle.dumps(out))


def tp_cases(inputs, work: Path, rank: int):
    """The model axis on the two ranks: two float64 steps (then a resume
    from rank 0's checkpoint and a third step), two float32 steps, the
    uneven batch, two steps with every draw on, and the split front end
    (the fused path through K1's plain version, the layered STFT chain,
    the enh transform's STFT)."""
    from aps_tpu_torch import distributed
    batches = inputs["tp_batches"]
    out = {"tp64": run_steps(tp_task(inputs), batches[:2], work / "tp64",
                             TRAINER_CONF, **TP_KW)}
    distributed.all_reduce(0.0)  # rank 0's checkpoint is on disk
    out["tp64_resumed"] = run_steps(
        tp_task(inputs), batches[2:], work / f"tp64r{rank}", TRAINER_CONF,
        resume=str(work / "tp64" / "last.ckpt"), **TP_KW)
    out["tp32"] = run_steps(tp_task(inputs, torch.float32), batches[:2],
                            work / f"tp32{rank}", TRAINER_CONF, **TP_KW)
    out["tp_odd"] = run_steps(tp_task(inputs), [inputs["tp_odd"]],
                              work / f"tpodd{rank}", TRAINER_CONF, **TP_KW)
    out["tp_draws"] = run_steps(tp_task(inputs, torch.float32, draws=True),
                                batches[:2], work / f"tpdraw{rank}",
                                TRAINER_CONF, **TP_KW)
    out["sp_front"] = sp_front_ends(inputs)
    return out


def sp_front_ends(inputs):
    """(unsplit, split) features of three front ends on tp_batches[0]'s
    waveforms (23 frames in the longest: 12 and 11 a rank) with their
    lengths and utterance cmvn."""
    from aps_tpu_torch import distributed
    from aps_tpu_torch.libs import aps_transform
    from aps_tpu_torch.parallel import SeqSplit
    split = SeqSplit(distributed.model_index(), WORLD,
                     distributed.model_group())
    egs = inputs["tp_batches"][0]
    wav = torch.from_numpy(egs["src_pad"])
    wav_len = torch.from_numpy(egs["src_len"])
    kw = dict(frame_len=400, frame_hop=160, window="hamm")
    fronts = {
        "fused": aps_transform("asr")(feats="fbank-log-cmvn", **kw),
        "layered": aps_transform("asr")(feats="fbank-log-cmvn", center=True,
                                        **kw),
        "enh": aps_transform("enh")(feats="spectrogram-log-cmvn",
                                    frame_len=512, frame_hop=256)}
    out = {}
    for name, front in fronts.items():
        pair = []
        for seq_split in (None, split):
            front.seq_split = seq_split
            if name == "enh":
                stft, _ = front.encode(wav)
                feats = torch.view_as_real(stft)
            else:
                feats, num_frames = front(wav, wav_len)
                feats = (feats, num_frames)
            pair.append(feats)
        out[name] = pair
    assert fronts["fused"].fused is not None
    assert fronts["layered"].fused is None
    return out


def start(case: str, work: Path):
    """The two ranks of `case`, started, their output in files of work (a
    pipe that fills would stop a rank inside a collective)."""
    port = free_port()
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    procs = []
    for rank in range(WORLD):
        logs = [work / f"{case}.{rank}.{ext}" for ext in ("out", "err")]
        with open(logs[0], "w") as out, open(logs[1], "w") as err:
            procs.append((subprocess.Popen(
                [sys.executable, __file__, case, str(rank), str(port),
                 str(work)], cwd=str(REPO), env=env, stdout=out,
                stderr=err), logs))
    return procs


def finish(procs, timeout: float):
    """-> (exit code, stdout, stderr) of each rank."""
    deadline = time.monotonic() + timeout
    try:
        for proc, _ in procs:
            proc.wait(timeout=max(deadline - time.monotonic(), 1))
    finally:
        for proc, _ in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return [(proc.returncode,) + tuple(log.read_text() for log in logs)
            for proc, logs in procs]


def aps_tpu_mesh_steps(jtask, init: Path, cpt: Path, batches, conf):
    """aps_tpu's DataParallelTrainer on a 2-device CPU mesh, warm-started
    from the port's checkpoint `init`, over `batches` -> its parameters,
    batch statistics and losses as numpy."""
    import jax

    from aps_tpu.trainer.dp import DataParallelTrainer as JaxTrainer
    theirs = JaxTrainer(jtask, checkpoint=cpt, init=str(init),
                        pipeline_depth=0, devices=jax.devices()[:WORLD],
                        **conf)
    assert theirs.ndev == WORLD
    theirs.init_state(dict(batches[0]))
    for egs in batches:
        assert theirs.train_one_step(dict(egs)) == [True]
        theirs.cur_step += 1
        theirs.lr_scheduler.step()
    return {"params": jax.tree_util.tree_map(np.asarray,
                                             theirs.params)["nnet"],
            "batch_stats": jax.tree_util.tree_map(
                np.asarray, theirs.mstate)["batch_stats"]["nnet"],
            "loss": [float(v) for v in theirs.reporter.stats["loss"]]}


def sisnr_mesh(inputs, root: Path):
    """Two float32 steps of sse@sisnr on sse@time_tcn in aps_tpu's trainer
    on the mesh, from the port's weights -> (its result, the weights)."""
    from aps_tpu import libs as jax_libs
    from aps_tpu_torch.trainer.dp import DataParallelTrainer
    seed = DataParallelTrainer(sep_task(inputs, torch.float32), device="cpu",
                               checkpoint=root / "seed", **SEP_TRAINER_CONF)
    seed.save_checkpoint(0, best=False)
    jnnet = jax_libs.aps_sse_nnet("sse@time_tcn")(**TCN_CONF)
    jtask = jax_libs.aps_task("sse@sisnr", jnnet, num_spks=2, permute=True)
    return aps_tpu_mesh_steps(jtask, root / "seed" / "last.ckpt",
                              root / "jax", inputs["sep_batches"],
                              SEP_TRAINER_CONF), \
        seed.checkpoint_states(0)["params"]["nnet"]


def ctc_xent_mesh(inputs, reduction: str, root: Path):
    """Two float32 steps of asr@ctc_xent under `reduction` in aps_tpu's
    trainer on the mesh, from the port's weights -> its result."""
    from aps_tpu import libs as jax_libs
    from aps_tpu.transform import AsrTransform as JaxTransform
    from aps_tpu_torch.trainer.dp import DataParallelTrainer
    seed = DataParallelTrainer(asr_task(inputs, reduction, torch.float32),
                               device="cpu", checkpoint=root / "seed",
                               **TRAINER_CONF)
    seed.save_checkpoint(0, best=False)
    conf = no_dropout_conf()
    jnnet = jax_libs.aps_asr_nnet(conf["nnet"])(
        asr_transform=JaxTransform(**conf["asr_transform"]),
        **conf["nnet_conf"])
    jtask = jax_libs.aps_task("asr@ctc_xent", jnnet, **TASK_CONF,
                              reduction=reduction)
    return aps_tpu_mesh_steps(jtask, root / "seed" / "last.ckpt",
                              root / "jax", inputs["asr_batches"],
                              TRAINER_CONF)


def tp_mesh(inputs, root: Path):
    """Two float32 steps of the width-256 flagship in aps_tpu's trainer
    with tensor_parallel 2 and sequence_parallel on a 1 x 2 CPU mesh, from
    the port's weights -> its result."""
    from aps_tpu import libs as jax_libs
    from aps_tpu.transform import AsrTransform as JaxTransform
    from aps_tpu_torch.trainer.dp import DataParallelTrainer
    seed = DataParallelTrainer(tp_task(inputs, torch.float32), device="cpu",
                               checkpoint=root / "seed", **TRAINER_CONF)
    seed.save_checkpoint(0, best=False)
    conf = tp_conf()
    jnnet = jax_libs.aps_asr_nnet(conf["nnet"])(
        asr_transform=JaxTransform(**conf["asr_transform"]),
        **conf["nnet_conf"])
    jtask = jax_libs.aps_task("asr@ctc_xent", jnnet, **TASK_CONF,
                              reduction="batchmean")
    return aps_tpu_mesh_steps(jtask, root / "seed" / "last.ckpt",
                              root / "jax", inputs["tp_batches"][:2],
                              dict(TRAINER_CONF, **TP_KW))


# the reductions whose aps_tpu mesh run the fixture makes beside the
# ranks (Tier-1); the others run in their test, under `slow` (XLA takes
# ~35-40 s to compile the flagship's step on the CPU, even at one layer)
MESH_IN_FIXTURE = ("batchmean",)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Two gloo ranks run every case once, while this process runs the
    one-process references and aps_tpu's mesh -> (the ranks' outputs, the
    references, the inputs, the work directory)."""
    from test_torch_train import _train_conf, _write_corpus

    from aps_tpu_torch.asr.beam_search.transformer import beam_search_batch
    work = tmp_path_factory.mktemp("dp")
    inputs = make_inputs()
    (work / "inputs.pkl").write_bytes(pickle.dumps(inputs))
    (work / "ports.json").write_text(json.dumps(
        [free_port() for _ in range(3)]))
    (work / "am").mkdir()
    _write_corpus(work / "am")
    _train_conf(work / "am")
    beg = time.monotonic()
    procs = start("worker", work)
    refs = {}
    try:
        for reduction in ("mean", "batchmean"):
            refs[reduction] = run_steps(asr_task(inputs, reduction),
                                        inputs["asr_batches"],
                                        work / f"one_{reduction}",
                                        TRAINER_CONF)
        refs["odd"] = run_steps(
            asr_task(inputs, "mean"),
            [fit_batch_to_mesh(inputs["odd_batch"], WORLD)],
            work / "one_odd", TRAINER_CONF)
        refs["sisnr"] = run_steps(sep_task(inputs), inputs["sep_batches"],
                                  work / "one_sisnr", SEP_TRAINER_CONF)
        refs["search"] = beam_search_batch(search_model(inputs),
                                           inputs["search"], **SEARCH_KW)
        refs["sisnr_mesh"] = sisnr_mesh(inputs, work / "mesh")
        tp_batches = inputs["tp_batches"]
        refs["tp64_2"], refs["tp64_3"] = run_steps(
            tp_task(inputs), tp_batches, work / "one_tp64", TRAINER_CONF,
            keep_after=2)
        refs["tp_odd"] = run_steps(
            tp_task(inputs), [fit_batch_to_mesh(inputs["tp_odd"], WORLD)],
            work / "one_tp_odd", TRAINER_CONF)
        refs["tp_mesh"] = tp_mesh(inputs, work / "mesh_tp")
        for reduction in MESH_IN_FIXTURE:
            refs[f"{reduction}_mesh"] = ctc_xent_mesh(
                inputs, reduction, work / f"mesh_{reduction}")
    finally:
        done = finish(procs, timeout=600)
    for code, stdout, stderr in done:
        assert code == 0, stderr[-4000:]
    outs = [pickle.loads((work / f"rank{r}.pkl").read_bytes())
            for r in range(WORLD)]
    print(f"the ranks and the references took {time.monotonic() - beg:.1f} "
          "s")
    return outs, refs, inputs, work


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------
def _leaves(tree, prefix=""):
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(val, dict):
            yield from _leaves(val, path)
        else:
            yield path, np.asarray(val)


def assert_close(got, want, rel=0.0, atol=0.0):
    """Each leaf within atol + rel x the leaf's largest entry of want."""
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        bound = atol + rel * float(np.abs(w).max())
        np.testing.assert_allclose(got[path], w, rtol=0, atol=bound,
                                   err_msg=path)


def test_facade_mean_sum_and_gather(ranks):
    outs = ranks[0]
    for r, out in enumerate(outs):
        rank, world, local, devices, mean, total, names = out["facade"]
        assert (rank, world, local, devices) == (r, WORLD, r, WORLD)
        assert mean == 1.5
        np.testing.assert_array_equal(total, [1.0, 2.0])
        assert names == ["r0", "r1"]


def test_facade_without_init():
    from aps_tpu_torch import distributed
    assert not distributed.initialized()
    assert (distributed.rank(), distributed.world_size(),
            distributed.num_devices()) == (0, 1, 1)
    assert distributed.all_reduce(2.5) == 2.5
    assert distributed.gather_objects("x") == ["x"]
    with distributed.sharded():
        assert distributed.step_group() is None
        assert distributed.global_sum(3) == 3
    with pytest.raises(ValueError, match="backend"):
        distributed.init("mpi")
    with pytest.raises(ValueError, match="coordinator"):
        distributed.init("gloo", "", 2, 0)


@pytest.mark.parametrize("reduction", ["mean", "batchmean"])
def test_ctc_xent_two_ranks_equal_one_process(ranks, reduction):
    """Two Adam steps of asr@ctc_xent (CTC and label-smoothed xent, the
    conformer's conv-module batch norm) on global batches whose halves
    hold 13 and 5 tokens: every rank holds the one-process parameters
    and running statistics, and reports the global stats."""
    outs, refs, _, _ = ranks
    want = refs[reduction]
    for out in outs:
        got = out[reduction]
        assert_close(got["variables"], want["variables"], rel=REL)
        for key in ("loss", "accu", "@ctc", "xent", "norm", "#tok"):
            np.testing.assert_allclose(got["stats"][key],
                                       want["stats"][key], rtol=STATS_REL,
                                       err_msg=key)
    # the ranks hold the same (all-reduced) values
    assert_close(outs[1][reduction]["variables"],
                 outs[0][reduction]["variables"])


def test_trainer_writes_from_the_chief_and_logs_per_rank(ranks):
    outs = ranks[0]
    assert outs[0]["mean"]["files"] == ["best.ckpt", "last.ckpt",
                                        "trainer.rank.0.log"]
    assert outs[1]["mean"]["files"] == ["trainer.rank.1.log"]


@pytest.mark.parametrize("reduction", [
    pytest.param("mean", marks=pytest.mark.slow), "batchmean"])
def test_ctc_xent_two_ranks_against_aps_tpu_mesh(ranks, reduction, tmp_path):
    """The same two steps in float32 on the two ranks (the conformer's
    global batch norm, the global denominators of `reduction`) in
    aps_tpu's DataParallelTrainer on a 2-device CPU mesh, warm-started
    from the port's weights: PERF.md section 2's training bounds on every
    rank's parameters and running statistics. The mesh run of a reduction
    not in MESH_IN_FIXTURE is made here, under `slow`."""
    _, refs, inputs, _ = ranks
    outs = ranks[0]
    want = refs.get(f"{reduction}_mesh") or ctc_xent_mesh(
        inputs, reduction, tmp_path)
    for out in outs:
        got = out[f"{reduction}32"]["variables"]
        assert_close(got["params"], want["params"], atol=STEP_ATOL)
        assert_close(got["batch_stats"], want["batch_stats"],
                     rel=STATS_RTOL)
    np.testing.assert_allclose(outs[0][f"{reduction}32"]["stats"]["loss"],
                               want["loss"], rtol=1e-4)


def test_sisnr_tcn_two_ranks_against_aps_tpu_mesh(ranks):
    """Two float32 steps of sse@sisnr on sse@time_tcn (batch norms in its
    blocks) in aps_tpu's DataParallelTrainer on a 2-device CPU mesh,
    warm-started from the port's weights: PERF.md section 2's training
    bounds on every rank's parameters and running statistics."""
    outs, refs, _, _ = ranks
    want, start = refs["sisnr_mesh"]
    start = dict(_leaves(start))
    assert max(np.abs(v - start[k]).max()
               for k, v in _leaves(want["params"])) > 1e-3
    for out in outs:
        got = out["sisnr32"]["variables"]
        assert_close(got["params"], want["params"], atol=STEP_ATOL)
        assert_close(got["batch_stats"], want["batch_stats"],
                     rel=STATS_RTOL)
    np.testing.assert_allclose(outs[0]["sisnr32"]["stats"]["loss"],
                               want["loss"], rtol=1e-4)


def test_uneven_batch_is_trimmed_as_aps_tpu_trims_it(ranks):
    """A batch of 5 rows: the trainer keeps the first 4 (2 a rank) and
    reports their #utt and #tok, as aps_tpu's fit_batch_to_mesh."""
    from aps_tpu.parallel import fit_batch_to_mesh as jax_fit

    outs, refs, inputs, _ = ranks
    odd = inputs["odd_batch"]
    kept = fit_batch_to_mesh(odd, WORLD)
    theirs = jax_fit(odd, WORLD)
    assert sorted(kept) == sorted(theirs)
    for key in kept:
        np.testing.assert_array_equal(kept[key], theirs[key])
    assert kept["#utt"] == 4 and kept["#tok"] == 18 + 4
    assert rank_rows(kept, 1, WORLD)["tgt_len"].tolist() == [3, 2]
    # smaller than the world: whole on every rank
    one = asr_batch(1, [8000], [2])
    assert rank_rows(one, 1, WORLD)["src_pad"].shape == (1, 8000)
    for out in outs:
        assert out["odd"]["stats"]["#utt"] == [4.0]
        assert out["odd"]["stats"]["#tok"] == [22.0]
        assert_close(out["odd"]["variables"], refs["odd"]["variables"],
                     rel=REL)


def test_sisnr_tcn_two_ranks_equal_one_process(ranks):
    """Two steps of sse@sisnr on sse@time_tcn, whose TCN blocks hold batch
    norms: the one-process parameters and running statistics."""
    outs, refs, _, _ = ranks
    want = refs["sisnr"]
    for out in outs:
        assert_close(out["sisnr"]["variables"], want["variables"], rel=REL)
        np.testing.assert_allclose(out["sisnr"]["stats"]["loss"],
                                   want["stats"]["loss"], rtol=STATS_REL)


def test_sharded_search_equals_the_plain_search(ranks):
    """The batched search through sharded_map, as decode_batch
    --data-parallel runs it, on two ranks (rows 0-1 and row 2, of 16000,
    13000 and 10000 samples: each shard padded to the batch's length) gives the plain search's n-best lists on every rank."""
    outs, refs, _, _ = ranks
    want = refs["search"]
    assert len(want) == 3
    assert len({tuple(h["trans"]) for h in want[0]}) > 1
    for out in outs:
        got = out["search"]
        assert len(got) == len(want)
        for hyps_g, hyps_w in zip(got, want):
            assert [h["trans"] for h in hyps_g] == \
                [h["trans"] for h in hyps_w]
            np.testing.assert_allclose([h["score"] for h in hyps_g],
                                       [h["score"] for h in hyps_w],
                                       rtol=SCORE_REL)


def test_train_am_and_decode_batch_data_parallel(ranks, tmp_path):
    """train_am --distributed gloo on two ranks (a checkpoint directory
    each, to show who writes what): rank 0 writes train.yaml, the dict and
    the checkpoints, each rank its trainer.rank.N.log; decode_batch
    --data-parallel from that checkpoint writes, on rank 0 only, the plain
    decode's transcripts."""
    from aps_tpu_torch.cmd import decode_batch
    work = ranks[3]
    chief = sorted(os.listdir(work / "am_cpt0"))
    assert {"best.ckpt", "last.ckpt", "train.yaml", "dict",
            "trainer.rank.0.log"} <= set(chief), chief
    assert "trainer.log" not in chief
    assert sorted(os.listdir(work / "am_cpt1")) == ["trainer.rank.1.log"]
    log = (work / "am_cpt1" / "trainer.rank.1.log").read_text()
    assert "Data parallel: rank 1 of 2 (gloo)" in log
    plain = tmp_path / "best.txt"
    decode_batch.main([
        str(work / "am" / "wav.scp"), str(plain), "--am",
        str(work / "am_cpt0"), "--am-tag", "last", "--dict",
        str(work / "am" / "dict"), "--beam-size", "4", "--ctc-weight",
        "0.4", "--batch-size", "5", "--device", "cpu"])
    want = sorted(plain.read_text().splitlines())
    assert len(want) == 12
    assert sorted((work / "dp_best0.txt").read_text().splitlines()) == want
    assert not (work / "dp_best1.txt").exists() or \
        (work / "dp_best1.txt").read_text() == ""


def test_decode_batch_prefetch_writes_the_serial_loops_bytes(
        ranks, tmp_path, monkeypatch):
    """decode_batch reads the wavs ahead on a background thread
    (eval/pipeline.py::prefetch_iter): its transcripts are the serial
    loop's byte for byte, in the same order."""
    from aps_tpu_torch.cmd import decode_batch
    work = ranks[3]
    texts = {}
    for how in ("pipelined", "serial"):
        if how == "serial":
            monkeypatch.setattr(decode_batch, "prefetch_iter",
                                lambda it, depth: it)
        decode_batch.main([
            str(work / "am" / "wav.scp"), str(tmp_path / how), "--am",
            str(work / "am_cpt0"), "--am-tag", "last", "--dict",
            str(work / "am" / "dict"), "--beam-size", "4", "--batch-size",
            "5", "--device", "cpu"])
        texts[how] = (tmp_path / how).read_bytes()
    assert texts["pipelined"] == texts["serial"]
    assert len(texts["serial"].splitlines()) == 12


def test_a_dead_rank_fails_the_other_in_time(tmp_path):
    """Rank 1 raises after init; rank 0, in an all-reduce, exits non-zero
    within its timeout instead of waiting for ever."""
    beg = time.monotonic()
    (code0, out0, err0), (code1, _, err1) = finish(
        start("die", tmp_path), timeout=DEAD_TIMEOUT + 60)
    assert code1 != 0 and "rank 1 fails" in err1
    assert code0 != 0, (out0, err0[-2000:])
    waited = float(out0.split("WAITED")[1].split()[0])
    assert waited <= DEAD_TIMEOUT + 5, waited
    assert time.monotonic() - beg < DEAD_TIMEOUT + 60


def test_tp_sp_two_ranks_equal_one_process(ranks):
    """tensor_parallel 2 with sequence_parallel on the two ranks (one data
    index, two model ranks; the width-256 flagship's attention and
    feed-forward projections sharded, the front end split in frames):
    two float64 Adam steps give the one process's parameters, running
    statistics and stats on every rank; a resume from rank 0's checkpoint
    under tensor_parallel and a third step give the one process's three
    steps."""
    outs, refs, _, _ = ranks
    assert len(outs[0]["tp64"]["sharded"]) == 23
    for out in outs:
        for key, want in (("tp64", refs["tp64_2"]),
                          ("tp64_resumed", refs["tp64_3"])):
            got = out[key]
            assert_close(got["variables"], want["variables"], rel=REL)
            assert got["steps"] == want["steps"]
        for key in ("loss", "accu", "@ctc", "xent", "norm", "#tok"):
            np.testing.assert_allclose(out["tp64"]["stats"][key],
                                       refs["tp64_2"]["stats"][key],
                                       rtol=STATS_REL, err_msg=key)
    assert_close(outs[1]["tp64"]["variables"], outs[0]["tp64"]["variables"])


def test_tp_sp_two_ranks_against_aps_tpu_mesh(ranks):
    """The same two steps in float32 on the two ranks against aps_tpu's
    DataParallelTrainer(tensor_parallel=2, sequence_parallel=True) on a
    1 x 2 CPU mesh from the same converted weights: PERF.md section 2's
    training bounds on every rank."""
    outs, refs, _, _ = ranks
    want = refs["tp_mesh"]
    for out in outs:
        got = out["tp32"]["variables"]
        assert_close(got["params"], want["params"], atol=STEP_ATOL)
        assert_close(got["batch_stats"], want["batch_stats"],
                     rel=STATS_RTOL)
        np.testing.assert_allclose(out["tp32"]["stats"]["loss"],
                                   want["loss"], rtol=1e-4)


def test_tp_checkpoint_loads_in_one_process_and_in_aps_tpu(ranks, tmp_path):
    """Rank 0's checkpoint under tensor_parallel is in aps_tpu's layout:
    whole weights (and whole Adam moments) that the port's converter
    loads into one process's model and aps_tpu's load_checkpoint reads,
    both equal to the ranks' gathered parameters."""
    import shutil

    from aps_tpu.eval.wrapper import load_checkpoint
    from aps_tpu_torch.convert import to_state_dict, to_variables
    from aps_tpu_torch.flagship import build_flagship
    outs, _, inputs, work = ranks
    want = outs[0]["tp64"]["variables"]
    cpt = pickle.loads((work / "tp64" / "last.ckpt").read_bytes())
    model = build_flagship(tp_conf()).double()
    model.load_state_dict(to_state_dict(
        {"params": cpt["params"]["nnet"],
         "batch_stats": cpt["mstate"]["batch_stats"]["nnet"]}, model))
    assert_close(to_variables(model), want)
    shapes = [p.shape for p in model.parameters()]
    moments = cpt["torch_opt_state"]["state"]
    assert [moments[i]["exp_avg"].shape for i in range(len(shapes))] == [
        tuple(s) for s in shapes]
    shutil.copy(work / "tp64" / "last.ckpt", tmp_path / "last.ckpt")
    conf = dict(tp_conf(), task="asr@ctc_xent", task_conf=TASK_CONF)
    (tmp_path / "train.yaml").write_text(json.dumps(conf))
    theirs = load_checkpoint(str(tmp_path), cpt_tag="last")
    assert_close({k: np.asarray(v) for k, v in dict(_leaves(
        theirs["params"])).items()}, dict(_leaves(want["params"])))


def test_tp_uneven_batch_is_trimmed_to_the_whole_world(ranks):
    """Under tensor_parallel the batch is trimmed to a multiple of the
    whole world (data x model ranks, aps_tpu's device count), not of the
    data axis: 5 rows -> 4, whole on both model ranks, as aps_tpu's
    fit_batch_to_mesh on its 1 x 2 mesh."""
    from aps_tpu.parallel import fit_batch_to_mesh as jax_fit

    outs, refs, inputs, _ = ranks
    kept, theirs = (fit(inputs["tp_odd"], WORLD)
                    for fit in (fit_batch_to_mesh, jax_fit))
    assert kept["#utt"] == theirs["#utt"] == 4
    np.testing.assert_array_equal(kept["src_pad"], theirs["src_pad"])
    for out in outs:
        assert out["tp_odd"]["stats"]["#utt"] == [4.0]
        assert out["tp_odd"]["stats"]["#tok"] == refs["tp_odd"]["stats"][
            "#tok"]
        assert_close(out["tp_odd"]["variables"], refs["tp_odd"]["variables"],
                     rel=REL)


@pytest.mark.parametrize("front", ["fused", "layered", "enh"])
def test_sp_front_end_gathers_the_unsplit_features(ranks, front):
    """The frames split over the two model ranks (12 and 11 of the
    longest utterance's 23; the enh STFT's 15 as 8 and 7), run on each
    rank's samples and gathered: the unsplit features and frame counts,
    after the utterance-level cmvn (fused: K1's plain version; layered:
    the centred STFT chain; enh: the complex STFT)."""
    outs = ranks[0]
    for out in outs:
        whole, split = out["sp_front"][front]
        if front == "enh":
            assert whole.shape[-2] == 15
            torch.testing.assert_close(split, whole, atol=SP_ATOL, rtol=0)
            continue
        assert whole[0].shape[1] == (23 if front == "fused" else 26)
        torch.testing.assert_close(split[0], whole[0], atol=SP_ATOL, rtol=0)
        assert torch.equal(split[1], whole[1])


def test_tp_draws_are_the_same_on_the_model_ranks(ranks):
    """With the dropouts, speed perturbation and SpecAugment on, the two
    model ranks (one data index: the same rows) draw alike, so their
    parameters stay bit-equal after two steps, and the steps moved
    them."""
    outs, refs, _, _ = ranks
    got = [out["tp_draws"]["variables"] for out in outs]
    assert_close(got[1], got[0])
    assert all(np.isfinite(out["tp_draws"]["stats"]["loss"]).all()
               for out in outs)
    from aps_tpu_torch.convert import to_variables
    start = dict(_leaves(to_variables(
        tp_task(ranks[2], torch.float32).nnet)["params"]))
    moved = max(np.abs(v - start[k]).max()
                for k, v in _leaves(got[0]["params"]))
    assert moved > 1e-4


# ---------------------------------------------------------------------------
# pipeline_depth (one process)
# ---------------------------------------------------------------------------
def test_pipeline_depth_matches_blocking(tmp_path):
    """pipeline_depth 2 against blocking steps on four batches whose third
    is non-finite (inside the window of steps in flight): the same
    losses, parameters, optimizer moments and running statistics, and the
    error breaker sees the same results in the same order; drain() reads
    the last ones."""
    from aps_tpu_torch.trainer.dp import DataParallelTrainer
    inputs = make_inputs()
    batches = [asr_batch(50 + i, [8000, 6000, 4000], [5, 4, 2])
               for i in range(4)]
    batches[2]["src_pad"][0, 100] = np.inf
    runs = {}
    for depth in (1, 2):
        trainer = DataParallelTrainer(
            asr_task(inputs, "mean", torch.float32), device="cpu",
            checkpoint=tmp_path / str(depth), pipeline_depth=depth,
            **TRAINER_CONF)
        seen, pending = [], []
        trainer._breaker = seen.append
        for egs in batches:
            trainer._train_step(copy.deepcopy(egs))
            pending.append(len(trainer._in_flight))
        trainer._drain()
        runs[depth] = (trainer, seen, pending)
    (block, seen1, pend1), (piped, seen2, pend2) = runs[1], runs[2]
    assert seen1 == seen2 == [True, True, False, True]
    assert pend1 == [0, 0, 0, 0] and pend2 == [0, 1, 2, 2]
    assert block.reporter.stats["loss"] == piped.reporter.stats["loss"]
    for a, b in zip(block.task.state_dict().values(),
                    piped.task.state_dict().values()):
        assert torch.equal(a, b)
    for p, q in zip(block.params, piped.params):
        for key, val in block.optimizer.state[p].items():
            assert torch.equal(val, piped.optimizer.state[q][key]), key


if __name__ == "__main__":
    worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
           Path(sys.argv[4]))
