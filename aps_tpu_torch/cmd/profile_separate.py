#!/usr/bin/env python
"""Where the time of Conv-TasNet separation and training goes, on one NVIDIA
card.

    python -m aps_tpu_torch.cmd.profile_separate [--out profile.txt]
        [--grad-check] [--cpu64]

Builds the full-width sse@time_tcn (N 256, L 20, B 256, H 512, X 8, R 4,
BatchNorm) from a seed, with running statistics off their initial values,
and prints, each with the card's name and power limit:

1. the fused TCN block kernel against its plain version at the separation
   batch's shape (32 x 3905 frames x 256 channels) for every dilation of a
   repeat, float32 and bfloat16: median of RUNS launches, CUDA events;
2. batches of 32 mixtures x 4 s at 8 kHz through cmd.separate's Separator
   (run_batch: padding, copy in, forward, copy out), folded and module,
   float32 and bfloat16: first batch, median and p90 of RUNS warm ones, and
   how far the outputs are from the float32 module's;
3. a torch.profiler trace of one warm float32 batch, folded and module:
   device time, busy share, kernel launches, the leading kernels;
4. sse@sisnr training (PIT, Adam 1e-3, clip 10) on one seeded batch of
   8 x 4 s: cold step, warm median and p90, peak memory, and a trace of one
   warm step;
5. with --grad-check: one training-mode pass on 4 mixtures in float32 on the
   card and on the CPU and in float64 on the card (--cpu64: and on the CPU),
   and how far each gradient is from the card's float64 one, relative to its
   largest entry.

--out takes the profiler's tables."""

import argparse
import copy
import json
import pickle
import statistics
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import torch

from aps_tpu_torch.cmd.profile_decode import (on_device, profile,
                                              synced_secs)
from aps_tpu_torch.cmd.separate import Separator
from aps_tpu_torch.convert import to_variables
from aps_tpu_torch.libs import aps_sse_nnet, aps_task, aps_trainer
from aps_tpu_torch.ops import build
from aps_tpu_torch.ops.tcn import (PACK_ROWS, tcn_block_fused,
                                   tcn_block_reference)
from aps_tpu_torch.trainer.dp import to_device

SR = 8000
SECS = 4
BATCH = 32
TRAIN_BATCH = 8
CHECK_UTTS = 4
RUNS = 10
TOP = 12
SEED = 777
CONF = dict(num_spks=2, L=20, N=256, X=8, R=4, B=256, H=512, norm="BN")
TRAINER_CONF = dict(optimizer="adam", optimizer_kwargs={"lr": 1e-3},
                    lr_scheduler="reduce_lr",
                    lr_scheduler_kwargs={"min_lr": 1e-8, "patience": 1,
                                         "factor": 0.5},
                    clip_gradient=10, report_metrics=["loss"])


def event_ms(fn, iters: int = RUNS, warmup: int = 2) -> float:
    """Median device time of fn() in ms, one CUDA event pair per call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        beg = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        beg.record()
        fn()
        end.record()
        end.synchronize()
        times.append(beg.elapsed_time(end))
    return statistics.median(times)


def seeded_model() -> torch.nn.Module:
    """Default initialisation under the seed, BatchNorm statistics moved."""
    torch.manual_seed(SEED)
    model = aps_sse_nnet("sse@time_tcn")(**CONF)
    gen = torch.Generator().manual_seed(SEED)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, torch.nn.BatchNorm1d):
                shape = mod.running_mean.shape
                mod.running_mean.copy_(0.1 * torch.randn(shape,
                                                         generator=gen))
                mod.running_var.copy_(1 + 0.2 * torch.rand(shape,
                                                           generator=gen))
    return model


def seeded_mixtures(count: int):
    """(mixtures, [sources of speaker 1, of speaker 2]), count x SECS * SR:
    two modulated tones and a little noise."""
    rng = np.random.default_rng(SEED)
    t = np.arange(SECS * SR) / SR
    n = np.arange(count)[:, None]
    a = 0.2 * np.sin(2 * np.pi * (180 + 7 * n) * t) * \
        (0.5 + 0.5 * np.sin(2 * np.pi * 1.3 * t))
    b = 0.2 * np.sin(2 * np.pi * (520 + 11 * n) * t) * \
        (0.5 + 0.5 * np.cos(2 * np.pi * 0.9 * t)) + \
        0.01 * rng.standard_normal((count, SECS * SR))
    a, b = a.astype(np.float32), b.astype(np.float32)
    return a + b, [a, b]


def block_times(dev, card: str) -> None:
    """Section 1: the kernel against its plain version per dilation."""
    gen = torch.Generator().manual_seed(SEED)
    B, H = CONF["B"], CONF["H"]
    stride = CONF["L"] // 2
    S = Separator.padded_len(SECS * SR)
    T = (S - CONF["L"]) // stride + 1
    rand = lambda *shape: torch.randn(shape, generator=gen)  # noqa: E731
    pack = 0.3 * rand(PACK_ROWS, H)
    pack[[1, 7]] = 1 + 0.2 * torch.rand((2, H), generator=gen)
    pack[[9, 10]] = 0.25
    x, k1, k2, b2 = rand(BATCH, T, B), rand(B, H) / B**0.5, \
        rand(H, B) / H**0.5, 0.1 * rand(1, B)
    for dtype in (torch.float32, torch.bfloat16):
        args = (x.to(dev, dtype), k1.to(dev, dtype), pack.to(dev),
                k2.to(dev, dtype), b2.to(dev))
        total = [0.0, 0.0]
        for n in range(CONF["X"]):
            d = 2**n
            got = tcn_block_fused(*args, d)
            want = tcn_block_reference(*args, d)
            err = (got.float() - want.float()).abs().max().item()
            ms = event_ms(lambda: tcn_block_fused(*args, d))
            plain = event_ms(lambda: tcn_block_reference(*args, d))
            total[0] += ms
            total[1] += plain
            print(f"tcn_block_fused N={BATCH} T={T} B={B} H={H} dilation={d} "
                  f"{str(dtype).split('.')[1]}: kernel {ms:.4f} ms, plain "
                  f"{plain:.4f} ms, max abs err {err:.3e} ({card})",
                  flush=True)
        print(f"  a forward's {CONF['R'] * CONF['X']} blocks: kernel "
              f"{CONF['R'] * total[0]:.3f} ms, plain "
              f"{CONF['R'] * total[1]:.3f} ms", flush=True)


def write_checkpoint(root: Path, model) -> Path:
    cpt = root / "cpt"
    cpt.mkdir()
    conf = dict(nnet="sse@time_tcn", nnet_conf=CONF, task="sse@sisnr",
                task_conf={}, data_conf={}, trainer_conf={})
    (cpt / "train.yaml").write_text(json.dumps(conf))
    variables = to_variables(model)
    with open(cpt / "best.ckpt", "wb") as fd:
        pickle.dump({"params": variables["params"],
                     "mstate": {"batch_stats": variables["batch_stats"]}}, fd)
    return cpt


def show_profile(title: str, fn, med: float, card: str, tables: list):
    build.reset_launches()
    device_ms, wall, launches, prof = profile(fn)
    print(f"{title}: device time {device_ms:.3f} ms in {wall:.4f} s wall, "
          f"busy share {device_ms / 1e3 / wall:.4f} (of the warm median "
          f"{device_ms / 1e3 / med:.4f}); {launches} kernel launches; port "
          f"kernels {dict(build.LAUNCHES)} ({card})", flush=True)
    ops = [e for e in prof.key_averages() if on_device(e)]
    ops.sort(key=lambda e: -e.self_device_time_total)
    for e in ops[:TOP]:
        ms = e.self_device_time_total / 1e3
        print(f"  {ms:9.3f} ms {ms / device_ms:7.2%} {e.count:6d} calls "
              f" {e.key[:90]}", flush=True)
    tables.append(f"{title} ({card})\n" + prof.key_averages().table(
        sort_by="self_device_time_total", row_limit=60))


def separation(cpt: Path, card: str, tables: list) -> None:
    """Sections 2 and 3: batches through the command's Separator."""
    mixes = list(seeded_mixtures(BATCH)[0])
    audio = BATCH * SECS
    outs, warm = {}, {}
    for dtype in ("float32", "bfloat16"):
        for fused in (True, False):
            name = f"{dtype} {'folded' if fused else 'module'}"
            sep = Separator(str(cpt), dtype=dtype, fused=fused)
            run = lambda: outs.__setitem__(  # noqa: E731
                name, sep.run_batch(mixes))
            first = synced_secs(run)
            secs = [synced_secs(run) for _ in range(RUNS)]
            warm[name] = med = statistics.median(secs)
            print(f"separate {BATCH} x {SECS} s, {name}: first batch "
                  f"{first:.4f} s, warm median {med:.4f} s, p90 "
                  f"{float(np.percentile(secs, 90)):.4f} s over {RUNS} = "
                  f"{audio / med:.2f} audio-s/s ({card})", flush=True)
            if dtype == "float32":
                show_profile(f"one warm batch, {name}", run, med, card,
                             tables)
    ref = np.stack([np.stack(u) for u in outs["float32 module"]])
    for name, out in outs.items():
        got = np.stack([np.stack(u) for u in out])
        print(f"  {name} vs float32 module: max abs diff "
              f"{np.abs(got - ref).max():.3e} of a largest sample "
              f"{np.abs(ref).max():.3f}", flush=True)


def training(dev, card: str, tables: list) -> dict:
    """Section 4: sse@sisnr steps on one batch. -> the batch."""
    mix, ref = seeded_mixtures(TRAIN_BATCH)
    egs = {"#utt": TRAIN_BATCH, "mix": mix, "ref": ref}
    task = aps_task("sse@sisnr", seeded_model(), num_spks=2, permute=True)
    with tempfile.TemporaryDirectory() as tmp:
        trainer = aps_trainer("dp")(task, device=dev, checkpoint=tmp,
                                    reduction_tag="#utt", **TRAINER_CONF)

        def step():
            if not trainer.train_one_step(egs):
                raise RuntimeError("the step was skipped: non-finite loss "
                                   "or gradient norm")

        torch.cuda.reset_peak_memory_stats(dev)
        cold = synced_secs(step)
        secs = [synced_secs(step) for _ in range(RUNS)]
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        med = statistics.median(secs)
        losses = [float(v) for v in trainer.reporter.stats["loss"]]
        print(f"sse@sisnr {TRAIN_BATCH} x {SECS} s: cold first step "
              f"{cold:.4f} s; warm median {med:.4f} s, p90 "
              f"{float(np.percentile(secs, 90)):.4f} s over {RUNS} steps = "
              f"{TRAIN_BATCH * SECS / med:.2f} audio-s/s; peak memory "
              f"{peak:.3f} GiB; loss {losses[0]:.4f} -> {losses[-1]:.4f} "
              f"({card})", flush=True)
        show_profile("one warm training step", step, med, card, tables)
    return egs


GRADS = ("encoder.weight", "tcn.block_0_0.linear_in.dense.weight",
         "tcn.block_3_7.conv.weight", "mask_out.weight")


def grad_check(egs: dict, dev, cpu64: bool) -> None:
    """Section 5: float32 against float64 gradients of one training pass."""
    task = aps_task("sse@sisnr", seeded_model(), num_spks=2, permute=True)
    tensors = {"mix": egs["mix"][:CHECK_UTTS],
               "ref": [r[:CHECK_UTTS] for r in egs["ref"]]}
    sides = [("card float64", dev, torch.float64),
             ("card float32", dev, torch.float32),
             ("CPU float32", "cpu", torch.float32)]
    if cpu64:
        sides.append(("CPU float64", "cpu", torch.float64))
    outs = {}
    for name, where, dtype in sides:
        side = copy.deepcopy(task).to(where, dtype).train()
        batch = to_device(tensors, torch.device(where))
        batch = {"mix": batch["mix"].to(dtype),
                 "ref": [r.to(dtype) for r in batch["ref"]]}
        loss = side(batch)["loss"]
        loss.backward()
        params = dict(side.nnet.named_parameters())
        outs[name] = (loss.item(),
                      {k: params[k].grad.double().cpu() for k in GRADS})
    ref_loss, ref = outs["card float64"]
    for name, (loss, grads) in outs.items():
        dist = {k: ((g - ref[k]).abs().max() / ref[k].abs().max()).item()
                for k, g in grads.items()}
        print(f"{name}: loss {loss:.9f} ({abs(loss - ref_loss):.1e} from "
              "the card's float64), gradients from the card's float64, "
              "relative to the largest entry: "
              + ", ".join(f"{k} {v:.3e}" for k, v in dist.items()),
              flush=True)


def run(args) -> None:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    tables = []
    block_times(dev, card)
    with tempfile.TemporaryDirectory() as tmp:
        cpt = write_checkpoint(Path(tmp), seeded_model())
        separation(cpt, card, tables)
    egs = training(dev, card, tables)
    if args.grad_check:
        grad_check(egs, dev, args.cpu64)
    if args.out:
        with open(args.out, "w") as fd:
            fd.write("\n\n".join(tables))


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="Profile separation and training of the full-width "
        "Conv-TasNet on one card")
    parser.add_argument("--out", type=str, default="",
                        help="file for the profiler's tables")
    parser.add_argument("--grad-check", action="store_true",
                        help="also compare float32 and float64 gradients")
    parser.add_argument("--cpu64", action="store_true",
                        help="with --grad-check: a float64 pass on the CPU "
                        "too (slow)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_separate needs a CUDA device")
    run(args)


if __name__ == "__main__":
    main()
