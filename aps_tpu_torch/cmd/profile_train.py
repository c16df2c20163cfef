#!/usr/bin/env python
"""Where the time of the port's training step goes, on one NVIDIA card.

    python -m aps_tpu_torch.cmd.profile_train [--model flagship|xfmr_abs]
        [--out profile.txt]

Builds a full-width model (the flagship, or with --model xfmr_abs the
long-form abs-pose transformer; attention dropout 0 in the encoder, the
other dropouts 0.1) from a seed under task asr@ctc_xent (ctc weight 0.2,
label smoothing 0.1) and the single-card trainer (Adam 1e-4, clip 5.0),
and takes steps on one seeded batch of 32 x 8 s (long-form: 8 x 24 s) with
24 labels each, padded as the loader's length grid pads it. It prints the cold
first step, the median and p90 of RUNS warm steps (host clock around a
synchronised step), the peak device memory, and a torch.profiler trace of
one warm step: device time, its share of the warm median, kernel launches
and the device time of the leading kernels. --out takes the profiler's
table."""

import argparse
import statistics
import subprocess
import tempfile

import numpy as np
import torch

from aps_tpu_torch.cmd.profile_decode import (on_device, profile,
                                              synced_secs)
from aps_tpu_torch.flagship import MODELS, build_flagship
from aps_tpu_torch.libs import aps_task, aps_trainer
from aps_tpu_torch.loader.utils import quantize_len
from aps_tpu_torch.ops import build

SR = 16000
VOCAB = 4233
# model -> (seconds per utterance, utterances per batch)
SHAPES = {"flagship": (8, 32), "xfmr_abs": (24, 8)}
LABELS = 24
RUNS = 10
TOP = 20
SEED = 777


def seeded_batch(utt_secs: int, batch: int) -> dict:
    rng = np.random.default_rng(SEED)
    valid = utt_secs * SR
    src = np.zeros((batch, quantize_len(valid, floor=8000, factor=1.2)),
                   dtype=np.float32)
    src[:, :valid] = 0.1 * rng.standard_normal((batch, valid))
    return {
        "#utt": batch,
        "#tok": batch * (LABELS + 1),
        "src_pad": src,
        "src_len": np.full(batch, valid, dtype=np.int64),
        "tgt_pad": rng.integers(1, VOCAB - 3, (batch, LABELS)),
        "tgt_len": np.full(batch, LABELS, dtype=np.int64),
    }


def run(out: str, name: str = "flagship") -> None:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.manual_seed(SEED)
    dev = torch.device("cuda:0")
    utt_secs, batch = SHAPES[name]
    conf = MODELS[name][1](VOCAB)
    task = aps_task(conf["task"], build_flagship(conf), blank=VOCAB - 1,
                    **conf["task_conf"])
    egs = seeded_batch(utt_secs, batch)
    print(f"model {name}: one batch of {batch} x {egs['src_pad'].shape[1]} "
          "samples", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        trainer = aps_trainer("dp")(task, device=dev, checkpoint=tmp,
                                    **conf["trainer_conf"])

        def step():
            if not trainer.train_one_step(egs):
                raise RuntimeError("the step was skipped: non-finite loss "
                                   "or gradient norm")

        torch.cuda.reset_peak_memory_stats(dev)
        cold = synced_secs(step)
        warm = [synced_secs(step) for _ in range(RUNS)]
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        med = statistics.median(warm)
        p90 = float(np.percentile(warm, 90))
        losses = [float(v) for v in trainer.reporter.stats["loss"]]
        print(f"N={batch} x {utt_secs} s: cold first step {cold:.4f} s; "
              f"warm median {med:.4f} s, p90 {p90:.4f} s over {RUNS} steps "
              f"= {batch * utt_secs / med:.2f} audio-s/s; peak memory "
              f"{peak:.3f} GiB; loss {losses[0]:.4f} -> {losses[-1]:.4f} "
              f"({card})", flush=True)
        build.reset_launches()
        device_ms, wall, launches, prof = profile(step)
    print(f"profiled step: device time {device_ms:.3f} ms in {wall:.4f} s "
          f"wall, busy share {device_ms / 1e3 / wall:.4f} (of the warm "
          f"median {device_ms / 1e3 / med:.4f}); {launches} kernel "
          f"launches; port kernels {dict(build.LAUNCHES)}", flush=True)
    ops = [e for e in prof.key_averages() if on_device(e)]
    ops.sort(key=lambda e: -e.self_device_time_total)
    for e in ops[:TOP]:
        ms = e.self_device_time_total / 1e3
        print(f"  {ms:9.3f} ms {ms / device_ms:7.2%} {e.count:6d} calls "
              f" {e.key[:90]}", flush=True)
    if out:
        with open(out, "w") as fd:
            fd.write(f"N={batch} ({card})\n" + prof.key_averages().table(
                sort_by="self_device_time_total", row_limit=80))


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="Profile the training step of a full-width model on "
        "one card")
    parser.add_argument("--model", choices=sorted(SHAPES),
                        default="flagship",
                        help="the flagship (32 x 8 s) or the long-form "
                        "abs-pose model (8 x 24 s)")
    parser.add_argument("--out", type=str, default="",
                        help="file for the profiler's table")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs a CUDA device")
    run(args.out, args.model)


if __name__ == "__main__":
    main()
