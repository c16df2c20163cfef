#!/usr/bin/env python
"""Where the time of the port's batched decode goes, on one NVIDIA card.

    python -m aps_tpu_torch.cmd.profile_decode [--model flagship|xfmr_abs]
        [--out profile.txt]

Builds a full-width model from a seed (the flagship, or with --model
xfmr_abs the long-form abs-pose transformer), with the peaky output layers
chip_smoke.py gives it, and for each batch size decodes batches of 8 s
(long-form: 24 s) utterances through beam_search_batch (beam 8, ctc weight
0.4, ctc beam 12, max_len 40), padded to their duration bucket as
decode_batch pads them. For each batch size (8 and 64; long-form: 4 and
16) it prints the cold first batch, the median
and p90 of RUNS warm batches (host clock around a synchronised search),
decode_enc alone, the peak device memory, and a torch.profiler trace of
one warm batch: device time, its share of the profiled wall and of the
warm median, kernel launches and the device time of the leading kernels.
--out takes the profiler's tables."""

import argparse
import statistics
import subprocess
import time

import numpy as np
import torch

from aps_tpu_torch.asr.beam_search.transformer import beam_search_batch
from aps_tpu_torch.asr.beam_search.utils import stack_padded
from aps_tpu_torch.cmd.decode_batch import quantize_dur
from aps_tpu_torch.flagship import MODELS, build_flagship, init_weights
from aps_tpu_torch.ops import build

SR = 16000
VOCAB = 4233
# model -> (seconds per utterance, batch sizes)
SHAPES = {"flagship": (8, (8, 64)), "xfmr_abs": (24, (4, 16))}
SEARCH = dict(sos=VOCAB - 3, eos=VOCAB - 2, beam_size=8, nbest=1,
              max_len=40, ctc_weight=0.4, allow_partial=True)
RUNS = 10
TOP = 15
SEED = 777


def synced_secs(fn) -> float:
    torch.cuda.synchronize()
    beg = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - beg


def on_device(evt) -> bool:
    """A kernel or copy that ran on the card (not a range an annotation
    such as the optimizer's step draws around them)."""
    return evt.device_type == torch.autograd.DeviceType.CUDA and \
        not getattr(evt, "is_user_annotation", False)


def profile(fn):
    """(device ms, profiled wall s, kernel launches, profiler) of fn()."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        wall = synced_secs(fn)
    device_us, launches = 0.0, 0
    for evt in prof.events():
        if on_device(evt):
            device_us += evt.self_device_time_total
        elif "LaunchKernel" in evt.name:
            launches += 1
    return device_us / 1e3, wall, launches, prof


def run(out: str, name: str = "flagship") -> None:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    gen = torch.Generator().manual_seed(SEED)
    utt_secs, batches = SHAPES[name]
    model = build_flagship(MODELS[name][0](vocab_size=VOCAB, small=False))
    init_weights(model, gen)
    with torch.no_grad():
        model.decoder.output.weight.mul_(8.0)
        model.ctc_head.weight.mul_(8.0)
    model = model.to(dev).eval()
    pad_to = quantize_dur(utt_secs * SR, base=SR)
    print(f"model {name}: utterances of {utt_secs} s padded to {pad_to} "
          "samples", flush=True)
    tables = []
    for B in batches:
        batch = [(0.1 * torch.randn(utt_secs * SR, generator=gen)).numpy()
                 for _ in range(B)]
        audio = B * utt_secs

        def decode():
            return beam_search_batch(model, batch, device=dev,
                                     pad_to=pad_to, **SEARCH)

        def encode():
            with torch.inference_mode():
                x, lens, _ = stack_padded(batch, pad_to=pad_to, device=dev)
                model.decode_enc(x, torch.as_tensor(lens, device=dev))

        torch.cuda.reset_peak_memory_stats(dev)
        cold = synced_secs(decode)
        warm = [synced_secs(decode) for _ in range(RUNS)]
        enc = statistics.median(synced_secs(encode) for _ in range(5))
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        med = statistics.median(warm)
        p90 = float(np.percentile(warm, 90))
        print(f"B={B}: cold first batch {cold:.4f} s; warm median "
              f"{med:.4f} s, p90 {p90:.4f} s over {RUNS} batches = "
              f"{audio / med:.2f} audio-s/s; decode_enc {enc * 1e3:.3f} ms; "
              f"peak memory {peak:.3f} GiB ({card})", flush=True)
        build.reset_launches()
        device_ms, wall, launches, prof = profile(decode)
        steps = build.LAUNCHES["ctc_score_step"]
        print(f"B={B} profiled batch: device time {device_ms:.3f} ms in "
              f"{wall:.4f} s wall, busy share {device_ms / 1e3 / wall:.4f} "
              f"(of the warm median {device_ms / 1e3 / med:.4f}); "
              f"{launches} kernel launches, {steps} search steps, "
              f"{launches / max(steps, 1):.1f} launches per step; port "
              f"kernels {dict(build.LAUNCHES)}", flush=True)
        ops = [e for e in prof.key_averages() if on_device(e)]
        ops.sort(key=lambda e: -e.self_device_time_total)
        for e in ops[:TOP]:
            ms = e.self_device_time_total / 1e3
            print(f"  {ms:9.3f} ms {ms / device_ms:7.2%} {e.count:6d} calls "
                  f" {e.key[:90]}", flush=True)
        tables.append(f"B={B} ({card})\n" + prof.key_averages().table(
            sort_by="self_device_time_total", row_limit=60))
    if out:
        with open(out, "w") as fd:
            fd.write("\n\n".join(tables))


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="Profile the batched decode of a full-width model on "
        "one card")
    parser.add_argument("--model", choices=sorted(SHAPES),
                        default="flagship",
                        help="the flagship (8 s utterances) or the long-form "
                        "abs-pose model (24 s utterances)")
    parser.add_argument("--out", type=str, default="",
                        help="file for the profiler's tables")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_decode needs a CUDA device")
    run(args.out, args.model)


if __name__ == "__main__":
    main()
