#!/usr/bin/env python
"""Global CMVN statistics over the outputs of a training config's feature
transform (port of cmd/compute_gmvn.py).

    python -m aps_tpu_torch.cmd.compute_gmvn wav.scp gmvn.npy --conf
        train.yaml [--transform auto|asr|enh] [--sr 16000] [--channel -1]
        [--segment segments] [--num-jobs 1] [--num-utts -1]
        [--device cuda|cpu] [--device-id -1]

Writes what aps_tpu's command writes: a (2, D) float32 .npy of [mean; std]
over every frame of every utterance, which CmvnTransform(gcmvn=...) reads.
The transform is the config's asr_transform (or, as aps_tpu builds it, an
asr transform of its enh_transform) with aug_prob 0 and without the steps
of KEYS_TO_REMOVE. Each utterance goes through it alone; its frames are
summed, and their squares, on the host in float32 as aps_tpu sums them.
One job runs on the card (--device-id picks which; K1 for an fbank-log
pair) and raises when torch sees none, --device cpu asks for the CPU;
--num-jobs N > 1 spawns N workers that each take every N-th utterance on
the CPU, as aps_tpu's do, and --num-utts caps the utterances (each worker
takes max(num_utts // N, 1))."""

import argparse
import logging
import sys

import numpy as np
import torch

from aps_tpu_torch.conf import load_yaml
from aps_tpu_torch.opts import add_device_args
from aps_tpu_torch.utils import get_logger

logger = get_logger(__name__)

# stages that must not contribute to the statistics (randomized or
# normalizing themselves)
KEYS_TO_REMOVE = ("perturb", "cmvn", "aug", "delta", "splice")


def build_transform(conf_path: str, which: str):
    """The config's feature transform for the statistics."""
    from aps_tpu_torch.libs import aps_transform
    conf = load_yaml(conf_path)
    if which == "auto":
        which = "asr" if "asr_transform" in conf else "enh"
    key = f"{which}_transform"
    if key not in conf:
        raise RuntimeError(f"No {key} configuration found in {conf_path}")
    trans_conf = dict(conf[key])
    trans_conf["aug_prob"] = 0
    feats = trans_conf.get("feats", "")
    trans_conf["feats"] = "-".join(
        t for t in feats.split("-") if t not in KEYS_TO_REMOVE)
    logger.info(f"Compute gmvn on feature {trans_conf['feats']}")
    return aps_transform("asr")(**trans_conf)


def accumulate(jobid: int, num_jobs: int, args):
    """Partial (sum, sum of squares, #frames) over every num_jobs-th
    utterance; a worker of several runs on the CPU."""
    from aps_tpu_torch.eval.wrapper import pick_device
    from aps_tpu_torch.io import AudioReader, SegmentAudioReader
    device = pick_device("cpu" if num_jobs > 1 else args.device,
                         args.device_id)
    transform = build_transform(args.conf, args.transform).to(device).eval()
    if args.segment:
        reader = SegmentAudioReader(args.wav_scp, args.segment, sr=args.sr,
                                    channel=args.channel)
    else:
        reader = AudioReader(args.wav_scp, sr=args.sr, channel=args.channel)
    acc_sum, acc_sqr, cnt, done = 0, 0, 0, 0
    for idx, (_, wav) in enumerate(reader):
        if idx % num_jobs != jobid:
            continue
        wav = torch.from_numpy(np.asarray(wav, dtype=np.float32))[None]
        with torch.inference_mode():
            out, _ = transform(wav.to(device), None)
        out = out.cpu().numpy()
        out = out.reshape(-1, out.shape[-1])
        acc_sum = acc_sum + out.sum(0)
        acc_sqr = acc_sqr + (out**2).sum(0)
        cnt += out.shape[0]
        done += 1
        if done % 100 == 0:
            logger.info(f"Worker {jobid}: processed {done} utterances...")
        if args.num_utts > 0 and done >= max(args.num_utts // num_jobs, 1):
            break
    return acc_sum, acc_sqr, cnt


def run(args) -> np.ndarray:
    """Write args.out_npy; returns the (2, D) statistics."""
    if args.num_jobs <= 1:
        parts = [accumulate(0, 1, args)]
    else:
        import multiprocessing as mp
        # spawn: the workers start afresh, on the CPU
        ctx = mp.get_context("spawn")
        with ctx.Pool(args.num_jobs) as pool:
            parts = pool.starmap(
                accumulate,
                [(j, args.num_jobs, args) for j in range(args.num_jobs)])
    acc_sum = sum(p[0] for p in parts)
    acc_sqr = sum(p[1] for p in parts)
    cnt = sum(p[2] for p in parts)
    mean = acc_sum / cnt
    std = np.sqrt(acc_sqr / cnt - mean**2)
    gmvn = np.stack([mean, std]).astype(np.float32)
    if np.isnan(gmvn).any():
        raise RuntimeError("Got NaN in gmvn statistics, please check")
    np.save(args.out_npy, gmvn)
    logger.info(f"Saved gcmvn stats over {cnt} frames to {args.out_npy}")
    return gmvn


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Compute global CMVN statistics (PyTorch port)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("wav_scp", type=str)
    parser.add_argument("out_npy", type=str)
    parser.add_argument("--conf", type=str, required=True,
                        help="Training yaml with the transform config")
    parser.add_argument("--transform", type=str, default="auto",
                        choices=["auto", "asr", "enh"],
                        help="Which transform section to use")
    parser.add_argument("--sr", type=int, default=16000)
    parser.add_argument("--channel", type=int, default=-1)
    parser.add_argument("--segment", type=str, default="",
                        help="Kaldi segments file")
    parser.add_argument("--num-jobs", type=int, default=1,
                        help="Parallel accumulation processes (on the CPU)")
    parser.add_argument("--num-utts", type=int, default=-1,
                        help="Cap the number of utterances used")
    add_device_args(parser)
    return parser


def main(argv=None) -> np.ndarray:
    if not logging.getLogger().handlers:
        logging.basicConfig(
            stream=sys.stderr, level=logging.INFO,
            format="%(asctime)s [%(name)s:%(lineno)d] %(message)s")
    return run(make_parser().parse_args(argv))


if __name__ == "__main__":
    main()
