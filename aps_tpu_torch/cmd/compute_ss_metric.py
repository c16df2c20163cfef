#!/usr/bin/env python
"""Compute SiSNR/SNR/PESQ/STOI/SDR between separated and reference audio
(port of cmd/compute_ss_metric.py; the same arguments and the same
report).

    python -m aps_tpu_torch.cmd.compute_ss_metric spk1.scp,spk2.scp \
        s1.scp,s2.scp [--metric sisnr|snr|pesq|stoi|sdr] [--sr 16000]
        [--utt2class utt2class] [--per-utt per_utt.txt] [--utt-ali ali.txt]

Several speakers are given as comma-separated scps and scored under the
best permutation. Scoring is numpy on the host, as in aps_tpu: the
command touches no device. pesq needs the pypesq package and raises
ImportError without it; stoi and sdr use the built-in implementations
(aps_tpu_torch.metric.stoi, BSS-eval) when pystoi or museval is absent."""

import argparse

import numpy as np

from aps_tpu_torch.io import AudioReader
from aps_tpu_torch.metric.reporter import AverageReporter
from aps_tpu_torch.metric.sse import permute_sse_metric


def run(args) -> None:
    sep_scps = args.sep_scp.split(",")
    ref_scps = args.ref_scp.split(",")
    if len(sep_scps) != len(ref_scps):
        raise RuntimeError(f"{len(sep_scps)} separated scps vs "
                           f"{len(ref_scps)} reference scps")
    sep_readers = [AudioReader(scp, sr=args.sr) for scp in sep_scps]
    ref_readers = [AudioReader(scp, sr=args.sr) for scp in ref_scps]
    units = {"sisnr": "dB", "snr": "dB", "sdr": "dB", "pesq": "MOS",
             "stoi": ""}
    reporter = AverageReporter(spk2class=args.utt2class,
                               name=args.metric.upper(),
                               unit=units.get(args.metric, ""))
    utt_val = open(args.per_utt, "w") if args.per_utt else None
    utt_ali = open(args.utt_ali, "w") if args.utt_ali else None
    want_ali = utt_ali is not None
    try:
        for key, _ in sep_readers[0]:
            sep = [r[key] for r in sep_readers]
            ref = [r[key] for r in ref_readers]
            S = min(min(s.shape[-1] for s in sep),
                    min(r.shape[-1] for r in ref))
            sep = np.stack([s[..., :S] for s in sep])
            ref = np.stack([r[..., :S] for r in ref])
            if len(sep_readers) == 1:
                sep, ref = sep[0], ref[0]
            val = permute_sse_metric(args.metric, ref, sep, fs=args.sr,
                                     compute_permutation=want_ali)
            ali = None
            if want_ali and isinstance(val, tuple):
                val, ali = val
            reporter.add(key, val)
            if utt_val:
                utt_val.write(f"{key}\t{val:.2f}\n")
            if utt_ali and ali is not None:
                utt_ali.write(f"{key}\t" + " ".join(map(str, ali)) + "\n")
    finally:
        for fd in (utt_val, utt_ali):
            if fd:
                fd.close()
    reporter.report()


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Compute SSE metrics (SiSNR/SNR/PESQ/STOI/SDR)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("sep_scp", type=str,
                        help="Separated audio scp (comma-separated list)")
    parser.add_argument("ref_scp", type=str,
                        help="Reference audio scp (comma-separated list)")
    parser.add_argument("--metric", type=str, default="sisnr",
                        choices=["sisnr", "snr", "pesq", "stoi", "sdr"])
    parser.add_argument("--sr", type=int, default=16000)
    parser.add_argument("--utt2class", type=str, default="")
    parser.add_argument("--per-utt", type=str, default="",
                        help="If given, write per-utterance metric values "
                        "to this file")
    parser.add_argument("--utt-ali", type=str, default="",
                        help="If given, write the best speaker permutation "
                        "per utterance to this file")
    return parser


def main(argv=None) -> None:
    run(make_parser().parse_args(argv))


if __name__ == "__main__":
    main()
