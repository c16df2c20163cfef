#!/usr/bin/env python
"""Compute WER/CER between hypothesis and reference transcriptions (port
of cmd/compute_wer.py; the same arguments and the same report).

    python -m aps_tpu_torch.cmd.compute_wer hyp.txt ref.txt [--cer true]
        [--utt2class utt2class] [--per-utt per_utt.txt] [--reduce sum|min]
        [--details true]

Multi-speaker output is given as comma-separated text files ("hyp1,hyp2"
vs "ref1,ref2") and scored permutation-invariantly (--reduce sum) or per
stream, the best one kept (--reduce min). Scoring is host work: the command
touches no device."""

import argparse
import math

from aps_tpu_torch.io import TextReader
from aps_tpu_torch.metric.asr import permute_wer
from aps_tpu_torch.metric.reporter import WerReporter
from aps_tpu_torch.opts import StrToBoolAction
from aps_tpu_torch.utils import get_logger

logger = get_logger(__name__)


class TransReader(object):
    """One TextReader per comma-separated transcription file."""

    def __init__(self, descriptor: str, cer: bool = False):
        self.readers = [
            TextReader(td, char=cer) for td in descriptor.split(",")
        ]

    def __len__(self):
        return len(self.readers)

    def __getitem__(self, key):
        return [reader[key] for reader in self.readers]

    def __contains__(self, key):
        return all(key in reader for reader in self.readers)

    def __iter__(self):
        for key in self.readers[0].index_keys:
            if not all(key in reader for reader in self.readers):
                logger.warning(f"Utterance {key} missing from some of the "
                               f"transcription files, skipped")
                continue
            yield key, self[key]


def run(args) -> None:
    hyp_reader = TransReader(args.hyp, cer=args.cer)
    ref_reader = TransReader(args.ref, cer=args.cer)
    if len(hyp_reader) != len(ref_reader):
        raise RuntimeError("#speakers do not match between hyp & ref: "
                           f"{len(hyp_reader)} vs {len(ref_reader)}")
    each_utt = open(args.per_utt, "w") if args.per_utt else None
    reporter = WerReporter(spk2class=args.utt2class,
                           name="CER" if args.cer else "WER", unit="%")
    for key, hyp in hyp_reader:
        if key not in ref_reader:
            continue
        ref = ref_reader[key]
        if args.reduce == "sum" or len(hyp_reader) == 1:
            err = permute_wer(hyp, ref, details=args.details)
            tot = sum(len(r) for r in ref)
        else:
            # min: score each hyp/ref stream separately, keep the best
            err, tot = [math.inf, 0, 0], 0
            for h, r in zip(hyp, ref):
                cur = permute_wer([h], [r], details=args.details)
                if sum(cur) < sum(err):
                    err, tot = cur, len(r)
        if each_utt:
            rate = f"{sum(err) / tot:.3f}" if tot else "INF"
            each_utt.write(f"{key}\t{rate}\n")
        reporter.add(key, err, tot)
    if each_utt:
        each_utt.close()
    reporter.report()


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Compute WER/CER",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("hyp", type=str,
                        help="Hypothesis transcriptions (multi-speaker: "
                        "comma-separated files)")
    parser.add_argument("ref", type=str,
                        help="Reference transcriptions (multi-speaker: "
                        "comma-separated files)")
    parser.add_argument("--cer", action=StrToBoolAction, default=False,
                        nargs="?", const=True,
                        help="Compute CER instead of WER")
    parser.add_argument("--utt2class", type=str, default="",
                        help="utt2class file for per-class breakdown")
    parser.add_argument("--per-utt", type=str, default="",
                        help="If given, write per-utterance error rates "
                        "to this file")
    parser.add_argument("--reduce", type=str, choices=["sum", "min"],
                        default="sum",
                        help="Multi-speaker reduction: permutation sum or "
                        "best single stream")
    parser.add_argument("--details", action=StrToBoolAction, default=False,
                        nargs="?", const=True)
    return parser


def main(argv=None) -> None:
    run(make_parser().parse_args(argv))


if __name__ == "__main__":
    main()
