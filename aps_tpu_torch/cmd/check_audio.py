#!/usr/bin/env python
"""Check that every utterance of a wav.scp reads and write its duration
(port of cmd/check_audio.py; host only).

    python -m aps_tpu_torch.cmd.check_audio wav.scp [--utt2dur utt2dur]
        [--sr 16000]

Logs each utterance that fails to read ("Bad utterance: key") and the
count; with --utt2dur writes "key seconds" lines (four decimals) for the
others, as aps_tpu's command does."""

import argparse
import logging
import sys

from aps_tpu_torch.io import AudioReader, io_wrapper
from aps_tpu_torch.utils import get_logger

logger = get_logger(__name__)


def run(args) -> int:
    """-> the number of bad utterances."""
    reader = AudioReader(args.wav_scp, sr=args.sr, failed_if_error=False)
    stdout, dur_fd = io_wrapper(args.utt2dur, "w") if args.utt2dur else \
        (True, None)
    bad = 0
    try:
        for key in reader.index_keys:
            samps = reader[key]
            if samps is None:
                logger.info(f"Bad utterance: {key}")
                bad += 1
                continue
            if dur_fd:
                dur = samps.shape[-1] / args.sr
                dur_fd.write(f"{key} {dur:.4f}\n")
    finally:
        if not stdout:
            dur_fd.close()
    logger.info(f"Checked {len(reader)} utterances, {bad} bad")
    return bad


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Check audio & dump durations (PyTorch port)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("wav_scp", type=str)
    parser.add_argument("--utt2dur", type=str, default="")
    parser.add_argument("--sr", type=int, default=16000)
    return parser


def main(argv=None) -> int:
    if not logging.getLogger().handlers:
        logging.basicConfig(
            stream=sys.stderr, level=logging.INFO,
            format="%(asctime)s [%(name)s:%(lineno)d] %(message)s")
    return run(make_parser().parse_args(argv))


if __name__ == "__main__":
    main()
