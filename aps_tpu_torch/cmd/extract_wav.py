#!/usr/bin/env python
"""Extract the audio of a wav.scp (archives included) into one wav file an
utterance (port of cmd/extract_wav.py; host only).

    python -m aps_tpu_torch.cmd.extract_wav wav.scp out_dir [--sr 16000]
        [--channel -1] [--segment segments]

Writes out_dir/<key>.wav for every utterance, or with --segment for every
segment's slice, 16-bit PCM as aps_tpu's command writes them."""

import argparse
import logging
import pathlib
import sys

from aps_tpu_torch.io import AudioReader, SegmentAudioReader, write_audio
from aps_tpu_torch.utils import get_logger

logger = get_logger(__name__)


def run(args) -> int:
    """-> the number of files written."""
    out_dir = pathlib.Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    if args.segment:
        reader = SegmentAudioReader(args.wav_scp, args.segment, sr=args.sr,
                                    channel=args.channel)
    else:
        reader = AudioReader(args.wav_scp, sr=args.sr, channel=args.channel)
    done = 0
    for done, (key, samps) in enumerate(reader, 1):
        write_audio(str(out_dir / f"{key}.wav"), samps, sr=args.sr)
        if done % 100 == 0:
            logger.info(f"Extracted {done} utterances...")
    logger.info(f"Extracted {done} utterances to {out_dir}")
    return done


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Extract wavs from wav.scp/archives (PyTorch port)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("wav_scp", type=str)
    parser.add_argument("out_dir", type=str)
    parser.add_argument("--sr", type=int, default=16000)
    parser.add_argument("--channel", type=int, default=-1,
                        help="Channel to keep for multi-channel audio "
                        "(-1: all)")
    parser.add_argument("--segment", type=str, default="",
                        help="Kaldi segments file: extract per-segment "
                        "slices")
    return parser


def main(argv=None) -> int:
    if not logging.getLogger().handlers:
        logging.basicConfig(
            stream=sys.stderr, level=logging.INFO,
            format="%(asctime)s [%(name)s:%(lineno)d] %(message)s")
    return run(make_parser().parse_args(argv))


if __name__ == "__main__":
    main()
