#!/usr/bin/env python
"""Pack the audio of a wav.scp into archives and an scp of offsets (port of
cmd/archive_wav.py; host only).

    python -m aps_tpu_torch.cmd.archive_wav wav.scp out.ark out.scp
        [--sr 16000] [--num-jobs 1] [--num-arks 1] [--segment segments]

Writes what aps_tpu's command writes: "key ark_path:offset" lines and, at
each offset, a plain 16-bit wav (io/audio.py::write_audio), which
AudioReader reads back. With --segment each segment's slice is archived
under its own key; with --num-arks N the utterances go round robin into N
shards out.<n>.ark (each with its scp out.<n>.scp, merged sorted into
out.scp and removed), packed by min(--num-jobs, N) worker processes. An
utterance that cannot be read is skipped with a warning; a shard whose
every utterance failed raises."""

import argparse
import logging
import multiprocessing as mp
import os
import sys

from aps_tpu_torch.io import AudioReader, group_segments, write_audio
from aps_tpu_torch.utils import get_logger

logger = get_logger(__name__)
PROG_INTERVAL = 500


def pack(jobid: int, num_shards: int, args) -> str:
    """Archive every num_shards-th utterance into shard `jobid`; returns
    the shard's scp."""
    if num_shards > 1:
        stem, ext = os.path.splitext(args.out_ark)
        ark_path = f"{stem}.{jobid}{ext}"
        scp_path = f"{os.path.splitext(args.out_scp)[0]}.{jobid}.scp"
    else:
        ark_path, scp_path = args.out_ark, args.out_scp
    reader = AudioReader(args.wav_scp, sr=args.sr)
    sr = args.sr if args.sr > 0 else 16000
    segments = group_segments(args.segment, sr) if args.segment else None
    done, failed = 0, 0
    with open(ark_path, "wb") as ark, open(scp_path, "w") as scp:

        def emit(key, samps):
            offset = ark.tell()
            write_audio(ark, samps, sr=sr)
            scp.write(f"{key} {ark_path}:{offset}\n")

        for n, key in enumerate(reader.index_keys):
            if n % num_shards != jobid:
                continue
            try:
                samps = reader[key]
            except Exception as exc:
                logger.warning(f"Worker {jobid}: reading {key} failed "
                               f"({exc}), skipped")
                failed += 1
                continue
            if segments is None:
                emit(key, samps)
            elif key in segments:
                for seg_key, beg, end in segments[key]:
                    emit(seg_key, samps[..., beg:end])
            done += 1
            if done % PROG_INTERVAL == 0:
                logger.info(f"Worker {jobid}: {done} utterances...")
    if failed and not done:
        raise RuntimeError(
            f"Worker {jobid}: ALL {failed} utterances failed to read — "
            f"check --sr and the wav.scp entries")
    logger.info(f"Worker {jobid}: archived {done} utterances to {ark_path}")
    return scp_path


def run(args) -> None:
    # --num-arks alone decides the shard count; --num-jobs only bounds the
    # worker pool (one worker writes a shard)
    shards = max(args.num_arks, 1)
    if args.num_jobs > shards:
        logger.info(f"--num-jobs {args.num_jobs} > --num-arks {shards}: "
                    f"only {shards} workers can run (one per ark shard)")
    if shards == 1:
        pack(0, 1, args)
        return
    # spawn: the workers start afresh (never fork a process with threads)
    with mp.get_context("spawn").Pool(min(args.num_jobs, shards)) as pool:
        scps = pool.starmap(pack, [(n, shards, args) for n in range(shards)])
    with open(args.out_scp, "w") as out:
        entries = []
        for scp in scps:
            with open(scp) as fd:
                entries += fd.readlines()
            os.remove(scp)
        out.writelines(sorted(entries))
    logger.info(f"Merged {len(scps)} shard scps into {args.out_scp}")


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Archive wav files into ark shards (PyTorch port)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("wav_scp", type=str)
    parser.add_argument("out_ark", type=str)
    parser.add_argument("out_scp", type=str)
    parser.add_argument("--sr", type=int, default=16000)
    parser.add_argument("--num-jobs", type=int, default=1,
                        help="Parallel packing processes")
    parser.add_argument("--num-arks", type=int, default=1,
                        help="Number of ark shards to produce")
    parser.add_argument("--segment", type=str, default="",
                        help="Kaldi segments file: archive per-segment "
                        "slices instead of whole utterances")
    return parser


def main(argv=None) -> None:
    if not logging.getLogger().handlers:
        logging.basicConfig(
            stream=sys.stderr, level=logging.INFO,
            format="%(asctime)s [%(name)s:%(lineno)d] %(message)s")
    run(make_parser().parse_args(argv))


if __name__ == "__main__":
    main()
