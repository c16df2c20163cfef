#!/usr/bin/env python
"""Batched ASR decoding with the PyTorch port (port of cmd/decode_batch.py).

    python -m aps_tpu_torch.cmd.decode_batch wav.scp best.txt --am <cpt_dir>
        [--dict dict] [--batch-size 8] [--beam-size 8] [--ctc-weight 0.4]

Takes the arguments of aps_tpu's decoder (aps_tpu_torch.opts.
DecodingParser), reads the same checkpoint directory and wav.scp, buckets
utterances on the same duration grid and writes the same
"key<TAB>transcript" lines. It decodes on the card (--device-id picks
which) and raises when torch sees none; --device cpu asks for the CPU in so
many words, where the kernels' plain versions run. The wall time of the
decode loop is logged with the real-time factor and audio seconds per
second."""

import argparse
import logging
import sys
import time

import torch

from aps_tpu_torch.io import AudioReader, io_wrapper
from aps_tpu_torch.opts import DecodingParser
from aps_tpu_torch.cmd.decode import FasterDecoder, beam_search_params
from aps_tpu_torch.conf import load_dict
from aps_tpu_torch.const import UNK_TOKEN
from aps_tpu_torch.eval.asr import TextPostProcessor

logger = logging.getLogger("aps_tpu_torch.decode_batch")


def quantize_dur(num_samples: int, grid: float = 1.25,
                 base: int = 16000) -> int:
    """Geometric duration grid: the utterances of one bucket pad to the
    same sample count."""
    length = base
    while length < num_samples:
        length = int(length * grid)
    return length


def run(args) -> dict:
    """Decode args.feats_or_wav_scp into args.best. Returns the counts,
    audio seconds, decode seconds (in all and per batch, host clock around
    the synchronised search) and each utterance's best score."""
    if args.lm:
        raise NotImplementedError("--lm: LM fusion is not ported yet")
    decoder = FasterDecoder(args.am, cpt_tag=args.am_tag,
                            device=args.device, device_id=args.device_id)
    logger.info(f"Loaded {args.am} (epoch {decoder.epoch}) on "
                f"{decoder.device}")
    src_reader = AudioReader(args.feats_or_wav_scp, sr=args.sr,
                             channel=args.channel)
    processor = TextPostProcessor(args.dict, space=args.space,
                                  show_unk=args.show_unk, spm=args.spm)
    kwargs = {k: getattr(args, k) for k in beam_search_params
              if hasattr(args, k)}
    if args.disable_unk:
        if not args.dict:
            raise RuntimeError("--disable-unk needs --dict to look up the "
                               "<unk> id")
        kwargs["unk"] = load_dict(args.dict)[UNK_TOKEN]
    stdout_top, top = io_wrapper(args.best, "w")
    stats = {"utts": 0, "audio_secs": 0.0, "decode_secs": 0.0,
             "batch_secs": [], "scores": {}}
    buckets = {}

    def flush_bucket(entries, bucket=-1):
        if decoder.device.type == "cuda":
            torch.cuda.synchronize(decoder.device)
        start = time.perf_counter()
        hyps = decoder.run_batch([s for _, s in entries], pad_to=bucket,
                                 **kwargs)
        stats["batch_secs"].append(time.perf_counter() - start)
        stats["decode_secs"] += stats["batch_secs"][-1]
        for (key, _), nbest in zip(entries, hyps):
            if not nbest:
                raise RuntimeError(f"{key}: the search returned no "
                                   "hypothesis")
            trans = processor.run(nbest[0]["trans"][1:-1])
            stats["scores"][key] = nbest[0]["score"]
            top.write(f"{key}\t{trans}\n")
        stats["utts"] += len(entries)
        top.flush()
        logger.info(f"Processed {stats['utts']} utterances ...")

    for key, src in src_reader:
        bucket = quantize_dur(src.shape[-1], base=args.sr)
        buckets.setdefault(bucket, []).append((key, src))
        stats["audio_secs"] += src.shape[-1] / args.sr
        if len(buckets[bucket]) == args.batch_size:
            flush_bucket(buckets.pop(bucket), bucket=bucket)
    for bucket, entries in buckets.items():
        flush_bucket(entries, bucket=bucket)
    if not stdout_top:
        top.close()
    cost = stats["decode_secs"]
    logger.info(f"Decoded {stats['utts']} utterances "
                f"({stats['audio_secs']:.1f} s of audio) in {cost:.3f} s on "
                f"{decoder.device}: RTF = "
                f"{cost / max(stats['audio_secs'], 1e-6):.5f}, "
                f"{stats['audio_secs'] / max(cost, 1e-9):.2f} audio-s/s")
    return stats


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Batch ASR decoding (PyTorch port)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
        parents=[DecodingParser.parser])
    parser.add_argument("--sr", type=int, default=16000)
    parser.add_argument("--space", type=str, default="")
    parser.add_argument("--show-unk", type=str, default="<unk>")
    parser.add_argument("--batch-size", type=int, default=8)
    return parser


def main(argv=None) -> dict:
    if not logging.getLogger().handlers:
        logging.basicConfig(
            stream=sys.stderr, level=logging.INFO,
            format="%(asctime)s [%(name)s:%(lineno)d] %(message)s")
    return run(make_parser().parse_args(argv))


if __name__ == "__main__":
    main()
