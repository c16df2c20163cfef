#!/usr/bin/env python
"""Batched ASR decoding with the PyTorch port (port of cmd/decode_batch.py).

    python -m aps_tpu_torch.cmd.decode_batch wav.scp best.txt --am <cpt_dir>
        [--dict dict] [--batch-size 8] [--beam-size 8] [--ctc-weight 0.4]
        [--lm <lm_dir> --lm-weight 0.2]

Takes the arguments of aps_tpu's decoder (aps_tpu_torch.opts.
DecodingParser), reads the same checkpoint directory and wav.scp, buckets
utterances on the same duration grid and writes the same
"key<TAB>transcript" lines. --lm names an LM checkpoint directory
(asr@rnn_lm or asr@xfmr_lm): the batched search fuses it (shallow fusion
at --lm-weight), which aps_tpu's command parses and then drops (its
run_batch gets no LM), while its beam_search_batch takes one. An n-gram
file raises NotImplementedError: aps_tpu has no batched n-gram path; decode
with aps_tpu_torch.cmd.decode or rescore the nbest with lm_rescore. The
body runs with cuBLAS's and cuDNN's TF32 flags off (float32), restored
after. It decodes on the card (--device-id picks which) and raises when
torch sees none; --device cpu asks for the CPU in so many words, where the
kernels' plain versions run. A multi-channel model (asr@enh_xfmr) decodes
C x S utterances (--channel -1, the default), padded on the sample axis
only (aps_tpu's batched search also pads the channel axis of a shorter
one). A transducer decodes through its batched frame-synchronous search
(with the LM, which must hold the blank id, or the command raises before
the first batch); asr@ctc and streaming_asr@ctc one utterance after
another through CtcApi, as in aps_tpu. The wall time of the decode loop is logged with the real-time factor
and audio seconds per second. As in aps_tpu, the wavs are read ahead on a
background thread (aps_tpu_torch/eval/pipeline.py::prefetch_iter, two
batches deep) while the card searches.

--data-parallel (with --distributed and its flags, one process a card):
every rank reads the whole scp and buckets it alike; each bucket's rows
are split over the ranks, each rank searches its block padded to the
bucket's length, as one process would pad it, and rank 0 gathers the
n-best lists in order and writes them (aps_tpu_torch.parallel.
sharded_map, over a gloo group on the host)."""

import argparse
import logging
import os
import sys
import time

import torch

from aps_tpu_torch import distributed
from aps_tpu_torch.io import AudioReader, io_wrapper
from aps_tpu_torch.opts import DecodingParser, add_distributed_args
from aps_tpu_torch.cmd.decode import (FasterDecoder, is_ngram, load_nn_lm,
                                      search_kwargs)
from aps_tpu_torch.eval.asr import TextPostProcessor
from aps_tpu_torch.eval.pipeline import prefetch_iter
from aps_tpu_torch.parallel import sharded_map
from aps_tpu_torch.utils import INFERENCE_PRECISION, matmul_precision

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
    if args.lm and is_ngram(args.lm):
        raise NotImplementedError(
            f"--lm {args.lm} is an n-gram file: the batched search fuses "
            "NN LMs only (as aps_tpu, which has no batched n-gram path); "
            "decode with aps_tpu_torch.cmd.decode, or rescore the nbest "
            "with aps_tpu_torch.cmd.lm_rescore")
    if args.data_parallel:
        device = distributed.launch(args)
        args.device_id = -1 if device.index is None else device.index
    elif args.distributed != "none":
        raise ValueError(f"--distributed {args.distributed} decodes with "
                         "--data-parallel only")
    decoder = FasterDecoder(args.am, cpt_tag=args.am_tag,
                            device=args.device, device_id=args.device_id)
    with matmul_precision(INFERENCE_PRECISION, decoder.device):
        return _decode(args, decoder)


def _decode(args, decoder: FasterDecoder) -> dict:
    logger.info(f"Loaded {args.am} (epoch {decoder.epoch}) on "
                f"{decoder.device}")
    src_reader = AudioReader(args.feats_or_wav_scp, sr=args.sr,
                             channel=args.channel)
    lm = load_nn_lm(args, decoder.sos) if args.lm else None
    decoder.check_lm(lm, args.lm_weight)
    processor = TextPostProcessor(args.dict, space=args.space,
                                  show_unk=args.show_unk, spm=args.spm)
    kwargs = search_kwargs(args)
    chief = distributed.rank() == 0
    stdout_top, top = io_wrapper(args.best if chief else os.devnull, "w")
    stats = {"utts": 0, "audio_secs": 0.0, "decode_secs": 0.0,
             "batch_secs": [], "scores": {}}
    buckets = {}

    def flush_bucket(entries, bucket=-1):
        if decoder.device.type == "cuda":
            torch.cuda.synchronize(decoder.device)
        start = time.perf_counter()
        hyps = sharded_map(
            lambda rows, pad_to: decoder.run_batch(rows, lm=lm,
                                                   pad_to=pad_to, **kwargs),
            [s for _, s in entries], pad_to=bucket)
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

    # the next utterances are read on a background thread while the card
    # searches (eval/pipeline.py); the lines keep the serial loop's order
    for key, src in prefetch_iter(iter(src_reader),
                                  depth=2 * args.batch_size):
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
    parser.add_argument("--data-parallel", action="store_true",
                        help="Split each decode batch over the processes "
                        "of --distributed, one a card")
    add_distributed_args(parser)
    return parser


def main(argv=None) -> dict:
    if not logging.getLogger().handlers:
        logging.basicConfig(
            stream=sys.stderr, level=logging.INFO,
            format="%(asctime)s [%(name)s:%(lineno)d] %(message)s")
    stats = run(make_parser().parse_args(argv))
    distributed.shutdown()
    return stats


if __name__ == "__main__":
    main()
