#!/usr/bin/env python
"""Streaming CTC recognition, chunk by chunk (port of
demos/streaming_asr/rt_ctc.py).

    python -m aps_tpu_torch.cmd.rt_ctc <wav> --checkpoint <dir>
        [--dict dict] [--tag best] [--sr 16000] [--chunk-frames 16]
        [--device cuda|cpu] [--device-id -1]

Takes the same arguments and prints the same lines as the demo: the
utterance's features are computed once (the model's asr_transform,
fbank-log-cmvn through the log-mel kernel on the card), padded with the
model's lctx / rctx zero frames as the offline pass pads them, and fed to
the streaming_asr@ctc model's step in chunks of --chunk-frames frames plus
that context; after each chunk the greedy CTC collapse of the tokens so
far is printed as "[<first frame>] <tokens>" (the text with --dict), then
the real-time factor. The streamed tokens equal the greedy collapse of the
offline ctc_logits. Runs on the card by default (raises without one);
--device cpu asks for the CPU."""

import argparse
import time

import torch

from aps_tpu_torch.eval.asr import TextPostProcessor
from aps_tpu_torch.eval.wrapper import NnetEvaluator
from aps_tpu_torch.io import read_audio
from aps_tpu_torch.libs import aps_transform
from aps_tpu_torch.opts import add_device_args
from aps_tpu_torch.utils import INFERENCE_PRECISION, matmul_precision


def run(args):
    """-> the streamed token ids."""
    evaluator = NnetEvaluator(args.checkpoint, cpt_tag=args.tag,
                              device=args.device, device_id=args.device_id)
    dev, nnet = evaluator.device, evaluator.nnet
    nnet_conf = evaluator.conf["nnet_conf"]
    lctx = max(nnet_conf.get("lctx", 0), 0)
    rctx = max(nnet_conf.get("rctx", 0), 0)
    blank = nnet_conf["vocab_size"] - 1
    processor = TextPostProcessor(args.dict) if args.dict else None
    transform = aps_transform("asr")(
        **evaluator.conf["asr_transform"]).to(dev).eval()
    wav = read_audio(args.wav, sr=args.sr)
    state, prev_tok, hyp = None, blank, []
    chunk = args.chunk_frames
    t0 = time.time()
    with torch.inference_mode(), matmul_precision(INFERENCE_PRECISION, dev):
        feats, _ = transform(torch.from_numpy(wav)[None].to(dev), None)
        T = feats.shape[1]
        feats = torch.nn.functional.pad(feats, (0, 0, lctx, rctx))
        for beg in range(0, T, chunk):
            width = min(chunk, T - beg)
            logits, state = nnet.step(feats[:, beg:beg + width + lctx + rctx],
                                      state)
            for tok in logits[0].argmax(-1).tolist():
                if tok != blank and tok != prev_tok:
                    hyp.append(tok)
                prev_tok = tok
            text = processor.run(hyp) if processor is not None else hyp
            print(f"[{beg:5d}] {text}", flush=True)
    dur = wav.shape[-1] / args.sr
    cost = time.time() - t0
    print(f"Streamed {dur:.2f}s audio in {cost:.2f}s "
          f"(RTF = {cost / dur:.4f})", flush=True)
    return hyp


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Streaming CTC ASR, chunk by chunk (PyTorch port)")
    parser.add_argument("wav")
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--dict", default="")
    parser.add_argument("--tag", default="best")
    parser.add_argument("--sr", type=int, default=16000)
    parser.add_argument("--chunk-frames", type=int, default=16)
    add_device_args(parser)
    return parser


def main(argv=None):
    return run(make_parser().parse_args(argv))


if __name__ == "__main__":
    main()
