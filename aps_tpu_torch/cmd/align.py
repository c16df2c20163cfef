#!/usr/bin/env python
"""CTC forced alignment with the PyTorch port (port of cmd/align.py).

    python -m aps_tpu_torch.cmd.align wav.scp text alignment --am <cpt_dir>
        [--am-tag best] [--dict dict] [--space ""] [--spm ""] [--sr 16000]
        [--channel -1] [--device cuda|cpu] [--device-id -1]

Takes aps_tpu's arguments (aps_tpu_torch.opts.AlignmentParser and the
command's own) and writes the same lines, "key score ali...": for each
utterance of wav.scp with a transcript in `text`, the transcript mapped to
ids (TextPreProcessor: --dict, --space, --spm), the wave padded onto
aps_tpu's length grid (quantize_len(S, floor=16000)) with its true length
passed, the model's ctc_logits (its asr_transform, K1 on the card, then the
encoder, K3 in a conformer) cut to the valid frames, and CtcApi's Viterbi
alignment on the host (blank = vocab_size - 1): the path's log-probability
with three decimals and one label a frame. Utterances without a transcript
are skipped, as in aps_tpu. Only a model with ctc_logits aligns (asr@ctc,
streaming_asr@ctc); any other raises a ValueError that names the method
before the first utterance. Runs on the card (--device-id picks which) and
raises when torch sees none; --device cpu asks for the CPU."""

import argparse
import logging
import pprint
import sys

import numpy as np
import torch

from aps_tpu_torch.asr.beam_search.ctc import CtcApi
from aps_tpu_torch.eval.asr import TextPreProcessor
from aps_tpu_torch.eval.wrapper import NnetEvaluator
from aps_tpu_torch.io import AudioReader, TextReader, io_wrapper
from aps_tpu_torch.loader.utils import quantize_len
from aps_tpu_torch.opts import AlignmentParser
from aps_tpu_torch.utils import (INFERENCE_PRECISION, get_logger,
                                 matmul_precision)

logger = get_logger(__name__)


def run(args) -> dict:
    """Align args.wav_scp into args.alignment. Returns each aligned
    utterance's {"score", "align"}, by key."""
    print(f"Arguments in args:\n{pprint.pformat(vars(args))}", flush=True)
    evaluator = NnetEvaluator(args.am, cpt_tag=args.am_tag,
                              device=args.device, device_id=args.device_id)
    nnet, dev = evaluator.nnet, evaluator.device
    if not callable(getattr(nnet, "ctc_logits", None)):
        raise ValueError(f"{type(nnet).__name__} has no method ctc_logits: "
                         "only a CTC model (asr@ctc, streaming_asr@ctc) "
                         "aligns")
    vocab_size = evaluator.conf["nnet_conf"]["vocab_size"]
    api = CtcApi(vocab_size - 1)
    wav_reader = AudioReader(args.wav_scp, sr=args.sr, channel=args.channel)
    txt_reader = TextReader(args.text)
    processor = TextPreProcessor(args.dict, space=args.space, spm=args.spm)
    stdout, ali_fd = io_wrapper(args.alignment, "w")
    out = {}
    with torch.inference_mode(), matmul_precision(INFERENCE_PRECISION, dev):
        try:
            _align(nnet, dev, api, wav_reader, txt_reader, processor,
                   ali_fd, out)
        finally:
            if not stdout:
                ali_fd.close()
    logger.info(f"Aligned {len(out)} utterances done")
    return out


def _align(nnet, dev, api, wav_reader, txt_reader, processor, ali_fd,
           out) -> None:
    """Each utterance with a transcript: its line into ali_fd, its result
    into out."""
    for key, wav in wav_reader:
        if key not in txt_reader:
            continue
        seq = processor.run(txt_reader[key])
        S = wav.shape[-1]
        wav = np.pad(np.asarray(wav, dtype=np.float32),
                     (0, quantize_len(S, floor=16000) - S))
        logits, n_frames = nnet.ctc_logits(
            torch.from_numpy(wav)[None].to(dev),
            torch.tensor([S], device=dev))
        logits = logits[0, :int(n_frames[0])]
        out[key] = api.viterbi_align(logits, np.asarray(seq))
        ali = " ".join(map(str, out[key]["align"]))
        ali_fd.write(f"{key} {out[key]['score']:.3f} {ali}\n")
        if len(out) % 50 == 0:
            logger.info(f"Aligned {len(out)} utterances...")


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="CTC viterbi alignment (PyTorch port)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
        parents=[AlignmentParser.parser])
    parser.add_argument("--sr", type=int, default=16000)
    parser.add_argument("--space", type=str, default="")
    parser.add_argument("--spm", type=str, default="")
    return parser


def main(argv=None) -> dict:
    if not logging.getLogger().handlers:
        logging.basicConfig(
            stream=sys.stderr, level=logging.INFO,
            format="%(asctime)s [%(name)s:%(lineno)d] %(message)s")
    return run(make_parser().parse_args(argv))


if __name__ == "__main__":
    main()
