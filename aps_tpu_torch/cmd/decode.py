#!/usr/bin/env python
"""Single-utterance ASR decoding with the PyTorch port (port of
cmd/decode.py), and the decoder wrapper that decode_batch shares.

    python -m aps_tpu_torch.cmd.decode wav.scp best.txt --am <cpt_dir>
        [--dict dict] [--beam-size 8] [--ctc-weight 0.4]
        [--lm <lm_dir or arpa> --lm-weight 0.2] [--dump-nbest nbest]
        [--function beam_search|greedy_search] [--segment segments]

Takes aps_tpu's arguments (aps_tpu_torch.opts.DecodingParser and the
command's own) and writes the same files: "key<TAB>transcript" lines and,
with --dump-nbest, the nbest format

    <nbest n>
    key1
    score-1 num-tok-1 hyp-1
    ...

--lm names either an LM checkpoint directory (asr@rnn_lm or asr@xfmr_lm:
shallow fusion inside the search, on the card) or an n-gram file (a text
ARPA file; a kenlm binary needs kenlm): a wide search without fusion
(nbest = max(nbest, beam_size)), every hypothesis rescored with lm_weight
x its n-gram log-probability, then sorted again, as aps_tpu does. The body
runs with cuBLAS's and cuDNN's TF32 flags off (float32), restored after.
It decodes on the card (--device-id picks which) and raises when torch
sees none; --device cpu asks for the CPU. asr@att and asr@enh_att decode
through the RNN decoder's search (asr/beam_search/att.py), asr@xfmr and
asr@enh_xfmr through the transformer's, asr@transducer,
asr@xfmr_transducer and streaming_asr@transducer through the
frame-synchronous transducer search
(asr/beam_search/transducer.py, which reads beam_size, nbest, len_norm and
lm_weight and ignores the other options; aps_tpu's decode drops lm_weight
there, so its transducer search fuses no LM, where the port fuses one as
its decode_batch does) and asr@ctc and streaming_asr@ctc (its offline
pass, under the chunk-context mask) through CtcApi's prefix search on the
host, the wave padded onto aps_tpu's length grid (quantize_len(S,
floor=16000)) with its true length passed. A transducer's RNN LM must hold
the blank id (an LM of the AM's dictionary does not): the command raises a
ValueError before the first utterance, and before it opens its outputs,
otherwise. A multi-channel model (asr@enh_xfmr,
asr@enh_att) decodes C x S utterances, which --channel -1 (the default,
as in aps_tpu) reads. A checkpoint that takes features rather than
waveforms (its asr_transform starts from no spectrum: accept_raw false)
reads feats_or_wav_scp as a kaldi feats.scp (loader/kaldi_io.py), T x F
matrices, as aps_tpu does; its transform then runs no K1. --dtype
bfloat16 is read as aps_tpu's single-utterance search reads it: not at
all (its search drops the key), so the utterance decodes in float32;
decode_batch's batched search takes it."""

import argparse
import logging
import sys
import time
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from aps_tpu_torch.conf import load_dict
from aps_tpu_torch.const import UNK_TOKEN
from aps_tpu_torch.eval.asr import TextPostProcessor
from aps_tpu_torch.eval.wrapper import NnetEvaluator
from aps_tpu_torch.io import AudioReader, SegmentAudioReader, io_wrapper
from aps_tpu_torch.loader.kaldi_io import ScriptReader
from aps_tpu_torch.opts import DecodingParser
from aps_tpu_torch.utils import INFERENCE_PRECISION, matmul_precision

logger = logging.getLogger("aps_tpu_torch.decode")

beam_search_params = [
    "beam_size", "nbest", "max_len", "min_len", "len_norm", "lm_weight",
    "ctc_weight", "temperature", "len_penalty", "cov_penalty",
    "eos_threshold", "cov_threshold", "allow_partial", "end_detect",
    "approx_topk", "dtype"
]


class FasterDecoder(NnetEvaluator):
    """Beam-search decoder over a loaded checkpoint: run for one utterance,
    run_batch for a batch."""

    def __init__(self, cpt_dir: str, cpt_tag: str = "best",
                 function: str = "beam_search", device: str = "cuda",
                 device_id: int = -1):
        super(FasterDecoder, self).__init__(cpt_dir, cpt_tag=cpt_tag,
                                            device=device,
                                            device_id=device_id)
        name = self.conf["nnet"]
        if name in ("asr@att", "asr@enh_att"):
            from aps_tpu_torch.asr.beam_search import att as api
        elif name in ("asr@xfmr", "asr@enh_xfmr"):
            from aps_tpu_torch.asr.beam_search import transformer as api
        elif "transducer" in name:
            from aps_tpu_torch.asr.beam_search import transducer as api
        elif name in ("asr@ctc", "streaming_asr@ctc"):
            api = None
        else:
            raise NotImplementedError(f"decoding {name} is not ported yet")
        self.api = api
        self.function = function
        self.sos = self.conf["nnet_conf"].get("sos", -1)
        self.eos = self.conf["nnet_conf"].get("eos", -1)
        self.vocab_size = self.conf["nnet_conf"]["vocab_size"]

    def check_lm(self, lm, lm_weight: float) -> None:
        """Raise before anything is decoded or written where the search
        cannot fuse lm (a transducer's LM must hold the blank id)."""
        if "transducer" in self.conf["nnet"]:
            self.api.check_lm(self.nnet, lm, lm_weight)

    def _ctc(self, src, **kwargs) -> List[Dict]:
        """CtcApi's prefix search on one waveform (S samples, padded onto
        aps_tpu's length grid with floor 16000) or feature matrix (T x F,
        its frames padded with floor 100), as aps_tpu's decode does."""
        from aps_tpu_torch.asr.beam_search.ctc import CtcApi
        from aps_tpu_torch.loader.utils import quantize_len
        src = np.asarray(src, dtype=np.float32)
        if src.ndim == 1:
            S = src.shape[-1]
            src_pad = np.pad(src, (0, quantize_len(S, floor=16000) - S))
        elif not self.accept_raw:
            S = src.shape[0]
            src_pad = np.pad(src, ((0, quantize_len(S, floor=100) - S),
                                   (0, 0)))
        else:
            raise NotImplementedError("asr@ctc decodes single-channel "
                                      "waveforms (S samples) or features")
        with torch.inference_mode():
            logits, n_frames = self.nnet.ctc_logits(
                torch.from_numpy(src_pad)[None].to(self.device),
                torch.tensor([S], device=self.device))
            logits = logits[0, :int(n_frames[0])]
        return CtcApi(self.vocab_size - 1).beam_search(
            logits, sos=self.sos, eos=self.eos, **kwargs)

    def run(self, src, lm=None, **kwargs) -> List[Dict]:
        """Decode one waveform (S, or C x S for a multi-channel model) ->
        its nbest list."""
        if self.api is None:
            return self._ctc(src, **kwargs)
        fn = self.api.greedy_search if self.function == "greedy_search" \
            else self.api.beam_search
        return fn(self.nnet, src, lm=lm, sos=self.sos, eos=self.eos,
                  device=self.device, **kwargs)

    def run_batch(self, batch: List, lm=None, **kwargs) -> List[List[Dict]]:
        """Decode a list of waveforms (S or C x S) -> one nbest list
        each (asr@ctc: one utterance after another, as in aps_tpu)."""
        if self.api is None:
            kwargs.pop("pad_to", None)
            return [self._ctc(src, **kwargs) for src in batch]
        return self.api.beam_search_batch(self.nnet, batch, lm=lm,
                                          sos=self.sos, eos=self.eos,
                                          device=self.device, **kwargs)


def is_ngram(lm: str) -> bool:
    """--lm names an n-gram file (not an LM checkpoint directory)."""
    return Path(lm).is_file()


def load_nn_lm(args, sos: int):
    """The LM checkpoint args.lm on the decoder's device -> its adapter
    for the search (buffer of args.max_len + 1 tokens for a Transformer
    LM)."""
    from aps_tpu_torch.asr.beam_search.lm import lm_adapter
    lm_eval = NnetEvaluator(args.lm, cpt_tag=args.lm_tag,
                            device=args.device, device_id=args.device_id)
    logger.info(f"Loaded LM {args.lm} ({lm_eval.conf['nnet']}, epoch "
                f"{lm_eval.epoch}), weight {args.lm_weight}")
    return lm_adapter(lm_eval.nnet, max_len=args.max_len, sos=sos)


def search_kwargs(args) -> Dict:
    """The search's keyword arguments from the command line."""
    kwargs = {k: getattr(args, k) for k in beam_search_params
              if hasattr(args, k)}
    if getattr(args, "disable_unk", False):
        if not args.dict:
            raise RuntimeError("--disable-unk needs --dict to look up the "
                               "<unk> id")
        kwargs["unk"] = load_dict(args.dict)[UNK_TOKEN]
    return kwargs


def run(args) -> dict:
    """Decode args.feats_or_wav_scp into args.best (and args.dump_nbest).
    Returns the counts, audio seconds, decode seconds (in all and per
    utterance) and each utterance's best score."""
    decoder = FasterDecoder(args.am, cpt_tag=args.am_tag,
                            function=args.function, device=args.device,
                            device_id=args.device_id)
    with matmul_precision(INFERENCE_PRECISION, decoder.device):
        return _decode(args, decoder)


def _decode(args, decoder: FasterDecoder) -> dict:
    logger.info(f"Loaded {args.am} (epoch {decoder.epoch}) on "
                f"{decoder.device}")
    if not decoder.accept_raw:
        src_reader = ScriptReader(args.feats_or_wav_scp)
    elif args.segment:
        src_reader = SegmentAudioReader(args.feats_or_wav_scp, args.segment,
                                        sr=args.sr, channel=args.channel)
    else:
        src_reader = AudioReader(args.feats_or_wav_scp, sr=args.sr,
                                 channel=args.channel)
    lm, ngram = None, None
    if args.lm:
        if is_ngram(args.lm):
            # an n-gram scores on the host: search without fusion, rescore
            # every emitted hypothesis, emit the rescored best
            from aps_tpu_torch.asr.lm.ngram import NgramLM
            ngram = NgramLM(args.lm, load_dict(args.dict))
            logger.info(f"Loaded ngram LM {args.lm} (nbest rescoring, "
                        f"weight {args.lm_weight})")
        else:
            lm = load_nn_lm(args, decoder.sos)
            decoder.check_lm(lm, args.lm_weight)
    processor = TextPostProcessor(args.dict, space=args.space,
                                  show_unk=args.show_unk, spm=args.spm)
    kwargs = search_kwargs(args)
    stdout_top, top = io_wrapper(args.best, "w")
    if args.dump_nbest:
        stdout_nbest, nbest_fd = io_wrapper(args.dump_nbest, "w")
        nbest_fd.write(f"{args.nbest}\n")
    stats = {"utts": 0, "audio_secs": 0.0, "decode_secs": 0.0,
             "utt_secs": [], "scores": {}}
    for key, src in src_reader:
        if decoder.device.type == "cuda":
            torch.cuda.synchronize(decoder.device)
        start = time.perf_counter()
        if ngram is not None:
            wide = dict(kwargs, nbest=max(args.nbest, args.beam_size))
            nbest_hypos = decoder.run(src, lm=None, **wide)
            for hyp in nbest_hypos:
                hyp["score"] += args.lm_weight * ngram.score(
                    hyp["trans"][1:-1])
            nbest_hypos = sorted(nbest_hypos, key=lambda h: h["score"],
                                 reverse=True)[:args.nbest]
        else:
            nbest_hypos = decoder.run(src, lm=lm, **kwargs)
        stats["utt_secs"].append(time.perf_counter() - start)
        stats["decode_secs"] += stats["utt_secs"][-1]
        if not nbest_hypos:
            raise RuntimeError(f"{key}: the search returned no hypothesis")
        nbest = [f"{key}\n"]
        for idx, hyp in enumerate(nbest_hypos):
            # remove sos/eos
            trans = processor.run(hyp["trans"][1:-1])
            nbest.append(f"{hyp['score']:.3f}\t"
                         f"{len(hyp['trans']) - 2:d}\t{trans}\n")
            if idx == 0:
                top.write(f"{key}\t{trans}\n")
                stats["scores"][key] = hyp["score"]
        if args.dump_nbest:
            nbest_fd.write("".join(nbest))
        stats["utts"] += 1
        if decoder.accept_raw:
            stats["audio_secs"] += src.shape[-1] / args.sr
        if stats["utts"] % 50 == 0:
            top.flush()
            logger.info(f"Processed {stats['utts']} utterances...")
    if not stdout_top:
        top.close()
    if args.dump_nbest and not stdout_nbest:
        nbest_fd.close()
    cost = stats["decode_secs"]
    logger.info(f"Decoded {stats['utts']} utterances in {cost:.3f} s on "
                f"{decoder.device}, RTF = "
                f"{cost / max(stats['audio_secs'], 1e-6):.5f}")
    return stats


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="ASR decoding with beam search (PyTorch port)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
        parents=[DecodingParser.parser])
    parser.add_argument("--sr", type=int, default=16000)
    parser.add_argument("--segment", type=str, default="")
    parser.add_argument("--space", type=str, default="")
    parser.add_argument("--show-unk", type=str, default="<unk>")
    parser.add_argument("--dump-nbest", type=str, default="")
    parser.add_argument("--function", type=str, default="beam_search",
                        choices=["beam_search", "greedy_search"])
    return parser


def main(argv=None) -> dict:
    if not logging.getLogger().handlers:
        logging.basicConfig(
            stream=sys.stderr, level=logging.INFO,
            format="%(asctime)s [%(name)s:%(lineno)d] %(message)s")
    return run(make_parser().parse_args(argv))


if __name__ == "__main__":
    main()
