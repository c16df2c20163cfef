#!/usr/bin/env python
"""Rescore an nbest file with an NN or an n-gram LM (port of
cmd/lm_rescore.py; the same arguments and output).

    python -m aps_tpu_torch.cmd.lm_rescore nbest best.txt --lm <lm_dir or
        arpa> [--lm-weight 0.2] [--len-norm ...] [--dict dict]

Each hypothesis of the nbest file (decode.py's --dump-nbest format) gets
am_score + lm_weight * lm_score / (its token count if --len-norm), and
the best of each utterance is written as "key<TAB>transcript". What
aps_tpu does and the port reproduces:

  * --len-norm is parsed by type=bool, so any non-empty string (also
    "false") counts as true and only an empty one as false;
  * an NN LM reads sos and eos from the checkpoint's task_conf and falls
    back to 0 and 1; load_lm_conf stores them at the top level of the
    configuration instead, so a checkpoint that train_lm wrote is scored
    with ids 0 and 1 (logged).

An NN LM scores on the card (--device-id picks which; it raises when torch
sees none; --device cpu asks for the CPU) with cuBLAS's and cuDNN's TF32
flags off, restored after; an n-gram scores on the host."""

import argparse
import logging
import sys
from typing import List

import numpy as np
import torch

from aps_tpu_torch.cmd.decode import is_ngram
from aps_tpu_torch.conf import load_dict
from aps_tpu_torch.eval.wrapper import NnetEvaluator
from aps_tpu_torch.io import NbestReader, io_wrapper
from aps_tpu_torch.opts import add_device_args
from aps_tpu_torch.utils import INFERENCE_PRECISION, matmul_precision

logger = logging.getLogger("aps_tpu_torch.lm_rescore")


def nn_lm_score(lm, hyp: List[int], sos: int, eos: int,
                device=None) -> float:
    """ln p(hyp + [eos]) under an NN LM: the sequence sos + hyp, padded
    with eos to a multiple of 8 tokens (as aps_tpu pads it), through the
    LM in one call, its log-softmax read along the hypothesis."""
    L = len(hyp) + 1
    Lp = max(8, -(-L // 8) * 8)
    seq = np.full((1, Lp), eos, dtype=np.int64)
    seq[0, 0] = sos
    seq[0, 1:L] = hyp
    with torch.inference_mode():
        out, _ = lm(torch.from_numpy(seq).to(device))
        logp = torch.log_softmax(out[0].float(), -1)
        idx = torch.as_tensor(hyp + [eos], device=logp.device)
        return float(logp[torch.arange(L, device=logp.device),
                          idx].sum())


def run(args) -> None:
    nbest_reader = NbestReader(args.nbest)
    vocab = load_dict(args.dict) if args.dict else None
    device = None
    if is_ngram(args.lm):
        from aps_tpu_torch.asr.lm.ngram import NgramLM
        ngram = NgramLM(args.lm, vocab)
        score_fn = lambda hyp: ngram.score(hyp)
    else:
        lm_eval = NnetEvaluator(args.lm, cpt_tag=args.lm_tag,
                                device=args.device, device_id=args.device_id)
        device = lm_eval.device
        sos = lm_eval.conf["task_conf"].get("sos", 0)
        eos = lm_eval.conf["task_conf"].get("eos", 1)
        logger.info(f"Scoring with {args.lm} ({lm_eval.conf['nnet']}) on "
                    f"{device}: sos {sos}, eos {eos} (from task_conf, "
                    "else 0 and 1, as aps_tpu)")
        score_fn = lambda hyp: nn_lm_score(lm_eval.nnet, hyp, sos, eos,
                                           device=device)
    _, out_fd = io_wrapper(args.best, "w")
    with matmul_precision(INFERENCE_PRECISION, device or "cpu"):
        for key, hypos in nbest_reader:
            best, best_score = None, -float("inf")
            for am_score, num_tokens, trans in hypos:
                toks = trans.split()
                ids = [vocab[t] for t in toks] if vocab else \
                    [int(t) for t in toks]
                lm_score = score_fn(ids)
                score = am_score + args.lm_weight * lm_score / \
                    (max(num_tokens, 1) if args.len_norm else 1)
                if score > best_score:
                    best_score, best = score, toks
            out_fd.write(f"{key}\t{' '.join(best)}\n")
    out_fd.close()
    logger.info(f"Rescored {len(nbest_reader)} utterances")


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Nbest LM rescoring (PyTorch port)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("nbest", type=str)
    parser.add_argument("best", type=str)
    parser.add_argument("--lm", type=str, required=True)
    parser.add_argument("--lm-tag", type=str, default="best")
    parser.add_argument("--lm-weight", type=float, default=0.2)
    # type=bool as in aps_tpu: any non-empty string is true
    parser.add_argument("--len-norm", type=bool, default=True)
    parser.add_argument("--dict", type=str, default="")
    parser.add_argument("--space", type=str, default="")
    parser.add_argument("--spm", type=str, default="")
    add_device_args(parser)
    return parser


def main(argv=None) -> None:
    if not logging.getLogger().handlers:
        logging.basicConfig(
            stream=sys.stderr, level=logging.INFO,
            format="%(asctime)s [%(name)s:%(lineno)d] %(message)s")
    run(make_parser().parse_args(argv))


if __name__ == "__main__":
    main()
