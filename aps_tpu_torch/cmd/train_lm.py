#!/usr/bin/env python
"""Train a language model with the PyTorch port (port of cmd/train_lm.py).

    python -m aps_tpu_torch.cmd.train_lm --conf nnlm.yaml --dict dict \
        --checkpoint <dir> [--batch-size 32] [--epochs 50] [--seed 777]

Takes aps_tpu's training arguments (aps_tpu_torch.opts.TrainParser) and LM
YAML configs (asr@rnn_lm or asr@xfmr_lm, task asr@lm, loader lm@utt or
lm@bptt) and writes aps_tpu-format checkpoints, train.yaml and the dict
into --checkpoint; the progress reports weigh by "#tok". It trains on the
card (--device-id picks which) and raises when torch sees none; --device
cpu asks for the CPU in so many words."""

import argparse
import pprint

from aps_tpu_torch import distributed
from aps_tpu_torch.conf import dump_dict, load_lm_conf
from aps_tpu_torch.libs import aps_asr_nnet, start_trainer
from aps_tpu_torch.opts import TrainParser
from aps_tpu_torch.utils import set_seed


def run(args):
    """Train as the arguments say; returns the trainer."""
    device = distributed.launch(args)
    set_seed(args.seed)
    conf, vocab = load_lm_conf(args.conf, args.dict)
    print(f"Arguments in args:\n{pprint.pformat(vars(args))}", flush=True)
    print(f"Arguments in yaml:\n{pprint.pformat(conf)}", flush=True)
    nnet = aps_asr_nnet(conf["nnet"])(**conf["nnet_conf"])
    trainer = start_trainer(args.trainer, conf, nnet, args, device,
                            reduction_tag="#tok",
                            other_loader_conf={
                                "vocab_dict": vocab,
                                "sos": conf["sos"],
                                "eos": conf["eos"],
                            })
    if trainer.is_chief:
        dump_dict(f"{args.checkpoint}/dict", vocab, reverse=False)
    return trainer


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Train language models (PyTorch port)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
        parents=[TrainParser.parser])
    parser.add_argument("--dict", type=str, required=True,
                        help="Dictionary file")
    return parser


def main(argv=None):
    trainer = run(make_parser().parse_args(argv))
    distributed.shutdown()
    return trainer


if __name__ == "__main__":
    main()
