#!/usr/bin/env python
"""Train an acoustic model with the PyTorch port (port of cmd/train_am.py).

    python -m aps_tpu_torch.cmd.train_am --conf train.yaml --dict dict \
        --checkpoint <dir> [--batch-size 32] [--epochs 50] [--seed 777]

Takes aps_tpu's training arguments (aps_tpu_torch.opts.TrainParser) and
YAML configs and writes aps_tpu-format checkpoints, train.yaml and the dict
into --checkpoint. It trains on the card (--device-id picks which) and
raises when torch sees none; --device cpu asks for the CPU in so many
words. A YAML with an enh_transform (examples/asr/chime4/conf/1b.yaml's
asr@enh_xfmr) builds the multi-channel model on N x C x S batches (the
loader keeps every channel with channel -1). The attention kernels have no
dropout inside: an encoder whose
att_dropout is above 0 trains through the dense attention path, on either
device, and one with att_dropout: 0 through the flash kernels."""

import argparse
import pprint

from aps_tpu_torch.conf import dump_dict, load_am_conf
from aps_tpu_torch.eval.wrapper import pick_device
from aps_tpu_torch.libs import aps_asr_nnet, aps_transform, start_trainer
from aps_tpu_torch.opts import TrainParser
from aps_tpu_torch.utils import set_seed


def run(args):
    """Train as the arguments say; returns the trainer."""
    device = pick_device(args.device, args.device_id)
    set_seed(args.seed)
    conf, vocab = load_am_conf(args.conf, args.dict)
    print(f"Arguments in args:\n{pprint.pformat(vars(args))}", flush=True)
    print(f"Arguments in yaml:\n{pprint.pformat(conf)}", flush=True)
    kwargs = dict(conf["nnet_conf"])
    if "asr_transform" in conf:
        kwargs["asr_transform"] = aps_transform("asr")(
            **conf["asr_transform"])
    if "enh_transform" in conf:
        kwargs["enh_transform"] = aps_transform("enh")(
            **conf["enh_transform"])
    nnet = aps_asr_nnet(conf["nnet"])(**kwargs)
    trainer = start_trainer(args.trainer, conf, nnet, args, device,
                            reduction_tag="#tok",
                            other_loader_conf={"vocab_dict": vocab})
    dump_dict(f"{args.checkpoint}/dict", vocab, reverse=False)
    return trainer


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Train acoustic models (PyTorch port)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
        parents=[TrainParser.parser])
    parser.add_argument("--dict", type=str, required=True,
                        help="Dictionary file")
    return parser


def main(argv=None):
    return run(make_parser().parse_args(argv))


if __name__ == "__main__":
    main()
