#!/usr/bin/env python
"""Train a separation / enhancement model with the PyTorch port (port of
cmd/train_ss.py).

    python -m aps_tpu_torch.cmd.train_ss --conf train.yaml \
        --checkpoint <dir> [--batch-size 32] [--epochs 50] [--seed 777]

Takes aps_tpu's training arguments (aps_tpu_torch.opts.TrainParser) and
YAML configs and writes aps_tpu-format checkpoints and train.yaml into
--checkpoint, which aps_tpu_torch.cmd.separate and aps_tpu's own commands
load. It trains on the card (--device-id picks which) and raises when torch
sees none; --device cpu asks for the CPU in so many words. A
frequency-domain model gets the enh_transform of its YAML
(aps_tpu_torch.transform.enh). The fused TCN block is an inference-only
fold; sse@freq_xfmr with the rel pose trains through the rel attention's
forward and backward kernels (csrc/rel_attention*.cu) when its attention
dropout is 0, and a sepformer through the flash attention's
(csrc/attention*.cu) likewise; every other model reaches no hand-written
kernel."""

import argparse
import pprint

from aps_tpu_torch.conf import load_ss_conf
from aps_tpu_torch.eval.wrapper import pick_device
from aps_tpu_torch.libs import aps_sse_nnet, aps_transform, start_trainer
from aps_tpu_torch.opts import TrainParser
from aps_tpu_torch.utils import set_seed


def run(args):
    """Train as the arguments say; returns the trainer."""
    device = pick_device(args.device, args.device_id)
    set_seed(args.seed)
    conf = load_ss_conf(args.conf)
    print(f"Arguments in args:\n{pprint.pformat(vars(args))}", flush=True)
    print(f"Arguments in yaml:\n{pprint.pformat(conf)}", flush=True)
    kwargs = dict(conf["nnet_conf"])
    if "enh_transform" in conf:
        kwargs["enh_transform"] = aps_transform("enh")(
            **conf["enh_transform"])
    nnet = aps_sse_nnet(conf["nnet"])(**kwargs)
    return start_trainer(args.trainer, conf, nnet, args, device,
                         reduction_tag="#utt")


def make_parser() -> argparse.ArgumentParser:
    return argparse.ArgumentParser(
        description="Train separation/enhancement models (PyTorch port)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
        parents=[TrainParser.parser])


def main(argv=None):
    return run(make_parser().parse_args(argv))


if __name__ == "__main__":
    main()
