#!/usr/bin/env python
"""Export one function of a trained model with torch.export (port of
cmd/export.py, which writes a jax.export StableHLO artifact).

    python -m aps_tpu_torch.cmd.export <checkpoint> <out_dir>
        [--function mask_predict] [--num-frames 21] [--num-bins 257]
        [--tag best] [--device cuda|cpu] [--device-id -1]

Writes out_dir/model.pt2, the torch.export program of the model's
`--function` method at a fixed (1, --num-frames, --num-bins) float32
input, and out_dir/model.json with aps_tpu's keys (nnet, function,
input_shape, conf) and the device the program was exported on.
aps_tpu_torch.deploy.RtExported runs it. Exported on the card by default
(raises without one); --device cpu asks for the CPU."""

import argparse
import json
import logging
import pathlib
import pprint

import torch
from torch import nn

from aps_tpu_torch.eval.wrapper import NnetEvaluator
from aps_tpu_torch.opts import add_device_args

logger = logging.getLogger("aps_tpu_torch.export")


class _Method(nn.Module):
    """One method of a model as the module's forward, for torch.export."""

    def __init__(self, nnet: nn.Module, method: str):
        super(_Method, self).__init__()
        self.nnet, self.method = nnet, method

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        return getattr(self.nnet, self.method)(feats)


def run(args) -> pathlib.Path:
    print(f"Arguments in args:\n{pprint.pformat(vars(args))}", flush=True)
    evaluator = NnetEvaluator(args.checkpoint, cpt_tag=args.tag,
                              device=args.device, device_id=args.device_id)
    out_dir = pathlib.Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    shape = (1, args.num_frames, args.num_bins)
    example = torch.zeros(shape, device=evaluator.device)
    with torch.no_grad():
        program = torch.export.export(
            _Method(evaluator.nnet, args.function).eval(), (example,))
    path = out_dir / "model.pt2"
    torch.export.save(program, str(path))
    meta = {
        "nnet": evaluator.conf["nnet"],
        "function": args.function,
        "input_shape": list(shape),
        "conf": {k: v for k, v in evaluator.conf.items()
                 if k in ("nnet", "enh_transform", "asr_transform")},
        "device": str(evaluator.device),
    }
    with open(out_dir / "model.json", "w") as fd:
        json.dump(meta, fd, indent=2, default=str)
    logger.info(f"Exported {args.function} ({path.stat().st_size} bytes) "
                f"to {out_dir}")
    return path


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Export a model function via torch.export (PyTorch "
        "port)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("checkpoint", type=str)
    parser.add_argument("out_dir", type=str)
    parser.add_argument("--tag", type=str, default="best")
    parser.add_argument("--function", type=str, default="mask_predict")
    parser.add_argument("--num-frames", type=int, default=21,
                        help="Chunk frames of the exported function")
    parser.add_argument("--num-bins", type=int, default=257)
    add_device_args(parser)
    return parser


def main(argv=None):
    return run(make_parser().parse_args(argv))


if __name__ == "__main__":
    main()
