#!/usr/bin/env python
"""Shared argparse parser parents of the port's commands (the port's own
copy of the decoding and training parsers of aps_tpu/opts.py, with the
same option names and defaults; the tensorboard option is left out).

Devices. The port's commands run on the card: --device defaults to "cuda"
and the command raises when torch sees no CUDA device. The CPU is used only
when asked for in so many words, with --device cpu. --device-id picks the
card (-1: card 0; in a data-parallel run, the card of the rank's local
rank).

Data parallelism (add_distributed_args, aps_tpu's four flags): one process
a device, each started with its own --process-id, all with the same
--num-processes and --coordinator-address (host:port of rank 0);
--distributed nccl for cards (one a rank), gloo for the CPU or for ranks
that share a card (aps_tpu_torch.distributed)."""

import argparse


class StrToBoolAction(argparse.Action):
    """Parse 'true'/'false' strings as booleans."""

    def __call__(self, parser, namespace, values, option_string=None):
        if values.lower() in ("true", "t", "yes", "1"):
            setattr(namespace, self.dest, True)
        elif values.lower() in ("false", "f", "no", "0"):
            setattr(namespace, self.dest, False)
        else:
            raise ValueError(f"Unknown value {values} for --{self.dest}")


def add_device_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--device", type=str, default="cuda",
                        choices=["cuda", "cpu"],
                        help="cuda: run on the card and fail when there is "
                        "none; cpu: run on the CPU (plain versions of the "
                        "kernels)")
    parser.add_argument("--device-id", type=int, default=-1,
                        help="Index of the card with --device cuda "
                        "(-1: card 0)")


def add_distributed_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--distributed", type=str, default="none",
                        choices=["none", "nccl", "gloo"],
                        help="Join the processes of a data-parallel run "
                        "through torch.distributed with this backend")
    parser.add_argument("--coordinator-address", type=str, default="",
                        help="host:port of process 0")
    parser.add_argument("--num-processes", type=int, default=1)
    parser.add_argument("--process-id", type=int, default=0)


class TrainParser(object):
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--conf", type=str, required=True,
                        help="Yaml configuration file for training")
    parser.add_argument("--checkpoint", type=str, required=True,
                        help="Directory to dump checkpoints")
    parser.add_argument("--batch-size", type=int, default=32,
                        help="Batch size")
    parser.add_argument("--epochs", type=int, default=50,
                        help="Number of training epochs")
    parser.add_argument("--eval-interval", type=int, default=-1,
                        help="Run validation every N steps (-1: per epoch)")
    parser.add_argument("--save-interval", type=int, default=-1,
                        help="Also write epoch.N.ckpt every N epochs (-1: "
                        "never; average_checkpoint > 1 in the trainer's "
                        "configuration makes it 1)")
    parser.add_argument("--prog-interval", type=int, default=100,
                        help="Log progress every N batches")
    parser.add_argument("--num-workers", type=int, default=0,
                        help="Host-side data workers")
    parser.add_argument("--dev-batch-factor", type=float, default=1,
                        help="Validation uses batch-size/factor batches")
    parser.add_argument("--resume", type=str, default="",
                        help="Checkpoint to resume from")
    parser.add_argument("--init", type=str, default="",
                        help="Checkpoint to warm-start weights from")
    parser.add_argument("--seed", type=str, default="777",
                        help="Random seed (-1: skip seeding)")
    parser.add_argument("--trainer", type=str, default="dp",
                        help="Registered trainer name")
    add_device_args(parser)
    add_distributed_args(parser)


class DecodingParser(object):
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("feats_or_wav_scp", type=str,
                        help="Input wave/feature script")
    parser.add_argument("best", type=str, help="Output transcription file")
    parser.add_argument("--beam-size", type=int, default=8)
    parser.add_argument("--am", type=str, required=True,
                        help="Checkpoint directory of the AM")
    parser.add_argument("--am-tag", type=str, default="best",
                        help="Which checkpoint to load (best|last|epoch.N)")
    parser.add_argument("--lm", type=str, default="",
                        help="Checkpoint directory of the LM (optional)")
    parser.add_argument("--lm-weight", type=float, default=0)
    parser.add_argument("--lm-tag", type=str, default="best")
    parser.add_argument("--ctc-weight", type=float, default=0)
    add_device_args(parser)
    parser.add_argument("--channel", type=int, default=-1,
                        help="Channel index for multi-channel input")
    parser.add_argument("--dict", type=str, default="",
                        help="Dictionary file (id -> token mapping)")
    parser.add_argument("--nbest", type=int, default=1)
    parser.add_argument("--dump-align", type=str, default="")
    parser.add_argument("--max-len", type=int, default=200)
    parser.add_argument("--min-len", type=int, default=0)
    parser.add_argument("--max-len-ratio", type=float, default=1)
    parser.add_argument("--min-len-ratio", type=float, default=0)
    parser.add_argument("--len-norm", action=StrToBoolAction, default=True,
                        nargs="?", const=True)
    parser.add_argument("--len-penalty", type=float, default=0)
    parser.add_argument("--cov-penalty", type=float, default=0)
    parser.add_argument("--cov-threshold", type=float, default=0.5)
    parser.add_argument("--eos-threshold", type=float, default=1)
    parser.add_argument("--temperature", type=float, default=1)
    parser.add_argument("--allow-partial", action=StrToBoolAction,
                        default=True, nargs="?", const=True,
                        help="Emit un-ended hypotheses when the search "
                        "hits max-len")
    parser.add_argument("--end-detect", action=StrToBoolAction,
                        default=False, nargs="?", const=True,
                        help="Stop the search early once the beam can no "
                        "longer improve")
    parser.add_argument("--disable-unk", action=StrToBoolAction,
                        default=False, nargs="?", const=True,
                        help="Never emit the <unk> symbol (needs --dict)")
    parser.add_argument("--approx-topk", action=StrToBoolAction,
                        default=False, nargs="?", const=True,
                        help="Accepted for parity with aps_tpu; the port's "
                        "candidate top-k is always exact")
    parser.add_argument("--dtype", type=str, default="float32",
                        choices=["float32", "bfloat16"])
    parser.add_argument("--spm", type=str, default="",
                        help="sentencepiece model for subword detok")
    parser.add_argument("--text-norm", type=str, default="")


class AlignmentParser(object):
    """aps_tpu's AlignmentParser; --device and --device-id come from
    add_device_args."""
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("wav_scp", type=str)
    parser.add_argument("text", type=str)
    parser.add_argument("alignment", type=str)
    parser.add_argument("--am", type=str, required=True)
    parser.add_argument("--am-tag", type=str, default="best")
    parser.add_argument("--dict", type=str, default="")
    parser.add_argument("--channel", type=int, default=-1)
    parser.add_argument("--word-boundary", type=str, default="")
    add_device_args(parser)
