#!/usr/bin/env python
"""Average the parameters of epoch checkpoints (port of
cmd/average_checkpoint.py, same arguments).

    python -m aps_tpu_torch.cmd.average_checkpoint <cpt_dir> <out.ckpt> \
        [--beg 1] [--end 100]

Reads every epoch.N.ckpt of cpt_dir for N in [beg, end] (the trainer
writes them with --save-interval, or every epoch under average_checkpoint),
and writes the first of them with its "params" replaced by their average.
Both packages write and read this format, so a file averaged here loads
into aps_tpu and the other way round. Entries that hold objects of
aps_tpu's optimizer (optax's state, which the port does not read) are left
out of the output."""

import argparse
import pathlib
import pickle

from aps_tpu_torch.eval.wrapper import Opaque, read_checkpoint
from aps_tpu_torch.trainer.base import ParameterAverager
from aps_tpu_torch.utils import get_logger

logger = get_logger(__name__)


def _plain(value) -> bool:
    """True when value holds no stand-in for a class the reader skips."""
    if isinstance(value, dict):
        return all(map(_plain, value.values()))
    if isinstance(value, (list, tuple)):
        return all(map(_plain, value))
    return not isinstance(value, Opaque)


def run(args):
    cpt_dir = pathlib.Path(args.checkpoint)
    averager = ParameterAverager()
    done = []
    base = None
    for epoch in range(args.beg, args.end + 1):
        path = cpt_dir / f"epoch.{epoch}.ckpt"
        if not path.exists():
            continue
        stats = read_checkpoint(path)
        if base is None:
            base = stats
        averager.add(stats["params"])
        done.append(epoch)
    if not done:
        raise RuntimeError(f"No epoch.N.ckpt found in {cpt_dir} "
                           f"for N in [{args.beg}, {args.end}]")
    base["params"] = averager.state_dict()
    skipped = sorted(k for k, v in base.items() if not _plain(v))
    if skipped:
        logger.info(f"Left out {', '.join(skipped)} (objects the port "
                    "does not read)")
    base = {k: v for k, v in base.items() if k not in skipped}
    with open(args.out, "wb") as fd:
        pickle.dump(base, fd)
    logger.info(f"Averaged {len(done)} checkpoints (epochs {done}) "
                f"-> {args.out}")


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Average model checkpoints over epochs",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("checkpoint", type=str, help="Checkpoint directory")
    parser.add_argument("out", type=str, help="Output checkpoint path")
    parser.add_argument("--beg", type=int, default=1)
    parser.add_argument("--end", type=int, default=100)
    return parser


def main(argv=None):
    run(make_parser().parse_args(argv))


if __name__ == "__main__":
    main()
