#!/usr/bin/env python
"""Tokenize text files into word, char or subword units (port of
cmd/text_tokenize.py; the same arguments and byte-equal output files).

    python -m aps_tpu_torch.cmd.text_tokenize text token [--unit char]
        [--text-format kaldi|raw] [--space <space>] [--spm model.json]
        [--filter-units a,b] [--add-units <unk>] [--dump-vocab dict]
        [--add-sos-eos true]

Tokenizing is host work: the command touches no device."""

import argparse
from collections import Counter

from aps_tpu_torch.io import io_wrapper
from aps_tpu_torch.libs import aps_tokenizer
from aps_tpu_torch.opts import StrToBoolAction


def run(args) -> None:
    kwargs = {}
    if args.unit == "char":
        kwargs["space"] = args.space
    if args.unit == "subword":
        kwargs["spm"] = args.spm
    filter_units = args.filter_units.split(",") if args.filter_units else []
    tokenizer = aps_tokenizer(args.unit)(filter_words=filter_units, **kwargs)
    src_std, src = io_wrapper(args.text, "r")
    _, out_fd = io_wrapper(args.token, "w")
    counter = Counter()
    for raw_line in src:
        toks = raw_line.strip().split()
        if not toks:
            continue
        if args.text_format == "kaldi":
            key, words = toks[0], toks[1:]
            out_fd.write(f"{key} ")
        else:
            words = toks
        units = tokenizer.encode(words)
        counter.update(units)
        out_fd.write(" ".join(units) + "\n")
    out_fd.close()
    if not src_std:
        src.close()
    if args.dump_vocab:
        # layout: the --add-units prefix (default <unk>), corpus units by
        # frequency, then optional <sos>/<eos>
        prefix = (args.add_units.split(",")
                  if args.add_units else ["<unk>"])
        with open(args.dump_vocab, "w") as fd:
            idx = 0
            for tok in prefix:
                fd.write(f"{tok} {idx}\n")
                idx += 1
            for tok, _ in counter.most_common():
                if tok in prefix:
                    continue
                fd.write(f"{tok} {idx}\n")
                idx += 1
            if args.add_sos_eos:
                fd.write(f"<sos> {idx}\n<eos> {idx + 1}\n")


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Tokenize transcriptions",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("text", type=str,
                        help="Input text (kaldi format or raw lines)")
    parser.add_argument("token", type=str, help="Output tokenized text")
    parser.add_argument("--unit", type=str, default="char",
                        choices=["word", "char", "subword"])
    parser.add_argument("--text-format", type=str, default="kaldi",
                        choices=["kaldi", "raw"],
                        help="kaldi lines begin with an utterance key")
    parser.add_argument("--space", type=str, default="<space>")
    parser.add_argument("--spm", type=str, default="")
    parser.add_argument("--filter-units", "--filter-words",
                        dest="filter_units", type=str, default="",
                        help="Comma-separated units to drop while "
                        "tokenizing")
    parser.add_argument("--add-units", type=str, default="",
                        help="Comma-separated units to prepend to the "
                        "dumped vocabulary (default: <unk>)")
    parser.add_argument("--dump-vocab", type=str, default="")
    parser.add_argument("--add-sos-eos", action=StrToBoolAction,
                        default=True, nargs="?", const=True)
    return parser


def main(argv=None) -> None:
    run(make_parser().parse_args(argv))


if __name__ == "__main__":
    main()
