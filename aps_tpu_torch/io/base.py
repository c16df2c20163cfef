#!/usr/bin/env python
"""Kaldi-style script file readers (the port's own copy of
aps_tpu/io/base.py)."""

from typing import Any, Callable


def parse_scps(scp_path: str,
               num_tokens: int = 2,
               value_processor: Callable = lambda x: x,
               restrict: bool = True):
    """Parse a kaldi script file: "key value..." per line -> dict."""
    index_dict = {}
    keys = []
    with open(scp_path, "r", encoding="utf-8") as f:
        for raw_line in f:
            toks = raw_line.strip().split()
            if not toks:
                continue
            if num_tokens >= 2 and len(toks) < num_tokens:
                raise RuntimeError(
                    f"For {scp_path}, format error in line: {raw_line}")
            if num_tokens == 2:
                key, value = toks[0], toks[1] if len(toks) == 2 else " ".join(
                    toks[1:])
            else:
                key, value = toks[0], toks[1:]
            if restrict and key in index_dict:
                raise ValueError(f"Duplicated key '{key}' exists in {scp_path}")
            index_dict[key] = value_processor(value)
            keys.append(key)
    return index_dict, keys


class BaseReader(object):
    """Random + sequential access over an scp index."""

    def __init__(self,
                 scp_path: str,
                 num_tokens: int = 2,
                 value_processor: Callable = lambda x: x,
                 restrict: bool = True):
        self.index_dict, self.index_keys = parse_scps(
            scp_path, num_tokens=num_tokens,
            value_processor=value_processor, restrict=restrict)

    def _load(self, key: str) -> Any:
        return self.index_dict[key]

    def __len__(self) -> int:
        return len(self.index_dict)

    def __contains__(self, key: str) -> bool:
        return key in self.index_dict

    def __getitem__(self, key: str):
        if key not in self.index_dict:
            raise KeyError(f"Missing key: {key}")
        return self._load(key)

    def __iter__(self):
        for key in self.index_keys:
            yield key, self._load(key)
