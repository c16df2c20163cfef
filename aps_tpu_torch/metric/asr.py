#!/usr/bin/env python
"""WER computation with SUB/INS/DEL breakdown (+ permutation WER); the
port's own copy of aps_tpu/metric/asr.py. The edit-distance DP is written
out here (no `edit_distance` package is needed)."""

import math
from itertools import permutations
from typing import List, Tuple

import numpy as np


def edit_distance_ops(hyp: List[str],
                      ref: List[str]) -> List[Tuple[str, int, int]]:
    """Levenshtein alignment ops: list of (op, hyp_idx, ref_idx) with op in
    {equal, replace, insert, delete}. `insert` = token missing from hyp."""
    H, R = len(hyp), len(ref)
    dist = np.zeros((H + 1, R + 1), dtype=np.int64)
    dist[:, 0] = np.arange(H + 1)
    dist[0, :] = np.arange(R + 1)
    for i in range(1, H + 1):
        for j in range(1, R + 1):
            sub = dist[i - 1, j - 1] + (hyp[i - 1] != ref[j - 1])
            dist[i, j] = min(sub, dist[i - 1, j] + 1, dist[i, j - 1] + 1)
    ops = []
    i, j = H, R
    while i > 0 or j > 0:
        if i > 0 and j > 0 and dist[i, j] == dist[i - 1, j - 1] + (
                hyp[i - 1] != ref[j - 1]):
            op = "equal" if hyp[i - 1] == ref[j - 1] else "replace"
            ops.append((op, i - 1, j - 1))
            i, j = i - 1, j - 1
        elif i > 0 and dist[i, j] == dist[i - 1, j] + 1:
            ops.append(("delete", i - 1, max(j - 1, 0)))
            i -= 1
        else:
            ops.append(("insert", max(i - 1, 0), j - 1))
            j -= 1
    return ops[::-1]


def _format_str(str1: str, str2: str) -> Tuple[str, str]:
    delta = len(str1) - len(str2)
    if delta == 0:
        return str1, str2
    lpad = abs(delta) // 2
    rpad = abs(delta) - lpad
    if delta < 0:
        return " " * lpad + str1 + " " * rpad, str2
    return str1, " " * lpad + str2 + " " * rpad


def print_operations(hyp: List[str], ref: List[str], ops) -> None:
    hyp_str, ref_str = [], []
    for op, hi, ri in ops:
        if op == "insert":
            a, b = "*" * len(ref[ri]), ref[ri]
        elif op == "delete":
            a, b = hyp[hi], "*" * len(hyp[hi])
        else:
            a, b = _format_str(hyp[hi], ref[ri])
        hyp_str.append(a)
        ref_str.append(b)
    print("hyp: " + " ".join(hyp_str))
    print("ref: " + " ".join(ref_str), flush=True)


def wer(hyp: List[str], ref: List[str],
        details: bool = False) -> Tuple[int, int, int]:
    """Return (sub, ins, del) error counts."""
    ops = edit_distance_ops(hyp, ref)
    sub_err = sum(1 for op in ops if op[0] == "replace")
    ins_err = sum(1 for op in ops if op[0] == "insert")
    del_err = sum(1 for op in ops if op[0] == "delete")
    if details:
        print_operations(hyp, ref, ops)
    return (sub_err, ins_err, del_err)


def permute_wer(hlist: List[List[str]],
                rlist: List[List[str]],
                details: bool = False) -> Tuple[int, int, int]:
    """Best-permutation WER for multi-speaker hypotheses."""

    def distance(hlist, rlist, details):
        err_pair = [wer(h, r, details=details) for h, r in zip(hlist, rlist)]
        err = tuple(sum(p[i] for p in err_pair) for i in range(3))
        return sum(err), err

    N = len(hlist)
    if N != len(rlist):
        raise RuntimeError(f"size mismatch: {N} vs {len(rlist)}")
    if N != 1:
        details = False
    best, pair, errs = math.inf, -1, []
    for index, order in enumerate(permutations(range(N))):
        err, permu_errs = distance(hlist, [rlist[n] for n in order], details)
        errs.append(permu_errs)
        if err < best:
            best, pair = err, index
    return errs[pair]
