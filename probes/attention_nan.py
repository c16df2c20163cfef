#!/usr/bin/env python
"""How K2 and K3's forward kernels treat a NaN input row, beside their
plain versions (which write a row as aps_tpu does: 0 where the row's sum
is not positive, alive = l > 0, so also where it is NaN).

A NaN query row: every score of the row is NaN, the row maximum (fmaxf)
stays -inf and the kernels take the row for one without a visible key:
0, as the plain versions. A NaN key row: every row of its head has a NaN
score, the row maximum is finite, the sum NaN, and the kernels write NaN
rows where the plain versions write 0. Other heads are unchanged.

One card, a few seconds with the builds, from the root of the
repository:

    python3 probes/attention_nan.py
"""

import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def rows(out) -> str:
    """Counts of a head's rows that hold a NaN and that are all 0."""
    return (f"{int(out.isnan().any(-1).sum())} NaN, "
            f"{int((out == 0).all(-1).sum())} zero of {out.shape[0]}")


def main() -> None:
    import torch

    from aps_tpu_torch.ops.attention import flash_attention, mha_reference
    from aps_tpu_torch.ops.rel_attention import (flash_attention_rel,
                                                 rel_mha_reference)
    if not torch.cuda.is_available():
        sys.exit("probes/attention_nan.py: torch sees no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    gen = torch.Generator().manual_seed(3)
    B, H, T, D = 2, 4, 233, 64
    for kind in ("K2", "K3"):
        count = 3 if kind == "K2" else 4
        ops = [torch.randn((B, H, T, D), generator=gen)
               for _ in range(count)]
        if kind == "K3":
            ops.append(0.3 * torch.randn((1, 2 * T - 1, D), generator=gen))
        run, plain = (flash_attention, mha_reference) if kind == "K2" else \
            (flash_attention_rel, rel_mha_reference)
        key = 1 if kind == "K2" else 2
        for what, idx in (("query", 0), ("key", key)):
            bad = [t.to(dev) for t in ops]
            bad[idx] = bad[idx].clone()
            bad[idx][1, 2, 50] = float("nan")
            got, want = run(*bad), plain(*bad)
            others = torch.ones(H, dtype=torch.bool)
            others[2] = False
            err = (got[1, others] - want[1, others]).abs().max().item()
            print(f"{kind}, a NaN {what} row (batch 1, head 2, row 50): "
                  f"kernel {rows(got[1, 2])}, plain {rows(want[1, 2])}; "
                  f"the other heads within {err:.3e} of the plain "
                  f"version ({card})", flush=True)


if __name__ == "__main__":
    main()
