#!/usr/bin/env python
"""End-to-end diarization task (port of aps_tpu/task/eend.py: EendTask).

The permutation-invariant binary cross-entropy over TimeDomainTask: each
speaker stream's logits against its 0/1 activity, permuted as the
separation tasks permute. It has no registry name, as in aps_tpu."""

import torch

from aps_tpu_torch.task.sse import TimeDomainTask


class EendTask(TimeDomainTask):
    """Permutation-invariant BCE for end-to-end diarization."""

    def objf(self, out: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
        """out: N x T logits, ref: N x T in {0, 1} -> N: the BCE with
        logits summed over T, in the stable form max(x, 0) - x ref +
        log1p(exp(-|x|)) as aps_tpu computes it."""
        out = torch.squeeze(out)
        loss = torch.clamp_min(out, 0) - out * ref + torch.log1p(
            torch.exp(-torch.abs(out)))
        return torch.sum(loss, -1)
