#!/usr/bin/env python
"""Column-parallel layers: the port of aps_tpu's tensor parallelism
(tp_param_shardings, which GSPMD propagates through the model).

shard_model swaps every nn.Linear and nn.Embedding whose weight
tp_param_shardings picks (aps_tpu_torch/parallel/mesh.py) for its
column-parallel counterpart, after the task is built and its weights are
loaded. Each holds its model rank's slice of the output dim (the rows of
a Linear's (out, in) weight, the columns of an Embedding's (V, D)); the
bias stays whole (replicated). The forward is the identity into the
product (copy_to_model, whose backward sums the input's gradient over the
model group), the product with the slice, and a gather of the output
along its last dim over the model group (gather_slices, whose backward
takes the own slice of the output's gradient); the bias is added to the
whole output. So every layer after it sees whole tensors, and the
attention kernels see whole heads.

A sharded parameter carries its place as `tp_shard` (TpShard: the axis,
the slice, the whole size and the model group): full() gathers a tensor
of its slice's shape (the parameter, its gradient, an optimizer moment)
and local() slices a whole one, for checkpoints in aps_tpu's layout and
for draws of the whole shape (weight noise)."""

from typing import Dict, NamedTuple, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from aps_tpu_torch.distributed import copy_to_model, gather_slices
from aps_tpu_torch.parallel.mesh import row_blocks, tp_param_shardings


class TpShard(NamedTuple):
    axis: int
    lo: int
    hi: int
    total: int
    group: object


def _slice(t: torch.Tensor, shard: TpShard) -> torch.Tensor:
    return t.narrow(shard.axis, shard.lo, shard.hi - shard.lo)


def full(t: torch.Tensor, shard: TpShard) -> torch.Tensor:
    """The whole tensor from every model rank's slice (a collective over
    the model group; no autograd)."""
    shape = list(t.shape)
    shape[shard.axis] = shard.total
    out = t.new_zeros(shape)
    _slice(out, shard).copy_(t)
    dist.all_reduce(out, group=shard.group)
    return out


def local(t: torch.Tensor, shard: TpShard) -> torch.Tensor:
    """This rank's slice of a whole tensor (a copy)."""
    return _slice(t, shard).clone()


def _sharded_param(weight: nn.Parameter, shard: TpShard) -> nn.Parameter:
    p = nn.Parameter(local(weight.detach(), shard),
                     requires_grad=weight.requires_grad)
    p.tp_shard = shard
    return p


class ColumnParallelLinear(nn.Linear):
    """nn.Linear whose weight holds rows [lo, hi) of the output dim."""

    def __init__(self, linear: nn.Linear, index: int, size: int, group):
        nn.Module.__init__(self)
        self.in_features = linear.in_features
        self.out_features = linear.out_features
        rows = row_blocks(linear.out_features, size)[index]
        self.shard = TpShard(0, rows.start, rows.stop, linear.out_features,
                             group)
        self.weight = _sharded_param(linear.weight, self.shard)
        self.bias = linear.bias

    def forward_rows(self, x: torch.Tensor, lo: int, hi: int
                     ) -> torch.Tensor:
        """Output columns [lo, hi) of the whole layer (a fused projection's
        part): each rank multiplies its rows that fall in [lo, hi)."""
        s = self.shard
        beg, end = max(lo, s.lo), min(hi, s.hi)
        if end <= beg:  # none of the rank's rows: an empty slice
            beg = end = lo
        rows = self.weight[max(beg - s.lo, 0):max(end - s.lo, 0)]
        part = F.linear(copy_to_model(x, s.group), rows)
        out = gather_slices(part, -1, beg - lo, end - lo, hi - lo, s.group)
        return out if self.bias is None else out + self.bias[lo:hi]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.forward_rows(x, 0, self.out_features)


class ColumnParallelEmbedding(nn.Embedding):
    """nn.Embedding whose weight holds columns [lo, hi) of the embedding
    dim."""

    def __init__(self, embed: nn.Embedding, index: int, size: int, group):
        nn.Module.__init__(self)
        self.num_embeddings = embed.num_embeddings
        self.embedding_dim = embed.embedding_dim
        self.padding_idx = embed.padding_idx
        self.max_norm = embed.max_norm
        self.norm_type = embed.norm_type
        self.scale_grad_by_freq = embed.scale_grad_by_freq
        self.sparse = embed.sparse
        cols = row_blocks(embed.embedding_dim, size)[index]
        self.shard = TpShard(1, cols.start, cols.stop, embed.embedding_dim,
                             group)
        self.weight = _sharded_param(embed.weight, self.shard)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        part = F.embedding(ids, self.weight, self.padding_idx, self.max_norm,
                           self.norm_type, self.scale_grad_by_freq,
                           self.sparse)
        s = self.shard
        return gather_slices(part, -1, s.lo, s.hi, s.total, s.group)


def shard_model(model: nn.Module, index: int, size: int, group,
                min_dim: int = 256) -> Dict[str, int]:
    """Swap the layers whose weight tp_param_shardings picks for their
    column-parallel counterparts (model rank `index` of `size` in
    `group`), in place -> the picked {parameter name: axis}."""
    plan = tp_param_shardings(model, size, min_dim)
    swap = {nn.Linear: ColumnParallelLinear,
            nn.Embedding: ColumnParallelEmbedding}
    for name, mod in list(model.named_modules()):
        for child_name, child in list(mod.named_children()):
            key = f"{name}.{child_name}" if name else child_name
            if f"{key}.weight" in plan and type(child) in swap:
                setattr(mod, child_name,
                        swap[type(child)](child, index, size, group))
    return plan


def shard_of(p: torch.Tensor) -> Optional[TpShard]:
    """A parameter's TpShard, or None for a replicated one."""
    return getattr(p, "tp_shard", None)


def full_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """model.state_dict() with every sharded weight whole (a collective
    over each model group, in the modules' order)."""
    state = model.state_dict()
    for key, p in model.named_parameters():
        shard = shard_of(p)
        if shard is not None:
            state[key] = full(p.detach(), shard)
    return state
