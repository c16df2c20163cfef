#!/usr/bin/env python
"""Processes of a data-parallel run (port of aps_tpu/distributed: init,
rank, local_rank, world_size, local_world_size, num_devices, all_reduce).

One process drives one device. init(backend, coordinator_address,
num_processes, process_id) joins them through torch.distributed: backend
"nccl" for cards, one card a rank; "gloo" for the CPU, or for CUDA tensors
where NCCL cannot run (two ranks on one card: NCCL refuses a card it sees
twice; gloo takes CUDA tensors for all_reduce and broadcast only); "none"
leaves the process alone, and every function below then answers for one
process. The coordinator is "host:port" (or a URL such as
tcp://host:port) of rank 0; the group is given a finite timeout, so a
rank that dies fails the others in bounded time instead of leaving them in
a collective. Beside the group of the backend, a gloo group over the host
carries host values (all_reduce of scalars, gather_objects of Python
objects) without a device round trip.

The data-parallel step marks the part of its work in which the batch's
rows are split over the ranks with `sharded()`; inside it,
global_sum(value) sums a count over the ranks (the denominators of the
tasks' losses) and step_group() names the group (the batch norms take
their statistics over the global batch), and outside it both act as for
one process, with no collective.

Tensor parallelism (aps_tpu's "model" mesh axis): init_model_parallel(tp)
splits the world into data x model ranks in the order of aps_tpu's
build_mesh (devices reshaped to (data, model)): rank r has data index
r // tp and model index r % tp. The model group holds the ranks of one
data index (they hold slices of the same weights and compute the same
rows), the data group the ranks of one model index (they hold the same
slices and split the batch's rows); sharded() and global_sum then act
over the data group. gather_slices and copy_to_model are the autograd
Functions of the column-parallel layers (aps_tpu_torch/parallel/tp.py)
and of the sequence-parallel front end: the gather is an all-reduce of a
zero-filled full buffer in which each rank writes its own slice (x + 0 is
x, so the gather is exact), one code path for every backend: gloo takes
CUDA tensors for all_reduce and broadcast only."""

import contextlib
import datetime
import os
from typing import Any, List, Optional

import torch
import torch.distributed as dist

BACKENDS = ("none", "nccl", "gloo")
# seconds a collective may wait for a peer before it fails
TIMEOUT = 300.0

BACKEND = "none"
_HOST_GROUP = None
_SHARDED = None
# init_model_parallel's size and groups: (tp, model group, data group)
_LAYOUT = (1, None, None)


def init(backend: str = "none",
         coordinator_address: str = "",
         num_processes: int = 1,
         process_id: int = 0,
         timeout: float = TIMEOUT) -> None:
    """Join the run's processes (a no-op for backend "none")."""
    global BACKEND, _HOST_GROUP
    if backend not in BACKENDS:
        raise ValueError(f"Unknown distributed backend: {backend} "
                         f"(one of {', '.join(BACKENDS)})")
    if backend == "none":
        return
    if dist.is_initialized():
        raise RuntimeError("torch.distributed is initialized already")
    if not coordinator_address:
        raise ValueError(f"--distributed {backend} needs "
                         "--coordinator-address host:port of rank 0")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} outside "
                         f"[0, {num_processes})")
    url = coordinator_address if "://" in coordinator_address else \
        f"tcp://{coordinator_address}"
    wait = datetime.timedelta(seconds=timeout)
    dist.init_process_group(backend, init_method=url,
                            world_size=num_processes, rank=process_id,
                            timeout=wait)
    _HOST_GROUP = dist.new_group(backend="gloo", timeout=wait) \
        if backend != "gloo" else dist.group.WORLD
    BACKEND = backend


def shutdown() -> None:
    """Leave the process group (after init)."""
    global BACKEND, _HOST_GROUP, _LAYOUT
    if dist.is_initialized():
        dist.destroy_process_group()
    BACKEND, _HOST_GROUP, _LAYOUT = "none", None, (1, None, None)


def initialized() -> bool:
    return BACKEND != "none"


def rank() -> int:
    return dist.get_rank() if initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if initialized() else 1


def local_rank() -> int:
    """The rank among the processes of this host: LOCAL_RANK when a
    launcher sets it, else the rank (one host)."""
    return int(os.environ.get("LOCAL_RANK", rank()))


def local_world_size() -> int:
    return int(os.environ.get("LOCAL_WORLD_SIZE", world_size()))


def num_devices() -> int:
    """The devices of the run: one a process."""
    return world_size()


def device_id(requested: int = -1) -> int:
    """The card of this rank: `requested` when it is 0 or more (the
    commands' --device-id), else the local rank."""
    return requested if requested >= 0 else local_rank()


def launch(args) -> torch.device:
    """init from a command's four flags (--distributed,
    --coordinator-address, --num-processes, --process-id), then the
    command's device (pick_device of --device and --device-id, or the
    rank's local card), made the current card under a group (NCCL makes
    its communicators on it). Before anything touches the card."""
    from aps_tpu_torch.eval.wrapper import pick_device
    backend = getattr(args, "distributed", "none")
    if backend == "nccl" and args.device != "cuda":
        raise ValueError("--distributed nccl runs on cards: use gloo with "
                         f"--device {args.device}")
    init(backend, getattr(args, "coordinator_address", ""),
         getattr(args, "num_processes", 1), getattr(args, "process_id", 0))
    device = pick_device(args.device, device_id(args.device_id))
    if initialized() and device.type == "cuda":
        torch.cuda.set_device(device)
    return device


def all_reduce(value, average: bool = True):
    """The mean (or the sum) of a host value (a number or an array) over
    the processes; the value itself for one process."""
    if not initialized():
        return value
    buf = torch.as_tensor(value, dtype=torch.float64).clone()
    dist.all_reduce(buf, group=_HOST_GROUP)
    if average:
        buf /= world_size()
    return buf.item() if buf.dim() == 0 else buf.numpy()


def gather_objects(obj: Any) -> List[Any]:
    """Every rank's `obj` (picklable), in rank order, on every rank."""
    if not initialized():
        return [obj]
    out = [None] * world_size()
    dist.all_gather_object(out, obj, group=_HOST_GROUP)
    return out


def init_model_parallel(tp: int) -> None:
    """Split the world into data x model ranks, `tp` model ranks a data
    index (the order of aps_tpu's build_mesh), and make the two families
    of subgroups (every rank makes every group, in the same order). tp 1
    leaves one model rank a data index. A world that tp does not divide
    raises a ValueError."""
    global _LAYOUT
    world = world_size()
    if tp < 1 or world % tp:
        raise ValueError(f"tensor_parallel {tp} does not divide the "
                         f"{world} process(es) of the run")
    if tp == _LAYOUT[0]:
        return
    if tp == 1:
        _LAYOUT = (1, None, None)
        return
    wait = datetime.timedelta(seconds=TIMEOUT)
    data = world // tp
    model_group = data_group = None
    for d in range(data):
        group = dist.new_group([d * tp + m for m in range(tp)], timeout=wait)
        if d == rank() // tp:
            model_group = group
    for m in range(tp):
        group = dist.new_group([d * tp + m for d in range(data)],
                               timeout=wait)
        if m == rank() % tp:
            data_group = group
    _LAYOUT = (tp, model_group, data_group)


def model_index() -> int:
    """This rank's index on the model axis."""
    return rank() % _LAYOUT[0]


def data_index() -> int:
    """This rank's index on the data axis."""
    return rank() // _LAYOUT[0]


def data_parallel_size() -> int:
    return world_size() // _LAYOUT[0]


def model_group():
    """The ranks of this rank's data index (None without tensor
    parallelism)."""
    return _LAYOUT[1]


def data_group():
    """The ranks of this rank's model index: the whole run without tensor
    parallelism."""
    if _LAYOUT[2] is not None:
        return _LAYOUT[2]
    return dist.group.WORLD if initialized() else None


class _GatherSlices(torch.autograd.Function):
    """x, this rank's slice [lo, hi) of a tensor's axis `dim` of `total`
    entries, -> the whole tensor on every rank of `group`; the backward
    gives the rank its own slice of the whole tensor's gradient (the work
    after the gather is the same on every rank)."""

    @staticmethod
    def forward(ctx, x, dim, lo, hi, total, group):
        shape = list(x.shape)
        shape[dim] = total
        out = x.new_zeros(shape)
        out.narrow(dim, lo, hi - lo).copy_(x)
        dist.all_reduce(out, group=group)
        ctx.dim, ctx.lo, ctx.hi = dim, lo, hi
        return out

    @staticmethod
    def backward(ctx, grad):
        return (grad.narrow(ctx.dim, ctx.lo, ctx.hi - ctx.lo).contiguous(),
                None, None, None, None, None)


class _CopyToModel(torch.autograd.Function):
    """The identity into a column-parallel product; the backward sums the
    input's gradient over `group` (each rank's slice of the product gives
    a part of it)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def gather_slices(x: torch.Tensor, dim: int, lo: int, hi: int, total: int,
                  group) -> torch.Tensor:
    """The whole tensor from every rank's slice [lo, hi) of axis `dim`
    (autograd: the backward takes the own slice of the gradient)."""
    dim = dim % x.dim()
    return _GatherSlices.apply(x, dim, lo, hi, total, group)


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """x as it is; its gradient summed over `group` in the backward."""
    return _CopyToModel.apply(x, group)


@contextlib.contextmanager
def sharded(group=None):
    """Mark work on this rank's rows of a global batch (the data-parallel
    trainer's steps): global_sum and step_group act over `group` (default:
    the data group, the whole run without tensor parallelism) inside. A
    no-op for one process without init."""
    global _SHARDED
    if not initialized():
        yield
        return
    prev, _SHARDED = _SHARDED, group or data_group()
    try:
        yield
    finally:
        _SHARDED = prev


def step_group() -> Optional[Any]:
    """The group of the sharded work under way, or None."""
    return _SHARDED


def global_sum(value, device=None):
    """A count (a tensor, or a number with the device of the tensors it
    divides) summed over the ranks of the sharded work under way, without
    a gradient; the value itself outside it. A rank that holds the whole
    batch (a batch smaller than the world, replicated) counts it once per
    rank, so that the ranks' shares still add up to the global value."""
    if _SHARDED is None:
        return value
    if isinstance(value, torch.Tensor):
        buf = value.detach().clone()
    else:
        buf = torch.tensor(value, device=device)
    dist.all_reduce(buf, group=_SHARDED)
    return buf


def global_mean(value: torch.Tensor) -> torch.Tensor:
    """value.mean() over the global batch: this rank's sum over the
    global count of entries inside sharded work, value.mean() outside."""
    if _SHARDED is None:
        return value.mean()
    return value.sum() / global_sum(value.numel(), device=value.device)
