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
one process, with no collective."""

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
    global BACKEND, _HOST_GROUP
    if dist.is_initialized():
        dist.destroy_process_group()
    BACKEND, _HOST_GROUP = "none", None


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


@contextlib.contextmanager
def sharded(group=None):
    """Mark work on this rank's rows of a global batch (the data-parallel
    trainer's steps): global_sum and step_group act over `group` (default:
    the whole run) inside. A no-op for one process without init."""
    global _SHARDED
    if not initialized():
        yield
        return
    prev, _SHARDED = _SHARDED, group or dist.group.WORLD
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
