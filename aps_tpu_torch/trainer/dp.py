#!/usr/bin/env python
"""The trainer registered "dp" (port of aps_tpu/trainer/dp.py::
DataParallelTrainer): one card, or the data axis of aps_tpu's mesh as one
process a card (below).

One step, as in aps_tpu: loss and gradients; the global L2 norm of the
gradients; a non-finite loss or norm skips the update and keeps parameters,
optimizer state, the accumulated gradient and batch-norm statistics;
otherwise the gradients are scaled by clip / max(norm, clip)
(optax.clip_by_global_norm divides by the norm itself, where
torch.nn.utils.clip_grad_norm_ divides by norm + 1e-6), and the optimizer's
update is scaled by the scheduler's current rate. With acmu_gradient k > 1
the step is optax.MultiSteps': a running mean of k mini-batch gradients,
clipped and applied on the k-th mini-step only, at that step's rate; the
parameters do not move on the others, the batch-norm statistics do, and
the reported norm is each mini-batch's own. The step reads one flag back
from the device (finite or not), so it is synchronous (pipeline_depth
below relaxes that). A device out-of-memory error in the forward or
backward skips the batch as aps_tpu does when its train state survives:
the step's tensors are freed, the parameters, optimizer state and
batch-norm statistics stay, the trainer logs "Step N: device OOM on
batch <shapes>, skipped" and the step counts as failed for the error
breaker. Weight noise, on the steps the base
trainer's weight_noise_now picks: before the forward, weight_noise_std
times a standard normal draw (draw_weight_noise, from the trainer's
generator on its device) is added to every trainable parameter for good,
as aps_tpu adds it: the gradient is taken at the noised parameters, the
optimizer updates them, and a non-finite step keeps them noised; a device
OOM, where aps_tpu's step leaves its state as it was, takes the noise back
off.

Data parallel (under aps_tpu_torch.distributed.init, one process a
device), as aps_tpu's mesh: every rank loads the same global batch, which
a training step trims to a multiple of the world (fit_batch_to_mesh), and
computes on its own rows (rank_rows) inside distributed.sharded(), where
the batch norms take the global batch's statistics and each loss term is
divided by the global batch's count (aps_tpu_torch.task.objf). A flag
all-reduced on the host tells every rank of a device OOM on any of them,
and then all of them skip the batch (an OOM that strikes one rank alone
between the collectives of the forward or the backward, the batch norms'
and the denominators', leaves the others in that collective until the
group's timeout, distributed.TIMEOUT, and then every rank fails);
otherwise one all-reduce (sum) of the
gradients and of the stats gives every rank the one-process gradient and
stats, and the norm, the clip, the non-finite skip and the accumulation
run on them unchanged, deciding alike on every rank. At the start, rank
0's parameters and buffers are broadcast. Validation shards each dev
batch without trimming it and sums the ranks' stats, so it sees every
utterance. The chief alone writes checkpoints (trainer.base).

pipeline_depth (aps_tpu's pipelined dispatch, dispatch_step): with d above
1, up to d steps run before the host reads a finite flag; a non-finite
step is undone on the device. With accumulation (acmu_gradient above 1)
it is refused."""

from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from aps_tpu_torch import distributed
from aps_tpu_torch.convert import to_state_dict, to_variables
from aps_tpu_torch.libs import ApsRegisters
from aps_tpu_torch.parallel import fit_batch_to_mesh, rank_rows
from aps_tpu_torch.trainer.base import Trainer
from aps_tpu_torch.utils import matmul_precision


class OptaxRMSprop(torch.optim.Optimizer):
    """optax.rmsprop at rate 1 (the trainer scales the update): eps inside
    the root, nu from 0, then a trace of decay `momentum`:
    t = g / sqrt(nu + eps) + momentum * t; p -= lr * t."""

    def __init__(self, params, lr=1.0, alpha=0.99, eps=1e-8, momentum=0.0):
        super(OptaxRMSprop, self).__init__(
            params, dict(lr=lr, alpha=alpha, eps=eps, momentum=momentum))

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            alpha, eps = group["alpha"], group["eps"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["nu"] = torch.zeros_like(p)
                    state["trace"] = torch.zeros_like(p)
                nu, trace = state["nu"], state["trace"]
                nu.mul_(alpha).addcmul_(p.grad, p.grad, value=1 - alpha)
                trace.mul_(group["momentum"]).add_(
                    p.grad * torch.rsqrt(nu + eps))
                p.add_(trace, alpha=-group["lr"])


class OptaxAdagrad(torch.optim.Optimizer):
    """optax.adagrad at rate 1: the sum of squares starts at 0.1 and eps
    goes inside the root: s += g * g; p -= lr * g / sqrt(s + eps)."""

    def __init__(self, params, lr=1.0, initial_accumulator_value=0.1,
                 eps=1e-7):
        super(OptaxAdagrad, self).__init__(
            params, dict(lr=lr, initial=initial_accumulator_value, eps=eps))

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["sum"] = torch.full_like(p, group["initial"])
                total = state["sum"]
                total.addcmul_(p.grad, p.grad)
                scale = torch.where(total > 0,
                                    torch.rsqrt(total + group["eps"]),
                                    torch.zeros_like(total))
                p.add_(p.grad * scale, alpha=-group["lr"])


def _sgd(params, kw):
    # optax.sgd takes momentum 0 as no momentum (and then no nesterov)
    momentum = kw["momentum"] or 0
    return torch.optim.SGD(params, lr=1.0, momentum=momentum,
                           nesterov=bool(kw["nesterov"]) and momentum > 0)


def _adam(params, kw):
    return torch.optim.Adam(params, lr=1.0, betas=(kw["beta1"], kw["beta2"]),
                            eps=kw["eps"])


# name -> (the optimizer_kwargs keys aps_tpu's OPTIMIZERS reads, with its
# defaults; a maker of the torch optimizer whose update is optax's). "lr"
# is the scheduler's start and the rate comes from the scheduler at every
# step; any other key has no effect in aps_tpu, so it has none here
OPTIMIZERS = {
    "adamw": ({"beta1": 0.9, "beta2": 0.999, "eps": 1e-8,
               "weight_decay": 1e-2},
              # optax.adamw decays every parameter: u = adam + wd * p, and
              # p -= lr * u is AdamW's p *= 1 - lr * wd; p -= lr * adam
              lambda params, kw: torch.optim.AdamW(
                  params, lr=1.0, betas=(kw["beta1"], kw["beta2"]),
                  eps=kw["eps"], weight_decay=kw["weight_decay"])),
    "sgd": ({"momentum": 0, "nesterov": False}, _sgd),
    "noam_adam": ({"beta1": 0.9, "beta2": 0.98, "eps": 1e-9}, _adam),
    "adadelta": ({"rho": 0.9},
                 lambda params, kw: torch.optim.Adadelta(
                     params, lr=1.0, rho=kw["rho"], eps=1e-6)),
    "rmsprop": ({"alpha": 0.99, "momentum": 0},
                lambda params, kw: OptaxRMSprop(params, alpha=kw["alpha"],
                                                momentum=kw["momentum"])),
    "adam": ({"beta1": 0.9, "beta2": 0.999, "eps": 1e-8}, _adam),
    # optax.adamax: max(b2 * u, |g| + eps), as torch's
    "adamax": ({}, lambda params, kw: torch.optim.Adamax(params, lr=1.0)),
    "adagrad": ({}, lambda params, kw: OptaxAdagrad(params)),
}


def make_optimizer(name: str, params, kwargs: Dict,
                   log=None) -> torch.optim.Optimizer:
    """The optimizer `name` as aps_tpu builds it from optimizer_kwargs;
    keys that aps_tpu does not read are named to `log` in one line."""
    if name not in OPTIMIZERS:
        raise ValueError(f"Unsupported optimizer: {name}")
    keys, build = OPTIMIZERS[name]
    ignored = sorted(k for k in kwargs if k != "lr" and k not in keys)
    if ignored and log is not None:
        reads = ", ".join(keys) if keys else "no key"
        log(f"optimizer_kwargs {', '.join(ignored)} have no effect: {name} "
            f"reads {reads} only, as in aps_tpu")
    return build(params, {k: kwargs.get(k, v) for k, v in keys.items()})


def global_norm(grads) -> torch.Tensor:
    """L2 norm over all gradients, as optax.global_norm."""
    return torch.sqrt(sum((g.detach()**2).sum() for g in grads))


def to_device(egs: Dict, device: torch.device) -> Dict:
    """numpy arrays and tensors of a batch, also inside lists (the
    references of a separation batch) -> tensors on device; the host stats
    (#utt, #tok) stay as they are."""

    def move(val):
        if isinstance(val, (list, tuple)):
            return [move(v) for v in val]
        if isinstance(val, np.ndarray):
            val = torch.from_numpy(val)
        return val.to(device) if isinstance(val, torch.Tensor) else val

    return {key: move(val) for key, val in egs.items()}


def _shapes(egs: Dict) -> List[Tuple[int, ...]]:
    """The shapes of a batch's tensors, also inside lists."""
    out = []
    for val in egs.values():
        for v in (val if isinstance(val, list) else [val]):
            if isinstance(v, torch.Tensor):
                out.append(tuple(v.shape))
    return out


def _map_state(state: Dict, kind, fn) -> Dict:
    """fn over the leaves of type `kind` of an optimizer's per-parameter
    state."""
    return {idx: {k: fn(v) if isinstance(v, kind) else v
                  for k, v in st.items()} for idx, st in state.items()}


@ApsRegisters.trainer.register("dp")
class DataParallelTrainer(Trainer):
    """Trains a task on one device, or data-parallel on one device a
    process under aps_tpu_torch.distributed (the name is aps_tpu's, whose
    "dp" trainer shards the batch over a device mesh)."""

    def __init__(self, task, pipeline_depth: int = 1, **kwargs):
        super(DataParallelTrainer, self).__init__(task, **kwargs)
        self.pipeline_depth = max(int(pipeline_depth), 1)
        if self.pipeline_depth > 1 and self.acmu_gradient > 1:
            raise ValueError(
                f"pipeline_depth {pipeline_depth} with acmu_gradient "
                f"{self.acmu_gradient}: the port pipelines whole steps only")
        self._in_flight = deque()
        self.params = [p for p in self.task.parameters() if p.requires_grad]
        self.optimizer = make_optimizer(self.optimizer_name, self.params,
                                        self.optimizer_kwargs,
                                        log=self.reporter.log)
        # optax.MultiSteps' state: the running mean and the mini-step
        self.acc_grads = [torch.zeros_like(p) for p in self.params] \
            if self.acmu_gradient > 1 else None
        self.mini_step = 0
        if self.cpt_stats is not None:
            self._load_states(self.cpt_stats)
        if self.pipeline_depth > 1 and self.device.type == "cuda":
            _on_device_steps(self.optimizer)
        if self.data_parallel:
            self._broadcast_state()
            self.reporter.log(f"Data parallel: rank {self.rank} of "
                              f"{self.world} ({distributed.BACKEND})")
        num_params = sum(p.numel() for p in self.params) / 1e6
        self.reporter.log(f"#param: {num_params:.2f}M on {self.device}")

    def _load_states(self, cpt: Dict) -> None:
        params = cpt["params"]
        variables = {"params": params.get("nnet", params)}
        for col, tree in cpt.get("mstate", {}).items():
            variables[col] = tree.get("nnet", tree)
        nnet = self.task.nnet
        if self.init_mode == "init":
            # a warm start: every weight whose path and shape match, and
            # nothing of the optimizer
            state = to_state_dict(variables, nnet, strict=False)
            nnet.load_state_dict(state, strict=False)
            num = sum(1 for k, _ in nnet.named_parameters() if k in state)
            total = sum(1 for _ in nnet.parameters())
            self.reporter.log(f"Warm start: loaded {num}/{total} parameter "
                              "tensors")
            return
        nnet.load_state_dict(to_state_dict(variables, nnet))
        if "torch_opt_state" in cpt:
            opt = dict(cpt["torch_opt_state"])
            opt["state"] = _map_state(
                opt["state"], np.ndarray,
                lambda v: torch.from_numpy(np.array(v)))
            self.optimizer.load_state_dict(opt)
        if "torch_acmu_state" in cpt and self.acc_grads is not None:
            acmu = cpt["torch_acmu_state"]
            self.mini_step = int(acmu["mini_step"])
            for acc, val in zip(self.acc_grads, acmu["acc_grads"]):
                acc.copy_(torch.from_numpy(np.asarray(val)))

    def checkpoint_states(self, epoch: int) -> Dict:
        stats = super(DataParallelTrainer, self).checkpoint_states(epoch)
        variables = to_variables(self.task.nnet)
        stats["params"] = {"nnet": variables.pop("params")}
        stats["mstate"] = {col: {"nnet": tree}
                           for col, tree in variables.items()}
        # the moments as numpy arrays, like every other tree of the file
        opt = self.optimizer.state_dict()
        opt["state"] = _map_state(opt["state"], torch.Tensor,
                                  lambda v: v.cpu().numpy())
        stats["torch_opt_state"] = opt
        if self.acc_grads is not None:
            stats["torch_acmu_state"] = {
                "mini_step": self.mini_step,
                "acc_grads": [a.cpu().numpy() for a in self.acc_grads]}
        return stats

    def _broadcast_state(self) -> None:
        """Rank 0's parameters and buffers on every rank (one broadcast a
        dtype), so the replicas start equal whatever each rank drew."""
        tensors = list(self.task.state_dict(keep_vars=True).values())
        for dtype in sorted({t.dtype for t in tensors}, key=str):
            group = [t.data for t in tensors if t.dtype == dtype]
            flat = _flatten_dense_tensors(group)
            dist.broadcast(flat, src=0)
            for t, val in zip(group, _unflatten_dense_tensors(flat, group)):
                t.copy_(val)

    def _split_egs(self, egs: Dict, train: bool = False) -> Tuple[Dict, Dict]:
        """(host stats such as #utt / #tok, device tensors). Data
        parallel: a training batch is trimmed to a multiple of the world
        first (fit_batch_to_mesh, which recomputes the host stats), and
        the rank keeps its rows of the tensors; a validation batch is
        never trimmed, so validation sees every utterance."""
        if self.data_parallel and train:
            egs = fit_batch_to_mesh(egs, self.world)
        host = {k: v for k, v in egs.items()
                if not isinstance(v, (np.ndarray, torch.Tensor, list))}
        dev = {k: v for k, v in egs.items() if k not in host}
        if self.data_parallel:
            dev = rank_rows(dev, self.rank, self.world)
        return host, to_device(dev, self.device)

    def _sum_over_ranks(self, tensors: List[torch.Tensor]) -> None:
        """All-reduce (sum) the tensors in place, one collective a dtype."""
        for dtype in sorted({t.dtype for t in tensors}, key=str):
            group = [t for t in tensors if t.dtype == dtype]
            flat = _flatten_dense_tensors(group)
            dist.all_reduce(flat)
            for t, val in zip(group, _unflatten_dense_tensors(flat, group)):
                t.copy_(val)

    def _global_stats(self, stats: Dict) -> Dict:
        """The stats of the global batch: each rank's share summed."""
        stats = {k: torch.as_tensor(v, device=self.device).detach().clone()
                 for k, v in stats.items()}
        self._sum_over_ranks(list(stats.values()))
        return stats

    def _accumulate(self, grads: List[torch.Tensor]) -> bool:
        """Fold a mini-batch's gradients into the running mean; True (and
        the mean in the parameters' .grad) on the k-th mini-step."""
        diff = torch._foreach_sub(grads, self.acc_grads)
        torch._foreach_div_(diff, self.mini_step + 1)
        torch._foreach_add_(self.acc_grads, diff)
        self.mini_step += 1
        if self.mini_step < self.acmu_gradient:
            return False
        for p, acc in zip(self.params, self.acc_grads):
            p.grad = acc.clone()
            acc.zero_()
        self.mini_step = 0
        return True

    def _apply(self, norm: torch.Tensor) -> None:
        """Clip the parameters' .grad by their global norm `norm` and take
        the optimizer's step at the scheduler's rate."""
        grads = [p.grad for p in self.params]
        if self.clip_gradient:
            scale = self.clip_gradient / torch.clamp_min(norm,
                                                         self.clip_gradient)
            torch._foreach_mul_(grads, scale)
        for group in self.optimizer.param_groups:
            group["lr"] = self.lr_scheduler.get_lr()
        self.optimizer.step()

    def draw_weight_noise(self) -> List[torch.Tensor]:
        """A standard normal draw of each trainable parameter's shape, from
        the trainer's generator on its device (a check may replace this to
        feed in draws of its own)."""
        return [torch.randn(p.shape, generator=self.generator,
                            device=p.device, dtype=p.dtype)
                for p in self.params]

    def _forward_backward(self, dev: Dict) -> Optional[Dict]:
        """The task's stats and the parameters' gradients on the rank's
        rows; data parallel, both summed over the ranks (one all-reduce
        of the gradients and the stats), so every rank holds the global
        batch's. None after a device OOM on any rank: the ranks reduce a
        flag first, so all of them skip the batch."""
        self.optimizer.zero_grad(set_to_none=True)
        try:
            with matmul_precision(self.matmul_precision, self.device), \
                    distributed.sharded():
                stats = self.task(dev)
                stats["loss"].backward()
        except torch.cuda.OutOfMemoryError:
            stats = None
            self.optimizer.zero_grad(set_to_none=True)
            if self.device.type == "cuda":
                torch.cuda.empty_cache()
        if self.data_parallel and distributed.all_reduce(
                float(stats is None), average=False) > 0:
            stats = None
            self.optimizer.zero_grad(set_to_none=True)
        if stats is None:
            return None
        for p in self.params:
            # optax updates every parameter, also one without a gradient
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.data_parallel:
            stats = {k: torch.as_tensor(v, device=self.device).detach()
                     for k, v in stats.items()}
            self._sum_over_ranks([p.grad for p in self.params] +
                                 list(stats.values()))
        return stats

    def _start_step(self, egs: Dict):
        """The batch split, the task in training mode, copies of the
        buffers (batch-norm statistics) and, on a weight-noise step, of
        the clean parameters before the noise is added."""
        host, dev = self._split_egs(egs, train=True)
        dev["#ssr"] = self.ssr
        self.task.train()
        buffers = [b for b in self.task.buffers()]
        saved = [b.clone() for b in buffers]
        clean = None
        if self.weight_noise_now():
            clean = [p.detach().clone() for p in self.params]
            with torch.no_grad():
                for p, draw in zip(self.params, self.draw_weight_noise()):
                    p.add_(draw * self.weight_noise_std)
        return host, dev, buffers, saved, clean

    def _skip_oom(self, dev, buffers, saved, clean) -> None:
        """As aps_tpu when its train state survived the OOM: the batch
        dropped, buffers and parameters (the noise taken off) as before."""
        with torch.no_grad():
            for b, old in zip(buffers, saved):
                b.copy_(old)
            for p, old in zip(self.params, clean or []):
                p.copy_(old)
        self.reporter.log(f"Step {self.cur_step}: device OOM on batch "
                          f"{_shapes(dev)}, skipped")

    def train_one_step(self, egs: Dict) -> bool:
        host, dev, buffers, saved, clean = self._start_step(egs)
        stats = self._forward_backward(dev)
        if stats is None:
            self._skip_oom(dev, buffers, saved, clean)
            return False
        loss = stats["loss"]
        grads = [p.grad for p in self.params]
        norm = global_norm(grads)
        if not bool(torch.isfinite(loss) & torch.isfinite(norm)):
            with torch.no_grad():
                for b, old in zip(buffers, saved):
                    b.copy_(old)
            self.reporter.log(
                f"Step {self.cur_step}: non-finite loss/grad, skipped")
            return False
        if self.acc_grads is None:
            self._apply(norm)
        elif self._accumulate(grads):
            self._apply(global_norm([p.grad for p in self.params]))
        stats = {k: v.detach() for k, v in stats.items()}
        stats["norm"] = norm
        stats["rate"] = self.lr_scheduler.get_lr()
        self.reporter.update(host)
        self.reporter.update(stats)
        return True

    def dispatch_step(self, egs: Dict) -> List[bool]:
        """With pipeline_depth d above 1 (aps_tpu's pipelined dispatch),
        up to d steps run before the host reads the oldest one's finite
        flag. A step is applied whatever its flag, then undone on the
        device where the flag is false: the parameters, the optimizer's
        state and the buffers are torch.where(finite, new, old), as
        aps_tpu's step selects them (on a card the optimizer's step
        counts live on the card for it, capturable). The reporter and the
        error breaker get each step's result when it is read, in order.
        The first step, which creates the optimizer's state, runs as a
        blocking one. At depth 1 every step is train_one_step."""
        if self.pipeline_depth == 1 or not self.optimizer.state:
            return self.drain() + [self.train_one_step(egs)]
        host, dev, buffers, saved, clean = self._start_step(egs)
        params = [p.detach().clone() for p in self.params]
        state = [{k: v.clone() for k, v in self.optimizer.state[p].items()
                  if isinstance(v, torch.Tensor)} for p in self.params]
        stats = self._forward_backward(dev)
        if stats is None:
            self._skip_oom(dev, buffers, saved, clean)
            return self.drain() + [False]
        norm = global_norm([p.grad for p in self.params])
        finite = torch.isfinite(stats["loss"]) & torch.isfinite(norm)
        self._apply(norm)
        with torch.no_grad():
            for p, old, st in zip(self.params, params, state):
                p.copy_(torch.where(finite, p, old))
                for key, val in st.items():
                    cur = self.optimizer.state[p][key]
                    cur.copy_(torch.where(finite.to(cur.device), cur, val))
            for b, old in zip(buffers, saved):
                b.copy_(torch.where(finite, b, old))
        stats = {k: v.detach() for k, v in stats.items()}
        stats["norm"] = norm
        stats["rate"] = self.lr_scheduler.get_lr()
        self._in_flight.append((self.cur_step, host, stats, finite))
        if len(self._in_flight) <= self.pipeline_depth:
            return []
        return [self._read_oldest()]

    def _read_oldest(self) -> bool:
        step, host, stats, finite = self._in_flight.popleft()
        if not bool(finite):
            self.reporter.log(f"Step {step}: non-finite loss/grad, skipped")
            return False
        self.reporter.update(host)
        self.reporter.update(stats)
        return True

    def drain(self) -> List[bool]:
        """Read every step still in flight, oldest first."""
        return [self._read_oldest() for _ in range(len(self._in_flight))]

    @torch.no_grad()
    def valid_one_step(self, egs: Dict) -> None:
        host, dev = self._split_egs(egs)
        self.task.eval()
        self.reporter.update(host)
        with matmul_precision(self.matmul_precision, self.device), \
                distributed.sharded():
            stats = self.task(dev)
        if self.data_parallel:
            stats = self._global_stats(stats)
        self.reporter.update(stats)


def _on_device_steps(optimizer: torch.optim.Optimizer) -> None:
    """Keep the optimizer's step counts on the parameters' device
    (capturable), so that a pipelined step can be undone there."""
    for group in optimizer.param_groups:
        if "capturable" in group:
            group["capturable"] = True
    for p, st in optimizer.state.items():
        if isinstance(st.get("step"), torch.Tensor):
            st["step"] = st["step"].to(p.device)
