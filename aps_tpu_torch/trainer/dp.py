#!/usr/bin/env python
"""The single-card trainer, registered "dp" (port of the step of
aps_tpu/trainer/dp.py::DataParallelTrainer, without the mesh).

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
from the device (finite or not), so it is synchronous. A device
out-of-memory error in the forward or backward skips the batch as aps_tpu
does when its train state survives: the step's tensors are freed, the
parameters, optimizer state and batch-norm statistics stay, the trainer
logs "Step N: device OOM on batch <shapes>, skipped" and the step counts
as failed for the error breaker. Weight noise, on the steps the base
trainer's weight_noise_now picks: before the forward, weight_noise_std
times a standard normal draw (draw_weight_noise, from the trainer's
generator on its device) is added to every trainable parameter for good,
as aps_tpu adds it: the gradient is taken at the noised parameters, the
optimizer updates them, and a non-finite step keeps them noised; a device
OOM, where aps_tpu's step leaves its state as it was, takes the noise back
off. aps_tpu's pipelined dispatch is not ported."""

from typing import Dict, List, Tuple

import numpy as np
import torch

from aps_tpu_torch.convert import to_state_dict, to_variables
from aps_tpu_torch.libs import ApsRegisters
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
    """Trains a task on one device (the name is aps_tpu's, whose "dp"
    trainer shards the batch over a device mesh)."""

    def __init__(self, task, **kwargs):
        super(DataParallelTrainer, self).__init__(task, **kwargs)
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

    def _split_egs(self, egs: Dict) -> Tuple[Dict, Dict]:
        """(host stats such as #utt / #tok, device tensors)."""
        egs = to_device(egs, self.device)
        host = {k: v for k, v in egs.items()
                if not isinstance(v, (torch.Tensor, list))}
        return host, {k: v for k, v in egs.items() if k not in host}

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

    def train_one_step(self, egs: Dict) -> bool:
        host, dev = self._split_egs(egs)
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
        self.optimizer.zero_grad(set_to_none=True)
        try:
            with matmul_precision(self.matmul_precision, self.device):
                stats = self.task(dev)
                loss = stats["loss"]
                loss.backward()
        except torch.cuda.OutOfMemoryError:
            # as aps_tpu when its train state survived the OOM: drop the
            # batch, free what the step allocated and go on
            stats = loss = None
            self.optimizer.zero_grad(set_to_none=True)
            with torch.no_grad():
                for b, old in zip(buffers, saved):
                    b.copy_(old)
                for p, old in zip(self.params, clean or []):
                    p.copy_(old)
            if self.device.type == "cuda":
                torch.cuda.empty_cache()
            self.reporter.log(f"Step {self.cur_step}: device OOM on batch "
                              f"{_shapes(dev)}, skipped")
            return False
        for p in self.params:
            # optax updates every parameter, also one without a gradient
            if p.grad is None:
                p.grad = torch.zeros_like(p)
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

    @torch.no_grad()
    def valid_one_step(self, egs: Dict) -> None:
        host, dev = self._split_egs(egs)
        self.task.eval()
        self.reporter.update(host)
        with matmul_precision(self.matmul_precision, self.device):
            self.reporter.update(self.task(dev))
