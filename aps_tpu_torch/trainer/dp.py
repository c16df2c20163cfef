#!/usr/bin/env python
"""The single-card trainer, registered "dp" (port of the step of
aps_tpu/trainer/dp.py::DataParallelTrainer, without the mesh).

One step, as in aps_tpu: loss and gradients; the global L2 norm of the
gradients; a non-finite loss or norm skips the update and keeps parameters,
optimizer state and batch-norm statistics; otherwise the gradients are
scaled by clip / max(norm, clip) (optax.clip_by_global_norm divides by the
norm itself, where torch.nn.utils.clip_grad_norm_ divides by norm + 1e-6),
and the optimizer's update is scaled by the scheduler's current rate. The
step reads one flag back from the device (finite or not), so it is
synchronous; aps_tpu's pipelined dispatch, its OOM skipping, weight noise
and gradient accumulation are not ported."""

from typing import Dict, Tuple

import numpy as np
import torch

from aps_tpu_torch.convert import to_state_dict, to_variables
from aps_tpu_torch.libs import ApsRegisters
from aps_tpu_torch.trainer.base import Trainer

# what aps_tpu's "adam" reads from optimizer_kwargs, with its defaults; "lr"
# is the scheduler's start and the rate comes from the scheduler at every
# step. Any other key (weight_decay, amsgrad, ...) has no effect there, so it
# has none here
ADAM_KEYS = {"beta1": 0.9, "beta2": 0.999, "eps": 1e-8}


def make_optimizer(name: str, params, kwargs: Dict,
                   log=None) -> torch.optim.Optimizer:
    """The optimizer `name` as aps_tpu builds it from optimizer_kwargs;
    keys that aps_tpu does not read are named to `log` in one line."""
    if name != "adam":
        raise ValueError(f"Unsupported optimizer: {name} (the port has adam)")
    ignored = sorted(k for k in kwargs if k != "lr" and k not in ADAM_KEYS)
    if ignored and log is not None:
        log(f"optimizer_kwargs {', '.join(ignored)} have no effect: adam "
            f"reads {', '.join(ADAM_KEYS)} only, as in aps_tpu")
    opts = {k: kwargs.get(k, v) for k, v in ADAM_KEYS.items()}
    return torch.optim.Adam(params, lr=kwargs.get("lr", 1e-3),
                            betas=(opts["beta1"], opts["beta2"]),
                            eps=opts["eps"])


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
        nnet.load_state_dict(to_state_dict(variables, nnet))
        if "torch_opt_state" in cpt:
            opt = dict(cpt["torch_opt_state"])
            opt["state"] = _map_state(
                opt["state"], np.ndarray,
                lambda v: torch.from_numpy(np.array(v)))
            self.optimizer.load_state_dict(opt)

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
        return stats

    def _split_egs(self, egs: Dict) -> Tuple[Dict, Dict]:
        """(host stats such as #utt / #tok, device tensors)."""
        egs = to_device(egs, self.device)
        host = {k: v for k, v in egs.items()
                if not isinstance(v, (torch.Tensor, list))}
        return host, {k: v for k, v in egs.items() if k not in host}

    def train_one_step(self, egs: Dict) -> bool:
        host, dev = self._split_egs(egs)
        self.task.train()
        buffers = [b for b in self.task.buffers()]
        saved = [b.clone() for b in buffers]
        self.optimizer.zero_grad(set_to_none=True)
        stats = self.task(dev)
        loss = stats["loss"]
        loss.backward()
        grads = [p.grad for p in self.params if p.grad is not None]
        norm = global_norm(grads)
        if not bool(torch.isfinite(loss) & torch.isfinite(norm)):
            with torch.no_grad():
                for b, old in zip(buffers, saved):
                    b.copy_(old)
            self.reporter.log(
                f"Step {self.cur_step}: non-finite loss/grad, skipped")
            return False
        if self.clip_gradient:
            scale = self.clip_gradient / torch.clamp_min(norm,
                                                         self.clip_gradient)
            torch._foreach_mul_(grads, scale)
        lr = self.lr_scheduler.get_lr()
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        stats = {k: v.detach() for k, v in stats.items()}
        stats["norm"] = norm
        stats["rate"] = lr
        self.reporter.update(host)
        self.reporter.update(stats)
        return True

    @torch.no_grad()
    def valid_one_step(self, egs: Dict) -> None:
        host, dev = self._split_egs(egs)
        self.task.eval()
        self.reporter.update(host)
        self.reporter.update(self.task(dev))
