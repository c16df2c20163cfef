#!/usr/bin/env python
"""Carry weights between aps_tpu (JAX) and the port.

to_state_dict turns aps_tpu's variables tree of numpy arrays,
{"params": ..., "batch_stats": ...} as aps_tpu's load_checkpoint returns
it, into the port model's state_dict; to_variables is the inverse (the
trainer writes aps_tpu checkpoints with it) and to_gradients gives the
parameters' gradients as a tree in aps_tpu's layout, so that they compare
leaf by leaf with jax.grad. All walk the port model's modules, so the
layout rule of each leaf follows the module that owns it:

  nn.Linear      weight (out, in)      <-> kernel (in, out); the fused QKV
                 in_proj keeps one (3E, E) weight <-> DenseGeneral (E, 3E)
  nn.Conv1d/2d   weight (O, I, ...)    <-> kernel (..., I, O)  (HWIO / WIO)
  nn.LayerNorm   weight, bias          <-> scale, bias
  nn.BatchNorm   weight, bias          <-> params scale, bias
                 running_mean/_var     <-> batch_stats mean, var
  nn.Embedding   weight                <-> embedding (as is)
  nn.ConvTranspose1d  weight (I, O, W) <-> kernel (W, I, O) with the W axis
                 reversed: flax's ConvTranspose (transpose_kernel=False)
                 correlates the dilated input with the kernel as stored,
                 where PyTorch scatters it, i.e. applies it flipped
  nn.PReLU       weight (1,)           <-> negative_slope ()
  jax_params     a module's own parameters named in its `jax_params`
                 (gLN gamma/beta, ScaleLinear scale, the rel_u / rel_v of an
                 xl attention or, when tied, of its encoder) keep name and
                 shape; one that is None (a ScaleLinear without scale) has
                 no leaf

BatchNorm's num_batches_tracked has no counterpart in aps_tpu and is left
at 0; the port builds its norms with aps_tpu's epsilons (LayerNorm 1e-6,
BatchNorm 1e-5). Module paths map segment by segment (MODULE_NAMES); an
unmapped or left-over key on either side raises."""

import re
from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

# port module name -> aps_tpu module name (one path segment each)
MODULE_NAMES = {
    "conv_encoder": "Conv2dEncoder_0",
    "conv": "Conv_0",
    "norm2d": "Normalize2d_0/BatchNorm_0",
    "linear1": "Dense_0",
    "linear2": "Dense_1",
    "embed": "Embed_0",
    "cross_attn": "multihead_attn",
    # LinearProj / Conv1dProj and their norms
    "conv1d_encoder": "Conv1dEncoder_0",
    "norm1d": "Normalize1d_0",
    "lnorm": "LayerNorm_0",
    # Conv-TasNet (aps_tpu_torch/sse/bss/tcn.py)
    "tcn": "conv",
    "linear_in": "ScaleLinear_0",
    "linear_out": "ScaleLinear_1",
    "dense": "Dense_0",
    "prelu_in": "PReLU_0",
    "prelu_out": "PReLU_1",
    "norm_in": "NormalizeLayer_0",
    "norm_out": "NormalizeLayer_1",
    "gln": "GlobalChannelLayerNorm_0",
    "bnorm": "BatchNorm_0",
}
_BN = (nn.BatchNorm1d, nn.BatchNorm2d)


def jax_module_path(torch_path: str) -> str:
    """'encoder.encoder.layers.3.self_attn' -> 'encoder/encoder/attn_3'."""
    # aps_tpu's encoder layers get their attentions as siblings
    path = re.sub(r"(^|\.)encoder\.layers\.(\d+)\.self_attn(?=\.|$)",
                  r"\1encoder.attn_\2", torch_path)
    path = re.sub(r"(^|\.)layers\.(\d+)(?=\.|$)", r"\1layer_\2", path)
    return "/".join(MODULE_NAMES.get(seg, seg) for seg in path.split("."))


def _leaves(module: nn.Module) -> Dict[str, Tuple[str, str, object]]:
    """port key -> (collection, aps_tpu leaf path, layout rule)."""
    out = {}
    for name, mod in module.named_modules():
        jpath = jax_module_path(name)
        prefix = f"{name}." if name else ""
        pfx = f"{jpath}/" if jpath else ""
        if isinstance(mod, nn.Linear):
            out[prefix + "weight"] = ("params", pfx + "kernel", "linear")
            if mod.bias is not None:
                out[prefix + "bias"] = ("params", pfx + "bias", None)
        elif isinstance(mod, (nn.Conv1d, nn.Conv2d)):
            out[prefix + "weight"] = ("params", pfx + "kernel", "conv")
            if mod.bias is not None:
                out[prefix + "bias"] = ("params", pfx + "bias", None)
        elif isinstance(mod, nn.LayerNorm):
            out[prefix + "weight"] = ("params", pfx + "scale", None)
            out[prefix + "bias"] = ("params", pfx + "bias", None)
        elif isinstance(mod, _BN):
            out[prefix + "weight"] = ("params", pfx + "scale", None)
            out[prefix + "bias"] = ("params", pfx + "bias", None)
            out[prefix + "running_mean"] = ("batch_stats", pfx + "mean", None)
            out[prefix + "running_var"] = ("batch_stats", pfx + "var", None)
        elif isinstance(mod, nn.Embedding):
            out[prefix + "weight"] = ("params", pfx + "embedding", None)
        elif isinstance(mod, nn.ConvTranspose1d):
            out[prefix + "weight"] = ("params", pfx + "kernel", "conv_t")
            if mod.bias is not None:
                out[prefix + "bias"] = ("params", pfx + "bias", None)
        elif isinstance(mod, nn.PReLU):
            out[prefix + "weight"] = ("params", pfx + "negative_slope",
                                      "scalar")
        for leaf in getattr(mod, "jax_params", ()):
            if getattr(mod, leaf) is not None:
                out[prefix + leaf] = ("params", pfx + leaf, None)
    return out


def _to_port(value: np.ndarray, rule) -> np.ndarray:
    if rule == "linear":
        return value.T
    if rule == "conv":
        # (..., I, O) -> (O, I, ...)
        nd = value.ndim
        return np.transpose(value, (nd - 1, nd - 2) + tuple(range(nd - 2)))
    if rule == "conv_t":
        # (W, I, O) -> (I, O, W), W reversed
        return np.transpose(value, (1, 2, 0))[..., ::-1]
    if rule == "scalar":
        return value.reshape(1)
    return value


def _to_jax(value: np.ndarray, rule) -> np.ndarray:
    if rule == "linear":
        return value.T
    if rule == "conv":
        # (O, I, ...) -> (..., I, O)
        nd = value.ndim
        return np.transpose(value, tuple(range(2, nd)) + (1, 0))
    if rule == "conv_t":
        # (I, O, W) -> (W, I, O), W reversed
        return np.transpose(value[..., ::-1], (2, 0, 1))
    if rule == "scalar":
        return value.reshape(())
    return value


def _flatten(tree: Dict, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(val, dict):
            out.update(_flatten(val, path))
        else:
            out[path] = np.asarray(val)
    return out


def _skipped(key: str) -> bool:
    return key.endswith("num_batches_tracked")


def to_state_dict(variables: Dict, model: nn.Module
                  ) -> Dict[str, torch.Tensor]:
    """aps_tpu variables tree (numpy) -> state_dict for `model`."""
    flat = {f"{col}/{path}": val
            for col, tree in variables.items()
            for path, val in _flatten(tree).items()}
    target = model.state_dict()
    leaves = _leaves(model)
    state = {}
    for key, ref in target.items():
        if _skipped(key):
            state[key] = ref.clone()
            continue
        if key not in leaves:
            raise KeyError(f"port key {key} has no aps_tpu mapping")
        col, path, rule = leaves[key]
        src = flat.pop(f"{col}/{path}", None)
        if src is None:
            raise KeyError(f"aps_tpu leaf {col}/{path} (for {key}) is "
                           "missing")
        val = torch.from_numpy(np.array(_to_port(src, rule), copy=True))
        if tuple(val.shape) != tuple(ref.shape):
            raise ValueError(f"{col}/{path} -> {key}: shape "
                             f"{tuple(val.shape)} != {tuple(ref.shape)}")
        state[key] = val.to(ref.dtype)
    if flat:
        raise KeyError(f"aps_tpu leaves left unmapped: {sorted(flat)}")
    return state


def _to_tree(model: nn.Module, named_values) -> Dict:
    """(port key, tensor) pairs -> aps_tpu tree of numpy arrays."""
    leaves = _leaves(model)
    tree = {}
    for key, val in named_values:
        if _skipped(key):
            continue
        if key not in leaves:
            raise KeyError(f"port key {key} has no aps_tpu mapping")
        col, path, rule = leaves[key]
        node = tree.setdefault(col, {})
        *mods, leaf = path.split("/")
        for seg in mods:
            node = node.setdefault(seg, {})
        if leaf in node:
            raise KeyError(f"two port keys map onto {col}/{path}")
        arr = _to_jax(val.detach().cpu().numpy(), rule)
        # ascontiguousarray alone would turn a 0-d leaf into shape (1,)
        node[leaf] = np.ascontiguousarray(arr).reshape(arr.shape)
    return tree


def to_variables(model: nn.Module) -> Dict:
    """The port model's weights and buffers -> aps_tpu variables tree of
    numpy arrays."""
    return _to_tree(model, model.state_dict().items())


def to_gradients(model: nn.Module) -> Dict:
    """The gradients of the port model's parameters (after backward) ->
    a tree shaped like aps_tpu's params; a parameter without a gradient
    raises."""
    grads = []
    for key, p in model.named_parameters():
        if p.grad is None:
            raise ValueError(f"parameter {key} has no gradient")
        grads.append((key, p.grad))
    return _to_tree(model, grads)["params"]
