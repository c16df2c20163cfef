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
  nn.ConvTranspose2d  weight (I, O, H, W) <-> kernel (H, W, O, I), no
                 reversal: the U-nets' ConvTranspose with
                 transpose_kernel=True is the gradient of a conv, as
                 PyTorch's is, with the in/out axes of its kernel swapped
  nn.PReLU       weight (1,)           <-> negative_slope ()
  nn.LSTM/GRU/RNN  weight_ih/hh, bias_ih/hh (G*H, ...), and their _reverse
                 twins of a bidirectional layer <-> one flax Dense a
                 gate (kernel (in, H), bias (H)) as the layer's `jax_gates`
                 names them (aps_tpu_torch/asr/base/rnn.py): each gate's
                 block of rows is its leaf transposed; a None block is 0
                 (a bias flax's cell lacks, frozen at 0), a "+leaf" block
                 is 0 on the way in and added into that leaf on the way out
                 (its gradient is the leaf's own, so it is not written)
  jax_params     a module's own parameters named in its `jax_params`
                 (gLN gamma/beta, ScaleLinear scale, the rel_u / rel_v of an
                 xl attention or, when tied, of its encoder; the learned
                 beamformers' complex weights as their <name>_real and
                 <name>_imag pairs, their spectra projection proj and the
                 trainable FixedBeamformer's weight (2, B, C, F, 1);
                 PHASEN's GlobalNorm gamma / beta and frequency map
                 freq_linear (F, F)) keep name and shape; one that is None
                 (a ScaleLinear without scale) has no leaf

The RNN attention model needs no rule of its own either: its encoders'
layers keep aps_tpu's names (enc_list_<i>, layer_<i>, fsmn_<i> with
inp_proj, the depthwise ctx_conv (P, 1, W) <-> (W, 1, P) and out_proj),
its decoder's too (vocab_embed, decoder, att_net, proj, pred), a location
filter F is a Conv1d (the grouped one of mhloc too) and the multi-head
score weight w (H, D) a jax_params leaf.

The SSE zoo's U-nets name their conv pairs real_conv / imag_conv /
plain_conv (transposed: *_convt) around a conv (conv_t), which map onto
aps_tpu's wrapper modules real / imag / conv around Conv_0 /
ConvTranspose_0; DCCRN's bottleneck is stacked_rnn / cplx_lstmp / lstmp
<-> StackedRNN_0 / ComplexLSTMP_0 / LSTMP_0, the dual-path separators'
head prelu <-> PReLU_0, SepFormer's chunk_xfmr <-> TransformerEncoder_0
and its third dense layer linear3 <-> Dense_2.

The streaming models need no rule of their own either: the chunked
encoder's layers are layer_<i> modules with their self_attn inside, as in
aps_tpu (not a `layers` list, whose self_attn the rule above moves to an
attn_<i> sibling), the conformer's causal depthwise conv dconv and its
batch norm bn; an rt_sse@dfsmn's encoder is dfsmn/impl/fsmn_<i>.

The multi-channel front ends need no rule of their own: an RNN mask
network (enh_net/mask_net, the encoder's proj, impl and outp) is Linear
layers and recurrent layers, the MVDR's reference attention
(enh_net/mvdr_net/ref) the Linear pair linear1 / linear2 <-> Dense_0 /
Dense_1, ComplexLinear the Dense layers real and imag, and the BatchNorms
of the learned beamformers bnorm <-> BatchNorm_0.

The ASR feature transform's layers carry aps_tpu's names (layers_<i>), so
a learnable mel filterbank's `filters` (MelTransform's jax_params) is
asr_transform/layers_<i>/filters, as in aps_tpu. A global CMVN's mean and
standard deviation (gmean, gstd) are no variable of aps_tpu, which reads
them from its gcmvn file whenever it builds the model; the port keeps them
in its state and writes them to a collection of their own, "constants"
(a checkpoint's mstate), which aps_tpu's apply does not read. A tree
without them (an aps_tpu checkpoint) leaves the model's own, read from its
gcmvn file.

BatchNorm's num_batches_tracked has no counterpart in aps_tpu and is left
at 0; the port builds its norms with aps_tpu's epsilons (LayerNorm 1e-6,
BatchNorm 1e-5). Module paths map segment by segment (MODULE_NAMES); an
unmapped or left-over key on either side raises."""

import re
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

# port module name -> aps_tpu module name (one path segment each)
MODULE_NAMES = {
    "conv_encoder": "Conv2dEncoder_0",
    "conv": "Conv_0",
    "norm2d": "Normalize2d_0",
    "linear1": "Dense_0",
    "linear2": "Dense_1",
    "embed": "Embed_0",
    # the RNN LM's token embedding (aps_tpu: "embed")
    "lm_embed": "embed",
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
    # a SingleRNN's torch layer: its flax cells are the SingleRNN's own
    # children (aps_tpu_torch/asr/base/rnn.py)
    "cells": "",
    # a VariantRNN's recurrent layer (aps_tpu: an unnamed SingleRNN)
    "single_rnn": "SingleRNN_0",
    # the dual-path separators' mask head (sse/bss/dprnn.py, sepformer.py)
    "prelu": "PReLU_0",
    # SepFormer's third dense layer and its chunk transformers' encoder
    "linear3": "Dense_2",
    "chunk_xfmr": "TransformerEncoder_0",
    # the U-nets' (complex) conv pairs (sse/enh/dcunet.py): aps_tpu's
    # wrapper modules real / imag / conv around Conv_0 / ConvTranspose_0
    "real_conv": "real",
    "imag_conv": "imag",
    "plain_conv": "conv",
    "real_convt": "real",
    "imag_convt": "imag",
    "plain_convt": "conv",
    "conv_t": "ConvTranspose_0",
    # DCCRN's bottleneck (sse/bss/dccrn.py)
    "stacked_rnn": "StackedRNN_0",
    "cplx_lstmp": "ComplexLSTMP_0",
    "lstmp": "LSTMP_0",
}
_BN = (nn.BatchNorm1d, nn.BatchNorm2d)


def jax_module_path(torch_path: str) -> str:
    """'encoder.encoder.layers.3.self_attn' -> 'encoder/encoder/attn_3'."""
    # aps_tpu's encoder layers get their attentions as siblings: an
    # encoder's, and the transducer's transformer prediction net's
    # (decoder.decoder, an ApsTransformerEncoder too)
    path = re.sub(
        r"(^|\.)(encoder|decoder\.decoder)\.layers\.(\d+)\.self_attn"
        r"(?=\.|$)", r"\1\2.attn_\3", torch_path)
    path = re.sub(r"(^|\.)layers\.(\d+)(?=\.|$)", r"\1layer_\2", path)
    return "/".join(name for name in (MODULE_NAMES.get(seg, seg)
                                      for seg in path.split(".")) if name)


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
        elif isinstance(mod, nn.ConvTranspose2d):
            out[prefix + "weight"] = ("params", pfx + "kernel", "conv_t2d")
            if mod.bias is not None:
                out[prefix + "bias"] = ("params", pfx + "bias", None)
        elif isinstance(mod, nn.PReLU):
            out[prefix + "weight"] = ("params", pfx + "negative_slope",
                                      "scalar")
        for leaf, parts in getattr(mod, "jax_gates", {}).items():
            kind = "/kernel" if leaf.startswith("weight") else "/bias"
            out[prefix + leaf] = ("params", tuple(
                None if p is None else
                ("+" + pfx + p[1:] + kind if p[0] == "+" else pfx + p + kind)
                for p in parts), "gates")
        for leaf in getattr(mod, "jax_params", ()):
            if getattr(mod, leaf) is not None:
                out[prefix + leaf] = ("params", pfx + leaf, None)
        for leaf in getattr(mod, "port_constants", ()):
            out[prefix + leaf] = ("constants", pfx + leaf, "constant")
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
    if rule == "conv_t2d":
        # (H, W, O, I) -> (I, O, H, W), no reversal
        return np.transpose(value, (3, 2, 0, 1))
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
    if rule == "conv_t2d":
        # (I, O, H, W) -> (H, W, O, I)
        return np.transpose(value, (2, 3, 1, 0))
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


def to_state_dict(variables: Dict, model: nn.Module, strict: bool = True
                  ) -> Dict[str, torch.Tensor]:
    """aps_tpu variables tree (numpy) -> state_dict for `model`. With
    strict=False (a warm start) the state_dict holds only the keys whose
    leaf the tree has at the model's shape, and left-over leaves are
    ignored: load it with load_state_dict(..., strict=False)."""
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
        if rule == "gates":
            src = _gates_in(flat, col, path, ref)
        else:
            src = flat.pop(f"{col}/{path}", None)
        if src is None and rule == "constant":
            # aps_tpu's trees have no such leaf: the model's own stays
            state[key] = ref.clone()
            continue
        if src is None:
            if not strict:
                continue
            raise KeyError(f"aps_tpu leaf {col}/{path} (for {key}) is "
                           "missing")
        val = torch.from_numpy(np.array(_to_port(src, rule), copy=True))
        if tuple(val.shape) != tuple(ref.shape):
            if not strict:
                continue
            raise ValueError(f"{col}/{path} -> {key}: shape "
                             f"{tuple(val.shape)} != {tuple(ref.shape)}")
        state[key] = val.to(ref.dtype)
    if flat and strict:
        raise KeyError(f"aps_tpu leaves left unmapped: {sorted(flat)}")
    return state


def _gates_in(flat: Dict, col: str, parts, ref: torch.Tensor):
    """The (G*H, ...) value of a recurrent layer's parameter from its gate
    leaves (None and "+leaf" blocks are 0); None when a leaf is
    missing."""
    rows = ref.shape[0] // len(parts)
    blocks = []
    for part in parts:
        if part is None or part[0] == "+":
            blocks.append(np.zeros((rows,) + tuple(ref.shape[1:]),
                                   dtype=np.float32))
            continue
        val = flat.pop(f"{col}/{part}", None)
        if val is None:
            return None
        blocks.append(val.T if val.ndim == 2 else val)
    return np.concatenate(blocks, 0)


def _to_tree(model: nn.Module, named_values, gradients: bool = False
             ) -> Dict:
    """(port key, tensor) pairs -> aps_tpu tree of numpy arrays. A
    recurrent layer's "+leaf" blocks are added into their leaves (values)
    or left out (gradients: the leaf's gradient is its own block's)."""
    leaves = _leaves(model)
    tree = {}
    folds = []

    def put(col, path, arr):
        node = tree.setdefault(col, {})
        *mods, leaf = path.split("/")
        for seg in mods:
            node = node.setdefault(seg, {})
        if leaf in node:
            raise KeyError(f"two port keys map onto {col}/{path}")
        # ascontiguousarray alone would turn a 0-d leaf into shape (1,)
        node[leaf] = np.ascontiguousarray(arr).reshape(arr.shape)

    for key, val in named_values:
        if _skipped(key):
            continue
        if key not in leaves:
            raise KeyError(f"port key {key} has no aps_tpu mapping")
        col, path, rule = leaves[key]
        if rule != "gates":
            put(col, path, _to_jax(val.detach().cpu().numpy(), rule))
            continue
        blocks = np.split(val.detach().cpu().numpy(), len(path), 0)
        for part, block in zip(path, blocks):
            if part is None:
                continue
            block = block.T if block.ndim == 2 else block
            if part[0] == "+":
                folds.append((col, part[1:], block))
            else:
                put(col, part, block)
    if not gradients:
        for col, path, block in folds:
            node = tree[col]
            *mods, leaf = path.split("/")
            for seg in mods:
                node = node[seg]
            node[leaf] = node[leaf] + block
    return tree


def to_variables(model: nn.Module, state: Optional[Dict] = None) -> Dict:
    """The port model's weights and buffers (or `state`, a state_dict of
    the model's keys: the whole weights of a tensor-parallel model) ->
    aps_tpu variables tree of numpy arrays."""
    return _to_tree(model, (model.state_dict() if state is None
                            else state).items())


def to_gradients(model: nn.Module) -> Dict:
    """The gradients of the port model's parameters (after backward) ->
    a tree shaped like aps_tpu's params; a trainable parameter without a
    gradient raises."""
    grads = []
    for key, p in model.named_parameters():
        if not p.requires_grad:
            # frozen at 0: a bias that aps_tpu's cell lacks
            continue
        if p.grad is None:
            raise ValueError(f"parameter {key} has no gradient")
        grads.append((key, p.grad))
    return _to_tree(model, grads, gradients=True)["params"]
