#!/usr/bin/env python
"""Checkpoint loading for the port (port of aps_tpu/eval/wrapper.py::
load_checkpoint, NnetEvaluator).

Reads the same checkpoint directory as aps_tpu: train.yaml beside a
pickled <tag>.ckpt of numpy arrays, with the model variables under "params"
(optionally scoped "nnet" by the task) and the other collections under
"mstate". The weights are converted with aps_tpu_torch.convert."""

import pathlib
import pickle
from typing import Dict

import torch

from aps_tpu_torch.conf import load_yaml
from aps_tpu_torch.convert import to_state_dict
from aps_tpu_torch.libs import aps_asr_nnet, aps_transform


class _Opaque(object):
    """Stand-in for objects of a checkpoint that the port does not read
    (the JAX trainer's optimizer state and the like): loading a checkpoint
    must not import the JAX stack."""

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        pass


class _CheckpointUnpickler(pickle.Unpickler):
    _SAFE = ("numpy", "builtins", "collections", "copyreg", "_codecs")

    def find_class(self, module, name):
        if module.split(".")[0] in self._SAFE:
            return super(_CheckpointUnpickler, self).find_class(module, name)
        return _Opaque


def read_checkpoint(path) -> Dict:
    with open(path, "rb") as fd:
        return _CheckpointUnpickler(fd).load()


def pick_device(device: str = "cuda", device_id: int = -1) -> torch.device:
    """The device of an entry point. "cuda" (the default) is card
    `device_id` (-1: card 0) and raises when torch sees no CUDA device;
    the CPU is used only when the caller asks for "cpu"."""
    if device == "cpu":
        return torch.device("cpu")
    if device != "cuda":
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("torch sees no CUDA device: the port runs on the "
                           "card; pass --device cpu (device='cpu') to run "
                           "on the CPU")
    return torch.device(f"cuda:{max(device_id, 0)}")


def load_checkpoint(cpt_dir: str, cpt_tag: str = "best") -> Dict:
    """Rebuild the nnet from train.yaml and load <tag>.ckpt into it (CPU,
    eval mode)."""
    cpt_dir = pathlib.Path(cpt_dir)
    cpt = read_checkpoint(cpt_dir / f"{cpt_tag}.ckpt")
    conf = load_yaml(cpt_dir / "train.yaml")
    nnet_cls = aps_asr_nnet(conf["nnet"])
    if "enh_transform" in conf:
        raise NotImplementedError("enh_transform is not ported yet")
    kwargs = dict(conf["nnet_conf"])
    if "asr_transform" in conf:
        kwargs["asr_transform"] = aps_transform("asr")(
            **conf["asr_transform"])
    nnet = nnet_cls(**kwargs)
    params = cpt["params"]
    if "nnet" in params:
        params = params["nnet"]
    variables = {"params": params}
    for col, tree in cpt.get("mstate", {}).items():
        variables[col] = tree["nnet"] if "nnet" in tree else tree
    nnet.load_state_dict(to_state_dict(variables, nnet))
    nnet.eval()
    return {
        "epoch": cpt.get("epoch", 0),
        "nnet": nnet,
        "conf": conf,
    }


class NnetEvaluator(object):
    """Binds a loaded nnet to a device for inference commands."""

    def __init__(self, cpt_dir: str, cpt_tag: str = "best",
                 device: str = "cuda", device_id: int = -1) -> None:
        stats = load_checkpoint(cpt_dir, cpt_tag=cpt_tag)
        self.conf = stats["conf"]
        self.device = pick_device(device, device_id)
        self.nnet = stats["nnet"].to(self.device)
        self.epoch = stats["epoch"]
