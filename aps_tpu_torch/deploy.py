#!/usr/bin/env python
"""Deployment-side model runners with a bytes-in / bytes-out surface (port
of aps_tpu/deploy.py: RtModel, RtSeparator; RtExported takes the place of
RtStablehlo).

RtModel runs a checkpoint's per-chunk function (mask_predict by default)
on float32 feature blocks, RtExported the same function from the
torch.export artifact of aps_tpu_torch.cmd.export, and RtSeparator a
checkpoint's infer on whole waveforms. Each takes a `device`: "cuda" (the
default) runs on the card and raises without one, "cpu" on the CPU, as
asked. aps_tpu's module forces its JAX backend onto the CPU; this one
does not. The bodies run with cuBLAS's and cuDNN's TF32 flags off
(float32), as the port's inference commands do."""

import json
import os
from typing import Tuple

import numpy as np
import torch

from aps_tpu_torch.eval.wrapper import NnetEvaluator, pick_device
from aps_tpu_torch.utils import INFERENCE_PRECISION, matmul_precision


def _as_bytes(out) -> Tuple[bytes, tuple]:
    out = np.ascontiguousarray(out.detach().float().cpu().numpy())
    return out.tobytes(), tuple(out.shape)


class RtModel(object):
    """A checkpoint's `function` (a method of the model) on 1 x T x F
    feature blocks."""

    def __init__(self, cpt_dir: str, function: str = "mask_predict",
                 cpt_tag: str = "best", device: str = "cuda",
                 device_id: int = -1):
        self.evaluator = NnetEvaluator(cpt_dir, cpt_tag=cpt_tag,
                                       device=device, device_id=device_id)
        self.function = function
        self.fn = getattr(self.evaluator.nnet, function)

    def forward_bytes(self, data: bytes, num_frames: int,
                      dim: int) -> Tuple[bytes, tuple]:
        """float32 bytes of 1 x num_frames x dim features -> (float32
        bytes of the output, its shape)."""
        dev = self.evaluator.device
        feats = np.frombuffer(data, dtype=np.float32).reshape(
            1, num_frames, dim)
        with torch.inference_mode(), matmul_precision(INFERENCE_PRECISION,
                                                      dev):
            out = self.fn(torch.from_numpy(feats.copy()).to(dev))
        return _as_bytes(out)


class RtExported(object):
    """Runs the artifact of aps_tpu_torch.cmd.export (model.pt2, a
    torch.export program of one model function at a fixed 1 x T x F
    input, and model.json). The program runs on the device it was exported
    on, which model.json names; `device` must agree with it."""

    def __init__(self, export_dir: str, device: str = "cuda",
                 device_id: int = -1):
        with open(os.path.join(export_dir, "model.json")) as fd:
            self.meta = json.load(fd)
        self.device = pick_device(device, device_id)
        if torch.device(self.meta["device"]).type != self.device.type:
            raise ValueError(f"{export_dir} was exported on "
                             f"{self.meta['device']}, not {self.device}")
        program = torch.export.load(os.path.join(export_dir, "model.pt2"))
        self.fn = program.module()
        self.input_shape = tuple(self.meta["input_shape"])

    def forward_bytes(self, data: bytes, num_frames: int,
                      dim: int) -> Tuple[bytes, tuple]:
        if (1, num_frames, dim) != self.input_shape:
            raise ValueError(f"the exported function takes "
                             f"{self.input_shape}, not (1, {num_frames}, "
                             f"{dim})")
        feats = np.frombuffer(data, dtype=np.float32).reshape(
            1, num_frames, dim)
        with torch.inference_mode(), matmul_precision(INFERENCE_PRECISION,
                                                      self.device):
            out = self.fn(torch.from_numpy(feats.copy()).to(self.device))
        return _as_bytes(out)


class RtSeparator(object):
    """A checkpoint's infer on one waveform (wave in, wave out; several
    branches or speakers stacked)."""

    def __init__(self, cpt_dir: str, cpt_tag: str = "best",
                 device: str = "cuda", device_id: int = -1):
        self.evaluator = NnetEvaluator(cpt_dir, cpt_tag=cpt_tag,
                                       device=device, device_id=device_id)

    def enhance_bytes(self, data: bytes,
                      num_samples: int) -> Tuple[bytes, tuple]:
        dev = self.evaluator.device
        mix = np.frombuffer(data, dtype=np.float32)[:num_samples]
        with torch.inference_mode(), matmul_precision(INFERENCE_PRECISION,
                                                      dev):
            out = self.evaluator.nnet.infer(torch.from_numpy(mix.copy()).to(
                dev))
        if isinstance(out, (list, tuple)):
            out = torch.stack(list(out))
        return _as_bytes(out)
