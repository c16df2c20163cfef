#!/usr/bin/env python
"""Small shared utilities: logging, timing, seeding (the port's own copy of
what it needs from aps_tpu/utils.py; set_seed seeds torch's global
generators, from which the dropouts draw), and matmul_precision, the TF32
flags of cuBLAS and cuDNN around a body of work (the trainer's steps and
the inference commands)."""

import contextlib
import copy
import logging
import random
import sys
import time

import numpy as np
import torch

LOG_FORMAT = "%(asctime)s [%(pathname)s:%(lineno)s - %(levelname)s ] %(message)s"


def get_logger(name: str,
               format_str: str = LOG_FORMAT,
               date_format: str = "%Y-%m-%d %H:%M:%S",
               file: bool = False) -> logging.Logger:
    """Get a python logger (stderr, or the file `name`)."""
    logger = logging.getLogger(name)
    if logger.handlers:
        return logger
    logger.setLevel(logging.INFO)
    formatter = logging.Formatter(fmt=format_str, datefmt=date_format)
    handler = logging.FileHandler(name) if file else \
        logging.StreamHandler(sys.stderr)
    handler.setFormatter(formatter)
    logger.addHandler(handler)
    logger.propagate = False
    return logger


def set_seed(seed_str: str) -> None:
    """Seed the python, numpy and torch (CPU and CUDA) generators; a
    negative seed skips seeding."""
    seed = int(seed_str)
    if seed < 0:
        return
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


class SimpleTimer(object):
    """Wall-clock timer reporting elapsed minutes."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.start = time.time()

    def elapsed(self) -> float:
        return (time.time() - self.start) / 60.0


# the precision of the inference commands' products and convolutions
# (decode, decode_batch, lm_rescore, separate): the one at which the
# card-vs-CPU decode and separation gates hold
INFERENCE_PRECISION = "float32"
# matmul_precision -> TF32 on for cuBLAS and cuDNN
TF32_PRECISIONS = {"float32": False, "highest": False, "bfloat16": True,
                   "tensorfloat32": True, "default": True}


@contextlib.contextmanager
def matmul_precision(precision: str, device: torch.device):
    """cuBLAS's and cuDNN's TF32 flags as `precision` asks, on a CUDA
    device, for the body only; nothing on another device."""
    if torch.device(device).type != "cuda":
        yield
        return
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = matmul.allow_tf32, cudnn.allow_tf32
    matmul.allow_tf32 = cudnn.allow_tf32 = TF32_PRECISIONS[precision]
    try:
        yield
    finally:
        matmul.allow_tf32, cudnn.allow_tf32 = saved


def bf16_rounded(t: torch.Tensor) -> torch.Tensor:
    """t rounded to bfloat16 (to nearest even), in t's own dtype."""
    return t.to(torch.bfloat16).to(t.dtype)


def bf16_rounded_copy(module: torch.nn.Module) -> torch.nn.Module:
    """A copy of module whose floating tensors of its state_dict (the
    parameters and the persistent buffers: what aps_tpu keeps as its
    variables and casts) are rounded to bfloat16 and kept in their own
    dtype."""
    module = copy.deepcopy(module)
    with torch.no_grad():
        for t in module.state_dict(keep_vars=True).values():
            if t.is_floating_point():
                t.copy_(bf16_rounded(t))
    return module
