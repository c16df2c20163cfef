#!/usr/bin/env python
"""Small shared utilities: logging, timing, seeding (the port's own copy of
what it needs from aps_tpu/utils.py; set_seed seeds torch's global
generators, from which the dropouts draw)."""

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
