#!/usr/bin/env python
"""Framework-wide constants (the port's own copy of aps_tpu/const.py: same
names, same values; float32 limits come from numpy)."""

import numpy as np

IGNORE_ID = -1
UNK_TOKEN = "<unk>"
BLK_TOKEN = "<b>"
SOS_TOKEN = "<sos>"
EOS_TOKEN = "<eos>"

MAX_INT16 = np.iinfo(np.int16).max
MIN_F32 = np.finfo(np.float32).min
MAX_F32 = np.finfo(np.float32).max
EPSILON = float(np.finfo(np.float32).eps)
NEG_INF = -1.0e30  # mask value that survives a bf16 downcast without nan
