"""aps_tpu_torch: the PyTorch/CUDA port of aps_tpu for one NVIDIA H100.

It mirrors aps_tpu's module paths, class names and registry names, reads
aps_tpu checkpoints (aps_tpu_torch.convert) and runs each TPU kernel of its
path as a hand-written CUDA kernel (aps_tpu_torch/csrc). It imports torch
and never jax."""

__version__ = "0.1.0"
