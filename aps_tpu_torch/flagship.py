#!/usr/bin/env python
"""The flagship model of the repo, a Conformer AED with a CTC head, as the
port builds it (the configuration of __graft_entry__._build_flagship).

flagship_conf gives the train.yaml sections (nnet, nnet_conf,
asr_transform) that aps_tpu's load_checkpoint and the port's both read;
build_flagship builds the port's model from them; init_weights draws its
weights from an explicit torch.Generator."""

import math
from typing import Dict

import torch
from torch import nn

from aps_tpu_torch.libs import aps_asr_nnet, aps_transform


def flagship_conf(vocab_size: int = 64, small: bool = True) -> Dict:
    """Id layout: 0..V-4 tokens, V-3 sos, V-2 eos, V-1 ctc blank. The full
    width (small=False) is 12 conformer layers of width 256 with 4 heads
    and 6 decoder layers."""
    att_dim = 64 if small else 256
    return {
        "nnet": "asr@xfmr",
        "asr_transform": {
            "feats": "fbank-log-cmvn",
            "frame_len": 400,
            "frame_hop": 160,
            "window": "hamm",
        },
        "nnet_conf": {
            "input_size": 80,
            "vocab_size": vocab_size,
            "sos": vocab_size - 3,
            "eos": vocab_size - 2,
            "ctc": True,
            "enc_type": "cfmr",
            "enc_kwargs": {
                "proj": "conv2d",
                "proj_kwargs": {"conv_channels": 32, "num_layers": 2},
                "pose": "rel",
                "num_layers": 2 if small else 12,
                "arch_kwargs": {
                    "att_dim": att_dim,
                    "nhead": 4,
                    "feedforward_dim": att_dim * 4,
                    "kernel_size": 15,
                    "pre_norm": True,
                },
            },
            "dec_kwargs": {
                "num_layers": 2 if small else 6,
                "arch_kwargs": {
                    "att_dim": att_dim,
                    "nhead": 4,
                    "feedforward_dim": att_dim * 4,
                },
            },
        },
    }


def build_flagship(conf: Dict) -> nn.Module:
    transform = aps_transform("asr")(**conf["asr_transform"])
    return aps_asr_nnet(conf["nnet"])(asr_transform=transform,
                                      **conf["nnet_conf"])


def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded random weights: matrices and kernels N(0, 1/fan_in),
    embeddings N(0, 1/dim), biases and norm shifts 0, norm scales 1, BN
    running statistics drawn around (0, 1) so the norms are not identity."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.dim() >= 2:
                fan_in = p.shape[-1] if name.endswith("embed.weight") or \
                    "vocab_embed" in name else math.prod(p.shape[1:])
                p.copy_(torch.randn(p.shape, generator=generator) /
                        math.sqrt(fan_in))
            elif name.endswith("bias"):
                p.zero_()
            else:
                p.fill_(1.0)
        for name, b in model.named_buffers():
            if name.endswith("running_mean"):
                b.copy_(0.1 * torch.randn(b.shape, generator=generator))
            elif name.endswith("running_var"):
                b.copy_(1.0 + 0.1 * torch.rand(b.shape, generator=generator))
