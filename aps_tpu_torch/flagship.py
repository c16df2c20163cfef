#!/usr/bin/env python
"""The named model configurations of the port.

The flagship of the repo is a Conformer AED with a CTC head (the
configuration of __graft_entry__._build_flagship): flagship_conf gives the
train.yaml sections (nnet, nnet_conf, asr_transform) that aps_tpu's
load_checkpoint and the port's both read. xfmr_abs_conf is the long-form
model beside it, a post-norm transformer encoder with absolute (input
sinusoid) positions, whose self-attention is the scaled-dot-product flash
kernel. MODELS maps a name to (conf, train conf); build_flagship builds the
port's model from either conf; init_weights draws its weights from an
explicit torch.Generator."""

import math
from typing import Dict, Optional

import torch
from torch import nn

from aps_tpu_torch.libs import aps_asr_nnet, aps_transform


def flagship_conf(vocab_size: int = 64, small: bool = True,
                  enc_att_dropout: Optional[float] = None) -> Dict:
    """Id layout: 0..V-4 tokens, V-3 sos, V-2 eos, V-1 ctc blank. The full
    width (small=False) is 12 conformer layers of width 256 with 4 heads
    and 6 decoder layers. enc_att_dropout sets att_dropout of the encoder
    layers (default 0.1 when left out): with 0 the encoder's self-attention
    takes the flash kernel in training too, with more it takes the dense
    path there (the kernels have no dropout inside)."""
    att_dim = 64 if small else 256
    conf = {
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
    if enc_att_dropout is not None:
        conf["nnet_conf"]["enc_kwargs"]["arch_kwargs"]["att_dropout"] = \
            enc_att_dropout
    return conf


def _train_sections(conf: Dict) -> Dict:
    conf.update(
        task="asr@ctc_xent",
        task_conf={"ctc_weight": 0.2, "lsm_factor": 0.1},
        trainer_conf={
            "optimizer": "adam",
            "optimizer_kwargs": {"lr": 1e-4},
            "clip_gradient": 5.0,
            "report_metrics": ["loss", "accu", "@ctc", "xent"],
        })
    return conf


def flagship_train_conf(vocab_size: int = 4233) -> Dict:
    """flagship_conf at full width with the encoder's attention dropout 0,
    plus the task and trainer sections of the training step the port is
    measured at (the shape of bench.py's step: asr@ctc_xent with ctc weight
    0.2 and label smoothing 0.1, Adam 1e-4, global-norm clip 5.0)."""
    return _train_sections(
        flagship_conf(vocab_size, small=False, enc_att_dropout=0.0))


def xfmr_abs_conf(vocab_size: int = 64, small: bool = True,
                  enc_att_dropout: Optional[float] = None) -> Dict:
    """The long-form abs-pose model: flagship_conf with the conformer
    encoder replaced by a post-norm transformer encoder (enc_type xfmr,
    pose abs). At full width 12 layers of width 256 with 4 heads (head dim
    64) and the layer's default feed-forward width of 2048, the widths
    aps_tpu's BENCHMARKS.md gives for its abs-pose encoder."""
    conf = flagship_conf(vocab_size, small=small)
    att_dim = 64 if small else 256
    nnet_conf = conf["nnet_conf"]
    nnet_conf["enc_type"] = "xfmr"
    nnet_conf["enc_kwargs"].update(
        pose="abs",
        arch_kwargs={"att_dim": att_dim, "nhead": 4,
                     "feedforward_dim": att_dim * 4 if small else 2048,
                     "pre_norm": False})
    if enc_att_dropout is not None:
        nnet_conf["enc_kwargs"]["arch_kwargs"]["att_dropout"] = \
            enc_att_dropout
    return conf


def xfmr_abs_train_conf(vocab_size: int = 4233) -> Dict:
    """xfmr_abs_conf at full width with the encoder's attention dropout 0
    (so that its self-attention takes the flash kernel in training), under
    the task and trainer sections of flagship_train_conf."""
    return _train_sections(
        xfmr_abs_conf(vocab_size, small=False, enc_att_dropout=0.0))


# name -> (conf(vocab_size, small, enc_att_dropout), train conf(vocab_size))
MODELS = {
    "flagship": (flagship_conf, flagship_train_conf),
    "xfmr_abs": (xfmr_abs_conf, xfmr_abs_train_conf),
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
