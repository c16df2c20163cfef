#!/usr/bin/env python
"""Transformer/Conformer encoder wrapper (port of
aps_tpu/asr/transformer/encoder.py::TransformerEncoder):
proj -> pose -> N encoder layers (-> outp), with optional chunked-context
masking (lctx/rctx/chunk_size). Batch-first."""

from typing import Dict, Optional

import torch
from torch import nn

from aps_tpu_torch.asr.base.attention import padding_mask
from aps_tpu_torch.asr.transformer.impl import get_xfmr_encoder
from aps_tpu_torch.asr.transformer.pose import get_xfmr_pose
from aps_tpu_torch.asr.transformer.proj import get_xfmr_proj
from aps_tpu_torch.asr.transformer.utils import prep_context_mask


class TransformerEncoder(nn.Module):
    """arch in {xfmr, cfmr}; pose in {abs, rel, xl, conv1d}; proj in {conv2d,
    conv1d, linear, none}. lctx/rctx give every layer an additive attn_mask,
    which puts its attention on the dense path."""

    def __init__(self,
                 arch: str,
                 input_size: int,
                 output_proj: int = -1,
                 num_layers: int = 6,
                 lctx: int = -1,
                 rctx: int = -1,
                 chunk_size: int = 1,
                 proj: str = "conv2d",
                 proj_kwargs: Optional[Dict] = None,
                 pose: str = "abs",
                 pose_kwargs: Optional[Dict] = None,
                 arch_kwargs: Optional[Dict] = None):
        super(TransformerEncoder, self).__init__()
        arch_kwargs = dict(arch_kwargs or {})
        att_dim = arch_kwargs["att_dim"]
        self.proj_layer = None if proj == "none" else get_xfmr_proj(
            proj, input_size, att_dim, **(proj_kwargs or {}))
        # the rel table is per head; xl and the input encodings are E wide
        pose_dim = att_dim // arch_kwargs["nhead"] if pose == "rel" \
            else att_dim
        self.pose_layer = get_xfmr_pose(pose, pose_dim,
                                        **(pose_kwargs or {}))
        self.pose_type = "abs" if pose == "conv1d" else pose
        self.encoder = get_xfmr_encoder(arch, self.pose_type, num_layers,
                                        arch_kwargs)
        self.att_dim = att_dim
        self.lctx, self.rctx, self.chunk_size = lctx, rctx, chunk_size
        self.outp = nn.Linear(att_dim, output_proj) \
            if output_proj > 0 else None

    def num_frames(self, inp_len):
        """Output frame count after the projection subsampling."""
        if inp_len is None or self.proj_layer is None:
            return inp_len
        return self.proj_layer.num_frames(inp_len)

    def forward(self, inp_pad: torch.Tensor, inp_len=None):
        """inp_pad: N x Ti x F -> (enc_out N x To x D, out_len)."""
        if self.proj_layer is None:
            enc_inp = inp_pad
        else:
            enc_inp, inp_len = self.proj_layer(inp_pad, inp_len)
        nframes = enc_inp.shape[1]
        dev = enc_inp.device
        src_pad_mask = None if inp_len is None else padding_mask(
            inp_len, nframes)
        inj_pose = None
        if self.pose_type == "abs":
            enc_inp = self.pose_layer(enc_inp)
        elif self.pose_type == "rel":
            inj_pose = self.pose_layer(
                torch.arange(-nframes + 1, nframes, device=dev))
        else:
            inj_pose = self.pose_layer(
                torch.arange(0, 2 * nframes - 1, dtype=torch.float32,
                             device=dev))
        src_mask = None
        if self.lctx != -1 or self.rctx != -1:
            src_mask = prep_context_mask(nframes, self.chunk_size,
                                         lctx=self.lctx, rctx=self.rctx,
                                         device=dev)
        enc_out = self.encoder(enc_inp, inj_pose=inj_pose, src_mask=src_mask,
                               src_key_padding_mask=src_pad_mask)
        if self.outp is not None:
            enc_out = self.outp(enc_out)
        return enc_out, inp_len
