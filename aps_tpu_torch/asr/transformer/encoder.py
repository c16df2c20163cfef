#!/usr/bin/env python
"""Transformer/Conformer encoder wrapper (port of
aps_tpu/asr/transformer/encoder.py::TransformerEncoder):
proj -> pose -> encoder layers. Batch-first."""

from typing import Dict, Optional

import torch
from torch import nn

from aps_tpu_torch.asr.base.attention import padding_mask
from aps_tpu_torch.asr.transformer.impl import get_xfmr_encoder
from aps_tpu_torch.asr.transformer.pose import get_xfmr_pose
from aps_tpu_torch.asr.transformer.proj import get_xfmr_proj


class TransformerEncoder(nn.Module):
    """arch cfmr with pose rel (the kinds the port has so far)."""

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
        if lctx != -1 or rctx != -1:
            raise NotImplementedError("chunked-context encoder masks are "
                                      "not ported yet")
        if pose != "rel":
            raise NotImplementedError(f"encoder pose {pose} is not ported "
                                      "yet (only rel)")
        if output_proj > 0:
            raise NotImplementedError("the output projection of CTC-only "
                                      "encoders is not ported yet")
        arch_kwargs = dict(arch_kwargs or {})
        att_dim = arch_kwargs["att_dim"]
        self.proj_layer = get_xfmr_proj(proj, input_size, att_dim,
                                        **(proj_kwargs or {}))
        self.pose_layer = get_xfmr_pose(pose,
                                        att_dim // arch_kwargs["nhead"],
                                        **(pose_kwargs or {}))
        self.encoder = get_xfmr_encoder(arch, pose, num_layers, arch_kwargs)
        self.att_dim = att_dim

    def num_frames(self, inp_len):
        return None if inp_len is None else self.proj_layer.num_frames(
            inp_len)

    def forward(self, inp_pad: torch.Tensor, inp_len=None):
        """inp_pad: N x Ti x F -> (enc_out N x To x D, out_len)."""
        enc_inp, inp_len = self.proj_layer(inp_pad, inp_len)
        nframes = enc_inp.shape[1]
        src_pad_mask = None if inp_len is None else padding_mask(
            inp_len, nframes)
        inj_pose = self.pose_layer(
            torch.arange(-nframes + 1, nframes, device=enc_inp.device))
        enc_out = self.encoder(enc_inp, inj_pose=inj_pose,
                               src_key_padding_mask=src_pad_mask)
        return enc_out, inp_len
