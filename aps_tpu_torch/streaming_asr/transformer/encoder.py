#!/usr/bin/env python
"""Streaming (chunked, bounded left context) transformer encoder (port of
aps_tpu/streaming_asr/transformer/encoder.py: StreamingTransformerEncoder).

proj -> rel pose -> the streaming layers (-> outp). Offline (forward) the
dense attention of every layer takes the chunk-context mask of `chunk`
frames a chunk and `lctx` chunks of left context; `step` takes one chunk
of frames (after the projection) and the per-layer caches, which gives the
same frames. The relative-position table's radii are set here: lctx on the
left, chunk - 1 on the right, as aps_tpu sets them."""

from typing import Dict, Optional

import torch
from torch import nn

from aps_tpu_torch.asr.base.attention import padding_mask
from aps_tpu_torch.asr.transformer.pose import get_xfmr_pose
from aps_tpu_torch.asr.transformer.proj import get_xfmr_proj
from aps_tpu_torch.asr.transformer.utils import prep_context_mask
from aps_tpu_torch.streaming_asr.transformer.impl import \
    ApsStreamingTransformerEncoder


class StreamingTransformerEncoder(nn.Module):

    def __init__(self,
                 arch: str,
                 input_size: int,
                 output_proj: int = -1,
                 num_layers: int = 6,
                 chunk: int = 1,
                 lctx: int = 3,
                 proj: str = "conv2d",
                 proj_kwargs: Optional[Dict] = None,
                 pose: str = "rel",
                 pose_kwargs: Optional[Dict] = None,
                 arch_kwargs: Optional[Dict] = None):
        super(StreamingTransformerEncoder, self).__init__()
        arch_kwargs = dict(arch_kwargs or {})
        att_dim = arch_kwargs["att_dim"]
        self.proj_layer = None if proj == "none" else get_xfmr_proj(
            proj, input_size, att_dim, **(proj_kwargs or {}))
        if pose != "rel":
            raise ValueError("Now only support rel position encodings")
        pose_kwargs = dict(pose_kwargs or {})
        pose_kwargs["lradius"] = lctx
        pose_kwargs["rradius"] = chunk - 1
        self.pose_layer = get_xfmr_pose("rel",
                                        att_dim // arch_kwargs["nhead"],
                                        **pose_kwargs)
        self.encoder = ApsStreamingTransformerEncoder(
            arch, num_layers, lctx * chunk, arch_kwargs=arch_kwargs)
        self.outp = nn.Linear(att_dim, output_proj) \
            if output_proj > 0 else None
        self.chunk, self.lctx = chunk, lctx
        self.out_dim = output_proj if output_proj > 0 else att_dim

    def output_dim(self) -> int:
        return self.out_dim

    def num_frames(self, inp_len):
        if inp_len is None or self.proj_layer is None:
            return inp_len
        return self.proj_layer.num_frames(inp_len)

    def forward(self, inp_pad: torch.Tensor, inp_len=None):
        """Offline: inp_pad N x T x F -> (N x T' x D, lengths), the
        attention under the chunk-context mask."""
        if self.proj_layer is None:
            enc_inp = inp_pad
        else:
            enc_inp, inp_len = self.proj_layer(inp_pad, inp_len)
        nframes = enc_inp.shape[1]
        dev = enc_inp.device
        src_pad_mask = None if inp_len is None else padding_mask(
            inp_len, nframes)
        inj_pose = self.pose_layer(torch.arange(-nframes + 1, nframes,
                                                device=dev))
        src_mask = prep_context_mask(nframes, self.chunk, lctx=self.lctx,
                                     rctx=0, device=dev)
        enc_out = self.encoder(enc_inp, inj_pose, src_mask=src_mask,
                               src_key_padding_mask=src_pad_mask)
        if self.outp is not None:
            enc_out = self.outp(enc_out)
        return enc_out, inp_len

    def init_step_state(self, batch: int, device=None) -> Dict:
        """The per-layer caches and the count of valid cached frames."""
        return self.encoder.init_state(batch, device=device)

    def _rel_mat(self, num_queries: int, device) -> torch.Tensor:
        """The step's C x S x D table, S = lctx * chunk + C: query l sits
        at window index Lc + l and key s at s, so the offset is
        s - Lc - l (clipped by the pose layer)."""
        lc = self.lctx * self.chunk
        s = torch.arange(lc + num_queries, device=device)
        l = torch.arange(num_queries, device=device)
        return self.pose_layer(s[None, :] - lc - l[:, None])

    def step(self, chunk: torch.Tensor, state=None):
        """chunk: N x T x F features (through a conv projection, enough
        frames for it to give `self.chunk` frames; a linear one works frame
        by frame) -> (N x chunk x D, state). Runs in evaluation mode, as
        aps_tpu's step does, whatever the module's mode."""
        training = self.training
        self.eval()
        try:
            if self.proj_layer is not None:
                chunk, _ = self.proj_layer(chunk, None)
            if state is None:
                state = self.init_step_state(chunk.shape[0], chunk.device)
            rel_mat = self._rel_mat(chunk.shape[1], chunk.device)
            out, state = self.encoder.step(chunk, rel_mat, state)
            if self.outp is not None:
                out = self.outp(out)
        finally:
            self.train(training)
        return out, state
