#!/usr/bin/env python
"""Real-time enhancement base (port of aps_tpu/rt_sse/base.py:
RealTimeSSEBase). aps_tpu's two real-time models each spell out the same
mask path, which lives here once: the enh transform's STFT and features,
the network's N x T x B*F (x 2 for a complex mask) outputs through the mask
non-linearity, one mask a branch (complex64 for a complex mask, where
aps_tpu packs a real pair), the masked STFTs back to waveforms. step and
mask_predict are the streaming and the deployment entries."""

from typing import List, Optional

import torch
from torch import nn

from aps_tpu_torch.sse.base import MaskNonLinear, SSEBase, tf_masking


class RealTimeSSEBase(SSEBase):
    """Subclasses build self.mask_net's forward (_network: N x T x F
    features -> N x T x B*F outputs) and its step (_network_step), and may
    pad the features offline (_context_pad)."""

    def __init__(self, enh_transform: Optional[nn.Module] = None,
                 num_branchs: int = 1, complex_mask: bool = True,
                 non_linear: str = "relu", training_mode: str = "freq"):
        super(RealTimeSSEBase, self).__init__(enh_transform=enh_transform,
                                              training_mode=training_mode)
        if enh_transform is None:
            raise ValueError(f"{type(self).__name__} needs an enh_transform")
        self.num_branchs = num_branchs
        self.complex_mask = complex_mask
        self.mask_act = MaskNonLinear(
            "none" if complex_mask else non_linear,
            enable="all" if complex_mask else "common")

    def _network(self, feats: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def _network_step(self, chunk: torch.Tensor, state):
        raise NotImplementedError

    def _context_pad(self, feats: torch.Tensor) -> torch.Tensor:
        return feats

    def _mask_post(self, proj: torch.Tensor) -> List[torch.Tensor]:
        """N x T x B*F (x 2) -> B masks N x F x T (complex64 for a complex
        mask: the real part the first F outputs of its branch)."""
        masks = torch.chunk(self.mask_act(proj).transpose(1, 2),
                            self.num_branchs, 1)
        if self.complex_mask:
            return [torch.complex(*torch.chunk(m, 2, 1)) for m in masks]
        return list(masks)

    def _infer(self, mix: torch.Tensor, mode: str):
        stft, _ = self.enh_transform.encode(mix, None)
        feats = self.enh_transform(stft, training=self.training)
        masks = self._mask_post(self._network(self._context_pad(feats)))
        if mode == "time":
            masks = self.enh_transform.decode(
                [tf_masking(stft, m) for m in masks])
        return masks[0] if self.num_branchs == 1 else masks

    def infer_batch(self, mix: torch.Tensor, mode: str = "time"):
        """mix: N x S -> waveforms N x S' (mode "freq": the masks), a list
        of them for several branches: the separate command's batch."""
        return self._infer(mix, mode)

    def forward(self, mix: torch.Tensor):
        """mix: N x S -> masks N x F x T or waveforms N x S', as
        training_mode says (a list of them for several branches)."""
        self.check_args(mix, training=True, valid_dim=[2])
        return self._infer(mix, self.training_mode)

    def infer(self, mix: torch.Tensor, mode: str = "time"):
        """mix: S -> the enhanced signal (mode "freq": the mask) without
        the batch axis; the module should be in eval mode."""
        self.check_args(mix, training=False, valid_dim=[1])
        ret = self._infer(mix[None], mode)
        return ret[0] if self.num_branchs == 1 else [r[0] for r in ret]

    def step(self, chunk: torch.Tensor, state=None):
        """chunk: N x T x F features (with the context the network needs)
        -> (masks N x F x T', B x N x F x T' for several branches, state)."""
        proj, state = self._network_step(chunk, state)
        masks = torch.stack(self._mask_post(proj))
        return (masks[0] if self.num_branchs == 1 else masks), state

    def mask_predict(self, feats: torch.Tensor) -> torch.Tensor:
        """The deployment entry: feats N x W x F -> the first branch's
        mask N x T' x F, or for a complex mask N x T' x F x 2 (real and
        imaginary parts), float32 as the runtime reads it."""
        proj = self._network(feats)
        mask = torch.chunk(self.mask_act(proj), self.num_branchs, -1)[0]
        if self.complex_mask:
            return torch.stack(torch.chunk(mask, 2, -1), -1)
        return mask
