#!/usr/bin/env python
"""Unsupervised ML enhancement RNN and the permutation alignment of its
masks (port of aps_tpu/sse/unsuper/rnn.py: norm_observation,
permu_aligner, RNNEnhML registered "sse@rnn_enh_ml").

RNNEnhML gives the magnitude-normalized multi-channel STFT (complex64,
each TF point divided by its norm over the channels) and the speech
masks N x T x F of a BLSTM on the enh transform's features (the
reference channel's log spectrum and the cos-IPD of the channel pairs);
the task "sse@enh_ml" (aps_tpu_torch.task.ml) scores them under a complex
angular Gaussian mixture. norm_observation and permu_aligner are numpy on
the host, as in aps_tpu."""

from typing import Optional

import numpy as np
import torch
from torch import nn

from aps_tpu_torch.asr.base.encoder import PyTorchRNNEncoder
from aps_tpu_torch.const import EPSILON
from aps_tpu_torch.libs import ApsRegisters
from aps_tpu_torch.sse.base import SSEBase

supported_plan = {
    257: [[20, 70, 170], [2, 90, 190], [2, 50, 150], [2, 110, 210],
          [2, 30, 130], [2, 130, 230], [2, 0, 110], [2, 150, 257]],
    513: [[20, 100, 200], [2, 120, 220], [2, 80, 180], [2, 140, 240],
          [2, 60, 160], [2, 160, 260], [2, 40, 140], [2, 180, 280],
          [2, 0, 120], [2, 200, 300], [2, 220, 320], [2, 240, 340],
          [2, 260, 360], [2, 280, 380], [2, 300, 400], [2, 320, 420],
          [2, 340, 440], [2, 360, 460], [2, 380, 480], [2, 400, 513]]
}


def norm_observation(mat: np.ndarray, axis: int = -1,
                     eps: float = EPSILON) -> np.ndarray:
    denorm = np.linalg.norm(mat, axis=axis, keepdims=True)
    return mat / np.maximum(denorm, eps)


def permu_aligner(masks: np.ndarray, transpose: bool = False) -> np.ndarray:
    """Frequency-permutation alignment of clustering-style masks.
    masks: K x T x F (K x F x T with transpose) -> aligned K x T x F."""
    from scipy.optimize import linear_sum_assignment
    if masks.ndim != 3:
        raise RuntimeError("Expect 3D TF-masks, K x T x F or K x F x T")
    if transpose:
        masks = np.transpose(masks, (0, 2, 1))
    K, _, F = masks.shape
    feature = norm_observation(masks, axis=1)
    mapping = np.stack([np.ones(F, dtype=np.int64) * k for k in range(K)])
    if F not in supported_plan:
        raise ValueError(f"Unsupported num_bins: {F}")
    for itr, beg, end in supported_plan[F]:
        for _ in range(itr):
            centroid = np.mean(feature[..., beg:end], axis=-1)
            centroid = norm_observation(centroid, axis=-1)
            go_on = False
            for f in range(beg, end):
                score = centroid @ norm_observation(feature[..., f],
                                                    axis=-1).T
                index, permu = linear_sum_assignment(score, maximize=True)
                if np.sum(permu != index) != 0:
                    feature[..., f] = feature[permu, :, f]
                    mapping[..., f] = mapping[permu, f]
                    go_on = True
            if not go_on:
                break
    permu_masks = np.zeros_like(masks)
    for f in range(F):
        permu_masks[..., f] = masks[mapping[..., f], :, f]
    return permu_masks


@ApsRegisters.sse.register("sse@rnn_enh_ml")
class RNNEnhML(SSEBase):
    """RNN mask estimator trained by maximum likelihood (no references):
    the mask network base_rnn (aps_tpu's PyTorchRNNEncoder, sigmoid
    output). It takes multi-channel input (cmd.separate reads
    multi_channel)."""
    multi_channel = True

    def __init__(self,
                 enh_transform: Optional[nn.Module] = None,
                 input_size: int = 257,
                 num_bins: int = 257,
                 input_proj: int = -1,
                 rnn: str = "lstm",
                 num_layers: int = 3,
                 hidden: int = 512,
                 dropout: float = 0.2,
                 bidirectional: bool = False,
                 training_mode: str = "freq"):
        super(RNNEnhML, self).__init__(enh_transform=enh_transform,
                                       training_mode=training_mode)
        if enh_transform is None:
            raise ValueError("RNNEnhML needs an enh_transform")
        self.base_rnn = PyTorchRNNEncoder(input_size,
                                          num_bins,
                                          rnn=rnn,
                                          input_proj=input_proj,
                                          num_layers=num_layers,
                                          hidden=hidden,
                                          dropout=dropout,
                                          bidirectional=bidirectional,
                                          non_linear="sigmoid")

    @staticmethod
    def _norm_abs(obs: torch.Tensor) -> torch.Tensor:
        """N x C x F x T complex, each TF point divided by its norm over
        the channels (at least EPSILON)."""
        mag_norm = torch.sqrt((obs.real**2 + obs.imag**2).sum(1,
                                                               keepdim=True))
        return obs / torch.clamp_min(mag_norm, EPSILON)

    def forward(self, noisy: torch.Tensor):
        """noisy: N x C x S -> (normalized STFT N x C x F x T complex,
        masks N x T x F)."""
        self.check_args(noisy, training=True, valid_dim=[3])
        cstft, _ = self.enh_transform.encode(noisy, None)
        feats = self.enh_transform(cstft, training=self.training)
        masks, _ = self.base_rnn(feats, None)
        return self._norm_abs(cstft), masks

    def infer(self, noisy: torch.Tensor, mode: str = "freq") -> torch.Tensor:
        """noisy: C x S -> the masks T x F (whatever the mode, as in
        aps_tpu)."""
        self.check_args(noisy, training=False, valid_dim=[2])
        return self.forward(noisy[None])[1][0]
