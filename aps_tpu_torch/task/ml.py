#!/usr/bin/env python
"""Unsupervised maximum-likelihood multi-channel enhancement (port of
aps_tpu/task/ml.py: MlEnhTask registered "sse@enh_ml").

Each TF point of the normalized observation is scored under a mixture of
two complex angular Gaussians (speech under the network's mask, noise
under one minus it), whose covariances B_k are the masked spatial
covariances of the MVDR (aps_tpu_torch.asr.filter.mvdr.estimate_covar)
times C, made Hermitian by (B + B^H) / 2. The log-determinant and the
quadratic form x^H B_k^-1 x go through the port's clamped Hermitian
Cholesky on complex64 (aps_tpu_torch.cplx), with every pivot at least
eps, as aps_tpu's real-embedding Cholesky has them."""

import math
from typing import Dict

import torch

from aps_tpu_torch.asr.filter.mvdr import estimate_covar
from aps_tpu_torch.const import EPSILON
from aps_tpu_torch.cplx import logdet_hermitian, solve_hermitian
from aps_tpu_torch.libs import ApsRegisters
from aps_tpu_torch.task.base import Task


@ApsRegisters.task.register("sse@enh_ml")
class MlEnhTask(Task):
    """Maximum-likelihood unsupervised multi-channel enhancement: the loss
    is the negative mean log-likelihood of the observations."""

    def __init__(self, nnet, eps: float = EPSILON,
                 description: str = "unsupervised ML enhancement"):
        super(MlEnhTask, self).__init__(nnet, description=description)
        self.eps = eps

    def log_pdf(self, mask: torch.Tensor, obs: torch.Tensor) -> torch.Tensor:
        """mask: N x F x T, obs: N x C x F x T complex -> N x F x T"""
        C = obs.shape[1]
        Bk = C * estimate_covar(mask, obs, eps=self.eps)
        Bk = (Bk + Bk.mH) / 2 + self.eps * torch.eye(C, dtype=Bk.dtype,
                                                      device=Bk.device)
        logdet = logdet_hermitian(Bk, eps=self.eps)
        # K = sum_c conj(obs) (Bk^-1 obs): real
        obs = obs.transpose(1, 2)  # N x F x C x T
        K = (obs.conj() * solve_hermitian(Bk, obs, eps=self.eps)).real.sum(-2)
        K = torch.clamp_min(K, self.eps)
        return -C * torch.log(K) - logdet[..., None]

    def forward(self, egs: Dict) -> Dict:
        """egs: {mix: N x C x S} (no references)."""
        obs, ms = self.nnet(egs["mix"])
        # masks N x T x F -> N x F x T
        ms = ms.transpose(-1, -2)
        ps = self.log_pdf(ms, obs)
        pn = self.log_pdf(1 - ms, obs)
        log_pdf = torch.logaddexp(ps, pn) + math.log(0.5)
        return {"loss": -log_pdf.mean()}
