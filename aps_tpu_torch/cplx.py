#!/usr/bin/env python
"""Hermitian linear algebra on complex64 tensors for the multi-channel
front ends and the unsupervised ML task (the port's counterpart of what
aps_tpu/cplx.py and aps_tpu/ops/cplx_pair.py give them).

aps_tpu works on real (real, imag) pairs and factorizes the real 2C x 2C
embedding of a Hermitian matrix, because its TPU runtime has neither
complex64 nor a Cholesky primitive; the port factorizes the complex C x C
matrix itself. What it keeps from aps_tpu is the clamped pivot: every
pivot is raised to at least `eps` before its square root, so that the
factorization never fails, also on a matrix that is singular or, in
float32, not quite positive definite (an all-zero mask over a bin,
channels that are delayed copies of one another). torch.linalg.cholesky
raises there, or reports info > 0, so it is not used; the loop over the C
columns (C is the number of microphones, at most 8) is unrolled as in
aps_tpu. The triangular solves are torch.linalg.solve_triangular."""

import torch


def trace(mat: torch.Tensor) -> torch.Tensor:
    """... x C x C -> ... (the sum of the diagonal)."""
    return torch.diagonal(mat, dim1=-2, dim2=-1).sum(-1)


def cholesky_clamped(mat: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """Lower Cholesky factor L of Hermitian ... x C x C matrices (L L^H =
    mat), each pivot clamped at eps before its square root."""
    C = mat.shape[-1]
    below = torch.arange(C, device=mat.device)
    cols = []
    for j in range(C):
        # v = mat[:, j] - sum_{k<j} conj(L[j, k]) L[:, k]
        v = mat[..., :, j]
        for k in range(j):
            v = v - cols[k][..., j:j + 1].conj() * cols[k]
        d = torch.sqrt(torch.clamp_min(v[..., j].real, eps))
        col = v / d[..., None]
        cols.append(torch.where(below >= j, col, torch.zeros_like(col)))
    return torch.stack(cols, -1)


def solve_hermitian(mat: torch.Tensor, rhs: torch.Tensor,
                    eps: float = 1e-10) -> torch.Tensor:
    """X with mat X = rhs for Hermitian (semi)definite mat ... x C x C and
    rhs ... x C x M, through the clamped Cholesky factor."""
    L = cholesky_clamped(mat, eps=eps)
    Y = torch.linalg.solve_triangular(L, rhs, upper=False)
    return torch.linalg.solve_triangular(L.mH, Y, upper=True)


def logdet_hermitian(mat: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """log det of Hermitian (semi)definite ... x C x C -> ... real, from
    the clamped Cholesky factor: 2 sum log max(diag L, eps)."""
    L = cholesky_clamped(mat, eps=eps)
    diag = torch.diagonal(L, dim1=-2, dim2=-1).real
    return 2 * torch.log(torch.clamp_min(diag, eps)).sum(-1)
