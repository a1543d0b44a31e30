"""Batched spectral ops: lower-triangle eigh, top-k eigenpairs, SAST orders.

PyTorch counterparts of ``si_mamba_tpu/ops/spectral.py``. The random-walk
Laplacian is not symmetric; like the reference, the eigensolver sees the
matrix reflected from its lower triangle (not ``(M + M^T) / 2``).
"""

from __future__ import annotations

import torch


def tril_symmetrize(M: torch.Tensor) -> torch.Tensor:
    """The symmetric matrix that ``eigh(UPLO='L')`` reads from ``M``."""
    return torch.tril(M) + torch.tril(M, -1).transpose(-1, -2)


def eigh_tril(M: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(eigenvalues ascending (..., N), eigenvectors in columns (..., N, N))."""
    return torch.linalg.eigh(tril_symmetrize(M))


def topk_eigh(L: torch.Tensor, k: int, smallest: bool = True):
    """k smallest eigenpairs ascending (or k largest descending) of (B, N, N)
    ``L``. Returns (vals (B, k), vecs (B, N, k), all_vals, all_vecs)."""
    vals, vecs = eigh_tril(L)
    if smallest:
        return vals[..., :k], vecs[..., :, :k], vals, vecs
    return vals.flip(-1)[..., :k], vecs.flip(-1)[..., :, :k], vals, vecs


def canonicalize_eigenvector_signs(vecs: torch.Tensor) -> torch.Tensor:
    """Make each eigenvector's entry of largest magnitude positive.
    (..., N, k) -> same shape."""
    amax = torch.argmax(vecs.abs(), dim=-2, keepdim=True)  # (..., 1, k)
    picked = torch.gather(vecs, -2, amax)
    return vecs * torch.where(picked >= 0, 1.0, -1.0).to(vecs.dtype)


def sort_orders_by_eigenvectors(eigvecs: torch.Tensor) -> torch.Tensor:
    """Stable ascending argsort of each eigenvector: (B, N, k) -> (B, k, N)."""
    return torch.argsort(eigvecs.transpose(-1, -2), dim=-1, stable=True)
