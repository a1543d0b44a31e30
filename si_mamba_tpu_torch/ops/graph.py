"""Batched kNN-graph adjacency and graph Laplacians over patch centres.

PyTorch counterparts of ``si_mamba_tpu/ops/graph.py``.
"""

from __future__ import annotations

import torch

from si_mamba_tpu_torch.ops.pointops import pairwise_dist


def knn_adjacency(points: torch.Tensor, k: int, alpha: float = 1.0,
                  symmetric: bool = False, self_loop: bool = False,
                  binary: bool = False) -> torch.Tensor:
    """Weighted or binary kNN adjacency over (B, N, D) points -> (B, N, N).

    The k+1 nearest by euclidean distance (self included); the nearest
    (self) column is dropped unless ``self_loop``. Weights are
    ``exp(-alpha d^2)``; ``binary`` writes ones. ``symmetric`` adds the
    transposed edges, i.e. ``max(A, A^T)``."""
    d = pairwise_dist(points, points)  # (B, N, N)
    idx = torch.topk(d, k + 1, dim=-1, largest=False, sorted=True).indices
    if not self_loop:
        idx = idx[..., 1:]
    mask = torch.zeros_like(d).scatter_(-1, idx, 1.0)
    A = mask if binary else mask * torch.exp(-alpha * d ** 2)
    if symmetric:
        A = torch.maximum(A, A.transpose(-1, -2))
    return A


def rw_laplacian(A: torch.Tensor, eps: float = 1e-6, eps_mode: str = "add") -> torch.Tensor:
    """Random-walk normalised Laplacian ``I - D^{-1} A`` of the symmetrised
    ``A`` (batched); ``eps_mode`` 'add' divides by ``deg + eps``, 'clamp' by
    ``max(deg, eps)``."""
    A = 0.5 * (A + A.transpose(-1, -2))
    deg = torch.sum(A, dim=-1)
    if eps_mode == "add":
        denom = deg + eps
    elif eps_mode == "clamp":
        denom = torch.clamp_min(deg, eps)
    else:
        raise ValueError(f"unknown eps_mode {eps_mode!r}")
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    return eye - A / denom[..., None]


def sym_laplacian(A: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """Symmetric normalised Laplacian ``I - D^{-1/2} A D^{-1/2}``."""
    A = 0.5 * (A + A.transpose(-1, -2))
    dinv_sqrt = (torch.sum(A, dim=-1) + eps) ** -0.5
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    return eye - dinv_sqrt[..., :, None] * A * dinv_sqrt[..., None, :]
