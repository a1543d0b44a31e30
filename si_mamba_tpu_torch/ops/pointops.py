"""Point-cloud primitives: pairwise distances, FPS, kNN, grouping.

PyTorch counterparts of ``si_mamba_tpu/ops/pointops.py`` with the same
arithmetic, so that indices agree exactly. Indices are int64 (torch's index
type); the JAX package returns int32.
"""

from __future__ import annotations

import torch


def pairwise_sqdist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Squared distances via the matmul expansion, clamped at 0.
    x: (..., N, D), y: (..., M, D) -> (..., N, M)."""
    x2 = torch.sum(x * x, dim=-1)[..., :, None]
    y2 = torch.sum(y * y, dim=-1)[..., None, :]
    xy = torch.einsum("...nd,...md->...nm", x, y)
    return torch.clamp_min(x2 + y2 - 2.0 * xy, 0.0)


def pairwise_sqdist_exact(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Squared distances via explicit differences (the reference's numerics)."""
    diff = x[..., :, None, :] - y[..., None, :, :]
    return torch.sum(diff * diff, dim=-1)


def pairwise_dist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Euclidean distances, difference-form numerics."""
    return torch.sqrt(pairwise_sqdist_exact(x, y))


def fps(points: torch.Tensor, n_samples: int, start_idx=0) -> torch.Tensor:
    """Farthest point sampling: points (B, N, 3) -> int64 indices (B, n_samples).

    Deterministic from ``start_idx`` (an int or a (B,) tensor); ties go to
    the first index, as ``jnp.argmax`` breaks them."""
    B, N, _ = points.shape
    start = torch.as_tensor(start_idx, dtype=torch.long, device=points.device)
    last = start.expand(B).clone()
    idxs = torch.empty((B, n_samples), dtype=torch.long, device=points.device)
    idxs[:, 0] = last
    min_d = torch.full((B, N), float("inf"), dtype=points.dtype, device=points.device)
    batch = torch.arange(B, device=points.device)
    for i in range(1, n_samples):
        last_pt = points[batch, last][:, None, :]  # (B, 1, 3)
        d = torch.sum((points - last_pt) ** 2, dim=-1)
        min_d = torch.minimum(min_d, d)
        last = torch.argmax(min_d, dim=-1)
        idxs[:, i] = last
    return idxs


def knn(query: torch.Tensor, points: torch.Tensor, k: int) -> torch.Tensor:
    """Indices (B, Q, k) of the k nearest ``points`` to each ``query`` point,
    nearest first."""
    d = pairwise_sqdist(query, points)
    return torch.topk(d, k, dim=-1, largest=False, sorted=True).indices


def gather_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points: (B, N, C), idx: (B, M) -> (B, M, C)."""
    return torch.gather(points, 1, idx[..., None].expand(-1, -1, points.shape[-1]))


def group_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points: (B, N, C), idx: (B, G, K) -> (B, G, K, C) neighbourhood gather."""
    B, G, K = idx.shape
    return gather_points(points, idx.reshape(B, G * K)).reshape(B, G, K, points.shape[-1])
