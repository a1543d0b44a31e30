"""Point-cloud primitives: pairwise distances, FPS, kNN, grouping, and the
PointNet++ ball query and set abstractions.

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


def ball_query(query: torch.Tensor, points: torch.Tensor, radius: float,
               max_samples: int) -> torch.Tensor:
    """Indices (B, S, max_samples) of up to ``max_samples`` of ``points``
    (B, N, D) within ``radius`` of each ``query`` (B, S, D), nearest first,
    ties to the lower index; the slots left over repeat the nearest (the
    reference's ``query_ball_point``)."""
    d = pairwise_sqdist(query, points)
    d = torch.where(d <= radius ** 2, d, torch.full_like(d, float("inf")))
    dists, idx = torch.sort(d, dim=-1, stable=True)
    dists, idx = dists[..., :max_samples], idx[..., :max_samples]
    return torch.where(torch.isfinite(dists), idx, idx[..., :1])


def set_abstraction(points: torch.Tensor, features: torch.Tensor | None, n_centroids: int,
                    radius: float, max_samples: int, mlp_apply):
    """PointNet++ single-scale set abstraction: FPS centroids, a ball query
    around each, the group's points relative to its centroid (then its
    features), ``mlp_apply`` (B, S, K, 3 + C) -> (B, S, K, C'), max over the
    group. Returns (new_xyz (B, S, 3), new_features (B, S, C'))."""
    new_xyz = gather_points(points, fps(points, n_centroids))
    idx = ball_query(new_xyz, points, radius, max_samples)
    grouped = group_points(points, idx) - new_xyz[:, :, None, :]
    if features is not None:
        grouped = torch.cat([grouped, group_points(features, idx)], dim=-1)
    return new_xyz, torch.amax(mlp_apply(grouped), dim=2)


def set_abstraction_msg(points: torch.Tensor, features: torch.Tensor | None, n_centroids: int,
                        radius_list, max_samples_list, mlp_applies):
    """Multi-scale set abstraction: one FPS centroid set; at each scale a
    ball query of its radius and size, the group's features then its points
    relative to the centroid, that scale's MLP, max over the group; the
    scales' features concatenated. Returns (new_xyz (B, S, 3), (B, S, sum of
    the C'_i))."""
    if not len(radius_list) == len(max_samples_list) == len(mlp_applies):
        raise ValueError("one radius, one group size and one MLP a scale")
    new_xyz = gather_points(points, fps(points, n_centroids))
    outs = []
    for radius, k, mlp_apply in zip(radius_list, max_samples_list, mlp_applies):
        idx = ball_query(new_xyz, points, radius, k)
        grouped = group_points(points, idx) - new_xyz[:, :, None, :]
        if features is not None:
            grouped = torch.cat([group_points(features, idx), grouped], dim=-1)
        outs.append(torch.amax(mlp_apply(grouped), dim=2))
    return new_xyz, torch.cat(outs, dim=-1)
