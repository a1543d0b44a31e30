"""FPS + kNN patch grouping (the reference's ``Group``)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from si_mamba_tpu_torch.ops.pointops import fps, gather_points, group_points, knn


class Grouped(NamedTuple):
    neighborhood: torch.Tensor  # (B, G, M, 3) centre-normalised
    center: torch.Tensor  # (B, G, 3)
    neighborhood_org: torch.Tensor  # (B, G, M, 3) absolute coordinates


def group_divider(pts: torch.Tensor, num_group: int, group_size: int,
                  start_idx=0) -> Grouped:
    """pts: (B, N, 3) -> FPS centres + kNN neighbourhoods."""
    center = gather_points(pts, fps(pts, num_group, start_idx=start_idx))
    idx = knn(center, pts, group_size)
    neighborhood_org = group_points(pts, idx)
    return Grouped(neighborhood_org - center[:, :, None, :], center, neighborhood_org)
