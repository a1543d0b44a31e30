"""Miscellaneous utilities, the counterparts of ``si_mamba_tpu/utils/misc.py``
(the reference's utils/misc.py): point-cloud cropping for MAE
visualisation, parameter summaries, seeding."""

from __future__ import annotations

import random
from collections.abc import Mapping

import numpy as np
import torch
import torch.nn as nn


def separate_point_cloud(xyz: np.ndarray, num_points: int, crop: int | list,
                         fixed_points=None, padding_zeros: bool = False,
                         rng: np.random.Generator | None = None):
    """Split each cloud into (kept, cropped) parts around a random (or fixed)
    viewpoint direction (reference ``seprate_point_cloud``, utils/misc.py:
    136-189). The JAX package's numpy code: the same ``rng`` gives the same
    crops. Returns (input (B, N - crop, 3), or zero-padded (B, N, 3); crop
    (B, crop, 3)), lists of them when ``crop`` is a [low, high) range."""
    rng = rng or np.random.default_rng()
    B, n, c = xyz.shape
    assert n == num_points and c == 3
    input_list, crop_list = [], []
    for b in range(B):
        num_crop = int(rng.integers(crop[0], crop[1])) if isinstance(crop, list) else crop
        points = xyz[b]
        if fixed_points is None:
            center = rng.standard_normal(3)
            center /= np.linalg.norm(center) + 1e-8
        else:
            fp = fixed_points if not isinstance(fixed_points, list) else \
                fixed_points[int(rng.integers(len(fixed_points)))]
            center = np.asarray(fp, np.float32)
        d = np.linalg.norm(points - center[None, :], axis=-1)
        idx = np.argsort(d)
        if padding_zeros:
            kept = points.copy()
            kept[idx[:num_crop]] = 0.0
        else:
            kept = points[idx[num_crop:]]
        input_list.append(kept)
        crop_list.append(points[idx[:num_crop]])
    if isinstance(crop, list):
        return input_list, crop_list
    return np.stack(input_list), np.stack(crop_list)


def _named_sizes(params) -> list[tuple[str, int]]:
    """(dotted name, element count) of every parameter of a module, or of
    every entry of a state dict (buffers included: a state dict does not
    tell them apart)."""
    items = params.named_parameters() if isinstance(params, nn.Module) else params.items()
    return [(name, int(np.prod(tuple(v.shape)))) for name, v in items]


def count_parameters(params: nn.Module | Mapping) -> int:
    return sum(n for _, n in _named_sizes(params))


def parameter_table(params: nn.Module | Mapping, max_rows: int = 60) -> str:
    """Parameter counts by top-level module (reference summary_parameters,
    utils/misc.py:257-280), largest first, and the total; the JAX package's
    table, its '/'-separated groups being the port's '.'-separated ones."""
    agg: dict[str, int] = {}
    for name, n in _named_sizes(params):
        top = name.split(".")[0]
        agg[top] = agg.get(top, 0) + n
    lines = [f"{'module':<30} {'params':>12}"]
    for k, v in sorted(agg.items(), key=lambda kv: -kv[1])[:max_rows]:
        lines.append(f"{k:<30} {v:>12,}")
    lines.append(f"{'TOTAL':<30} {count_parameters(params):>12,}")
    return "\n".join(lines)


def set_global_seed(seed: int) -> torch.Generator:
    """Seed Python's, numpy's and torch's global generators and return a
    ``torch.Generator`` seeded with ``seed`` (reference set_random_seed,
    utils/misc.py:46-70; the JAX package returns a key)."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)
