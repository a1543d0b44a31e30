"""Batched point-cloud augmentations.

PyTorch counterparts of ``si_mamba_tpu/data/transforms.py`` (the reference's
per-sample GPU transforms, datasets/data_transforms.py, vectorised over the
batch). Every random draw takes an explicit ``torch.Generator`` on the
points' device; the draws differ from JAX's, the distributions are the same.
"""

from __future__ import annotations

import math

import torch

from si_mamba_tpu_torch.ops.pointops import fps, gather_points


def _uniform(shape, low: float, high: float, generator: torch.Generator,
             like: torch.Tensor) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=like.device, dtype=like.dtype)
    return low + (high - low) * u


def rotate_y(pts: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Per-sample random rotation about the y (up) axis."""
    B = pts.shape[0]
    ang = _uniform((B,), 0.0, 2 * math.pi, generator, pts)
    c, s = torch.cos(ang), torch.sin(ang)
    zeros, ones = torch.zeros_like(c), torch.ones_like(c)
    R = torch.stack([c, zeros, s, zeros, ones, zeros, -s, zeros, c], dim=-1).reshape(B, 3, 3)
    return torch.einsum("bnd,bde->bne", pts, R)


def scale_and_translate(pts: torch.Tensor, generator: torch.Generator | None,
                        scale_low: float = 2.0 / 3.0, scale_high: float = 3.0 / 2.0,
                        translate_range: float = 0.2,
                        uniforms: tuple[torch.Tensor, torch.Tensor] | None = None
                        ) -> torch.Tensor:
    """Per-sample anisotropic scale + translation. ``uniforms``: the (B, 1, 3)
    U(0, 1) draws of the scale and of the shift in place of the generator's
    (for tests that replay another framework's)."""
    B = pts.shape[0]
    if uniforms is None:
        s = _uniform((B, 1, 3), scale_low, scale_high, generator, pts)
        shift = _uniform((B, 1, 3), -translate_range, translate_range, generator, pts)
    else:
        s = scale_low + (scale_high - scale_low) * uniforms[0]
        shift = -translate_range + 2 * translate_range * uniforms[1]
    return pts * s + shift


def jitter(pts: torch.Tensor, generator: torch.Generator, std: float = 0.01,
           clip: float = 0.05) -> torch.Tensor:
    noise = torch.randn(pts.shape, generator=generator, device=pts.device, dtype=pts.dtype)
    return pts + torch.clamp(std * noise, -clip, clip)


def translate(pts: torch.Tensor, generator: torch.Generator,
              translate_range: float = 0.2) -> torch.Tensor:
    return pts + _uniform((pts.shape[0], 1, 3), -translate_range, translate_range,
                          generator, pts)


def scale(pts: torch.Tensor, generator: torch.Generator, scale_low: float = 2.0 / 3.0,
          scale_high: float = 3.0 / 2.0) -> torch.Tensor:
    return pts * _uniform((pts.shape[0], 1, 3), scale_low, scale_high, generator, pts)


def random_input_dropout(pts: torch.Tensor, generator: torch.Generator,
                         max_dropout_ratio: float = 0.875) -> torch.Tensor:
    """Replace a random fraction of each cloud's points with its first point
    (the reference's PointcloudRandomInputDropout, static shape)."""
    B, N, _ = pts.shape
    ratio = _uniform((B, 1), 0.0, max_dropout_ratio, generator, pts)
    drop = _uniform((B, N), 0.0, 1.0, generator, pts) <= ratio
    return torch.where(drop[..., None], pts[:, :1, :], pts)


def fps_resample(pts: torch.Tensor, generator: torch.Generator, npoints: int,
                 point_all: int | None = None) -> torch.Tensor:
    """The reference's train-time resample (tools/runner_finetune.py:177-194):
    FPS to ``point_all`` points (its 1200/2400/4800/8192 table), then a random
    subset of ``npoints`` of them, drawn per cloud as the head of a random
    permutation. The FPS is a host loop of ``point_all`` steps."""
    B, N, _ = pts.shape
    n_over = point_all if point_all is not None else int(npoints * 1.2)
    if N > n_over:
        pts = gather_points(pts, fps(pts, n_over))
    else:
        n_over = N
    keys = torch.rand((B, n_over), generator=generator, device=pts.device)
    sel = torch.argsort(keys, dim=1)[:, :npoints]
    return gather_points(pts, sel)
