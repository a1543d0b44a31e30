"""Chamfer distances, the counterpart of ``si_mamba_tpu/ops/chamfer.py``
(pytorch3d's ``chamfer_distance`` semantics, the reference's pretraining
loss): a cloud's term is the mean over its points of the least (squared)
distance to the other cloud; the loss sums both directions, optionally
averaged over the batch."""

from __future__ import annotations

import torch

from si_mamba_tpu_torch.ops.pointops import pairwise_sqdist_exact


def _chamfer(x: torch.Tensor, y: torch.Tensor, squared: bool) -> torch.Tensor:
    d = pairwise_sqdist_exact(x, y)  # (..., N, M)
    if not squared:
        d = torch.sqrt(d)
    return torch.mean(torch.amin(d, dim=-1), dim=-1) + torch.mean(torch.amin(d, dim=-2), dim=-1)


def chamfer_l2(x: torch.Tensor, y: torch.Tensor,
               batch_reduction: str | None = "mean") -> torch.Tensor:
    """Squared-L2 chamfer (config ``loss: cdl2``): x (B, N, 3), y (B, M, 3)
    -> scalar (``batch_reduction='mean'``) or (B,) (None)."""
    per = _chamfer(x, y, squared=True)
    return torch.mean(per) if batch_reduction == "mean" else per


def chamfer_l1(x: torch.Tensor, y: torch.Tensor,
               batch_reduction: str | None = "mean") -> torch.Tensor:
    """Unsquared (L2-norm) chamfer (config ``loss: cdl1``)."""
    per = _chamfer(x, y, squared=False)
    return torch.mean(per) if batch_reduction == "mean" else per
