"""Earth mover's distance by entropic optimal transport (Sinkhorn), the
pretraining model's optional ``loss: emd``: the counterpart of
``si_mamba_tpu/ops/emd.py``. The reference declares this loss but never runs
it (its CUDA emd extension is absent and the branch raises)."""

from __future__ import annotations

import math

import torch

from si_mamba_tpu_torch.ops.pointops import pairwise_sqdist_exact


def emd_sinkhorn(x: torch.Tensor, y: torch.Tensor, epsilon: float = 0.01, n_iters: int = 50,
                 batch_reduction: str | None = "mean") -> torch.Tensor:
    """Approximate EMD between (B, N, 3) and (B, M, 3) clouds: log-domain
    Sinkhorn with uniform marginals on the squared distances C, then <P, C>
    per cloud (B,), or its batch mean."""
    C = pairwise_sqdist_exact(x.float(), y.float())
    B, N, M = C.shape
    logK = -C / epsilon
    log_r, log_c = -math.log(N), -math.log(M)
    f = torch.zeros((B, N), dtype=torch.float32, device=C.device)
    g = torch.zeros((B, M), dtype=torch.float32, device=C.device)
    for _ in range(n_iters):
        f = log_r - torch.logsumexp(logK + g[:, None, :], dim=-1)
        g = log_c - torch.logsumexp(logK + f[:, :, None], dim=-2)
    P = torch.exp(f[:, :, None] + logK + g[:, None, :])
    per = torch.sum(P * C, dim=(-2, -1))
    return torch.mean(per) if batch_reduction == "mean" else per
