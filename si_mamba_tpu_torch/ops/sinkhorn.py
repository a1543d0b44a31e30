"""Differentiable sorting by entropic optimal transport (Sinkhorn) with
hard permutations: the counterpart of ``si_mamba_tpu/ops/sinkhorn.py``'s
``sinkhorn_soft_perm``, ``greedy_round``, ``hungarian_round`` and
``sinkhorn_sort_perm``, the pretraining model's traversal orders.

The soft permutation runs the log-domain iterations; under autograd each
iteration is recomputed in the backward from the (..., N) duals it started
from (``torch.utils.checkpoint``, as the JAX package checkpoints its scan
body), so the backward keeps two (..., N) vectors an iteration, not the
(..., N, N) residuals of every iteration, and its gradient is the plain
reverse mode's. Greedy rounding is a loop of N row argmaxes on the device;
Hungarian rounding is scipy's ``linear_sum_assignment`` on the host (the
published-behaviour preset, ``PointMAEConfig.parity_preset``).
"""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint


def _iteration(f, g, logK, log_r):
    f = log_r - torch.logsumexp(logK + g[..., None, :], dim=-1)
    g = log_r - torch.logsumexp(logK + f[..., :, None], dim=-2)
    return f, g


def sinkhorn_soft_perm(scores: torch.Tensor, epsilon: float = 0.05, n_iters: int = 40,
                       target: str = "sorted") -> torch.Tensor:
    """Soft permutation matrices sorting each score vector: (..., N) ->
    (..., N, N) doubly stochastic, float32.

    target='sorted': cost (sort(s)_i - s_j)^2, true differentiable sorting
    (row i of the hard rounding points at the i-th smallest score).
    target='self': cost against the unsorted vector, the reference's
    pretraining variant, whose optimal plan is the identity."""
    s = scores.float()
    if target == "sorted":
        tgt = torch.sort(s, dim=-1).values
    elif target == "self":
        tgt = s
    else:
        raise ValueError(f"unknown sinkhorn target {target!r}")
    logK = -((tgt[..., :, None] - s[..., None, :]) ** 2) / epsilon
    log_r = -math.log(s.shape[-1])
    f = torch.zeros_like(s)
    g = torch.zeros_like(s)
    keep = torch.is_grad_enabled() and logK.requires_grad
    for _ in range(n_iters):
        if keep:
            f, g = checkpoint(_iteration, f, g, logK, log_r, use_reentrant=False)
        else:
            f, g = _iteration(f, g, logK, log_r)
    return torch.exp(f[..., :, None] + logK + g[..., None, :])


def greedy_round(P: torch.Tensor) -> torch.Tensor:
    """Greedy row-by-row argmax assignment -> hard permutation (0/1), of
    P's dtype: row i takes its largest entry among the columns no earlier row
    took, the first on a tie (as ``jnp.argmax``)."""
    P = P.detach()
    N = P.shape[-1]
    avail = torch.ones(P.shape[:-2] + (N,), dtype=torch.bool, device=P.device)
    cols = []
    for i in range(N):
        row = torch.where(avail, P[..., i, :], torch.full_like(P[..., i, :], -math.inf))
        col = torch.argmax(row, dim=-1)
        avail = avail.scatter(-1, col[..., None], False)
        cols.append(col)
    return torch.nn.functional.one_hot(torch.stack(cols, dim=-1), N).to(P.dtype)


def hungarian_round(P: torch.Tensor) -> torch.Tensor:
    """The optimal assignment of each (N, N) matrix (the largest total), by
    scipy's ``linear_sum_assignment`` on the host."""
    from scipy.optimize import linear_sum_assignment

    p = P.detach().cpu().double().numpy()
    flat = p.reshape(-1, p.shape[-2], p.shape[-1])
    out = torch.zeros(flat.shape, dtype=P.dtype)
    for b in range(flat.shape[0]):
        row, col = linear_sum_assignment(-flat[b])
        out[b, torch.from_numpy(row), torch.from_numpy(col)] = 1.0
    return out.reshape(P.shape).to(P.device)


def sinkhorn_sort_perm(scores: torch.Tensor, epsilon: float = 0.05, n_iters: int = 40,
                       rounding: str = "greedy", target: str = "sorted"
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """(P, P_soft) for each (..., N) score vector: P has the hard
    permutation's value and the soft matrix's gradient (P_hard + P_soft -
    P_soft.detach())."""
    P_hat = sinkhorn_soft_perm(scores, epsilon, n_iters, target=target)
    if rounding == "greedy":
        P_hard = greedy_round(P_hat)
    elif rounding == "hungarian":
        P_hard = hungarian_round(P_hat)
    else:
        raise ValueError(f"unknown rounding {rounding!r}")
    return P_hard + P_hat - P_hat.detach(), P_hat
