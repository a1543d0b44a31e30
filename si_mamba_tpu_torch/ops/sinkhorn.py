"""Differentiable sorting by entropic optimal transport (Sinkhorn) with
hard permutations: the counterpart of ``si_mamba_tpu/ops/sinkhorn.py``'s
``sinkhorn_soft_perm``, ``greedy_round``, ``hungarian_round`` and
``sinkhorn_sort_perm`` (the pretraining model's traversal orders),
``sinkhorn_perm_ift`` (a soft permutation with the implicit-function
backward), ``neural_sort_perm`` and ``plackett_luce_log_prob`` (the
classifier's permutation policy, ``models/permute_policy.py``).

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


def _sinkhorn_uv(C: torch.Tensor, tau: float, n_iters: int):
    """The kernel-domain iterations u = 1/(K v), v = 1/(K^T u) on K =
    exp(-C/tau), all-ones marginals, from u = v = 1/N: (K, u, v)."""
    K = torch.exp(-C.float() / tau)
    u = torch.full(C.shape[:-1], 1.0 / C.shape[-1], dtype=torch.float32, device=C.device)
    v = u
    for _ in range(n_iters):
        u = 1.0 / torch.einsum("...ij,...j->...i", K, v)
        v = 1.0 / torch.einsum("...ji,...j->...i", K, u)
    return K, u, v


class _SinkhornIFT(torch.autograd.Function):
    """P = diag(u) K diag(v) forward; the backward solves the adjoint of the
    fixed-point conditions F = (u (K v) - 1, v (K^T u) - 1) instead of
    unrolling the iterations."""

    @staticmethod
    def forward(ctx, C, tau, n_iters):
        K, u, v = _sinkhorn_uv(C, tau, n_iters)
        ctx.tau = tau
        ctx.save_for_backward(K, u, v)
        return u[..., :, None] * K * v[..., None, :]

    @staticmethod
    def backward(ctx, gradP):
        K, u, v = ctx.saved_tensors
        tau = ctx.tau
        gradP = gradP.float()
        a = torch.einsum("...ij,...j->...i", K, v)  # K v
        b = torch.einsum("...ji,...j->...i", K, u)  # K^T u
        g_u = torch.sum(gradP * K * v[..., None, :], dim=-1)
        g_v = torch.sum(gradP * K * u[..., :, None], dim=-2)
        # F_x^T = [[diag(K v), K diag(v)], [K^T diag(u), diag(K^T u)]]
        F_T = torch.cat([torch.cat([torch.diag_embed(a), K * v[..., None, :]], dim=-1),
                         torch.cat([K.transpose(-1, -2) * u[..., None, :], torch.diag_embed(b)],
                                   dim=-1)], dim=-2)
        # the pseudo-inverse at rtol 1e-6 projects out the gauge direction
        # (u, v) -> (c u, v / c), an exact null space of F_x
        lam = torch.einsum("...ij,...j->...i", torch.linalg.pinv(F_T, rtol=1e-6),
                           torch.cat([g_u, g_v], dim=-1))
        N = K.shape[-1]
        P = u[..., :, None] * K * v[..., None, :]
        gradC = (P * (lam[..., :N, None] + lam[..., None, N:]) - gradP * P) / tau
        return gradC, None, None


def sinkhorn_perm_ift(C: torch.Tensor, tau: float = 1.0, n_iters: int = 20) -> torch.Tensor:
    """A soft permutation (..., N, N) from the cost C (..., N, N): the
    kernel-domain Sinkhorn iterations on K = exp(-C/tau), P = diag(u) K
    diag(v), fp32. Its gradient comes from the implicit-function theorem (the
    reference's new_layers.py:31-91), memory independent of ``n_iters``, with
    the JAX package's three corrections of the reference: the adjoint
    system is F_x^T, the direct term -gP P / tau is kept, and the singular
    system is solved by a pseudo-inverse (rtol 1e-6)."""
    return _SinkhornIFT.apply(C, tau, n_iters)


def neural_sort_perm(scores: torch.Tensor, tau: float = 1.0) -> torch.Tensor:
    """The NeuralSort relaxation (reference ``neural_sort``) with
    straight-through greedy rounding: (..., N) -> (..., N, N), row i the
    (i+1)-th largest score, the value of the hard permutation and the
    gradient of the soft one."""
    s = scores.float()
    n = s.shape[-1]
    Asum = torch.sum(torch.abs(s[..., :, None] - s[..., None, :]), dim=-1)
    c = n + 1 - 2 * torch.arange(1, n + 1, dtype=s.dtype, device=s.device)
    P_hat = torch.softmax((c[:, None] * s[..., None, :] - Asum[..., None, :]) / tau, dim=-1)
    return greedy_round(P_hat) + P_hat - P_hat.detach()


def plackett_luce_log_prob(logits: torch.Tensor) -> torch.Tensor:
    """log P of the identity ordering under Plackett-Luce (reference
    ``plackett_luce_dist``): sum_i (l_i - logsumexp(l_i, ..., l_N)) over the
    last axis."""
    lse = torch.logcumsumexp(logits.flip(-1), dim=-1).flip(-1)
    return torch.sum(logits - lse, dim=-1)
