"""Batched symmetric eigendecomposition by parallel-ordered cyclic Jacobi,
as batched ``bmm``s on the device: the counterpart of
``si_mamba_tpu/ops/jacobi.py`` (the pretraining presets'
``wavelet_solver: jacobi``).

A round-robin tournament gives n - 1 rounds of n/2 disjoint index pairs
covering every pair once; each round builds the block-rotation matrix J that
zeroes its pairs' off-diagonal entries and applies ``A <- J^T A J``,
``V <- V J``. The sweep counts are the JAX package's: 10 for n <= 64, 14 for
n <= 128, and larger n is refused.
"""

from __future__ import annotations

import functools

import torch


@functools.lru_cache(maxsize=None)
def _round_robin_schedule(n: int) -> list[tuple[tuple[int, ...], tuple[int, ...]]]:
    """Tournament pairing: n - 1 rounds of n/2 disjoint pairs (i < j)
    covering all n(n-1)/2 index pairs (n even)."""
    players = list(range(n))
    rounds = []
    for _ in range(n - 1):
        half = n // 2
        pi = tuple(min(players[k], players[n - 1 - k]) for k in range(half))
        pj = tuple(max(players[k], players[n - 1 - k]) for k in range(half))
        rounds.append((pi, pj))
        players = [players[0], players[-1]] + players[1:-1]
    return rounds


def _schedule_indices(n: int, device) -> list[tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """Each round's (pi, pj, J's entry rows | columns) as index tensors."""
    out = []
    for pi, pj in _round_robin_schedule(n):
        a, b = torch.tensor(pi, device=device), torch.tensor(pj, device=device)
        out.append((a, b, torch.cat([a, b, a, b]), torch.cat([a, b, b, a])))
    return out


def jacobi_eigh(A: torch.Tensor, sweeps: int | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Eigendecomposition of symmetric batched ``A`` (B, n, n), fp32:
    (eigenvalues ascending (B, n), eigenvectors in columns (B, n, n)), the
    convention of ``torch.linalg.eigh``; an eigenvector's sign (and the basis
    within a degenerate cluster) is the solver's. Odd n is padded with an
    isolated diagonal entry above the spectrum and sliced back out."""
    A = A.float()
    B, n, _ = A.shape
    if sweeps is None:
        if n > 128:
            raise ValueError(
                f"jacobi_eigh default sweep count is only validated to n=128 (got n={n}); "
                f"pass sweeps= explicitly or use the exact 'eigh' solver")
        sweeps = 10 if n <= 64 else 14
    n0 = n
    if n % 2:
        pad = torch.zeros((B, n + 1, n + 1), dtype=A.dtype, device=A.device)
        pad[:, :n, :n] = A
        pad[:, n, n] = A.abs().sum(dim=(-1, -2)).max() + 4.0
        A, n = pad, n + 1
    V = torch.eye(n, dtype=A.dtype, device=A.device).expand(B, n, n).contiguous()
    J = torch.zeros_like(A)
    rounds = _schedule_indices(n, A.device)
    for _ in range(sweeps):
        for pi, pj, rows, cols in rounds:
            aii, ajj, aij = A[:, pi, pi], A[:, pj, pj], A[:, pi, pj]
            # the angle that zeroes a_ij: tan(2 theta) = 2 a_ij / (a_ii - a_jj)
            theta = 0.5 * torch.atan2(2.0 * aij, aii - ajj)
            c, s = torch.cos(theta), torch.sin(theta)
            J.zero_()
            J[:, rows, cols] = torch.cat([c, c, -s, s], dim=-1)
            A = torch.bmm(J.transpose(-1, -2), torch.bmm(A, J))
            V = torch.bmm(V, J)
        A = 0.5 * (A + A.transpose(-1, -2))  # against the products' rounding drift
    vals = torch.diagonal(A, dim1=-2, dim2=-1)
    order = torch.argsort(vals, dim=-1, stable=True)
    vals = torch.gather(vals, -1, order)
    V = torch.gather(V, -1, order[:, None, :].expand(B, n, n))
    if n0 != n:
        vals, V = vals[:, :n0], V[:, :n0, :n0]
    return vals, V
