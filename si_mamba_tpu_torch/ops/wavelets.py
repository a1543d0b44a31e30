"""Diffusion wavelets for the pretraining model's traversal orders: the
counterpart of ``_expm_neg_psd``, ``_topk_colspace``,
``diffusion_wavelet_bases``, ``DiffusionWaveletSGWT`` and ``scale_scores`` in
``si_mamba_tpu/ops/wavelets.py`` (the reference's DiffusionWavelets and
DiffusionWaveletSGWT, models/point_mamba.py:1826-2087).

No parameter lies upstream of the bases (they come from the centres' kNN
graph), so they are computed without a gradient. ``DiffusionWaveletSGWT``
keeps the reference's module names, ``pos_embed.{0,2}`` and
``mixer.{0,1,3,4,6}``. At a bf16 activation dtype it rounds where the JAX
module does: its input and the projections are rounded to bf16, every layer
computes in fp32 (flax ``Dense`` and ``LayerNorm`` without a dtype promote
to their fp32 parameters), and the scores come back fp32.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from si_mamba_tpu_torch.ops.jacobi import jacobi_eigh
from si_mamba_tpu_torch.parallel import draws
from si_mamba_tpu_torch.parallel.collectives import psum
from si_mamba_tpu_torch.parallel.mesh import batch_axis

SOLVERS = ("eigh", "jacobi", "subspace")


def _expm_neg_psd(A: torch.Tensor, scale: float, terms: int = 8,
                  squarings: int = 4) -> torch.Tensor:
    """``expm(-scale A)`` for batched PSD ``A`` with spectrum in [0, 2]:
    Taylor in Horner form of X = -scale A / 2^squarings, then squarings,
    every step a batched matmul."""
    N = A.shape[-1]
    I = torch.eye(N, dtype=A.dtype, device=A.device)
    X = (-scale / (1 << squarings)) * A
    T = I + X / terms
    for k in range(terms - 1, 0, -1):
        T = I + (X / k) @ T
    for _ in range(squarings):
        T = T @ T
    return T


def _topk_colspace(M: torch.Tensor, k: int, iters: int = 12, qr_every: int = 4) -> torch.Tensor:
    """An orthonormal basis (B, N, k) of the dominant-k column space of
    (B, N, r) ``M``, by subspace iteration on its Gram matrix."""
    C = M.transpose(-1, -2) @ M
    Q = torch.linalg.qr(C[..., :, :k]).Q
    for i in range(iters):
        Q = C @ Q
        if (i + 1) % qr_every == 0 or i == iters - 1:
            Q = torch.linalg.qr(Q).Q
    return torch.linalg.qr(M @ Q).Q


@torch.no_grad()
def scaling_bases(L: torch.Tensor, J: int, solver: str = "eigh") -> list[torch.Tensor]:
    """The scaling bases [V_0 = I, V_1, ..., V_J] of batched Laplacians L
    (B, N, N), V_j (B, N, r_j) with r_j = ceil(N / 2^j): T_j = expm(-log 2 / 2
    * 2^(j-1) L), and V_j the top-r_j left singular directions of T_j V_(j-1)
    from its Gram matrix's top eigenpairs ('eigh': ``torch.linalg.eigh``,
    'jacobi': :func:`jacobi_eigh`, both scaled by the singular values; the
    Taylor expm for 'jacobi') or by subspace iteration ('subspace')."""
    if solver not in SOLVERS:
        raise ValueError(f"wavelet solver {solver!r} not in {SOLVERS}")
    B, N, _ = L.shape
    t0 = math.log(2.0) / 2.0  # lam_max = 2
    V_prev = torch.eye(N, dtype=L.dtype, device=L.device).expand(B, N, N)
    V_bases = [V_prev]
    for j in range(1, J + 1):
        k = max(1, -(-N // (1 << j)))
        scale = t0 * (2.0 ** (j - 1))
        T = _expm_neg_psd(L, scale) if solver != "eigh" else torch.linalg.matrix_exp(-scale * L)
        M = T @ V_prev
        if solver == "subspace":
            Vj = _topk_colspace(M, k)
        else:
            C = (M.transpose(-1, -2) @ M).float()
            evals, V = jacobi_eigh(C) if solver == "jacobi" else torch.linalg.eigh(C)
            V_k = V[..., -k:].flip(-1)
            sigma = torch.sqrt(torch.clamp_min(evals[..., -k:], 1e-12)).flip(-1)
            Vj = (M @ V_k.to(L.dtype)) / sigma[:, None, :].to(L.dtype)
        V_bases.append(Vj)
        V_prev = Vj
    return V_bases


def wavelet_complements(V_bases: list[torch.Tensor]) -> list[torch.Tensor]:
    """Each V_j's part outside span(V_(j+1)), V_j - V_(j+1) V_(j+1)^T V_j
    (before the QR that makes it a basis)."""
    return [Vj - Vjp1 @ (Vjp1.transpose(-1, -2) @ Vj)
            for Vj, Vjp1 in zip(V_bases[:-1], V_bases[1:])]


@torch.no_grad()
def diffusion_wavelet_bases(L: torch.Tensor, J: int, solver: str = "eigh"
                            ) -> tuple[list[torch.Tensor], torch.Tensor]:
    """Orthonormal diffusion-wavelet bases of batched Laplacians L (B, N, N):
    (W list of (B, N, r_j) for j = 0..J-1, V_J (B, N, r_J)): the scaling
    bases of :func:`scaling_bases` and, as wavelets, the Q of each V_j's
    complement to V_(j+1)."""
    V_bases = scaling_bases(L, J, solver)
    W = [torch.linalg.qr(w).Q.to(L.dtype) for w in wavelet_complements(V_bases)]
    return W, V_bases[-1]


def wavelet_projections(L: torch.Tensor, J: int, solver: str = "eigh") -> torch.Tensor:
    """The J + 1 projections (B, J+1, N, N): V_J V_J^T, then W_j W_j^T."""
    W, VJ = diffusion_wavelet_bases(L.float(), J, solver)
    return torch.stack([VJ @ VJ.transpose(-1, -2)] + [w @ w.transpose(-1, -2) for w in W],
                       dim=1)


def _lecun_normal_(w: torch.Tensor, generator: torch.Generator) -> None:
    """flax's default Dense init: normal of variance 1 / fan_in truncated at
    +-2 standard deviations of the untruncated normal (std corrected)."""
    std = 1.0 / math.sqrt(w.shape[1]) / 0.87962566103423978
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=generator)


class DiffusionWaveletSGWT(nn.Module):
    """Learned diffusion-wavelet transform: (x (B, N, F), the J + 1
    projections of :func:`wavelet_projections` (B, J+1, N, N)) -> per-scale
    node scores (B, N, 1, J+1). In training (``deterministic`` False, ``tau``
    given) the scores take tau-scaled Gumbel noise, its uniforms from
    ``generator`` or given as ``gumbel_uniform``. The JAX module takes L and
    computes the projections itself; here the caller does, so that the bases
    can be timed apart.

    The scores are scaled by the RMS of the coefficients over the batch and
    the nodes; in training under data parallelism (``data_axis`` of more
    than one rank, as the BatchNorms take it) over the global batch, as the
    JAX step over a data mesh takes it."""

    data_axis = None

    def __init__(self, J: int = 3, in_features: int = 3, hidden: int = 64,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.J, self.hidden, self.dtype = J, hidden, dtype
        self.pos_embed = nn.Sequential(nn.Linear(in_features, hidden), nn.GELU(),
                                       nn.Linear(hidden, hidden))
        width = hidden * (J + 1)
        self.mixer = nn.Sequential(
            nn.Linear(width, 2 * hidden), nn.LayerNorm(2 * hidden, eps=1e-6), nn.GELU(),
            nn.Linear(2 * hidden, hidden), nn.LayerNorm(hidden, eps=1e-6), nn.GELU(),
            nn.Linear(hidden, width))

    def reset_parameters(self, generator: torch.Generator) -> None:
        for m in self.pos_embed:
            if isinstance(m, nn.Linear):
                _lecun_normal_(m.weight.data, generator)
                m.bias.data.zero_()
        for m in self.mixer:
            if isinstance(m, nn.Linear):
                flat = torch.empty(m.weight.shape, device=m.weight.device)
                m.weight.data.copy_(_orthogonal(flat.normal_(generator=generator)))
                m.bias.data.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.reset_parameters()

    def forward(self, x: torch.Tensor, PJ: torch.Tensor, tau: float | None = 0.5,
                deterministic: bool = True, generator: torch.Generator | None = None,
                gumbel_uniform: torch.Tensor | None = None) -> torch.Tensor:
        B, N, _ = x.shape
        h = self.pos_embed(x.to(self.dtype).float())
        coeffs = torch.einsum("bjnm,bmf->bnfj", PJ.to(self.dtype).float(), h)
        eps = torch.finfo(coeffs.dtype).eps
        axis = batch_axis(self) if self.training else None
        if axis is None:
            rms = torch.sqrt(torch.mean(coeffs ** 2, dim=(0, 1), keepdim=True) + eps)
        else:
            total = psum(torch.sum(coeffs ** 2, dim=(0, 1), keepdim=True), axis)
            rows = psum(coeffs.new_full((), coeffs.shape[0] * coeffs.shape[1]), axis)
            rms = torch.sqrt(total / rows + eps)
        coeffs = coeffs / torch.clamp_min(rms, 1e-2)
        m = self.mixer(coeffs.reshape(B, N, self.hidden * (self.J + 1)))
        coeffs = coeffs + m.reshape(coeffs.shape)
        coeffs = torch.sqrt(torch.sum(coeffs ** 2, dim=2, keepdim=True)) / coeffs.shape[2]
        if not deterministic and tau is not None:
            u = gumbel_uniform
            if u is None:
                if generator is None:
                    raise ValueError("the Gumbel noise in training needs a torch.Generator")
                u = draws.rand(coeffs.shape, generator, device=coeffs.device)
            coeffs = coeffs + tau * -torch.log(-torch.log(u + eps) + eps)
        return coeffs


def _orthogonal(flat: torch.Tensor) -> torch.Tensor:
    """A (rows, cols) matrix with orthonormal rows or columns from a normal
    draw (flax's ``orthogonal`` initialiser: QR with the signs of R's
    diagonal)."""
    rows, cols = flat.shape
    a = flat if rows >= cols else flat.T
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))
    return q if rows >= cols else q.T


def scale_scores(coeffs: torch.Tensor, k: int | None = None,
                 strategy: str = "coarsest_k") -> torch.Tensor:
    """k per-scale score vectors from (B, N, F, S) coeffs -> (B, N, k):
    the mean over F, then the k coarsest scales, coarsest first
    ('coarsest_k'), the k finest ('finest_k') or the k of most energy
    ('top_energy')."""
    S = coeffs.shape[-1]
    k = S if k is None else k
    score = torch.mean(coeffs, dim=2)
    if strategy == "coarsest_k":
        ids = list(range(S - 1, S - 1 - k, -1))
    elif strategy == "finest_k":
        ids = list(range(k))
    elif strategy == "top_energy":
        energy = torch.sum(score ** 2, dim=1).mean(0)
        return score[..., torch.argsort(-energy)[:k]]
    else:
        raise ValueError(strategy)
    return score[..., ids]
