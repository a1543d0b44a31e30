"""Graph wavelets for the pretraining model's traversal orders: the
counterpart of ``_expm_neg_psd``, ``_topk_colspace``,
``diffusion_wavelet_bases``, ``DiffusionWaveletSGWT`` and ``scale_scores`` in
``si_mamba_tpu/ops/wavelets.py`` (the reference's DiffusionWavelets and
DiffusionWaveletSGWT, models/point_mamba.py:1826-2087), and of its standalone
transforms, which no model calls (the reference's pretraining ablations):
``chebyshev_sgwt`` (the Meyer tight-frame Chebyshev SGWT), ``complex_meyer_sgwt``
and ``graph_scattering``.

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
from si_mamba_tpu_torch.ops.spectral import tril_symmetrize
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


# ---------------------------------------------------------------------------
# the standalone transforms: Chebyshev SGWT, complex Meyer SGWT, scattering
# ---------------------------------------------------------------------------

def _meyer_window(lam: torch.Tensor, lam1: float = 0.5, lam2: float = 1.0) -> torch.Tensor:
    t = torch.clamp((lam - lam1) / (lam2 - lam1), 0.0, 1.0)
    mid = 0.5 * (1.0 + torch.cos(math.pi * t))
    return torch.where(lam < lam1, 1.0, torch.where(lam > lam2, 0.0, mid))


def _chebyshev_terms(x: torch.Tensor, L: torch.Tensor, K: int) -> torch.Tensor:
    """T_k(L - I) x for k < K: (K, B, N, F)."""
    L_hat = L - torch.eye(L.shape[-1], dtype=x.dtype, device=x.device)
    polys = [x, L_hat @ x]
    for _ in range(2, K):
        polys.append(2.0 * (L_hat @ polys[-1]) - polys[-2])
    return torch.stack(polys[:K], dim=0)


def chebyshev_sgwt(x: torch.Tensor, laplacian: torch.Tensor, K: int = 25, J: int = 4,
                   tight_frame: bool = True, scales: list[float] | None = None,
                   lam_max: float = 2.0) -> torch.Tensor:
    """The Chebyshev-polynomial SGWT (the reference's GraphWaveletTransform):
    x (B, N, F) on the graph of ``laplacian`` (B, N, N) -> (B, N, F (J + 1))
    with ``tight_frame`` (the Meyer scaling kernel and J dyadic wavelets),
    else (B, N, F len(scales)) with the kernels t lam e^(-t lam)."""
    P = _chebyshev_terms(x, laplacian, K)
    lam = torch.cos(math.pi * torch.arange(K, dtype=x.dtype, device=x.device) / K) + 1.0
    if tight_frame:
        def g(l):
            return torch.sqrt(torch.clamp(1.0 - _meyer_window(l / lam_max) ** 2, min=0.0))

        weights = [_meyer_window(lam / lam_max)] + [g(lam * 2.0 ** j) for j in range(J)]
    else:
        if scales is None:
            raise ValueError("chebyshev_sgwt without tight_frame needs scales")
        weights = [(t * lam) * torch.exp(-t * lam) for t in scales]
    return torch.cat([torch.einsum("k,kbnf->bnf", w, P) for w in weights], dim=2)


def _jackson_damping(K: int) -> torch.Tensor:
    k = torch.arange(K, dtype=torch.float32)
    a = math.pi / (K + 1)
    return ((K - k + 1) * torch.cos(a * k) + torch.sin(a * k) / math.tan(a)) / (K + 1)


def complex_meyer_sgwt(x: torch.Tensor, L: torch.Tensor, J: int = 3, K: int = 30,
                       lam_max: float = 2.0, use_complex: bool = True, use_delta: bool = False,
                       jackson: bool = False) -> torch.Tensor:
    """The analytic complex Meyer SGWT (the reference's ComplexMeyerSGWT):
    x (B, N, F) on the graph of L (B, N, N) -> (B, N, F, C), complex64 with
    ``use_complex``, C = J bands (and first, with ``use_delta``, a band
    around lambda_1, the eigenvalues from ``eigvalsh`` of L's lower
    triangle); ``jackson`` damps the Chebyshev terms."""
    T = _chebyshev_terms(x, L, K)
    k_vec = torch.arange(K, dtype=x.dtype, device=x.device)
    lam_k = (torch.cos(math.pi * k_vec / K) + 1.0) * (lam_max / 2)
    gamma = _jackson_damping(K).to(x.device) if jackson else None

    def band(real, imag=None):
        if not use_complex:
            return real
        return real.to(torch.complex64) if imag is None else torch.complex(real, imag)

    bands = []
    if use_delta:
        eigvals = torch.linalg.eigvalsh(tril_symmetrize(L))
        lam0, lam1 = eigvals[:, 0], eigvals[:, 1]
        eps = torch.clamp_min(torch.clamp_min((lam1 - lam0) * 0.5, 0.05 * lam_max), lam_max / K)
        diff = lam_k[None, :] - lam1[:, None]
        g_delta = torch.where(diff.abs() <= eps[:, None],
                              torch.cos(0.5 * math.pi * diff / eps[:, None]), 0.0)
        if gamma is not None:
            g_delta = g_delta * gamma[None]
        bands.append(band(torch.einsum("bk,kbnf->bnf", g_delta, T)))
    for j in range(J):
        lam1, lam2 = lam_max / 2 ** (j + 1), lam_max / 2 ** j
        nu = torch.clamp((lam_k - lam1) / (lam2 - lam1), 0.0, 1.0)
        gk, hk = torch.sin(0.5 * math.pi * nu), torch.cos(0.5 * math.pi * nu)
        if gamma is not None:
            gk, hk = gk * gamma, hk * gamma
        real = torch.einsum("k,kbnf->bnf", gk, T)
        bands.append(band(real, torch.einsum("k,kbnf->bnf", hk, T) if use_complex else None))
    return torch.stack(bands, dim=-1)


def graph_scattering(x: torch.Tensor, L: torch.Tensor, sgwt_fn, level: int = 2,
                     nonlin=torch.abs) -> torch.Tensor:
    """Second-order graph scattering (the reference's GraphScattering) over an
    SGWT ``sgwt_fn(x, L)`` that returns (B, N, F, J + 1), channel 0 the
    scaling band: [S0, |b1_j| for each j, and at ``level`` 2 |b2_jk| for
    j < k], stacked on the last axis in their common dtype."""
    coeffs = sgwt_fn(x, L)
    S0, b1 = coeffs[..., 0], coeffs[..., 1:]
    B, N, F, J = b1.shape
    if level >= 1:
        b1 = nonlin(b1)
    outputs = [S0] + list(b1.movedim(-1, 0))
    if level >= 2:
        U1 = b1.movedim(-1, 1).reshape(B * J, N, F)
        coeffs2 = sgwt_fn(U1, torch.repeat_interleave(L, J, dim=0))
        b2 = nonlin(coeffs2.reshape(B, J, N, F, -1)[..., 1:])
        outputs += [b2[:, j, :, :, k] for j in range(J) for k in range(j + 1, J)]
    dtype = outputs[0].dtype
    for o in outputs[1:]:
        dtype = torch.promote_types(dtype, o.dtype)
    return torch.stack([o.to(dtype) for o in outputs], dim=-1)
