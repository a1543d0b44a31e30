"""Batched spectral ops: lower-triangle eigh, top-k eigenpairs, the subspace
eigensolver, SAST orders and HLT codes.

PyTorch counterparts of ``si_mamba_tpu/ops/spectral.py``. The random-walk
Laplacian is not symmetric; like the reference, the eigensolver sees the
matrix reflected from its lower triangle (not ``(M + M^T) / 2``).
"""

from __future__ import annotations

import numpy as np
import torch


def tril_symmetrize(M: torch.Tensor) -> torch.Tensor:
    """The symmetric matrix that ``eigh(UPLO='L')`` reads from ``M``."""
    return torch.tril(M) + torch.tril(M, -1).transpose(-1, -2)


def eigh_tril(M: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(eigenvalues ascending (..., N), eigenvectors in columns (..., N, N))."""
    return torch.linalg.eigh(tril_symmetrize(M))


def topk_eigh(L: torch.Tensor, k: int, smallest: bool = True):
    """k smallest eigenpairs ascending (or k largest descending) of (B, N, N)
    ``L``. Returns (vals (B, k), vecs (B, N, k), all_vals, all_vecs)."""
    vals, vecs = eigh_tril(L)
    if smallest:
        return vals[..., :k], vecs[..., :, :k], vals, vecs
    return vals.flip(-1)[..., :k], vecs.flip(-1)[..., :, :k], vals, vecs


def canonicalize_eigenvector_signs(vecs: torch.Tensor) -> torch.Tensor:
    """Make each eigenvector's entry of largest magnitude positive.
    (..., N, k) -> same shape."""
    amax = torch.argmax(vecs.abs(), dim=-2, keepdim=True)  # (..., 1, k)
    picked = torch.gather(vecs, -2, amax)
    return vecs * torch.where(picked >= 0, 1.0, -1.0).to(vecs.dtype)


def sort_orders_by_eigenvectors(eigvecs: torch.Tensor) -> torch.Tensor:
    """Stable ascending argsort of each eigenvector: (B, N, k) -> (B, k, N)."""
    return torch.argsort(eigvecs.transpose(-1, -2), dim=-1, stable=True)


def multilevel_codes(eigvecs: torch.Tensor, level: int) -> torch.Tensor:
    """HLT bucket codes: bit i of a token's code is whether its entry of
    eigenvector i lies at or above that eigenvector's mean over the tokens,
    the first ``level`` eigenvectors packed most significant first.
    (B, N, k) -> (B, N) float codes in the eigenvectors' dtype."""
    means = torch.mean(eigvecs, dim=1, keepdim=True)
    bits = (eigvecs >= means).to(eigvecs.dtype)[..., :level]
    powers = 2.0 ** torch.arange(level - 1, -1, -1, dtype=eigvecs.dtype, device=eigvecs.device)
    return torch.sum(bits * powers, dim=-1)


_THREEFRY_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _threefry2x32(k0: int, k1: int, x0: np.ndarray, x1: np.ndarray):
    """Threefry-2x32 with 20 rounds (Salmon et al., 2011) over uint32 counter
    pairs (x0, x1) under the key (k0, k1): JAX's ``threefry2x32``."""
    def rotl(v, r):
        return (v << np.uint32(r)) | (v >> np.uint32(32 - r))

    ks = (np.uint32(k0), np.uint32(k1), np.uint32(k0 ^ k1 ^ 0x1BD11BDA))
    x0, x1 = x0 + ks[0], x1 + ks[1]
    for i in range(5):
        for r in _THREEFRY_ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def prng_key(seed: int) -> tuple[int, int]:
    """The raw threefry key (k0, k1) of ``jax.random.key(seed)``, seed in
    [0, 2**31)."""
    if not 0 <= seed < 2 ** 31:
        raise ValueError(f"seed {seed} is outside [0, 2**31)")
    return 0, seed


def fold_in(key: tuple[int, int], data: int) -> tuple[int, int]:
    """``jax.random.fold_in`` of a raw threefry key and a uint32 ``data``:
    threefry of the counter pair (0, data) under the key."""
    with np.errstate(over="ignore"):
        y0, y1 = _threefry2x32(key[0], key[1], np.zeros(1, np.uint32),
                               np.full(1, data, np.uint32))
    return int(y0[0]), int(y1[0])


def uniform(key: tuple[int, int], shape, bf16: bool = False) -> np.ndarray:
    """U[0, 1) of ``shape`` as float32, bit for bit ``jax.random.uniform`` of
    the raw threefry ``key`` (partitionable bit generation): the 32 random
    bits of element i are x0 ^ x1 of threefry over the 64-bit flat index i
    split into (hi, lo); their top 23 bits as the mantissa of a float in
    [1, 2), minus 1, are the value. With ``bf16`` the draw of dtype bfloat16
    (7 mantissa bits, so JAX draws 8 bits): the low byte of x0 ^ x1, shifted
    right once, over 128. Drawn on the host with numpy."""
    n = int(np.prod(shape, dtype=np.int64))
    idx = np.arange(n, dtype=np.uint64)
    with np.errstate(over="ignore"):
        x0, x1 = _threefry2x32(key[0], key[1],
                               (idx >> np.uint64(32)).astype(np.uint32),
                               (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    bits = x0 ^ x1
    if bf16:
        return (((bits & np.uint32(0xFF)) >> np.uint32(1)).astype(np.float32)
                / np.float32(128)).reshape(shape)
    u = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) - np.float32(1.0)
    return u.reshape(shape)


def rademacher(seed: int, shape) -> np.ndarray:
    """+-1 float32 of ``shape``, bit for bit ``jax.random.rademacher(
    jax.random.key(seed), shape, jnp.float32)`` for a seed in [0, 2**31):
    +1 where :func:`uniform` of the same key and shape is below 0.5."""
    return np.where(uniform(prng_key(seed), shape) < np.float32(0.5), np.float32(1.0),
                    np.float32(-1.0))


def topk_smallest_subspace(L: torch.Tensor, k: int, iters: int = 40, oversample: int = 4,
                           qr_every: int = 5, seed: int = 0):
    """Approximate k smallest eigenpairs of the lower-triangle-symmetric
    (B, N, N) ``L``: orthogonal (subspace) iteration on M = 2I - L (the
    random-walk Laplacian's eigenvalues lie in [0, 2]) from the seeded
    Rademacher start of the JAX package, a QR every ``qr_every`` products and
    after the last, then Rayleigh-Ritz through ``eigh`` of the (B, m, m)
    projection, m = k + oversample. The same start and steps as
    ``si_mamba_tpu.ops.spectral.topk_smallest_subspace``, so both converge to
    the same vectors. Returns (vals (B, k), vecs (B, N, k)) ascending, fp32."""
    Ls = tril_symmetrize(L).float()
    B, N, _ = Ls.shape
    m = k + oversample
    M = 2.0 * torch.eye(N, dtype=torch.float32, device=Ls.device) - Ls
    Q = torch.from_numpy(rademacher(seed, (B, N, m))).to(Ls.device)
    Q, _ = torch.linalg.qr(Q)
    for i in range(iters):
        Q = torch.bmm(M, Q)
        if (i + 1) % qr_every == 0 or i == iters - 1:
            Q, _ = torch.linalg.qr(Q)
    S = torch.bmm(Q.transpose(-1, -2), torch.bmm(Ls, Q))
    svals, svecs = torch.linalg.eigh(S)  # ascending
    return svals[..., :k], torch.bmm(Q, svecs[..., :k])
