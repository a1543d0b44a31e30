"""The arithmetic of the chunk-parallel SSD kernels (csrc/ssd_xbc_fwd.cu,
csrc/ssd_xbc_bwd.cu: K8/K9 and the split K6/K7), emulated on the CPU in fp32
with every product taken as the kernels take it, for the tests that hold it
against the plain versions in float64 within chip_smoke.py's tolerances.

Test-only code: the CUDA kernels have no CPU mode, so this is what a CPU run
can check of their split of the work and of their 3xTF32 products."""

from __future__ import annotations

import torch

from si_mamba_tpu_torch.ops.kernels import ssd as kssd


def tf32(x):
    """x rounded to TF32 (10 mantissa bits) on its fp32 bit pattern, to
    nearest with ties away from zero, as cvt.rna.tf32.f32 rounds."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def mm3(a, b):
    """a @ b as the kernels take every product: each operand split into a
    TF32 high part and a TF32 low part, a_lo b_hi + a_hi b_lo + a_hi b_hi
    summed in fp32 (the products of two TF32 parts are exact in fp32)."""
    ah, bh = tf32(a), tf32(b)
    al, bl = tf32(a - ah), tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def mm1(a, b):
    """a @ b as one TF32 product: both operands rounded to TF32, summed in
    fp32."""
    return tf32(a) @ tf32(b)


def chunked_3xtf32(x, Bc, Cc, dth, S, dyh, D=None, dh_fin=None, mm=mm3):
    """The forward and backward as the chunk-parallel body splits them (G once
    per chunk, the chunks' local end states and carry terms, elementwise
    carry passes, the head sum of dG taken before dG B and dG^T C), every
    product through ``mm``, in fp32. x, dyh (b, h, nc, q, p); Bc, Cc
    (b, nc, q, n); dth, S (b, h, nc, q); D (h,) for the D terms (K8/K9) or
    None (K6/K7); dh_fin (b, h, n, p), the seed of the dh carry (K7 seeded),
    or None for a carry from 0.

    Returns (y, h_in (b, h, nc, n, p), h_fin (b, h, n, p), (dx, ddt, dS, dB,
    dC, dD or None)), y and dx (b, h, nc, q, p), dB and dC (b, nc, q, n)."""
    b, h, nc, q, p = x.shape
    E, T_end = torch.exp(S), torch.exp(S[..., -1:] - S)
    M = kssd.decay_mask(S)  # (b, h, nc, q, q)
    G = mm(Cc, Bc.transpose(-1, -2))  # (b, nc, q, q), once for the heads
    local = mm((Bc[:, None] * (dth * T_end)[..., None]).transpose(-1, -2), x)
    h_in = torch.zeros_like(local)
    for c in range(1, nc):
        h_in[:, :, c] = torch.exp(S[:, :, c - 1, -1])[..., None, None] * h_in[:, :, c - 1] \
            + local[:, :, c - 1]
    h_fin = local[:, :, -1] + torch.exp(S[:, :, -1, -1])[..., None, None] * h_in[:, :, -1]
    GM = G[:, None] * M
    y = mm(GM * dth[..., None, :], x) + mm(Cc[:, None] * E[..., None], h_in)
    if D is not None:
        y = y + D[None, :, None, None, None] * x

    carry = mm((Cc[:, None] * E[..., None]).transpose(-1, -2), dyh)  # (C E)^T dy
    dh = torch.zeros_like(h_in)
    if dh_fin is not None:
        dh[:, :, -1] = dh_fin
    for c in range(nc - 2, -1, -1):
        dh[:, :, c] = torch.exp(S[:, :, c + 1, -1])[..., None, None] * dh[:, :, c + 1] \
            + carry[:, :, c + 1]
    dGM = mm(dyh, x.transpose(-1, -2)) * dth[..., None, :]
    dlogM = dGM * GM
    dG = (dGM * M).sum(1)  # the head sum, (b, nc, q, q)
    Bdh = mm(Bc[:, None], dh)
    dT = (Bdh * x * dth[..., None]).sum(-1)
    dxdt = Bdh * T_end[..., None] + mm(GM.transpose(-1, -2), dyh)
    dx = dxdt * dth[..., None]
    dD = None
    if D is not None:
        dx = dx + D[None, :, None, None, None] * dyh
        dD = (dyh * x).sum((0, 2, 3, 4))
    yh = mm(dyh, h_in.transpose(-1, -2))  # dy h_in^T, (b, h, nc, q, n)
    dE = (yh * Cc[:, None]).sum(-1)
    dC = (E[..., None] * yh).sum(1) + mm(dG, Bc)
    dB = mm((x * (dth * T_end)[..., None]).permute(0, 2, 3, 1, 4).reshape(b, nc, q, h * p),
              dh.permute(0, 2, 1, 4, 3).reshape(b, nc, h * p, -1)) \
        + mm(dG.transpose(-1, -2), Cc)
    dS = dlogM.sum(-1) + dE * E - dT * T_end - dlogM.sum(-2)
    dS[..., -1] += (dT * T_end).sum(-1) + torch.exp(S[..., -1]) * (dh * h_in).sum((-2, -1))
    return y, h_in, h_fin, (dx, (dxdt * x).sum(-1), dS, dB, dC, dD)


def rel_err_of_max(got, ref) -> float:
    """max |got - ref| over max |ref|."""
    return ((got.double() - ref).abs().max() / ref.abs().max()).item()
