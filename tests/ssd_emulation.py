"""The arithmetic of the chunk-parallel SSD kernels (csrc/ssd_xbc_fwd.cu,
csrc/ssd_xbc_bwd.cu: K8/K9 and the split K6/K7), emulated on the CPU in fp32
with every product taken as the kernels take it, for the tests that hold it
against the plain versions in float64 within chip_smoke.py's tolerances.

Test-only code: the CUDA kernels have no CPU mode, so this is what a CPU run
can check of their split of the work and of their 3xTF32 products, and
(:func:`chunked_bf16`) of their bf16 variants: which operands they round to
bf16, which products stay 3xTF32, and where a factor moves across a
product."""

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


def bf16(x):
    """x rounded to bf16 (to nearest even) and held in fp32."""
    return x.to(torch.bfloat16).to(torch.float32)


def mmb(a, b):
    """a @ b as a bf16 tensor-core product: both operands rounded to bf16,
    their products exact in fp32 (8 x 8 significant bits), summed in fp32."""
    return bf16(a) @ bf16(b)


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


def chunked_bf16(x, Bc, Cc, dth, S, dyh, D=None, dh_fin=None):
    """The bf16 variants of the same split (csrc/ssd_xbc_fwd.cu and
    csrc/ssd_xbc_bwd.cu at bf16), in fp32, arguments and returns as
    :func:`chunked_3xtf32` (x, Bc, Cc, dyh holding bf16 values; y, dx, dB, dC
    rounded to bf16 as the kernels write them). The bf16 products (:func:`mmb`):
    G = C B^T, the local end states B^T bf16(bf16(x dt) T_end), bf16(G (.) M)
    bf16(x dt), C bf16(h_in) (scaled by E after it), dy bf16(x dt)^T,
    bf16(GM)^T dy, dy bf16(h_in)^T. The 3xTF32 ones (:func:`mm3`): the carry
    (C E)^T dy, B dh, (bf16(x dt) dh^T) (scaled by T_end after it), and dG B,
    dG^T C on the head sum of each head's bf16(dG)."""
    b, h, nc, q, p = x.shape
    E, T_end = torch.exp(S), torch.exp(S[..., -1:] - S)
    M = kssd.decay_mask(S)
    xdt = bf16(x * dth[..., None])
    G = mmb(Cc, Bc.transpose(-1, -2))
    local = mmb(Bc[:, None].transpose(-1, -2), bf16(xdt * T_end[..., None]))
    h_in = torch.zeros_like(local)
    for c in range(1, nc):
        h_in[:, :, c] = torch.exp(S[:, :, c - 1, -1])[..., None, None] * h_in[:, :, c - 1] \
            + local[:, :, c - 1]
    h_fin = local[:, :, -1] + torch.exp(S[:, :, -1, -1])[..., None, None] * h_in[:, :, -1]
    GM = G[:, None] * M
    y = E[..., None] * mmb(Cc[:, None], h_in) + mmb(GM, xdt)
    if D is not None:
        y = y + D[None, :, None, None, None] * x

    carry = mm3((Cc[:, None] * E[..., None]).transpose(-1, -2), dyh)
    dh = torch.zeros_like(h_in)
    if dh_fin is not None:
        dh[:, :, -1] = dh_fin
    for c in range(nc - 2, -1, -1):
        dh[:, :, c] = torch.exp(S[:, :, c + 1, -1])[..., None, None] * dh[:, :, c + 1] \
            + carry[:, :, c + 1]
    dGM = mmb(dyh, xdt.transpose(-1, -2))
    dlogM = dGM * GM
    dG = bf16(dGM * M).sum(1)
    Bdh = mm3(Bc[:, None], dh)
    dT = (Bdh * x * dth[..., None]).sum(-1)
    dxdt = Bdh * T_end[..., None] + mmb(GM.transpose(-1, -2), dyh)
    dx = dxdt * dth[..., None]
    dD = None
    if D is not None:
        dx = dx + D[None, :, None, None, None] * dyh
        dD = (dyh * x).sum((0, 2, 3, 4))
    yh = mmb(dyh, h_in.transpose(-1, -2))
    dE = (yh * Cc[:, None]).sum(-1)
    dC = (E[..., None] * yh).sum(1) + mm3(dG, Bc)
    dB = (T_end[..., None] * mm3(xdt, dh.transpose(-1, -2))).sum(1) + mm3(dG.transpose(-1, -2), Cc)
    dS = dlogM.sum(-1) + dE * E - dT * T_end - dlogM.sum(-2)
    dS[..., -1] += (dT * T_end).sum(-1) + torch.exp(S[..., -1]) * (dh * h_in).sum((-2, -1))
    return bf16(y), h_in, h_fin, (bf16(dx), (dxdt * x).sum(-1), dS, bf16(dB), bf16(dC), dD)


def rel_err_of_max(got, ref) -> float:
    """max |got - ref| over max |ref|."""
    return ((got.double() - ref).abs().max() / ref.abs().max()).item()
