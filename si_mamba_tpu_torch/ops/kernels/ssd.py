"""Chunked SSD core, forward and backward: the CUDA kernels, their plain
versions and the autograd Functions over them, in two forms.

The boundary-fused core takes the SSD mixer's un-split conv output xbc
(b, l, d + 2n), columns [x | B | C], the per-chunk step sizes dt and log-decay
cumsums S, both (b, h, nc, q), and the per-head skip D (h,), and returns
y (b, l, d) = the SSD recurrence of ``ops/ssd.py`` plus the D skip. The split
core takes x (b, l, h p), B and C (b, l, n) as separate (strided) operands, as
the tensor- and sequence-parallel mixers make them, and has no D term; it can
also return the state after the last chunk, h_fin (b, h, n, p), and take its
cotangent back as the seed of the backward's carry.

Kernels, one chunk-parallel body in each source, its products on the tensor
cores (``csrc/ssd_tc.cuh``: 3xTF32, and at bf16 also bf16 products), with two
entry points each and a ``_bf16`` twin of each:
- ``csrc/ssd_xbc_fwd.cu``: K8 (``ssd_xbc_fwd``), which replaces the TPU
  kernel ``_make_fwd_kernel_xbc`` behind ``_fwd_call_xbc``
  (si_mamba_tpu/ops/pallas/ssd_kernel.py), in two variants: the lean forward
  (``emit_states=False``, serving) and the training forward, which also
  writes the state entering every chunk, h_in (b, nc, h, n, p) fp32, each
  also with the state after the last chunk, h_fin (b, h, n, p) fp32
  (``ssd_xbc_fwd_hfin``, ``_fwd_call_xbc(emit_hfin=True)``); and K6
  (``ssd_split_fwd``), which replaces ``_make_fwd_kernel`` behind
  ``_fwd_call``: lean, with states, with h_fin, or with both. Their
  scratch: G = C B^T (b, nc, q, q), and for the lean forward an h_in of the
  slots 1 .. nc - 1;
- ``csrc/ssd_xbc_bwd.cu``: K9 (``ssd_xbc_bwd``), which replaces
  ``_make_bwd_kernel_xbc`` behind ``_bwd_call_xbc``: it writes every column
  of dxbc, ddt, dS and per-(chunk, strip) partials of dD that the wrapper's
  ``torch.sum`` finishes, its dh carry starting at 0 or at a given dh_fin
  (``ssd_xbc_bwd_seeded``, ``_bwd_call_xbc(dh_fin=...)``); and K7
  (``ssd_split_bwd``), which replaces
  ``_make_bwd_kernel`` behind ``_bwd_call``: dx, ddt, dS and the head sums of
  dB and dC into one (b, l, 2n) buffer, its dh carry starting at 0 or at a
  given dh_fin. Their scratch is laid out by :func:`bwd_scratch_floats`.
:func:`run_fwd`, :func:`run_bwd`, :func:`run_split_fwd` and
:func:`run_split_bwd` allocate outputs and scratch and launch through a given
library; the C side refuses scratch of another size.
The sources describe the designs and bounds. They are built for every
d_state and head_dim the JAX kernels compile for, positive multiples of
:data:`STATE_TILE` (n = p = 128 as the tuned instantiation, any other as the
wide one: more 64 x 128 output tiles and deeper k-loops, the same shared
memory), and every chunk the JAX kernels compile for, a multiple of
:data:`CHUNK_ALIGN` (up to :data:`MAX_CHUNK`). Their bodies walk a chunk in
64-row strips (:data:`STRIP`). A chunk that is not a multiple of the strip
runs laid out in strips (:func:`_to_strips`): each chunk's rows followed by
zero rows up to the next multiple of 64 (x, B, C and dy 0, dt 0, S held at
the chunk's last value), which add nothing to G, to y, to the carry or to
any gradient; dS of the copies of the last S is folded back onto it. A chunk
longer than 256 sizes the kernels' per-chunk shared arrays at launch
(dynamic shared memory) and walks the q x q G scratch in the same strips.
Those two are the ``_strip`` and ``_long`` variants of each entry point, with
their own launch counts (``VARIANT_LAUNCHES``), chosen by the chunk before
the launch; the wide instantiation adds ``_wide`` to the name of whichever
of the three ran (:func:`kernel_variant`).

At bf16, d_state = head_dim = 128 and a chunk of :data:`SM90_CHUNKS`, every
K8 (lean, with states, with h_fin) and K9 (from 0 or seeded) runs a body of
its own, ``csrc/ssd_xbc_bf16_sm90.cu`` (:data:`SM90_SOURCE`): every product a
Hopper warpgroup ``wgmma``, G kept in registers as the next product's
operand, the chunk carry in the accumulator, the tiles brought by the tensor
memory accelerator (:func:`run_sm90_fwd`, :func:`run_sm90_bwd`;
:func:`kernel_variant` names it '_sm90', its launches count on
``VARIANT_LAUNCHES``). Every other call keeps the chunk-parallel bodies.

Every kernel takes fp32 or bf16 activations (xbc, or x, B and C, and dy; y,
dx, dB and dC come back in their dtype), with dt, S, D, h_in and dh_fin fp32,
as the TPU kernels take them at either activation dtype. At bf16 the products
whose operands the TPU kernels round to bf16 (their ``mm``) are bf16
tensor-core products, the ones with the fp32 state carry stay 3xTF32, and
the plain versions round where ``_make_fwd_kernel(_xbc)`` and ``_bwd_head``
round (:func:`ssd_chunks_ref`, :func:`_bwd_chunks`). Each dtype is its own
variant with its own launch count: ``ssd_xbc_fwd`` / ``ssd_xbc_fwd_bf16``,
``ssd_split_bwd_seeded`` / ``ssd_split_bwd_seeded_bf16``, and so on.

:func:`ssd_chunked_xbc` runs the lean K8 when no gradient is wanted and
:class:`SSDChunkedXbcFn` (K8 with states, K9) when one is, or with
``return_carry`` K8 with h_fin and :class:`SSDChunkedXbcCarryFn`;
:func:`ssd_chunked_split` likewise runs K6 and K7 through
:class:`SSDChunkedSplitFn`, or with ``return_carry`` through
:class:`SSDChunkedSplitCarryFn`. On a CPU tensor each is its plain version.
Nothing falls back from one to the other.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from si_mamba_tpu_torch.ops.kernels.build import LaunchCount, load_library

STATE = 128  # d_state of the tuned instantiation (kN in both sources)
HEAD_DIM = 128  # head_dim of the tuned instantiation (kP)
STATE_TILE = 128  # d_state and head_dim are positive multiples of this (kTile)
STRIP = 64  # rows of a time strip (kBM); a chunk that is no multiple runs laid out in strips
CHUNK_ALIGN = 8  # the chunk is a multiple of this, as the JAX kernels require
TUNED_CHUNK = 256  # the longest chunk the per-chunk shared arrays always held (kArrayFloor)
MAX_CHUNK = 8192  # the longest chunk the kernels' dynamic shared memory holds (kMaxChunk)
SM90_SOURCE = "ssd_xbc_bf16_sm90"  # the Hopper bf16 K8/K9 body
SM90_CHUNKS = (64, 128, 192, 256)  # the chunks it serves (a multiple of 64 up to kMaxChunk)
# the activation dtypes the kernels are built for; dt, S, D and the states are fp32
KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def _acc_dtype(x: torch.Tensor) -> torch.dtype:
    """The plain versions compute in fp32, or in fp64 for fp64 input."""
    return torch.promote_types(x.dtype, torch.float32)


def _rounder(mm):
    """t rounded to ``mm`` and back (bf16: what a bf16 operand of a product
    with fp32 accumulation holds), or t itself for mm None, fp32 or fp64."""
    if mm is None or mm in (torch.float32, torch.float64):
        return lambda t: t
    return lambda t: t.to(mm).to(t.dtype)


def decay_mask(S: torch.Tensor) -> torch.Tensor:
    """M[..., t, s] = exp(S[t] - S[s]) for s <= t, else 0, from S (..., q).
    Masked in log space: for s > t the exponent is large and positive (S is
    non-increasing), and exp of it overflows to inf, where inf * 0 is NaN."""
    q = S.shape[-1]
    tri = torch.ones(q, q, dtype=torch.bool, device=S.device).tril()
    return torch.exp(torch.where(tri, S[..., :, None] - S[..., None, :], float("-inf")))


def ssd_chunks_ref(xdt, S, Bc, Cc, mm=None, round_decay: bool = False):
    """The chunked SSD without the D skip, heads next to the batch: xdt
    (b, h, nc, q, p) = dt x, S (b, h, nc, q) the per-chunk log-decay cumsums,
    Bc, Cc (b, nc, q, n). Returns y (b, h, nc, q, p), the state entering each
    chunk h_in (b, h, nc, n, p) and the state leaving the last (b, h, n, p):
    the intra-chunk (C B^T (.) decay mask) (dt x), the inter-chunk
    C h_in e^S, and the carry h <- e^{S_end} h + B^T (dt x (.) e^{S_end - S}).

    ``mm`` bf16: the products' operands rounded to bf16 where the JAX package
    rounds them at bf16 activations (xdt is the caller's, already rounded):
    G (.) M, the decayed xdt of the carry (its factor e^{S_end - S} rounded
    first with ``round_decay``, as ``ops/ssd.ssd_chunked``'s bf16 product does;
    not, as the Pallas kernels do) and h_in as the operand of C h_in. Products
    accumulate in xdt's dtype, the carry and y stay in it."""
    b, h, nc, _, p = xdt.shape
    n = Bc.shape[-1]
    rnd = _rounder(mm)
    G = torch.einsum("bcqn,bckn->bcqk", Cc, Bc)
    y_intra = torch.einsum("bhcqk,bhckp->bhcqp", rnd(G[:, None] * decay_mask(S)), xdt)
    T_end = torch.exp(S[..., -1:] - S)
    decay = rnd(T_end) if round_decay else T_end
    states = torch.einsum("bcqn,bhcqp->bhcnp", Bc, rnd(xdt * decay[..., None]))
    state, entries = xdt.new_zeros((b, h, n, p)), []
    for c in range(nc):
        entries.append(state)
        state = torch.exp(S[:, :, c, -1])[..., None, None] * state + states[:, :, c]
    h_in = torch.stack(entries, dim=2) if entries else xdt.new_zeros((b, h, 0, n, p))
    y_inter = torch.einsum("bcqn,bhcnp->bhcqp", Cc, rnd(h_in)) * torch.exp(S)[..., None]
    return y_intra + y_inter, h_in, state


def _split_xbc(xbc, d_inner: int, h: int, chunk: int):
    """x (b, h, nc, q, p), B and C (b, nc, q, n) from xbc (b, l, d + 2n)."""
    b, l, total = xbc.shape
    n, p, nc = (total - d_inner) // 2, d_inner // h, l // chunk
    acc = _acc_dtype(xbc)
    x = xbc[..., :d_inner].to(acc).reshape(b, nc, chunk, h, p).permute(0, 3, 1, 2, 4)
    Bc = xbc[..., d_inner:d_inner + n].to(acc).reshape(b, nc, chunk, n)
    Cc = xbc[..., d_inner + n:].to(acc).reshape(b, nc, chunk, n)
    return x, Bc, Cc


def ssd_xbc_fwd_ref(xbc, dt, S, D, d_inner: int, chunk: int, emit_states: bool = False,
                    emit_hfin: bool = False):
    """Plain version of K8: (y (b, l, d) in xbc's dtype, h_in (b, nc, h, n, p)
    fp32 or None), and with ``emit_hfin`` also h_fin (b, h, n, p) fp32, the
    state after the last chunk.

    What ``_make_fwd_kernel_xbc`` computes: :func:`ssd_chunks_ref` with the
    head-shared G = C B^T, plus the D skip; at bf16 with its roundings
    (xdt = bf16(x dt), then those of :func:`ssd_chunks_ref`)."""
    b, l, _ = xbc.shape
    x, Bc, Cc = _split_xbc(xbc, d_inner, dt.shape[1], chunk)
    dt, S, D = dt.to(x.dtype), S.to(x.dtype), D.to(x.dtype)
    rnd = _rounder(xbc.dtype)
    y, h_in, h_fin = ssd_chunks_ref(rnd(x * dt[..., None]), S, Bc, Cc, mm=xbc.dtype)
    y = y + D[None, :, None, None, None] * x
    y = y.permute(0, 2, 3, 1, 4).reshape(b, l, d_inner).to(xbc.dtype)
    out = (y, h_in.transpose(1, 2).contiguous() if emit_states else None)
    return (*out, h_fin) if emit_hfin else out


def _bwd_chunks(x, dt, S, Bc, Cc, hin_all, dyh, dh, D=None, mm=None):
    """The reverse chunk loop of the backward, heads next to the batch: x, dyh
    (b, h, nc, q, p), dt, S (b, h, nc, q), Bc, Cc (b, nc, q, n), hin_all
    (b, h, nc, n, p), dh (b, h, n, p) the cotangent of the state leaving the
    last chunk, D (h,) or None for the core without the D skip; every operand
    in the accumulation dtype, the activations' values bf16 ones for ``mm``
    bf16. Returns (dx, ddt, dS, dB, dC, dD partials (b, nc, h) or None).

    Written out as ``_bwd_head`` computes it (not taken from autograd): the
    chunks in reverse with dh carried from each chunk to the one before,

        dh_in = e^{S_end} dh_out + (C e^S)^T dy,

    dx = (GM^T dy + (B dh_out) e^{S_end - S}) dt (+ D dy), the head-summed dB
    and dC, dS from the mask's rows and columns, the e^S and e^{S_end - S}
    factors and the chunk's end (dSend), ddt, and dD as per-chunk partials.

    ``mm`` bf16 rounds where ``_bwd_head`` rounds at bf16: xdt = bf16(x dt)
    in dy xdt^T and (unrounded again) in the carry term of dB, GM and dG as
    operands of GM^T dy, dG B and dG^T C, and h_in as the operand of
    dy h_in^T and C h_in; the dh carry and every product it enters stay in
    the accumulation dtype."""
    rnd = _rounder(mm)
    b, h, nc = dt.shape[:3]
    dx, ddt, dS = torch.empty_like(x), torch.empty_like(dt), torch.empty_like(S)
    dB, dC = torch.empty_like(Bc), torch.empty_like(Cc)
    dD_part = x.new_empty((b, nc, h)) if D is not None else None
    for c in reversed(range(nc)):
        Sc, dtc = S[:, :, c], dt[:, :, c]  # (b, h, q)
        xc, dyc, hin = x[:, :, c], dyh[:, :, c], hin_all[:, :, c]
        B, C = Bc[:, c], Cc[:, c]  # (b, q, n)
        E = torch.exp(Sc)
        send = Sc[..., -1]
        T_end = torch.exp(send[..., None] - Sc)
        xdt32 = xc * dtc[..., None]
        xdt = rnd(xdt32)
        M = decay_mask(Sc)  # (b, h, q_t, q_s)
        GM = torch.einsum("btn,bsn->bts", C, B)[:, None] * M
        hin_mm = rnd(hin)

        t1 = torch.einsum("bhts,bhtp->bhsp", rnd(GM), dyc)
        Bdh = torch.einsum("bsn,bhnp->bhsp", B, dh)
        dxdt = t1 + Bdh * T_end[..., None]
        dx[:, :, c] = dxdt * dtc[..., None]
        if D is not None:
            dx[:, :, c] += D[None, :, None, None] * dyc
            dD_part[:, c] = torch.sum(dyc * xc, dim=(-2, -1))
        ddt[:, :, c] = torch.sum(dxdt * xc, dim=-1)

        dGM = torch.einsum("bhtp,bhsp->bhts", dyc, xdt)
        dG = dGM * M
        dlogM = dGM * GM
        dC[:, c] = (torch.einsum("bhts,bsn->bhtn", rnd(dG), B)
                    + torch.einsum("bhtp,bhnp->bhtn", dyc, hin_mm) * E[..., None]).sum(1)
        dB[:, c] = (torch.einsum("bhts,btn->bhsn", rnd(dG), C)
                    + torch.einsum("bhsp,bhnp->bhsn", xdt * T_end[..., None], dh)).sum(1)

        Chin = torch.einsum("btn,bhnp->bhtp", C, hin_mm)
        dE = torch.sum(dyc * Chin, dim=-1)
        dT = torch.sum(Bdh * xdt32, dim=-1)
        dSend = torch.sum(dT * T_end, dim=-1) + torch.exp(send) * torch.sum(dh * hin, dim=(-2, -1))
        dSc = torch.sum(dlogM, dim=-1) + dE * E - dT * T_end - torch.sum(dlogM, dim=-2)
        dSc[..., -1] += dSend
        dS[:, :, c] = dSc

        dh = (torch.exp(send)[..., None, None] * dh
              + torch.einsum("bhtn,bhtp->bhnp", C[:, None] * E[..., None], dyc))
    return dx, ddt, dS, dB, dC, dD_part


def ssd_xbc_bwd_ref(xbc, dt, S, D, h_in, dy, d_inner: int, chunk: int, dh_fin=None):
    """Plain version of K9: (dxbc (b, l, d + 2n) in xbc's dtype, ddt, dS
    (b, h, nc, q), dD (h,)), by :func:`_bwd_chunks` with the D skip, rounding
    as ``_bwd_head`` at xbc's dtype; the dh of the last chunk is ``dh_fin``
    (b, h, n, p), the cotangent of the forward's h_fin, or 0."""
    b, l, total = xbc.shape
    h = dt.shape[1]
    x, Bc, Cc = _split_xbc(xbc, d_inner, h, chunk)
    acc = x.dtype
    nc, q, n, p = l // chunk, chunk, Bc.shape[-1], x.shape[-1]
    dyh = dy.to(acc).reshape(b, nc, q, h, p).permute(0, 3, 1, 2, 4)
    dh = x.new_zeros((b, h, n, p)) if dh_fin is None else dh_fin.to(acc)
    dx, ddt, dS, dB, dC, dD_part = _bwd_chunks(
        x, dt.to(acc), S.to(acc), Bc, Cc, h_in.to(acc).transpose(1, 2), dyh, dh, D.to(acc),
        mm=xbc.dtype)
    dxbc = torch.cat([dx.permute(0, 2, 3, 1, 4).reshape(b, l, d_inner),
                      dB.reshape(b, l, n), dC.reshape(b, l, n)], dim=-1)
    return dxbc.to(xbc.dtype), ddt, dS, dD_part.sum(dim=(0, 1))


def _split_operands(x, Bc, Cc, h: int, chunk: int):
    """x (b, h, nc, q, p), B and C (b, nc, q, n) from x (b, l, h p) and the
    (b, l, n) B and C, in the plain versions' dtype."""
    b, l, d = x.shape
    n, nc = Bc.shape[-1], l // chunk
    acc = _acc_dtype(x)
    xh = x.to(acc).reshape(b, nc, chunk, h, d // h).permute(0, 3, 1, 2, 4)
    return xh, Bc.to(acc).reshape(b, nc, chunk, n), Cc.to(acc).reshape(b, nc, chunk, n)


def ssd_split_fwd_ref(x, dt, S, Bc, Cc, chunk: int, emit_states: bool = False,
                      emit_hfin: bool = False):
    """Plain version of K6: (y (b, l, h p) in x's dtype, h_in (b, nc, h, n, p)
    or None, h_fin (b, h, n, p) or None, both fp32) for x (b, l, h p), dt, S
    (b, h, nc, q) and the (b, l, n) B and C: :func:`ssd_chunks_ref` with no D
    skip, what ``_make_fwd_kernel`` computes, at bf16 with its roundings."""
    b, l, d = x.shape
    xh, Bh, Ch = _split_operands(x, Bc, Cc, dt.shape[1], chunk)
    dt, S = dt.to(xh.dtype), S.to(xh.dtype)
    rnd = _rounder(x.dtype)
    y, h_in, h_fin = ssd_chunks_ref(rnd(xh * dt[..., None]), S, Bh, Ch, mm=x.dtype)
    y = y.permute(0, 2, 3, 1, 4).reshape(b, l, d).to(x.dtype)
    return (y, h_in.transpose(1, 2).contiguous() if emit_states else None,
            h_fin if emit_hfin else None)


def ssd_split_bwd_ref(x, dt, S, Bc, Cc, h_in, dy, chunk: int, dh_fin=None):
    """Plain version of K7: (dx (b, l, h p), ddt, dS (b, h, nc, q), dB, dC
    (b, l, n)), dx, dB and dC in x's dtype, by :func:`_bwd_chunks` without the
    D skip, rounding as ``_bwd_head`` at x's dtype; the dh carry starts at
    ``dh_fin`` (b, h, n, p), the cotangent of the forward's h_fin, or at 0."""
    b, l, d = x.shape
    h = dt.shape[1]
    xh, Bh, Ch = _split_operands(x, Bc, Cc, h, chunk)
    acc = xh.dtype
    nc, n, p = l // chunk, Bh.shape[-1], d // h
    dyh = dy.to(acc).reshape(b, nc, chunk, h, p).permute(0, 3, 1, 2, 4)
    dh = xh.new_zeros((b, h, n, p)) if dh_fin is None else dh_fin.to(acc)
    dx, ddt, dS, dB, dC, _ = _bwd_chunks(xh, dt.to(acc), S.to(acc), Bh, Ch,
                                         h_in.to(acc).transpose(1, 2), dyh, dh, mm=x.dtype)
    dx = dx.permute(0, 2, 3, 1, 4).reshape(b, l, d).to(x.dtype)
    return dx, ddt, dS, dB.reshape(b, l, n).to(x.dtype), dC.reshape(b, l, n).to(x.dtype)


@functools.cache
def _fwd_library() -> ctypes.CDLL:
    return fwd_interface(load_library("ssd_xbc_fwd"))


@functools.cache
def _bwd_library() -> ctypes.CDLL:
    return bwd_interface(load_library("ssd_xbc_bwd"))


@functools.cache
def _sm90_library() -> ctypes.CDLL:
    return sm90_interface(load_library(SM90_SOURCE))


_I, _LL, _P = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
# The C entry points of the ``ssd_xbc_fwd`` library by name, each with its
# argument list, which its ``_bf16`` twin shares: the pointers, h_in (or the
# lean forward's scratch for the states entering chunks 1 .. nc - 1) and G's
# scratch each with its float count, the states flag (and for K6 and K8 with
# the carry h_fin; K6 takes null for none), the geometry, the operands'
# strides, the stream.
FWD_ENTRIES = {"ssd_xbc_fwd": [_P] * 6 + [_LL, _I, _P, _LL] + [_I] * 7 + [_LL] * 2 + [_P],
               "ssd_xbc_fwd_hfin": [_P] * 6 + [_LL, _I, _P, _P, _LL] + [_I] * 7 + [_LL] * 2
               + [_P],
               "ssd_split_fwd": [_P] * 7 + [_LL, _I, _P, _P, _LL] + [_I] * 6 + [_LL] * 6 + [_P]}
# those of the ``ssd_xbc_bwd`` library: the pointers (the seeded K9's with
# dh_fin after dy; K7 takes null for none), (K9) dD's partials and the
# scratch each with its float count, the geometry, the operands' strides, the
# stream.
BWD_ENTRIES = {"ssd_xbc_bwd": [_P] * 10 + [_LL, _P, _LL] + [_I] * 7 + [_LL] * 4 + [_P],
               "ssd_xbc_bwd_seeded": [_P] * 11 + [_LL, _P, _LL] + [_I] * 7 + [_LL] * 4 + [_P],
               "ssd_split_bwd": [_P] * 13 + [_LL] + [_I] * 6 + [_LL] * 8 + [_P]}


# those of the ``ssd_xbc_bf16_sm90`` library: K8 (the pointers, h_in or the
# lean scratch with its float count, the states flag, h_fin or null, the bf16
# copy of the states with its element count, the geometry, xbc's strides, the
# stream) and K9 (the pointers, dh_fin or null among them, dD's partials and
# the scratch each with its float count, the geometry, the operands' strides,
# the stream).
SM90_ENTRIES = {"ssd_sm90_fwd": [_P] * 6 + [_LL, _I, _P, _P, _LL] + [_I] * 7 + [_LL] * 2 + [_P],
                "ssd_sm90_bwd": [_P] * 11 + [_LL, _P, _LL] + [_I] * 7 + [_LL] * 4 + [_P]}


def _declare(lib: ctypes.CDLL, entries: dict, error_string: str) -> ctypes.CDLL:
    for name, argtypes in entries.items():
        for fn in (getattr(lib, name), getattr(lib, name + "_bf16")):
            fn.argtypes, fn.restype = argtypes, _I
    getattr(lib, error_string).argtypes = [_I]
    getattr(lib, error_string).restype = ctypes.c_char_p
    return lib


def fwd_interface(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of K8 and K6 in a built ``ssd_xbc_fwd``
    library, each entry point with its ``_bf16`` twin (``FWD_ENTRIES``)."""
    return _declare(lib, FWD_ENTRIES, "ssd_xbc_fwd_error_string")


def bwd_interface(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of K9 and K7 in a built ``ssd_xbc_bwd``
    library, each entry point with its ``_bf16`` twin (``BWD_ENTRIES``)."""
    return _declare(lib, BWD_ENTRIES, "ssd_xbc_bwd_error_string")


def sm90_interface(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of the Hopper bf16 K8/K9 body in a built
    ``ssd_xbc_bf16_sm90`` library (``SM90_ENTRIES``)."""
    for name, argtypes in SM90_ENTRIES.items():
        getattr(lib, name).argtypes, getattr(lib, name).restype = argtypes, _I
    lib.ssd_sm90_bwd_scratch_floats.argtypes = [_I] * 5
    lib.ssd_sm90_bwd_scratch_floats.restype = _LL
    lib.ssd_sm90_error_string.argtypes, lib.ssd_sm90_error_string.restype = [_I], ctypes.c_char_p
    return lib


def carry_parts(n: int, p: int) -> int:
    """The blocks a (batch row, head) of the carry passes, four state
    elements a thread (carry_parts in both sources): 16 at n = p = 128."""
    return n * p // (256 * 4)


def bwd_scratch_floats(b: int, l: int, h: int, chunk: int, n: int, p: int) -> int:
    """The floats of K9's and K7's scratch, in the order the C side carves
    it: G and the head sum of dG (b, nc, q, q) each, the dh carry
    (b, nc, h, n, p), the row and column sums of dlogM (b, h, nc, tile pairs,
    STRIP) each, dT and dE (b, h, l) each, and the partials of
    sum(dh (.) h_in) (b, h, nc, carry_parts(n, p))."""
    nc, t = l // chunk, chunk // STRIP
    pairs = t * (t + 1) // 2
    return (2 * b * nc * chunk * chunk + b * nc * h * n * p
            + 2 * b * h * nc * pairs * STRIP + 2 * b * h * l + b * h * nc * carry_parts(n, p))


def sm90_bwd_scratch_floats(b: int, l: int, h: int, chunk: int, seeded: bool = False) -> int:
    """The floats of the Hopper bf16 K9's scratch, in the order the C side
    carves it: the head sum of bf16(dG) (b, nc, q, q); the dh carry
    (b, nc - 1, h, n, p), a slot more when ``seeded`` (dh_fin's); h_in of
    chunks 1 .. nc - 1 in bf16 (half a float an element); the row and column
    sums of dlogM (b, h, nc, tile pairs, STRIP) each; dT (b, h, l); dE's sums
    over the two halves of n (2, b, h, l); the two halves' sums of dh (.) h_in
    (b, h, nc, 2)."""
    nc, t = l // chunk, chunk // STRIP
    pairs = t * (t + 1) // 2
    state = h * STATE * HEAD_DIM
    return (b * nc * chunk * chunk + b * (nc - 1 + int(seeded)) * state
            + b * (nc - 1) * state // 2 + 2 * b * h * nc * pairs * STRIP + 3 * b * h * l
            + 2 * b * h * nc)


def _check_geometry(n: int, p: int, l: int, chunk: int) -> None:
    if n <= 0 or p <= 0 or n % STATE_TILE or p % STATE_TILE:
        raise ValueError(f"the SSD kernels are built for d_state and head_dim that are "
                         f"multiples of {STATE_TILE}, as the JAX kernels compile; got "
                         f"d_state {n} and head_dim {p}")
    if chunk % CHUNK_ALIGN or not 0 < chunk <= MAX_CHUNK:
        raise ValueError(f"the SSD kernels take a chunk that is a multiple of {CHUNK_ALIGN} "
                         f"up to {MAX_CHUNK}, got {chunk}")
    if l % chunk:
        raise ValueError(f"L={l} is not a multiple of chunk={chunk}; pad first")


def chunk_variant(chunk: int) -> str:
    """The variant that runs ``chunk``: '' (the strips of the tuned kernels,
    a multiple of 64 up to 256), '_strip' (laid out in 64-row strips, any
    chunk that is not a multiple of 64) or '_long' (a multiple of 64 above
    256, the per-chunk arrays sized at launch)."""
    if chunk % STRIP:
        return "_strip"
    return "_long" if chunk > TUNED_CHUNK else ""


def sm90_serves(dtype: torch.dtype, chunk: int, n: int, p: int) -> bool:
    """Whether the Hopper bf16 body (``csrc/ssd_xbc_bf16_sm90.cu``) runs a
    K8 or K9 call: bf16 activations, n = p = 128 and a chunk of
    :data:`SM90_CHUNKS`, with or without h_fin or a seeded carry."""
    return dtype == torch.bfloat16 and (n, p) == (STATE, HEAD_DIM) and chunk in SM90_CHUNKS


def kernel_variant(chunk: int, n: int, p: int, dtype: torch.dtype | None = None) -> str:
    """The variant that runs ``chunk`` at d_state ``n`` and head_dim ``p``:
    '_sm90' where the Hopper bf16 body serves a K8/K9 call at ``dtype``
    (:func:`sm90_serves`), else :func:`chunk_variant`, followed by '_wide'
    unless n = p = 128 (the wide instantiation). K6/K7 calls pass no dtype."""
    if dtype is not None and sm90_serves(dtype, chunk, n, p):
        return "_sm90"
    return chunk_variant(chunk) + ("" if (n, p) == (STATE, HEAD_DIM) else "_wide")


def _strip_len(chunk: int) -> int:
    return -(-chunk // STRIP) * STRIP


def _to_strips(t: torch.Tensor, chunk: int) -> torch.Tensor:
    """Rows (b, nc q, c) of any strides laid out in strips: (b, nc qs, c)
    contiguous, each chunk's q rows followed by qs - q zero rows."""
    b, l, c = t.shape
    nc, qs = l // chunk, _strip_len(chunk)
    out = t.new_zeros((b, nc, qs, c))
    out[:, :, :chunk] = t.reshape(b, nc, chunk, c)
    return out.reshape(b, nc * qs, c)


def _from_strips(t: torch.Tensor, chunk: int) -> torch.Tensor:
    """The inverse of :func:`_to_strips` on rows (b, nc qs, c)."""
    b, ls, c = t.shape
    qs = _strip_len(chunk)
    return t.reshape(b, ls // qs, qs, c)[:, :, :chunk].reshape(b, ls // qs * chunk, c)


def _dt_s_to_strips(dt: torch.Tensor, S: torch.Tensor, chunk: int):
    """dt and S (b, h, nc, q) in strips: dt 0 on the added rows, S held at
    the chunk's last value (no decay, no input)."""
    pad = _strip_len(chunk) - chunk
    return (F.pad(dt, (0, pad)).contiguous(),
            torch.cat([S, S[..., -1:].expand(*S.shape[:-1], pad)], dim=-1).contiguous())


def _ds_from_strips(dS: torch.Tensor, chunk: int) -> torch.Tensor:
    """dS (b, h, nc, qs) back to the chunk: the added rows hold copies of the
    last S, so their cotangents add onto it."""
    out = dS[..., :chunk].clone()
    out[..., -1] += dS[..., chunk:].sum(-1)
    return out


def _strip_operands(chunk: int, dt: torch.Tensor, S: torch.Tensor, *rows: torch.Tensor):
    """The operands of a chunk that is no multiple of STRIP, laid out in
    strips: (the strip length to launch at, dt, S, *rows)."""
    return (_strip_len(chunk), *_dt_s_to_strips(dt, S, chunk),
            *(_to_strips(r, chunk) for r in rows))


def _grads_from_strips(chunk: int, ddt: torch.Tensor, dS: torch.Tensor, *rows: torch.Tensor):
    """A backward's outputs laid out in strips, back to the chunk: (ddt, dS,
    *rows)."""
    return (ddt[..., :chunk].contiguous(), _ds_from_strips(dS, chunk),
            *(_from_strips(r, chunk) for r in rows))


# the activation operands, which are fp32 or bf16 (one dtype a call); every
# other operand is fp32
ACTIVATIONS = ("xbc", "x", "B", "C", "dy")


def _check_dtype_device(named: dict, device) -> None:
    act = next(t.dtype for name, t in named.items() if name in ACTIVATIONS)
    if act not in KERNEL_DTYPES:
        raise TypeError(f"the SSD kernels take float32 or bfloat16 activations, got {act}")
    for name, t in named.items():
        want = act if name in ACTIVATIONS else torch.float32
        if t.dtype != want:
            raise TypeError(f"the SSD kernels take {name} in {want}; it is {t.dtype}")
        if not t.is_cuda or t.device != device:
            raise ValueError(f"{name} must lie on the first input's CUDA device")
        if name in ACTIVATIONS and act == torch.bfloat16 and (
                t.data_ptr() % 4 or any(st % 2 for st in t.stride()[:-1])):
            raise ValueError(f"the bf16 SSD kernels need {name}'s rows 4-byte aligned")


def _check_layout(named: dict, shapes: dict, strided: tuple) -> None:
    """The expected shapes; the names in ``strided`` need unit stride along
    their last axis only, the others contiguity."""
    for name, t in named.items():
        if name in shapes and tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shapes[name]}")
        if name in strided:
            if t.stride(-1) != 1:
                raise ValueError(f"the SSD kernels need unit stride along {name}'s last axis")
        elif not t.is_contiguous():
            raise ValueError(f"the SSD kernels need {name} contiguous")


def _check_inputs(xbc, dt, S, D, d_inner: int, chunk: int, extra: dict | None = None):
    """Raise for anything K8/K9 do not take; returns (b, l, h, n, p)."""
    b, l, total = xbc.shape
    h = dt.shape[1] if dt.dim() == 4 else -1
    named = dict(xbc=xbc, dt=dt, S=S, D=D) | (extra or {})
    _check_dtype_device(named, xbc.device)
    n, p = (total - d_inner) // 2, d_inner // max(h, 1)
    if h < 1 or d_inner % h or 2 * n + d_inner != total:
        raise ValueError(f"xbc {tuple(xbc.shape)} does not split into d_inner={d_inner} "
                         f"and two equal B/C blocks over dt's heads {tuple(dt.shape)}")
    _check_geometry(n, p, l, chunk)
    nc = l // chunk
    _check_layout(named, dict(dt=(b, h, nc, chunk), S=(b, h, nc, chunk), D=(h,),
                              h_in=(b, nc, h, n, p), dy=(b, l, d_inner),
                              dh_fin=(b, h, n, p)), ("xbc", "dy"))
    return b, l, h, n, p


def _check_split(x, dt, S, Bm, Cm, chunk: int, extra: dict | None = None):
    """Raise for anything K6/K7 do not take; returns (b, l, h, n, p)."""
    b, l, d = x.shape
    h = dt.shape[1] if dt.dim() == 4 else -1
    named = dict(x=x, dt=dt, S=S, B=Bm, C=Cm) | (extra or {})
    _check_dtype_device(named, x.device)
    if h < 1 or d % h:
        raise ValueError(f"x {tuple(x.shape)} does not split over dt's heads {tuple(dt.shape)}")
    n, p = Bm.shape[-1], d // h
    _check_geometry(n, p, l, chunk)
    nc = l // chunk
    _check_layout(named, dict(dt=(b, h, nc, chunk), S=(b, h, nc, chunk), B=(b, l, n),
                              C=(b, l, n), h_in=(b, nc, h, n, p), dy=(b, l, d),
                              dh_fin=(b, h, n, p)), ("x", "B", "C", "dy"))
    return b, l, h, n, p


def _fwd_buffers(b: int, l: int, h: int, n: int, p: int, chunk: int, states: bool, dtype,
                 device):
    """y (b, l, h p) in ``dtype``; h_in (b, nc, h, n, p) with ``states``, else
    the lean forward's scratch for the states entering chunks 1 .. nc - 1; G's
    scratch (b, nc, q, q)."""
    f32 = dict(dtype=torch.float32, device=device)
    nc = l // chunk
    return (torch.empty((b, l, h * p), dtype=dtype, device=device),
            torch.empty((b, nc if states else nc - 1, h, n, p), **f32),
            torch.empty((b, nc, chunk, chunk), **f32))


def _raise_on(error_string, err: int, what: str) -> None:
    """Raise for a non-zero cudaError_t code, named by the library's
    ``error_string``."""
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: {error_string(err).decode()} ({err})")


def run_fwd(lib, xbc, dt, S, D, d_inner: int, chunk: int, states: bool, stream,
            hfin: bool = False):
    """Allocate K8's outputs and scratch beside xbc and launch it through
    ``lib`` (a library with :func:`fwd_interface`) on ``stream``: (y,
    h_in or None), and with ``hfin`` (the ``ssd_xbc_fwd_hfin`` entry point)
    also h_fin (b, h, n, p). Checks nothing; :func:`_launch_fwd` checks
    first."""
    if chunk % STRIP:
        qs, dts, Ss, xs = _strip_operands(chunk, dt, S, xbc)
        y, *rest = run_fwd(lib, xs, dts, Ss, D, d_inner, qs, states, stream, hfin=hfin)
        return (_from_strips(y, chunk), *rest)
    b, l, total = xbc.shape
    h, n = dt.shape[1], (total - d_inner) // 2
    p = d_inner // h
    y, hin, G = _fwd_buffers(b, l, h, n, p, chunk, states, xbc.dtype, xbc.device)
    name = "ssd_xbc_fwd_hfin" if hfin else "ssd_xbc_fwd"
    entry = getattr(lib, name + ("_bf16" if xbc.dtype == torch.bfloat16 else ""))
    h_fin = torch.empty((b, h, n, p), dtype=torch.float32, device=xbc.device) if hfin \
        else None
    if y.numel():
        _raise_on(lib.ssd_xbc_fwd_error_string, entry(
            xbc.data_ptr(), dt.data_ptr(), S.data_ptr(), D.data_ptr(), y.data_ptr(),
            hin.data_ptr(), hin.numel(), int(states),
            *((h_fin.data_ptr(),) if hfin else ()), G.data_ptr(), G.numel(), b, l, h,
            d_inner, n, p, chunk, xbc.stride(0), xbc.stride(1), stream), "SSD forward")
    elif hfin:
        h_fin.zero_()
    out = (y, hin if states else None)
    return (*out, h_fin) if hfin else out


def run_split_fwd(lib, x, dt, S, Bm, Cm, chunk: int, states: bool, hfin: bool, stream):
    """Allocate K6's outputs and scratch beside x and launch it through
    ``lib`` (a library with :func:`fwd_interface`) on ``stream``: (y, h_in or
    None, h_fin or None). Checks nothing; :func:`_launch_split_fwd` checks
    first."""
    if chunk % STRIP:
        qs, dts, Ss, xs, Bs, Cs = _strip_operands(chunk, dt, S, x, Bm, Cm)
        y, hin, h_fin = run_split_fwd(lib, xs, dts, Ss, Bs, Cs, qs, states, hfin, stream)
        return _from_strips(y, chunk), hin, h_fin
    b, l, d = x.shape
    h, n = dt.shape[1], Bm.shape[-1]
    y, hin, G = _fwd_buffers(b, l, h, n, d // h, chunk, states, x.dtype, x.device)
    entry = lib.ssd_split_fwd_bf16 if x.dtype == torch.bfloat16 else lib.ssd_split_fwd
    h_fin = torch.empty((b, h, n, d // h), dtype=torch.float32, device=x.device) if hfin \
        else None
    if y.numel() == 0:
        return y, (hin if states else None), (h_fin.zero_() if hfin else None)
    _raise_on(lib.ssd_xbc_fwd_error_string, entry(
        x.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), dt.data_ptr(), S.data_ptr(), y.data_ptr(),
        hin.data_ptr(), hin.numel(), int(states), h_fin.data_ptr() if hfin else None,
        G.data_ptr(), G.numel(), b, l, h, n, d // h, chunk, x.stride(0), x.stride(1),
        Bm.stride(0), Bm.stride(1), Cm.stride(0), Cm.stride(1), stream), "split SSD forward")
    return y, (hin if states else None), h_fin


def run_bwd(lib, xbc, dt, S, D, h_in, dy, d_inner: int, chunk: int, stream, dh_fin=None):
    """Allocate K9's outputs and scratch beside xbc and launch it through
    ``lib`` (a library with :func:`bwd_interface`) on ``stream``, its carry
    seeded with ``dh_fin`` (the ``ssd_xbc_bwd_seeded`` entry point) unless
    that is None: (dxbc, ddt, dS, dD). Checks nothing; :func:`_launch_bwd`
    checks first."""
    if chunk % STRIP:
        qs, dts, Ss, xs, dys = _strip_operands(chunk, dt, S, xbc, dy)
        dxbc, ddt, dS, dD = run_bwd(lib, xs, dts, Ss, D, h_in, dys, d_inner, qs, stream,
                                    dh_fin=dh_fin)
        ddt, dS, dxbc = _grads_from_strips(chunk, ddt, dS, dxbc)
        return dxbc, ddt, dS, dD
    b, l, total = xbc.shape
    h, nc = dt.shape[1], l // chunk
    n = (total - d_inner) // 2
    f32 = dict(dtype=torch.float32, device=xbc.device)
    dxbc = torch.empty((b, l, total), dtype=xbc.dtype, device=xbc.device)
    name = "ssd_xbc_bwd" if dh_fin is None else "ssd_xbc_bwd_seeded"
    entry = getattr(lib, name + ("_bf16" if xbc.dtype == torch.bfloat16 else ""))
    ddt, dS = torch.empty((b, h, nc, chunk), **f32), torch.empty((b, h, nc, chunk), **f32)
    if dxbc.numel() == 0:
        return dxbc.zero_(), ddt, dS, torch.zeros_like(D)
    dD_part = torch.empty((b, h, nc, chunk // STRIP), **f32)
    scratch = torch.empty(bwd_scratch_floats(b, l, h, chunk, n, d_inner // h), **f32)
    _raise_on(lib.ssd_xbc_bwd_error_string, entry(
        xbc.data_ptr(), dt.data_ptr(), S.data_ptr(), D.data_ptr(), h_in.data_ptr(),
        dy.data_ptr(), *(() if dh_fin is None else (dh_fin.data_ptr(),)), dxbc.data_ptr(),
        ddt.data_ptr(), dS.data_ptr(), dD_part.data_ptr(),
        dD_part.numel(), scratch.data_ptr(), scratch.numel(), b, l, h, d_inner, n,
        d_inner // h, chunk, xbc.stride(0), xbc.stride(1), dy.stride(0), dy.stride(1), stream),
        "SSD backward")
    return dxbc, ddt, dS, dD_part.sum(dim=(0, 2, 3))


def tma_rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` (b, l, w) where the tensor memory accelerator can read its rows
    (its start and its batch and row strides 16-byte aligned, unit stride
    along w), else a contiguous copy of it."""
    size = t.element_size()
    if (t.stride(2) == 1 and t.data_ptr() % 16 == 0
            and all(s * size % 16 == 0 for s in t.stride()[:2])):
        return t
    return torch.empty(t.shape, dtype=t.dtype, device=t.device).copy_(t)


def run_sm90_fwd(lib, xbc, dt, S, D, d_inner: int, chunk: int, states: bool, stream,
                 hfin: bool = False):
    """Allocate the Hopper bf16 K8's outputs and scratch beside xbc and launch
    it through ``lib`` (a library with :func:`sm90_interface`) on ``stream``:
    (y, h_in or None), and with ``hfin`` also h_fin (b, h, n, p) fp32. Its
    scratch: the lean forward's states entering chunks 1 .. nc - 1, and those
    states rounded to bf16 (the operand of C h_in); no G scratch. xbc goes
    through :func:`tma_rows`. Checks nothing else; :func:`_launch_fwd` checks
    first."""
    b, l, total = xbc.shape
    h, n = dt.shape[1], (total - d_inner) // 2
    nc, p = l // chunk, d_inner // h
    xbc = tma_rows(xbc)
    y = torch.empty((b, l, d_inner), dtype=xbc.dtype, device=xbc.device)
    hin = torch.empty((b, nc if states else nc - 1, h, n, p), dtype=torch.float32,
                      device=xbc.device)
    hin16 = torch.empty((b, nc - 1, h, n, p), dtype=xbc.dtype, device=xbc.device)
    h_fin = torch.empty((b, h, n, p), dtype=torch.float32, device=xbc.device) if hfin \
        else None
    if y.numel():
        _raise_on(lib.ssd_sm90_error_string, lib.ssd_sm90_fwd(
            xbc.data_ptr(), dt.data_ptr(), S.data_ptr(), D.data_ptr(), y.data_ptr(),
            hin.data_ptr(), hin.numel(), int(states), h_fin.data_ptr() if hfin else None,
            hin16.data_ptr(), hin16.numel(), b, l, h, d_inner, n, p, chunk, xbc.stride(0),
            xbc.stride(1), stream), "Hopper bf16 SSD forward")
    elif hfin:
        h_fin.zero_()
    out = y, (hin if states else None)
    return (*out, h_fin) if hfin else out


def run_sm90_bwd(lib, xbc, dt, S, D, h_in, dy, d_inner: int, chunk: int, stream, dh_fin=None):
    """Allocate the Hopper bf16 K9's outputs and scratch
    (:func:`sm90_bwd_scratch_floats`) beside xbc and launch it through
    ``lib`` on ``stream``, its carry seeded with ``dh_fin`` unless that is
    None: (dxbc, ddt, dS, dD). xbc and dy go through :func:`tma_rows`. Checks
    nothing else; :func:`_launch_bwd` checks first."""
    b, l, total = xbc.shape
    h, nc = dt.shape[1], l // chunk
    n = (total - d_inner) // 2
    f32 = dict(dtype=torch.float32, device=xbc.device)
    dxbc = torch.empty((b, l, total), dtype=xbc.dtype, device=xbc.device)
    ddt, dS = torch.empty((b, h, nc, chunk), **f32), torch.empty((b, h, nc, chunk), **f32)
    if dxbc.numel() == 0:
        return dxbc.zero_(), ddt, dS, torch.zeros_like(D)
    xbc, dy = tma_rows(xbc), tma_rows(dy)
    dD_part = torch.empty((b, h, nc, chunk // STRIP), **f32)
    scratch = torch.empty(sm90_bwd_scratch_floats(b, l, h, chunk, dh_fin is not None), **f32)
    _raise_on(lib.ssd_sm90_error_string, lib.ssd_sm90_bwd(
        xbc.data_ptr(), dt.data_ptr(), S.data_ptr(), D.data_ptr(), h_in.data_ptr(),
        dy.data_ptr(), None if dh_fin is None else dh_fin.data_ptr(), dxbc.data_ptr(),
        ddt.data_ptr(), dS.data_ptr(), dD_part.data_ptr(), dD_part.numel(), scratch.data_ptr(),
        scratch.numel(), b, l, h, d_inner, n, d_inner // h, chunk, xbc.stride(0),
        xbc.stride(1), dy.stride(0), dy.stride(1), stream), "Hopper bf16 SSD backward")
    return dxbc, ddt, dS, dD_part.sum(dim=(0, 2, 3))


def run_split_bwd(lib, x, dt, S, Bm, Cm, h_in, dy, chunk: int, dh_fin, stream):
    """Allocate K7's outputs and scratch beside x and launch it through
    ``lib`` (a library with :func:`bwd_interface`) on ``stream``, its carry
    seeded with ``dh_fin`` unless that is None: (dx, ddt, dS, dB, dC), dB and
    dC the two halves of one (b, l, 2n) buffer. Checks nothing;
    :func:`_launch_split_bwd` checks first."""
    if chunk % STRIP:
        qs, dts, Ss, xs, Bs, Cs, dys = _strip_operands(chunk, dt, S, x, Bm, Cm, dy)
        dx, ddt, dS, dB, dC = run_split_bwd(lib, xs, dts, Ss, Bs, Cs, h_in, dys, qs, dh_fin,
                                            stream)
        ddt, dS, dx, dB, dC = _grads_from_strips(chunk, ddt, dS, dx, dB, dC)
        return dx, ddt, dS, dB, dC
    b, l, d = x.shape
    h, n = dt.shape[1], Bm.shape[-1]
    f32 = dict(dtype=torch.float32, device=x.device)
    act = dict(dtype=x.dtype, device=x.device)
    dx, dbc = torch.empty((b, l, d), **act), torch.empty((b, l, 2 * n), **act)
    ddt, dS = torch.empty_like(dt), torch.empty_like(S)
    entry = lib.ssd_split_bwd_bf16 if x.dtype == torch.bfloat16 else lib.ssd_split_bwd
    if dx.numel():
        scratch = torch.empty(bwd_scratch_floats(b, l, h, chunk, n, d // h), **f32)
        _raise_on(lib.ssd_xbc_bwd_error_string, entry(
            x.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), dt.data_ptr(), S.data_ptr(),
            h_in.data_ptr(), dy.data_ptr(), None if dh_fin is None else dh_fin.data_ptr(),
            dx.data_ptr(), dbc.data_ptr(), ddt.data_ptr(), dS.data_ptr(), scratch.data_ptr(),
            scratch.numel(), b, l, h, n, d // h, chunk, x.stride(0), x.stride(1),
            Bm.stride(0), Bm.stride(1), Cm.stride(0), Cm.stride(1), dy.stride(0),
            dy.stride(1), stream), "split SSD backward")
    else:
        dbc.zero_()
    return dx, ddt, dS, dbc[..., :n], dbc[..., n:]


def _launch_fwd(xbc, dt, S, D, d_inner: int, chunk: int, states: bool, hfin: bool = False):
    _, _, _, n, p = _check_inputs(xbc, dt, S, D, d_inner, chunk)
    variant = kernel_variant(chunk, n, p, xbc.dtype)
    with torch.cuda.device(xbc.device):
        stream = torch.cuda.current_stream(xbc.device).cuda_stream
        if variant == "_sm90":
            out = run_sm90_fwd(_sm90_library(), xbc, dt, S, D, d_inner, chunk, states, stream,
                               hfin=hfin)
        else:
            out = run_fwd(_fwd_library(), xbc, dt, S, D, d_inner, chunk, states, stream,
                          hfin=hfin)
    if out[0].numel():
        _count(_XBC_FWD[(states, hfin, xbc.dtype == torch.bfloat16)], variant)
    return out


def _launch_bwd(xbc, dt, S, D, h_in, dy, d_inner: int, chunk: int, dh_fin=None):
    extra = dict(h_in=h_in, dy=dy) | ({} if dh_fin is None else dict(dh_fin=dh_fin))
    _, _, _, n, p = _check_inputs(xbc, dt, S, D, d_inner, chunk, extra)
    variant = kernel_variant(chunk, n, p, xbc.dtype)
    with torch.cuda.device(xbc.device):
        stream = torch.cuda.current_stream(xbc.device).cuda_stream
        if variant == "_sm90":
            out = run_sm90_bwd(_sm90_library(), xbc, dt, S, D, h_in, dy, d_inner, chunk, stream,
                               dh_fin=dh_fin)
        else:
            out = run_bwd(_bwd_library(), xbc, dt, S, D, h_in, dy, d_inner, chunk, stream,
                          dh_fin=dh_fin)
    if out[0].numel():
        bf16 = xbc.dtype == torch.bfloat16
        if dh_fin is None:
            _count(ssd_xbc_bwd_bf16 if bf16 else ssd_xbc_bwd, variant)
        else:
            _count(ssd_xbc_bwd_seeded_bf16 if bf16 else ssd_xbc_bwd_seeded, variant)
    return out


def ssd_xbc_fwd(xbc, dt, S, D, d_inner: int, chunk: int) -> torch.Tensor:
    """Lean forward (K8 without states): y (b, l, d). xbc (b, l, d + 2n) needs
    unit stride only along its last axis; dt, S (b, h, nc, q) and D (h,)
    contiguous. The kernel on a CUDA tensor (or an error), the y of
    :func:`ssd_xbc_fwd_ref` on the CPU. ``ssd_xbc_fwd.launches`` counts
    kernel launches."""
    if xbc.is_cuda:
        return _launch_fwd(xbc, dt, S, D, d_inner, chunk, states=False)[0]
    return ssd_xbc_fwd_ref(xbc, dt, S, D, d_inner, chunk)[0]


def ssd_xbc_fwd_states(xbc, dt, S, D, d_inner: int, chunk: int):
    """Training forward (K8 with states): (y, h_in (b, nc, h, n, p) fp32), the
    state entering each chunk. The kernel on a CUDA tensor,
    :func:`ssd_xbc_fwd_ref` on the CPU. ``ssd_xbc_fwd_states.launches``
    counts kernel launches."""
    if xbc.is_cuda:
        return _launch_fwd(xbc, dt, S, D, d_inner, chunk, states=True)
    return ssd_xbc_fwd_ref(xbc, dt, S, D, d_inner, chunk, emit_states=True)


def ssd_xbc_bwd(xbc, dt, S, D, h_in, dy, d_inner: int, chunk: int):
    """Backward (K9): (dxbc, ddt, dS, dD) for the output gradient dy (b, l, d)
    and the forward's h_in. The kernel on a CUDA tensor (dy needs unit stride
    only along its last axis), :func:`ssd_xbc_bwd_ref` on the CPU.
    ``ssd_xbc_bwd.launches`` counts kernel launches."""
    if xbc.is_cuda:
        return _launch_bwd(xbc, dt, S, D, h_in, dy, d_inner, chunk)
    return ssd_xbc_bwd_ref(xbc, dt, S, D, h_in, dy, d_inner, chunk)


def ssd_xbc_fwd_hfin(xbc, dt, S, D, d_inner: int, chunk: int):
    """Lean forward with the carry (K8 with h_fin): (y, h_fin (b, h, n, p)
    fp32), the state after the last chunk from a zero start. The kernel on a
    CUDA tensor, :func:`ssd_xbc_fwd_ref` on the CPU."""
    if xbc.is_cuda:
        y, _, h_fin = _launch_fwd(xbc, dt, S, D, d_inner, chunk, states=False, hfin=True)
        return y, h_fin
    y, _, h_fin = ssd_xbc_fwd_ref(xbc, dt, S, D, d_inner, chunk, emit_hfin=True)
    return y, h_fin


def ssd_xbc_fwd_states_hfin(xbc, dt, S, D, d_inner: int, chunk: int):
    """Training forward with the carry (K8 with states and h_fin): (y, h_in,
    h_fin)."""
    if xbc.is_cuda:
        return _launch_fwd(xbc, dt, S, D, d_inner, chunk, states=True, hfin=True)
    return ssd_xbc_fwd_ref(xbc, dt, S, D, d_inner, chunk, emit_states=True, emit_hfin=True)


def ssd_xbc_bwd_seeded(xbc, dt, S, D, h_in, dy, dh_fin, d_inner: int, chunk: int):
    """Seeded backward (K9 with dh_fin): as :func:`ssd_xbc_bwd`, the carry
    starting at ``dh_fin`` (b, h, n, p) fp32 contiguous, the cotangent of the
    forward's h_fin."""
    if xbc.is_cuda:
        return _launch_bwd(xbc, dt, S, D, h_in, dy, d_inner, chunk, dh_fin=dh_fin)
    return ssd_xbc_bwd_ref(xbc, dt, S, D, h_in, dy, d_inner, chunk, dh_fin=dh_fin)


class SSDChunkedXbcFn(torch.autograd.Function):
    """The boundary-fused core with its backward: K8 with states forward and
    K9 backward on a CUDA tensor, the plain versions on the CPU. Inputs
    (xbc, dt, S, D, d_inner, chunk) as :func:`ssd_xbc_fwd`."""

    @staticmethod
    def forward(ctx, xbc, dt, S, D, d_inner, chunk):
        y, h_in = ssd_xbc_fwd_states(xbc, dt, S, D, d_inner, chunk)
        ctx.save_for_backward(xbc, dt, S, D, h_in)
        ctx.d_inner, ctx.chunk = d_inner, chunk
        return y

    @staticmethod
    def backward(ctx, dy):
        if dy.stride(-1) != 1:
            dy = dy.contiguous()
        xbc, dt, S, D, h_in = ctx.saved_tensors
        dxbc, ddt, dS, dD = ssd_xbc_bwd(xbc, dt, S, D, h_in, dy, ctx.d_inner, ctx.chunk)
        return dxbc, ddt, dS, dD, None, None


class SSDChunkedXbcCarryFn(torch.autograd.Function):
    """The boundary-fused core that also returns the state after the last
    chunk: (y, h_fin) by K8 with states and h_fin; the backward hands h_fin's
    cotangent to K9 as the seed of its carry. The plain versions on the CPU.
    Inputs as :class:`SSDChunkedXbcFn`."""

    @staticmethod
    def forward(ctx, xbc, dt, S, D, d_inner, chunk):
        y, h_in, h_fin = ssd_xbc_fwd_states_hfin(xbc, dt, S, D, d_inner, chunk)
        ctx.save_for_backward(xbc, dt, S, D, h_in)
        ctx.d_inner, ctx.chunk = d_inner, chunk
        return y, h_fin

    @staticmethod
    def backward(ctx, dy, dh_fin):
        if dy.stride(-1) != 1:
            dy = dy.contiguous()
        xbc, dt, S, D, h_in = ctx.saved_tensors
        dxbc, ddt, dS, dD = ssd_xbc_bwd_seeded(xbc, dt, S, D, h_in, dy, dh_fin.contiguous(),
                                               ctx.d_inner, ctx.chunk)
        return dxbc, ddt, dS, dD, None, None


def ssd_chunked_xbc(xbc, dt, A, D, *, d_inner: int, chunk: int = 128,
                    return_carry: bool = False):
    """The counterpart of ``ssd_chunked_pallas_xbc``: the SSD core with the D
    skip on the conv's un-split output. xbc (b, l, d + 2n) with columns
    [x | B | C]; dt (b, l, h) post-softplus; A (h,) negative; D (h,).
    Returns y (b, l, d), or with ``return_carry`` (y, total_decay (b, h),
    h_fin (b, h, n, p) fp32): the slice's total decay exp(sum of each chunk's
    last S) and the state after the last chunk from a zero start, the
    contract of ``ssd_chunked_pallas_xbc(return_carry=True)``. L must be a
    multiple of ``chunk`` (the callers pad).

    S = cumsum(dt A) per chunk and the total decay are computed here, outside
    the autograd Functions, so autograd chains dS into ddt and dA. With a
    gradient wanted this is :class:`SSDChunkedXbcFn` (with ``return_carry``
    :class:`SSDChunkedXbcCarryFn`), else the lean forward (K8 without states,
    with h_fin for ``return_carry``, on a CUDA tensor)."""
    b, l, _ = xbc.shape
    h = dt.shape[-1]
    if l % chunk:
        raise ValueError(f"L={l} is not a multiple of chunk={chunk}; pad first")
    acc = _acc_dtype(xbc)
    dth = dt.to(acc).transpose(1, 2).reshape(b, h, l // chunk, chunk).contiguous()
    S = torch.cumsum(dth * A.to(acc)[None, :, None, None], dim=-1)
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in (xbc, dt, A, D))
    if return_carry:
        y, h_fin = (SSDChunkedXbcCarryFn.apply(xbc, dth, S, D, d_inner, chunk) if grad
                    else ssd_xbc_fwd_hfin(xbc, dth, S, D, d_inner, chunk))
        return y, torch.exp(S[..., -1].sum(-1)), h_fin
    if grad:
        return SSDChunkedXbcFn.apply(xbc, dth, S, D, d_inner, chunk)
    return ssd_xbc_fwd(xbc, dth, S, D, d_inner, chunk)


def _launch_split_fwd(x, dt, S, Bm, Cm, chunk: int, states: bool, hfin: bool):
    _, _, _, n, p = _check_split(x, dt, S, Bm, Cm, chunk)
    with torch.cuda.device(x.device):
        out = run_split_fwd(_fwd_library(), x, dt, S, Bm, Cm, chunk, states, hfin,
                            torch.cuda.current_stream(x.device).cuda_stream)
    if out[0].numel():
        _count(_SPLIT_FWD[(states, hfin, x.dtype == torch.bfloat16)],
               kernel_variant(chunk, n, p))
    return out


def _launch_split_bwd(x, dt, S, Bm, Cm, h_in, dy, chunk: int, dh_fin=None):
    extra = dict(h_in=h_in, dy=dy) | ({} if dh_fin is None else dict(dh_fin=dh_fin))
    _, _, _, n, p = _check_split(x, dt, S, Bm, Cm, chunk, extra)
    with torch.cuda.device(x.device):
        out = run_split_bwd(_bwd_library(), x, dt, S, Bm, Cm, h_in, dy, chunk, dh_fin,
                            torch.cuda.current_stream(x.device).cuda_stream)
    if out[0].numel():
        bf16 = x.dtype == torch.bfloat16
        if dh_fin is None:
            _count(ssd_split_bwd_bf16 if bf16 else ssd_split_bwd, kernel_variant(chunk, n, p))
        else:
            _count(ssd_split_bwd_seeded_bf16 if bf16 else ssd_split_bwd_seeded,
                   kernel_variant(chunk, n, p))
    return out


def ssd_split_fwd(x, dt, S, Bm, Cm, chunk: int) -> torch.Tensor:
    """Lean split forward (K6 without states): y (b, l, h p), no D term. x
    (b, l, h p), B and C (b, l, n) need unit stride only along their last
    axis; dt, S (b, h, nc, q) contiguous. The kernel on a CUDA tensor (or an
    error), :func:`ssd_split_fwd_ref` on the CPU. Each ``ssd_split_fwd*``
    wrapper counts its kernel launches in ``.launches``."""
    if x.is_cuda:
        return _launch_split_fwd(x, dt, S, Bm, Cm, chunk, states=False, hfin=False)[0]
    return ssd_split_fwd_ref(x, dt, S, Bm, Cm, chunk)[0]


def ssd_split_fwd_states(x, dt, S, Bm, Cm, chunk: int):
    """Training split forward (K6 with states): (y, h_in (b, nc, h, n, p))."""
    if x.is_cuda:
        return _launch_split_fwd(x, dt, S, Bm, Cm, chunk, states=True, hfin=False)[:2]
    return ssd_split_fwd_ref(x, dt, S, Bm, Cm, chunk, emit_states=True)[:2]


def ssd_split_fwd_hfin(x, dt, S, Bm, Cm, chunk: int):
    """Lean split forward with the carry (K6 with h_fin): (y, h_fin (b, h, n, p)),
    the state after the last chunk from a zero start."""
    if x.is_cuda:
        y, _, h_fin = _launch_split_fwd(x, dt, S, Bm, Cm, chunk, states=False, hfin=True)
        return y, h_fin
    y, _, h_fin = ssd_split_fwd_ref(x, dt, S, Bm, Cm, chunk, emit_hfin=True)
    return y, h_fin


def ssd_split_fwd_states_hfin(x, dt, S, Bm, Cm, chunk: int):
    """Training split forward with the carry (K6 with states and h_fin):
    (y, h_in, h_fin)."""
    if x.is_cuda:
        return _launch_split_fwd(x, dt, S, Bm, Cm, chunk, states=True, hfin=True)
    return ssd_split_fwd_ref(x, dt, S, Bm, Cm, chunk, emit_states=True, emit_hfin=True)


def ssd_split_bwd(x, dt, S, Bm, Cm, h_in, dy, chunk: int):
    """Split backward (K7, its carry from 0): (dx (b, l, h p), ddt, dS
    (b, h, nc, q), dB, dC (b, l, n)) for the output gradient dy (b, l, h p) and
    the forward's h_in. The kernel on a CUDA tensor (dy needs unit stride only
    along its last axis), :func:`ssd_split_bwd_ref` on the CPU."""
    if x.is_cuda:
        return _launch_split_bwd(x, dt, S, Bm, Cm, h_in, dy, chunk)
    return ssd_split_bwd_ref(x, dt, S, Bm, Cm, h_in, dy, chunk)


def ssd_split_bwd_seeded(x, dt, S, Bm, Cm, h_in, dy, dh_fin, chunk: int):
    """Seeded split backward (K7 with dh_fin): as :func:`ssd_split_bwd`, the
    carry starting at ``dh_fin`` (b, h, n, p) contiguous, the cotangent of the
    forward's h_fin."""
    if x.is_cuda:
        return _launch_split_bwd(x, dt, S, Bm, Cm, h_in, dy, chunk, dh_fin=dh_fin)
    return ssd_split_bwd_ref(x, dt, S, Bm, Cm, h_in, dy, chunk, dh_fin=dh_fin)


def _require_bf16(t: torch.Tensor) -> None:
    if t.dtype != torch.bfloat16:
        raise TypeError(f"the _bf16 entry points take bfloat16 activations, got {t.dtype}")


def ssd_xbc_fwd_bf16(xbc, dt, S, D, d_inner: int, chunk: int) -> torch.Tensor:
    """:func:`ssd_xbc_fwd` for bf16 xbc, which it requires.
    ``ssd_xbc_fwd_bf16.launches`` counts the bf16 lean K8's launches, whichever
    entry point reached it; so does each ``_bf16`` wrapper below for its
    variant."""
    _require_bf16(xbc)
    return ssd_xbc_fwd(xbc, dt, S, D, d_inner, chunk)


def ssd_xbc_fwd_states_bf16(xbc, dt, S, D, d_inner: int, chunk: int):
    """:func:`ssd_xbc_fwd_states` for bf16 xbc."""
    _require_bf16(xbc)
    return ssd_xbc_fwd_states(xbc, dt, S, D, d_inner, chunk)


def ssd_xbc_bwd_bf16(xbc, dt, S, D, h_in, dy, d_inner: int, chunk: int):
    """:func:`ssd_xbc_bwd` for bf16 xbc and dy."""
    _require_bf16(xbc)
    return ssd_xbc_bwd(xbc, dt, S, D, h_in, dy, d_inner, chunk)


def ssd_xbc_fwd_hfin_bf16(xbc, dt, S, D, d_inner: int, chunk: int):
    """:func:`ssd_xbc_fwd_hfin` for bf16 xbc."""
    _require_bf16(xbc)
    return ssd_xbc_fwd_hfin(xbc, dt, S, D, d_inner, chunk)


def ssd_xbc_fwd_states_hfin_bf16(xbc, dt, S, D, d_inner: int, chunk: int):
    """:func:`ssd_xbc_fwd_states_hfin` for bf16 xbc."""
    _require_bf16(xbc)
    return ssd_xbc_fwd_states_hfin(xbc, dt, S, D, d_inner, chunk)


def ssd_xbc_bwd_seeded_bf16(xbc, dt, S, D, h_in, dy, dh_fin, d_inner: int, chunk: int):
    """:func:`ssd_xbc_bwd_seeded` for bf16 xbc and dy."""
    _require_bf16(xbc)
    return ssd_xbc_bwd_seeded(xbc, dt, S, D, h_in, dy, dh_fin, d_inner, chunk)


def ssd_split_fwd_bf16(x, dt, S, Bm, Cm, chunk: int) -> torch.Tensor:
    """:func:`ssd_split_fwd` for bf16 x, B and C."""
    _require_bf16(x)
    return ssd_split_fwd(x, dt, S, Bm, Cm, chunk)


def ssd_split_fwd_states_bf16(x, dt, S, Bm, Cm, chunk: int):
    """:func:`ssd_split_fwd_states` for bf16 x, B and C."""
    _require_bf16(x)
    return ssd_split_fwd_states(x, dt, S, Bm, Cm, chunk)


def ssd_split_fwd_hfin_bf16(x, dt, S, Bm, Cm, chunk: int):
    """:func:`ssd_split_fwd_hfin` for bf16 x, B and C."""
    _require_bf16(x)
    return ssd_split_fwd_hfin(x, dt, S, Bm, Cm, chunk)


def ssd_split_fwd_states_hfin_bf16(x, dt, S, Bm, Cm, chunk: int):
    """:func:`ssd_split_fwd_states_hfin` for bf16 x, B and C."""
    _require_bf16(x)
    return ssd_split_fwd_states_hfin(x, dt, S, Bm, Cm, chunk)


def ssd_split_bwd_bf16(x, dt, S, Bm, Cm, h_in, dy, chunk: int):
    """:func:`ssd_split_bwd` for bf16 x, B, C and dy."""
    _require_bf16(x)
    return ssd_split_bwd(x, dt, S, Bm, Cm, h_in, dy, chunk)


def ssd_split_bwd_seeded_bf16(x, dt, S, Bm, Cm, h_in, dy, dh_fin, chunk: int):
    """:func:`ssd_split_bwd_seeded` for bf16 x, B, C and dy."""
    _require_bf16(x)
    return ssd_split_bwd_seeded(x, dt, S, Bm, Cm, h_in, dy, dh_fin, chunk)


# the K8 wrapper that counts a launch, by (states, h_fin, bf16)
_XBC_FWD = {(False, False, False): ssd_xbc_fwd, (True, False, False): ssd_xbc_fwd_states,
            (False, True, False): ssd_xbc_fwd_hfin, (True, True, False): ssd_xbc_fwd_states_hfin,
            (False, False, True): ssd_xbc_fwd_bf16, (True, False, True): ssd_xbc_fwd_states_bf16,
            (False, True, True): ssd_xbc_fwd_hfin_bf16,
            (True, True, True): ssd_xbc_fwd_states_hfin_bf16}
# the K6 wrapper that counts a launch, by (states, h_fin, bf16)
_SPLIT_FWD = {(False, False, False): ssd_split_fwd, (True, False, False): ssd_split_fwd_states,
              (False, True, False): ssd_split_fwd_hfin,
              (True, True, False): ssd_split_fwd_states_hfin,
              (False, False, True): ssd_split_fwd_bf16,
              (True, False, True): ssd_split_fwd_states_bf16,
              (False, True, True): ssd_split_fwd_hfin_bf16,
              (True, True, True): ssd_split_fwd_states_hfin_bf16}


class SSDChunkedSplitFn(torch.autograd.Function):
    """The split core with its backward: K6 with states forward and K7
    backward on a CUDA tensor, the plain versions on the CPU. Inputs
    (x, dt, S, Bm, Cm, chunk) as :func:`ssd_split_fwd`; returns y."""

    @staticmethod
    def forward(ctx, x, dt, S, Bm, Cm, chunk):
        y, h_in = ssd_split_fwd_states(x, dt, S, Bm, Cm, chunk)
        ctx.save_for_backward(x, dt, S, Bm, Cm, h_in)
        ctx.chunk = chunk
        return y

    @staticmethod
    def backward(ctx, dy):
        if dy.stride(-1) != 1:
            dy = dy.contiguous()
        dx, ddt, dS, dB, dC = ssd_split_bwd(*ctx.saved_tensors, dy, ctx.chunk)
        return dx, ddt, dS, dB, dC, None


class SSDChunkedSplitCarryFn(torch.autograd.Function):
    """The split core that also returns the state after the last chunk:
    (y, h_fin) by K6 with states and h_fin; the backward hands h_fin's
    cotangent to K7 as the seed of its carry. The plain versions on the CPU."""

    @staticmethod
    def forward(ctx, x, dt, S, Bm, Cm, chunk):
        y, h_in, h_fin = ssd_split_fwd_states_hfin(x, dt, S, Bm, Cm, chunk)
        ctx.save_for_backward(x, dt, S, Bm, Cm, h_in)
        ctx.chunk = chunk
        return y, h_fin

    @staticmethod
    def backward(ctx, dy, dh_fin):
        if dy.stride(-1) != 1:
            dy = dy.contiguous()
        dx, ddt, dS, dB, dC = ssd_split_bwd_seeded(*ctx.saved_tensors, dy, dh_fin.contiguous(),
                                                   ctx.chunk)
        return dx, ddt, dS, dB, dC, None


def ssd_chunked_split(x, dt, A, Bm, Cm, D, *, chunk: int = 128, return_carry: bool = False):
    """The counterpart of ``ssd_chunked_pallas``: the SSD core on split
    operands, the same shapes and result as ``ops/ssd.py:ssd_chunked``. x
    (b, l, h, p) (a view with unit stride along p will do); dt (b, l, h)
    post-softplus; A (h,) negative; Bm, Cm (b, l, n), strided views allowed;
    D (h,). L must be a multiple of ``chunk`` (the callers pad).

    S = cumsum(dt A) per chunk, the D skip and, with ``return_carry``, the
    slice's total decay exp(sum of each chunk's last S) (b, h) are computed
    here, outside the autograd Functions, so autograd chains dS into ddt and
    dA. Without a gradient wanted the lean K6 runs (with h_fin when
    ``return_carry``), with one :class:`SSDChunkedSplitFn` or
    :class:`SSDChunkedSplitCarryFn`. Returns y (b, l, h, p), or (y,
    total_decay, h_fin (b, h, n, p)) with ``return_carry``."""
    b, l, h, p = x.shape
    if l % chunk:
        raise ValueError(f"L={l} is not a multiple of chunk={chunk}; pad first")
    acc = _acc_dtype(x)
    xf = x.reshape(b, l, h * p)
    dth = dt.to(acc).transpose(1, 2).reshape(b, h, l // chunk, chunk).contiguous()
    S = torch.cumsum(dth * A.to(acc)[None, :, None, None], dim=-1)
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in (x, dt, A, Bm, Cm))
    h_fin = None
    if return_carry:
        y, h_fin = (SSDChunkedSplitCarryFn.apply(xf, dth, S, Bm, Cm, chunk) if grad
                    else ssd_split_fwd_hfin(xf, dth, S, Bm, Cm, chunk))
    else:
        y = (SSDChunkedSplitFn.apply(xf, dth, S, Bm, Cm, chunk) if grad
             else ssd_split_fwd(xf, dth, S, Bm, Cm, chunk))
    y = y.reshape(b, l, h, p) + D.to(y.dtype)[None, None, :, None] * x
    if return_carry:
        return y, torch.exp(S[..., -1].sum(-1)), h_fin
    return y


_WRAPPERS = (*_XBC_FWD.values(), ssd_xbc_bwd, ssd_xbc_bwd_seeded, ssd_xbc_bwd_bf16,
             ssd_xbc_bwd_seeded_bf16, *_SPLIT_FWD.values(), ssd_split_bwd, ssd_split_bwd_seeded,
             ssd_split_bwd_bf16, ssd_split_bwd_seeded_bf16)
for _fn in _WRAPPERS:
    _fn.launches = 0


def _variant_name(wrapper_name: str, variant: str) -> str:
    """'ssd_xbc_fwd_bf16', '_strip' -> 'ssd_xbc_fwd_strip_bf16'."""
    base = wrapper_name.removesuffix("_bf16")
    return base + variant + wrapper_name[len(base):]


# the launch counts of every entry point's variants other than the tuned
# one: '_strip' and '_long' at n = p = 128, each of the three chunk variants
# of the wide instantiation, and the Hopper bf16 body's K8 and K9 ('_sm90')
VARIANT_LAUNCHES = {**{_variant_name(fn.__name__, v): LaunchCount()
                       for fn in _WRAPPERS
                       for v in ("_strip", "_long", "_wide", "_strip_wide", "_long_wide")},
                    **{_variant_name(fn.__name__, "_sm90"): LaunchCount()
                       for fn in (*[_XBC_FWD[(s, f, True)] for s in (False, True)
                                    for f in (False, True)],
                                  ssd_xbc_bwd_bf16, ssd_xbc_bwd_seeded_bf16)}}


def _count(wrapper, variant: str) -> None:
    """One launch of ``wrapper``'s kernel, on the count of the variant that
    ran it (:func:`kernel_variant`)."""
    if variant:
        VARIANT_LAUNCHES[_variant_name(wrapper.__name__, variant)].launches += 1
    else:
        wrapper.launches += 1
