"""Boundary-fused chunked SSD core, forward and backward: the CUDA kernels,
their plain versions and the autograd Function over them.

The core takes the SSD mixer's un-split conv output xbc (b, l, d + 2n),
columns [x | B | C], the per-chunk step sizes dt and log-decay cumsums S,
both (b, h, nc, q), and the per-head skip D (h,), and returns
y (b, l, d) = the SSD recurrence of ``ops/ssd.py`` plus the D skip.

Kernels:
- ``csrc/ssd_xbc_fwd.cu`` (K8), which replaces the TPU kernel
  ``_make_fwd_kernel_xbc`` behind ``_fwd_call_xbc``
  (si_mamba_tpu/ops/pallas/ssd_kernel.py), in two variants: the lean forward
  (``emit_states=False``, serving) and the training forward, which also
  writes the state entering every chunk, h_in (b, nc, h, n, p) fp32;
- ``csrc/ssd_xbc_bwd.cu`` (K9), which replaces ``_make_bwd_kernel_xbc``
  behind ``_bwd_call_xbc``: it walks the chunks in reverse with the dh carry
  and writes dx into the x columns of dxbc, per-head partials of dB and dC
  (the wrapper's ``torch.sum`` over heads fills the B and C columns), ddt,
  dS and per-chunk partials of dD.
Both are bound by fp32 operations on the H100; the sources describe the
designs. They are built for d_state = head_dim = 128 and chunks that are a
multiple of :data:`STRIP` up to :data:`MAX_CHUNK`, in float32.

:func:`ssd_chunked_xbc` runs the lean K8 when no gradient is wanted and
:class:`SSDChunkedXbcFn` (K8 with states, K9) when one is; on a CPU tensor
each is its plain version. Nothing falls back from one to the other.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from si_mamba_tpu_torch.ops.kernels.build import load_library

STATE = 128  # d_state the kernels are built for (kN in both sources)
HEAD_DIM = 128  # head_dim the kernels are built for (kP)
STRIP = 64  # rows of a time strip; the chunk must be a multiple (kStrip)
MAX_CHUNK = 256  # the longest chunk the kernels' shared memory holds (kMaxChunk)


def _acc_dtype(x: torch.Tensor) -> torch.dtype:
    """The plain versions compute in fp32, or in fp64 for fp64 input."""
    return torch.promote_types(x.dtype, torch.float32)


def decay_mask(S: torch.Tensor) -> torch.Tensor:
    """M[..., t, s] = exp(S[t] - S[s]) for s <= t, else 0, from S (..., q).
    Masked in log space: for s > t the exponent is large and positive (S is
    non-increasing), and exp of it overflows to inf, where inf * 0 is NaN."""
    q = S.shape[-1]
    tri = torch.ones(q, q, dtype=torch.bool, device=S.device).tril()
    return torch.exp(torch.where(tri, S[..., :, None] - S[..., None, :], float("-inf")))


def ssd_chunks_ref(xdt, S, Bc, Cc):
    """The chunked SSD without the D skip, heads next to the batch: xdt
    (b, h, nc, q, p) = dt x, S (b, h, nc, q) the per-chunk log-decay cumsums,
    Bc, Cc (b, nc, q, n). Returns y (b, h, nc, q, p), the state entering each
    chunk h_in (b, h, nc, n, p) and the state leaving the last (b, h, n, p):
    the intra-chunk (C B^T (.) decay mask) (dt x), the inter-chunk
    C h_in e^S, and the carry h <- e^{S_end} h + B^T (dt x (.) e^{S_end - S})."""
    b, h, nc, _, p = xdt.shape
    n = Bc.shape[-1]
    G = torch.einsum("bcqn,bckn->bcqk", Cc, Bc)
    y_intra = torch.einsum("bhcqk,bhckp->bhcqp", G[:, None] * decay_mask(S), xdt)
    T_end = torch.exp(S[..., -1:] - S)
    states = torch.einsum("bcqn,bhcqp->bhcnp", Bc, xdt * T_end[..., None])
    state, entries = xdt.new_zeros((b, h, n, p)), []
    for c in range(nc):
        entries.append(state)
        state = torch.exp(S[:, :, c, -1])[..., None, None] * state + states[:, :, c]
    h_in = torch.stack(entries, dim=2) if entries else xdt.new_zeros((b, h, 0, n, p))
    y_inter = torch.einsum("bcqn,bhcnp->bhcqp", Cc, h_in) * torch.exp(S)[..., None]
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


def ssd_xbc_fwd_ref(xbc, dt, S, D, d_inner: int, chunk: int, emit_states: bool = False):
    """Plain version of K8: (y (b, l, d), h_in (b, nc, h, n, p) or None).

    What ``_make_fwd_kernel_xbc`` computes: :func:`ssd_chunks_ref` with the
    head-shared G = C B^T, plus the D skip."""
    b, l, _ = xbc.shape
    x, Bc, Cc = _split_xbc(xbc, d_inner, dt.shape[1], chunk)
    dt, S, D = dt.to(x.dtype), S.to(x.dtype), D.to(x.dtype)
    y, h_in, _ = ssd_chunks_ref(x * dt[..., None], S, Bc, Cc)
    y = y + D[None, :, None, None, None] * x
    y = y.permute(0, 2, 3, 1, 4).reshape(b, l, d_inner).to(xbc.dtype)
    return y, (h_in.transpose(1, 2).contiguous() if emit_states else None)


def ssd_xbc_bwd_ref(xbc, dt, S, D, h_in, dy, d_inner: int, chunk: int):
    """Plain version of K9: (dxbc (b, l, d + 2n), ddt, dS (b, h, nc, q), dD (h,)).

    Written out as ``_bwd_head`` computes it (not taken from autograd): the
    chunks in reverse with the state cotangent dh carried from each chunk to
    the one before,

        dh_in = e^{S_end} dh_out + (C e^S)^T dy,

    dx = (GM^T dy + (B dh_out) e^{S_end - S}) dt + D dy in the x columns, the
    head-summed dB and dC in theirs, dS from the mask's rows and columns, the
    e^S and e^{S_end - S} factors and the chunk's end (dSend), ddt, and dD as
    a sum of per-chunk partials."""
    b, l, total = xbc.shape
    h = dt.shape[1]
    x, Bc, Cc = _split_xbc(xbc, d_inner, h, chunk)
    acc = x.dtype
    dt, S, D = dt.to(acc), S.to(acc), D.to(acc)
    nc, q, n, p = l // chunk, chunk, Bc.shape[-1], x.shape[-1]
    hin_all = h_in.to(acc).transpose(1, 2)  # (b, h, nc, n, p)
    dyh = dy.to(acc).reshape(b, nc, q, h, p).permute(0, 3, 1, 2, 4)
    dx, ddt, dS = torch.empty_like(x), torch.empty_like(dt), torch.empty_like(S)
    dB, dC = torch.empty_like(Bc), torch.empty_like(Cc)
    dD_part = x.new_empty((b, nc, h))
    dh = x.new_zeros((b, h, n, p))  # the cotangent of the state leaving the chunk
    for c in reversed(range(nc)):
        Sc, dtc = S[:, :, c], dt[:, :, c]  # (b, h, q)
        xc, dyc, hin = x[:, :, c], dyh[:, :, c], hin_all[:, :, c]
        B, C = Bc[:, c], Cc[:, c]  # (b, q, n)
        E = torch.exp(Sc)
        send = Sc[..., -1]
        T_end = torch.exp(send[..., None] - Sc)
        xdt = xc * dtc[..., None]
        M = decay_mask(Sc)  # (b, h, q_t, q_s)
        GM = torch.einsum("btn,bsn->bts", C, B)[:, None] * M

        t1 = torch.einsum("bhts,bhtp->bhsp", GM, dyc)
        Bdh = torch.einsum("bsn,bhnp->bhsp", B, dh)
        dxdt = t1 + Bdh * T_end[..., None]
        dx[:, :, c] = dxdt * dtc[..., None] + D[None, :, None, None] * dyc
        dD_part[:, c] = torch.sum(dyc * xc, dim=(-2, -1))
        ddt[:, :, c] = torch.sum(dxdt * xc, dim=-1)

        dGM = torch.einsum("bhtp,bhsp->bhts", dyc, xdt)
        dG = dGM * M
        dlogM = dGM * GM
        dC[:, c] = (torch.einsum("bhts,bsn->bhtn", dG, B)
                    + torch.einsum("bhtp,bhnp->bhtn", dyc, hin) * E[..., None]).sum(1)
        dB[:, c] = (torch.einsum("bhts,btn->bhsn", dG, C)
                    + torch.einsum("bhsp,bhnp->bhsn", xdt * T_end[..., None], dh)).sum(1)

        Chin = torch.einsum("btn,bhnp->bhtp", C, hin)
        dE = torch.sum(dyc * Chin, dim=-1)
        dT = torch.sum(Bdh * xdt, dim=-1)
        dSend = torch.sum(dT * T_end, dim=-1) + torch.exp(send) * torch.sum(dh * hin, dim=(-2, -1))
        dSc = torch.sum(dlogM, dim=-1) + dE * E - dT * T_end - torch.sum(dlogM, dim=-2)
        dSc[..., -1] += dSend
        dS[:, :, c] = dSc

        dh = (torch.exp(send)[..., None, None] * dh
              + torch.einsum("bhtn,bhtp->bhnp", C[:, None] * E[..., None], dyc))
    dxbc = torch.cat([dx.permute(0, 2, 3, 1, 4).reshape(b, l, d_inner),
                      dB.reshape(b, l, n), dC.reshape(b, l, n)], dim=-1)
    return dxbc.to(xbc.dtype), ddt, dS, dD_part.sum(dim=(0, 1))


@functools.cache
def _fwd_library() -> ctypes.CDLL:
    lib = load_library("ssd_xbc_fwd")
    lib.ssd_xbc_fwd.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + \
        [ctypes.c_longlong] * 2 + [ctypes.c_void_p]
    lib.ssd_xbc_fwd.restype = ctypes.c_int
    lib.ssd_xbc_fwd_error_string.argtypes = [ctypes.c_int]
    lib.ssd_xbc_fwd_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _bwd_library() -> ctypes.CDLL:
    lib = load_library("ssd_xbc_bwd")
    lib.ssd_xbc_bwd.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7 + \
        [ctypes.c_longlong] * 4 + [ctypes.c_void_p]
    lib.ssd_xbc_bwd.restype = ctypes.c_int
    lib.ssd_xbc_bwd_error_string.argtypes = [ctypes.c_int]
    lib.ssd_xbc_bwd_error_string.restype = ctypes.c_char_p
    return lib


def _check_inputs(xbc, dt, S, D, d_inner: int, chunk: int, extra: dict | None = None):
    """Raise for anything the kernels do not take; returns (b, l, h, n, p)."""
    b, l, total = xbc.shape
    h = dt.shape[1] if dt.dim() == 4 else -1
    named = dict(xbc=xbc, dt=dt, S=S, D=D) | (extra or {})
    for name, t in named.items():
        if t.dtype != torch.float32:
            raise TypeError(f"the SSD kernels take float32 inputs; {name} is {t.dtype}")
        if not t.is_cuda or t.device != xbc.device:
            raise ValueError(f"{name} must lie on xbc's CUDA device")
    n, p = (total - d_inner) // 2, d_inner // max(h, 1)
    if h < 1 or d_inner % h or 2 * n + d_inner != total:
        raise ValueError(f"xbc {tuple(xbc.shape)} does not split into d_inner={d_inner} "
                         f"and two equal B/C blocks over dt's heads {tuple(dt.shape)}")
    if n != STATE or p != HEAD_DIM:
        raise ValueError(f"the SSD kernels are built for d_state {STATE} and head_dim "
                         f"{HEAD_DIM}, got {n} and {p}")
    if chunk % STRIP or not 0 < chunk <= MAX_CHUNK:
        raise ValueError(f"the SSD kernels take a chunk that is a multiple of {STRIP} up to "
                         f"{MAX_CHUNK}, got {chunk}")
    if l % chunk:
        raise ValueError(f"L={l} is not a multiple of chunk={chunk}; pad first")
    nc = l // chunk
    shapes = dict(dt=(b, h, nc, chunk), S=(b, h, nc, chunk), D=(h,),
                  h_in=(b, nc, h, n, p), dy=(b, l, d_inner))
    for name, t in named.items():
        if name != "xbc" and tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shapes[name]}")
        if name in ("xbc", "dy"):
            if t.stride(-1) != 1:
                raise ValueError(f"the SSD kernels need unit stride along {name}'s last axis")
        elif not t.is_contiguous():
            raise ValueError(f"the SSD kernels need {name} contiguous")
    return b, l, h, n, p


def _launch_fwd(xbc, dt, S, D, d_inner: int, chunk: int, states: bool):
    b, l, h, n, p = _check_inputs(xbc, dt, S, D, d_inner, chunk)
    y = torch.empty((b, l, d_inner), dtype=torch.float32, device=xbc.device)
    h_in = (torch.empty((b, l // chunk, h, n, p), dtype=torch.float32, device=xbc.device)
            if states else None)
    if y.numel() == 0:
        return y, h_in
    lib = _fwd_library()
    stream = torch.cuda.current_stream(xbc.device).cuda_stream
    with torch.cuda.device(xbc.device):
        err = lib.ssd_xbc_fwd(xbc.data_ptr(), dt.data_ptr(), S.data_ptr(), D.data_ptr(),
                              y.data_ptr(), h_in.data_ptr() if states else None,
                              b, l, h, d_inner, n, p, chunk, xbc.stride(0), xbc.stride(1), stream)
    if err != 0:
        msg = lib.ssd_xbc_fwd_error_string(err).decode()
        raise RuntimeError(f"SSD forward kernel launch failed: {msg} ({err})")
    if states:
        ssd_xbc_fwd_states.launches += 1
    else:
        ssd_xbc_fwd.launches += 1
    return y, h_in


def _launch_bwd(xbc, dt, S, D, h_in, dy, d_inner: int, chunk: int):
    b, l, h, n, p = _check_inputs(xbc, dt, S, D, d_inner, chunk, dict(h_in=h_in, dy=dy))
    f32 = dict(dtype=torch.float32, device=xbc.device)
    dxbc = torch.empty((b, l, d_inner + 2 * n), **f32)
    dbc_part = torch.empty((b, h, l, 2 * n), **f32)
    ddt, dS = torch.empty((b, h, l // chunk, chunk), **f32), torch.empty((b, h, l // chunk, chunk), **f32)
    dD_part = torch.empty((b, h, l // chunk), **f32)
    if dxbc.numel() == 0:
        return dxbc.zero_(), ddt, dS, torch.zeros_like(D)
    lib = _bwd_library()
    stream = torch.cuda.current_stream(xbc.device).cuda_stream
    with torch.cuda.device(xbc.device):
        err = lib.ssd_xbc_bwd(xbc.data_ptr(), dt.data_ptr(), S.data_ptr(), D.data_ptr(),
                              h_in.data_ptr(), dy.data_ptr(), dxbc.data_ptr(),
                              dbc_part.data_ptr(), ddt.data_ptr(), dS.data_ptr(),
                              dD_part.data_ptr(), b, l, h, d_inner, n, p, chunk,
                              xbc.stride(0), xbc.stride(1), dy.stride(0), dy.stride(1), stream)
    if err != 0:
        msg = lib.ssd_xbc_bwd_error_string(err).decode()
        raise RuntimeError(f"SSD backward kernel launch failed: {msg} ({err})")
    ssd_xbc_bwd.launches += 1
    dxbc[..., d_inner:] = dbc_part.sum(dim=1)  # the head sums of dB | dC
    return dxbc, ddt, dS, dD_part.sum(dim=(0, 2))


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


def ssd_chunked_xbc(xbc, dt, A, D, *, d_inner: int, chunk: int = 128) -> torch.Tensor:
    """The counterpart of ``ssd_chunked_pallas_xbc``: the SSD core with the D
    skip on the conv's un-split output. xbc (b, l, d + 2n) with columns
    [x | B | C]; dt (b, l, h) post-softplus; A (h,) negative; D (h,).
    Returns y (b, l, d). L must be a multiple of ``chunk`` (the callers pad).

    S = cumsum(dt A) per chunk is computed here, outside the autograd
    Function, so autograd chains dS into ddt and dA. With a gradient wanted
    this is :class:`SSDChunkedXbcFn`, else the lean forward (K8 without
    states on a CUDA tensor)."""
    b, l, _ = xbc.shape
    h = dt.shape[-1]
    if l % chunk:
        raise ValueError(f"L={l} is not a multiple of chunk={chunk}; pad first")
    acc = _acc_dtype(xbc)
    dth = dt.to(acc).transpose(1, 2).reshape(b, h, l // chunk, chunk)
    S = torch.cumsum(dth * A.to(acc)[None, :, None, None], dim=-1)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (xbc, dt, A, D)):
        return SSDChunkedXbcFn.apply(xbc, dth.contiguous(), S, D, d_inner, chunk)
    return ssd_xbc_fwd(xbc, dth.contiguous(), S, D, d_inner, chunk)


ssd_xbc_fwd.launches = 0
ssd_xbc_fwd_states.launches = 0
ssd_xbc_bwd.launches = 0
