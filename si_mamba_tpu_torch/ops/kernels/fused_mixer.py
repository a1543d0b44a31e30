"""The fused Mamba-1 mixer interior, forward and backward: the CUDA kernels,
their plain versions and the autograd Function over them.

From xz = x @ in_proj (b, l, 2 d_inner), columns [x | z], the interior is

    xi             = silu(causal_conv(x) + conv_b)
    dt_low | B | C = xi @ x_proj                      (R + 2n columns)
    dt_raw         = dt_low @ dt_proj + dt_b          (the rank-R pair)
    y              = (selective_scan(xi, softplus(dt_raw), A, B, C) + D xi) * silu(z)

in the kernels' layouts: conv_wt (W, d) and at (n, d) transposed, conv_b,
dtb and d (d,), x_proj (d, R + 2n) and dt_proj (R, d) as
``mamba_mixer_apply`` keeps them. No (d, d) product of the two projections
is formed anywhere on this route.

Kernels:
- ``csrc/fused_mixer_fwd.cu`` (K10), which replaces the TPU kernel
  ``_fwd_kernel`` behind ``_fused_fwd_call``
  (si_mamba_tpu/ops/pallas/fused_mixer_kernel.py), in two variants: the lean
  forward (serving) and the training forward, which also writes the state
  entering every :data:`CHUNK`-token chunk, h_entries (b, ceil(l / CHUNK),
  n, d) fp32. At small batch it cuts L into segments (two passes); the
  variant with states takes the lean one's segment count, so both give the
  same y bit for bit;
- ``csrc/fused_mixer_bwd.cu`` (K11), which replaces ``_bwd_kernel`` behind
  ``_fused_bwd_call``: it recomputes the interior chunk by chunk from
  h_entries, runs the reverse dh scan and writes dxz and per-batch-row
  partials of the seven weight gradients, which ``torch.sum`` finishes.
Both run the d / TILE blocks of a batch row as one thread-block cluster; the
sources describe the designs and what bounds them. They are built for
d_state 16, d_conv 4, dt_rank + 2 d_state up to :data:`MAX_XDBL` and a
d_inner that is a multiple of 128 up to :data:`MAX_D_INNER`, in float32; on
CUDA anything else raises.

:func:`fused_mamba_mixer` transposes conv_w and A outside the Function, as
the JAX function does, so autograd returns their exact gradients; x_proj and
dt_proj go in as they are and K11 returns their gradients. It runs the lean
K10 when no gradient is wanted and :class:`FusedMixerFn` (K10 with states,
K11) when one is; on a CPU tensor each is its plain version. Nothing falls
back from one to the other.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from si_mamba_tpu_torch.ops.kernels.build import load_library

CHUNK = 16  # tokens a chunk of both kernels, the h_entries stride (kT; checked at load)
STATE = 16  # d_state the kernels are built for (kN)
CONV = 4  # conv width the kernels are built for (kW)
TILE = 128  # channels a block (kTile); d_inner must be a multiple
MAX_D_INNER = 8 * TILE  # d_inner / TILE blocks form one cluster, at most the portable 8
MAX_XDBL = 64  # columns of x_proj, dt_rank + 2 d_state, the kernels take (kXW)

_NOT_BUILT = "ROADMAP queue 2, K10/K11: other sizes are built when a configuration needs them"


def _acc_dtype(x: torch.Tensor) -> torch.dtype:
    """The plain versions compute in fp32, or in fp64 for fp64 input."""
    return torch.promote_types(x.dtype, torch.float32)


def fused_mixer_supported(d_inner: int, d_state: int, L: int) -> bool:
    """The shapes ``impl='fused'`` takes, as the JAX package states them
    (fused_mixer_kernel.py:401-403); L is free."""
    return d_inner % 128 == 0 and d_state <= 32


def _conv_lin(x, conv_wt, conv_b):
    """xi_lin[t] = b + sum_i w[i] x[t - (W - 1) + i], zeros left of t = 0."""
    W, l = conv_wt.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, W - 1, 0))
    out = conv_b + x * conv_wt[W - 1]
    for i in range(W - 1):
        out = out + xp[:, i:i + l] * conv_wt[i]
    return out


def _interior(xz, conv_wt, conv_b, x_proj, dt_proj, dtb, n: int):
    """x, z, xi_lin, xi, dt_low, dt_raw, B, C of the forward, in the
    accumulation dtype."""
    di, r = xz.shape[-1] // 2, dt_proj.shape[0]
    x, z = xz[..., :di], xz[..., di:]
    xi_lin = _conv_lin(x, conv_wt, conv_b)
    xi = F.silu(xi_lin)
    x_dbl = xi @ x_proj
    dt_low = x_dbl[..., :r]
    raw = dt_low @ dt_proj + dtb
    return x, z, xi_lin, xi, dt_low, raw, x_dbl[..., r:r + n], x_dbl[..., r + n:r + 2 * n]


def fused_mixer_fwd_ref(xz, conv_wt, conv_b, x_proj, dt_proj, dtb, at, d, chunk: int = 64,
                        emit_states: bool = False):
    """Plain version of K10: (y (b, l, d), h_entries (b, ceil(l / chunk), n, d)
    or None), the state entering every chunk. What ``_fwd_kernel`` computes,
    with the rank-R pair in place of the folded product, in plain fp32 (or
    fp64 for fp64 input), the scan one step at a time."""
    acc = _acc_dtype(xz)
    xz, conv_wt, conv_b, x_proj, dt_proj, dtb, at, d = (
        t.to(acc) for t in (xz, conv_wt, conv_b, x_proj, dt_proj, dtb, at, d))
    b, l, _ = xz.shape
    n = at.shape[0]
    _, z, _, xi, _, raw, Bm, Cm = _interior(xz, conv_wt, conv_b, x_proj, dt_proj, dtb, n)
    delta, A = F.softplus(raw), at.t()
    h = xz.new_zeros((b, A.shape[0], n))
    ys, entries = [], []
    for t in range(l):
        if t % chunk == 0:
            entries.append(h.transpose(1, 2))
        dt_t = delta[:, t, :, None]
        h = torch.exp(dt_t * A) * h + (dt_t * xi[:, t, :, None]) * Bm[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, Cm[:, t]))
    y = torch.stack(ys, dim=1) if ys else xi.new_zeros(xi.shape)
    y = (y + d * xi) * F.silu(z)
    if not emit_states:
        return y, None
    h_entries = (torch.stack(entries, dim=1) if entries
                 else xz.new_zeros((b, 0, n, A.shape[0])))
    return y, h_entries


def fused_mixer_bwd_ref(xz, conv_wt, conv_b, x_proj, dt_proj, dtb, at, d, h_entries, g,
                        chunk: int = 64):
    """Plain version of K11, written out as ``_bwd_kernel`` computes it: per
    chunk, last first, the states rebuilt from the chunk's entry state, then
    the reverse recurrence

        dh_t = gy_t C_t + a_{t+1} dh_{t+1},   gy_t = g_t silu(z_t),

    with dh carried across chunks; then, through the rank-R pair,
    d_dtlow = ddt_raw dt_proj^T, dxi = du + [d_dtlow | dB | dC] x_proj^T, the
    conv backward and the weight gradients d x_proj = xi^T [d_dtlow | dB |
    dC] and d dt_proj = dt_low^T ddt_raw. Returns (dxz, dconv_wt, dconv_b,
    dx_proj, ddt_proj, ddtb, dat, dd), the gradients of the inputs in their
    order."""
    acc = _acc_dtype(xz)
    xz, conv_wt, conv_b, x_proj, dt_proj, dtb, at, d, g = (
        t.to(acc) for t in (xz, conv_wt, conv_b, x_proj, dt_proj, dtb, at, d, g))
    b, l, _ = xz.shape
    n, W = at.shape[0], conv_wt.shape[0]
    x, z, xi_lin, xi, dt_low, raw, Bm, Cm = _interior(xz, conv_wt, conv_b, x_proj, dt_proj,
                                                      dtb, n)
    delta, sig_raw, A = F.softplus(raw), torch.sigmoid(raw), at.t()
    sz = torch.sigmoid(z)
    gy = g * (z * sz)
    y0, ddt, du = (torch.empty_like(xi) for _ in range(3))
    dbt, dct = torch.empty_like(Bm), torch.empty_like(Cm)
    dA = torch.zeros_like(A)
    dh = xz.new_zeros((b, A.shape[0], n))  # a_{t+1} dh_{t+1}
    for c in reversed(range(h_entries.shape[1])):
        t0, t1 = c * chunk, min((c + 1) * chunk, l)
        h = h_entries[:, c].to(acc).transpose(1, 2)  # (b, d, n)
        prev, hs = [], []
        for t in range(t0, t1):
            prev.append(h)
            dt_t = delta[:, t, :, None]
            h = torch.exp(dt_t * A) * h + (dt_t * xi[:, t, :, None]) * Bm[:, t, None, :]
            hs.append(h)
        for t in reversed(range(t0, t1)):
            dt_t = delta[:, t, :, None]
            a = torch.exp(dt_t * A)
            y0[:, t] = torch.einsum("bdn,bn->bd", hs[t - t0], Cm[:, t]) + d * xi[:, t]
            dh = dh + gy[:, t, :, None] * Cm[:, t, None, :]
            daa = dh * prev[t - t0] * a
            dA += torch.sum(daa * dt_t, dim=0)
            dhb = torch.einsum("bdn,bn->bd", dh, Bm[:, t])
            ddt[:, t] = (torch.sum(daa * A, dim=-1) + dhb * xi[:, t]) * sig_raw[:, t]
            du[:, t] = delta[:, t] * dhb + gy[:, t] * d
            dbt[:, t] = torch.einsum("bdn,bd->bn", dh, delta[:, t] * xi[:, t])
            dct[:, t] = torch.einsum("bdn,bd->bn", hs[t - t0], gy[:, t])
            dh = a * dh
    dz = g * y0 * (sz * (1.0 + z * (1.0 - sz)))
    dxd = torch.cat([ddt @ dt_proj.t(), dbt, dct], dim=-1)  # [d_dtlow | dB | dC]
    dxi = du + dxd @ x_proj.t()
    sx = torch.sigmoid(xi_lin)
    dxl = dxi * (sx * (1.0 + xi_lin * (1.0 - sx)))
    # the conv backward: dx[t] = sum_i w[i] dxl[t + W - 1 - i]
    dxl_p = F.pad(dxl, (0, 0, 0, W - 1))
    dx = dxl * conv_wt[W - 1]
    for i in range(W - 1):
        k = W - 1 - i
        dx = dx + dxl_p[:, k:k + l] * conv_wt[i]
    xp = F.pad(x, (0, 0, W - 1, 0))
    dconv_wt = torch.stack([torch.sum(xp[:, i:i + l] * dxl, dim=(0, 1)) for i in range(W)])
    dx_proj = torch.einsum("bti,btj->ij", xi, dxd)
    ddt_proj = torch.einsum("btk,btj->kj", dt_low, ddt)
    return (torch.cat([dx, dz], dim=-1), dconv_wt, dxl.sum(dim=(0, 1)), dx_proj, ddt_proj,
            ddt.sum(dim=(0, 1)), dA.t(), torch.sum(gy * xi, dim=(0, 1)))


def fwd_interface(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a ``fused_mixer_fwd`` library."""
    lib.fused_mixer_fwd.argtypes = [ctypes.POINTER(ctypes.c_void_p)] + \
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    lib.fused_mixer_fwd.restype = ctypes.c_int
    lib.fused_mixer_fwd_segments.argtypes = [ctypes.c_int] * 3
    lib.fused_mixer_fwd_segments.restype = ctypes.c_int
    lib.fused_mixer_chunk_len.restype = ctypes.c_int
    if lib.fused_mixer_chunk_len() != CHUNK:
        raise RuntimeError("csrc/fused_mixer_fwd.cu's kT differs from CHUNK")
    lib.fused_mixer_fwd_error_string.argtypes = [ctypes.c_int]
    lib.fused_mixer_fwd_error_string.restype = ctypes.c_char_p
    return lib


def bwd_interface(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a ``fused_mixer_bwd`` library."""
    lib.fused_mixer_bwd.argtypes = [ctypes.POINTER(ctypes.c_void_p)] * 2 + \
        [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.fused_mixer_bwd.restype = ctypes.c_int
    lib.fused_mixer_bwd_max_active_clusters.argtypes = [ctypes.c_int]
    lib.fused_mixer_bwd_max_active_clusters.restype = ctypes.c_int
    lib.fused_mixer_bwd_chunk_len.restype = ctypes.c_int
    if lib.fused_mixer_bwd_chunk_len() != CHUNK:
        raise RuntimeError("csrc/fused_mixer_bwd.cu's kT differs from CHUNK")
    lib.fused_mixer_bwd_error_string.argtypes = [ctypes.c_int]
    lib.fused_mixer_bwd_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _fwd_library() -> ctypes.CDLL:
    return fwd_interface(load_library("fused_mixer_fwd"))


@functools.cache
def _bwd_library() -> ctypes.CDLL:
    return bwd_interface(load_library("fused_mixer_bwd"))


_NAMES = ("xz", "conv_wt", "conv_b", "x_proj", "dt_proj", "dtb", "at", "d")


def _check_inputs(args, extra: dict | None = None) -> tuple[int, int, int, int]:
    """Raise for anything the kernels do not take; returns (b, l, d_inner,
    dt_rank)."""
    named = dict(zip(_NAMES, args)) | (extra or {})
    xz, conv_wt, dt_proj, at = named["xz"], named["conv_wt"], named["dt_proj"], named["at"]
    b, l, two_d = xz.shape
    di, n, W, r = two_d // 2, at.shape[0], conv_wt.shape[0], dt_proj.shape[0]
    for name, t in named.items():
        if t.dtype != torch.float32:
            raise TypeError(f"the fused-mixer kernels take float32 inputs; {name} is {t.dtype}")
        if not t.is_cuda or t.device != xz.device:
            raise ValueError(f"{name} must lie on xz's CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"the fused-mixer kernels need {name} contiguous")
    if two_d % 2 or not fused_mixer_supported(di, n, l):
        raise ValueError(f"the fused mixer needs an even xz width, d_inner % 128 == 0 and "
                         f"d_state <= 32; got xz width {two_d} and d_state {n}")
    if n != STATE or W != CONV or di > MAX_D_INNER or r + 2 * n > MAX_XDBL:
        raise NotImplementedError(
            f"the fused-mixer kernels are built for d_state {STATE}, d_conv {CONV}, d_inner "
            f"up to {MAX_D_INNER} and dt_rank + 2 d_state up to {MAX_XDBL}, got {n}, {W}, "
            f"{di} and {r + 2 * n} ({_NOT_BUILT})")
    shapes = dict(xz=(b, l, 2 * di), conv_wt=(W, di), conv_b=(di,), x_proj=(di, r + 2 * n),
                  dt_proj=(r, di), dtb=(di,), at=(n, di), d=(di,), g=(b, l, di),
                  h_entries=(b, -(-l // CHUNK), n, di))
    for name, t in named.items():
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shapes[name]}")
    return b, l, di, r


def _pointers(tensors) -> ctypes.Array:
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


def _launch_fwd(args, states: bool, segments: int | None = None):
    """K10 (with ``states``, the variant that writes h_entries). ``segments``
    forces the number of segments of L (1: one pass); by default the
    kernel's own choice for the shape (``fused_mixer_fwd_segments``)."""
    if segments is not None and segments < 1:
        raise ValueError(f"segments must be at least 1, got {segments}")
    b, l, di, r = _check_inputs(args)
    xz, n = args[0], args[6].shape[0]
    f32 = dict(dtype=torch.float32, device=xz.device)
    y = torch.empty((b, l, di), **f32)
    h_entries = torch.empty((b, -(-l // CHUNK), n, di), **f32) if states else None
    if y.numel() == 0:
        return y, h_entries
    lib = _fwd_library()
    if segments is None:
        segments = lib.fused_mixer_fwd_segments(b, l, di)
    h_end = torch.empty((b, segments - 1, n, di), **f32)
    dsum = torch.empty((b, segments - 1, di), **f32)
    stream = torch.cuda.current_stream(xz.device).cuda_stream
    with torch.cuda.device(xz.device):
        err = lib.fused_mixer_fwd(_pointers(args), y.data_ptr(),
                                  h_entries.data_ptr() if states else None,
                                  h_end.data_ptr(), dsum.data_ptr(), b, l, di, n, r, CONV,
                                  segments, stream)
    if err != 0:
        msg = lib.fused_mixer_fwd_error_string(err).decode()
        raise RuntimeError(f"fused-mixer forward kernel launch failed: {msg} ({err})")
    if states:
        fused_mixer_fwd_states.launches += 1
    else:
        fused_mixer_fwd.launches += 1
    return y, h_entries


def _launch_bwd(args, h_entries, g):
    b, l, di, r = _check_inputs(args, dict(h_entries=h_entries, g=g))
    xz, n = args[0], args[6].shape[0]
    f32 = dict(dtype=torch.float32, device=xz.device)
    dxz = torch.empty((b, l, 2 * di), **f32)
    # per-batch-row partials: dx_proj, ddt_proj, dconv_wt, dconv_b, dat, dd, ddtb
    parts = [torch.empty(shape, **f32) for shape in (
        (b, di, r + 2 * n), (b, r, di), (b, CONV, di), (b, di), (b, n, di), (b, di), (b, di))]
    if dxz.numel() == 0:
        return (dxz, *(torch.zeros(t.shape[1:], **f32) for t in parts))
    lib = _bwd_library()
    stream = torch.cuda.current_stream(xz.device).cuda_stream
    with torch.cuda.device(xz.device):
        err = lib.fused_mixer_bwd(_pointers((*args, h_entries, g)), _pointers((dxz, *parts)),
                                  b, l, di, n, r, CONV, stream)
    if err != 0:
        msg = lib.fused_mixer_bwd_error_string(err).decode()
        raise RuntimeError(f"fused-mixer backward kernel launch failed: {msg} ({err})")
    fused_mixer_bwd.launches += 1
    dx_proj, ddt_proj, dconv_wt, dconv_b, dat, dd, ddtb = (t.sum(dim=0) for t in parts)
    return dxz, dconv_wt, dconv_b, dx_proj, ddt_proj, ddtb, dat, dd


def fused_mixer_fwd(xz, conv_wt, conv_b, x_proj, dt_proj, dtb, at, d) -> torch.Tensor:
    """Lean forward (K10 without states): y (b, l, d). Inputs contiguous, in
    the layouts of the module docstring. The kernel on a CUDA tensor (or an
    error), the y of :func:`fused_mixer_fwd_ref` on the CPU.
    ``fused_mixer_fwd.launches`` counts kernel launches."""
    args = (xz, conv_wt, conv_b, x_proj, dt_proj, dtb, at, d)
    if xz.is_cuda:
        return _launch_fwd(args, states=False)[0]
    return fused_mixer_fwd_ref(*args, chunk=CHUNK)[0]


def fused_mixer_fwd_states(xz, conv_wt, conv_b, x_proj, dt_proj, dtb, at, d):
    """Training forward (K10 with states): (y, h_entries (b, ceil(l / CHUNK),
    n, d) fp32). The kernel on a CUDA tensor, :func:`fused_mixer_fwd_ref` on
    the CPU. ``fused_mixer_fwd_states.launches`` counts kernel launches."""
    args = (xz, conv_wt, conv_b, x_proj, dt_proj, dtb, at, d)
    if xz.is_cuda:
        return _launch_fwd(args, states=True)
    return fused_mixer_fwd_ref(*args, chunk=CHUNK, emit_states=True)


def fused_mixer_bwd(xz, conv_wt, conv_b, x_proj, dt_proj, dtb, at, d, h_entries, g):
    """Backward (K11): (dxz, dconv_wt, dconv_b, dx_proj, ddt_proj, ddtb, dat,
    dd) for the output gradient g (b, l, d) and the forward's h_entries. The
    kernel on a CUDA tensor (the weight gradients are per-batch-row partials
    summed by ``torch.sum``), :func:`fused_mixer_bwd_ref` on the CPU.
    ``fused_mixer_bwd.launches`` counts kernel launches."""
    args = (xz, conv_wt, conv_b, x_proj, dt_proj, dtb, at, d)
    if xz.is_cuda:
        return _launch_bwd(args, h_entries, g)
    return fused_mixer_bwd_ref(*args, h_entries, g, chunk=CHUNK)


class FusedMixerFn(torch.autograd.Function):
    """The fused interior with its backward: K10 with states forward and K11
    backward on a CUDA tensor, the plain versions on the CPU, or on any
    device with ``plain=True`` (the port's 'fused_interpret'). Inputs as
    :func:`fused_mixer_fwd`, then ``plain``."""

    @staticmethod
    def forward(ctx, xz, conv_wt, conv_b, x_proj, dt_proj, dtb, at, d, plain):
        args = (xz, conv_wt, conv_b, x_proj, dt_proj, dtb, at, d)
        if plain:
            y, h_entries = fused_mixer_fwd_ref(*args, chunk=CHUNK, emit_states=True)
        else:
            y, h_entries = fused_mixer_fwd_states(*args)
        ctx.save_for_backward(*args, h_entries)
        ctx.plain = plain
        return y

    @staticmethod
    def backward(ctx, g):
        *args, h_entries = ctx.saved_tensors
        g = g.contiguous()
        if ctx.plain:
            grads = fused_mixer_bwd_ref(*args, h_entries, g, chunk=CHUNK)
        else:
            grads = fused_mixer_bwd(*args, h_entries, g)
        return (*grads, None)


def kernel_inputs(xz, conv_w, conv_b, x_proj_w, dt_proj_w, dt_proj_b, A, D, *,
                  dt_rank: int, d_state: int) -> tuple:
    """(xz, conv_wt, conv_b, x_proj, dt_proj, dtb, at, d), the kernels'
    inputs, from the ``mamba_mixer_apply`` layouts (conv_w (d_inner, W),
    x_proj_w (d_inner, dt_rank + 2n), dt_proj_w (dt_rank, d_inner), A
    (d_inner, n)): conv_w and A transposed, x_proj_w and dt_proj_w as they
    are (no copy when they are contiguous float32), all contiguous.
    Differentiable PyTorch operations."""
    acc = _acc_dtype(xz)
    if x_proj_w.shape[-1] != dt_rank + 2 * d_state or dt_proj_w.shape[0] != dt_rank:
        raise ValueError(f"x_proj_w {tuple(x_proj_w.shape)} and dt_proj_w "
                         f"{tuple(dt_proj_w.shape)} do not match dt_rank {dt_rank} and "
                         f"d_state {d_state}")
    return (xz.contiguous(), conv_w.to(acc).t().contiguous(), conv_b.to(acc).contiguous(),
            x_proj_w.to(acc).contiguous(), dt_proj_w.to(acc).contiguous(),
            dt_proj_b.to(acc).contiguous(), A.to(acc).t().contiguous(), D.to(acc).contiguous())


def fused_mamba_mixer(xz, conv_w, conv_b, x_proj_w, dt_proj_w, dt_proj_b, A, D, *,
                      dt_rank: int, d_state: int, plain: bool = False) -> torch.Tensor:
    """The counterpart of the JAX package's ``fused_mamba_mixer``: the mixer
    interior, xz (b, l, 2 d_inner) -> y (b, l, d_inner), parameters in the
    layouts of :func:`kernel_inputs`.

    The transposes are PyTorch operations outside the autograd Function, so
    their gradients come from autograd. With a gradient wanted this is
    :class:`FusedMixerFn`, else the lean forward (K10 without states on a
    CUDA tensor). ``plain=True`` takes the plain versions on any device."""
    args = kernel_inputs(xz, conv_w, conv_b, x_proj_w, dt_proj_w, dt_proj_b, A, D,
                         dt_rank=dt_rank, d_state=d_state)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (
            xz, conv_w, conv_b, x_proj_w, dt_proj_w, dt_proj_b, A, D)):
        return FusedMixerFn.apply(*args, plain)
    if plain:
        return fused_mixer_fwd_ref(*args, chunk=CHUNK)[0]
    return fused_mixer_fwd(*args)


fused_mixer_fwd.launches = 0
fused_mixer_fwd_states.launches = 0
fused_mixer_bwd.launches = 0
