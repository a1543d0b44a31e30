"""Mamba-1 selective scan, forward and backward: the CUDA kernels, their
plain versions and the autograd Function over them.

Kernels (fp32 activations; bf16 below):
- ``csrc/selective_scan_fwd.cu``, two variants of the TPU kernel
  ``_fwd_kernel`` (si_mamba_tpu/ops/pallas/selective_scan_kernel.py):
  the lean inference forward (K2, ``emit_residuals=False``), and the training
  forward (K3, ``emit_residuals=True`` through ``_vjp_fwd``), which also writes
  the fp32 state at the entry of every :data:`CHUNK`-step tile. Bound by bytes
  on the H100. Each channel's 16 states are split over 4 lanes, so the
  (B, L, d, n) discretised tensors never reach device memory and the grid
  fills the card at the train batch; at small batch L is cut into segments,
  scanned twice (end states from zero, then from the composed entry states),
  with the segment count the kernel picks for the shape (K3 the same as K2).
- ``csrc/selective_scan_bwd.cu`` (K4), which replaces ``_bwd_kernel``
  (``_pallas_scan_bwd``) and the partial sums of ``_vjp_bwd``. Held by
  instruction throughput and latency more than bytes; with the same lane
  split it walks the tiles in reverse inside each block, rebuilds a tile's
  states from its entry state into shared memory, carries dh in registers,
  and writes the channel and batch sums as partials that ``torch.sum``
  finishes (no atomics: bitwise deterministic).
The sources describe the designs. Both are built for d_state 16, the
width every shipped model uses; at any other d_state the wrappers launch
the variants of ``csrc/mamba_any.cu`` instead (one warp a block, one channel
a lane, the states and the tile's B and C in shared memory, or above
:data:`MAX_SHARED_STATE` in a global workspace; the backward rebuilds each
tile's states into a per-block scratch and sums dB and dC over the warp's
channels into per-block partials), chosen by d_state before the launch, with
their own launch counts (``ANY_LAUNCHES``) and the same h_entries layout.

At bf16 activations and d_state 16 (perf mode, every bf16 Mamba-1 model) the
three run on their Hopper body instead, ``csrc/selective_scan_bf16_sm90.cu``
(:data:`SM90_SOURCE`, :func:`sm90_serves`): tiles by the tensor memory
accelerator, the per-step channel scalars once a tile, two channels by four
states a lane, and a backward over :data:`SM90_TILE`-step tiles that keeps
the rebuilt states in registers and their decays in shared memory (one ex2 a
state element), so its K3 writes h_entries every :data:`SM90_TILE` steps
(:func:`entry_tile`; the plain versions take the tile as an argument). Its
launches count on ``SM90_LAUNCHES`` ('_sm90' before the dtype, as the Hopper
K8/K9 count). Views the tensor maps cannot read go through
:func:`tma_view`.

Together they take fp32 or bf16 activations (u, delta, B, C, z and g, one
dtype) with fp32 A, D, delta_bias and state, as the TPU kernels do at either
activation dtype: y, du, ddelta and dz come back in the activation dtype,
dB and dC summed in fp32 and then cast to it, dA, dD and ddelta_bias in
fp32. The bf16 backward rounds its recomputed y_pre to bf16 before dz, as
the TPU kernel reads the y_pre its forward stored in the activation dtype.

:func:`selective_scan_fused` runs K2 when no gradient is wanted and
:class:`SelectiveScanFn` (K3 forward, K4 backward) when one is; on a CPU
tensor each is its plain version. Nothing falls back from one to the other.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from si_mamba_tpu_torch.ops.kernels import any_shape
from si_mamba_tpu_torch.ops.kernels.build import LaunchCount, load_library

# Steps per tile of the forward kernels' h_entries and of the backward's
# rebuild (kChunk in both CUDA sources; checked when they are loaded).
CHUNK = 16
# the same of the Hopper bf16 body (kHTile of csrc/selective_scan_bf16_sm90.cu)
SM90_TILE = 8
SM90_SOURCE = "selective_scan_bf16_sm90"

_NAMES = ("u", "delta", "A", "B", "C", "D", "z", "delta_bias")
# the activation dtypes the kernels are built for; the operands below are fp32
KERNEL_DTYPES = (torch.float32, torch.bfloat16)
_FP32_OPERANDS = ("A", "D", "delta_bias", "h_entries")
TUNED_STATE = 16  # the d_state selective_scan_{fwd,bwd}.cu are built for (kState)
MAX_SHARED_STATE = 256  # above it the any-state variants' arrays live in a workspace (kMaxState)
# the launch counts of the any-state variants (csrc/mamba_any.cu), by name
ANY_LAUNCHES = {name + suffix: LaunchCount()
                for name in ("selective_scan_fwd_any", "selective_scan_fwd_residuals_any",
                             "selective_scan_bwd_any") for suffix in ("", "_bf16")}
# the launch counts of the Hopper bf16 body's K2, K3 and K4, by name
SM90_LAUNCHES = {name: LaunchCount()
                 for name in ("selective_scan_fwd_sm90_bf16",
                              "selective_scan_fwd_residuals_sm90_bf16",
                              "selective_scan_bwd_sm90_bf16")}


def sm90_serves(dtype: torch.dtype, n: int) -> bool:
    """Whether the Hopper bf16 body runs a scan of activation ``dtype`` and
    d_state ``n``: bf16 at the tuned d_state."""
    return dtype == torch.bfloat16 and n == TUNED_STATE


def entry_tile(dtype: torch.dtype, n: int) -> int:
    """The steps between the states in h_entries of a scan of activation
    ``dtype`` and d_state ``n``: :data:`SM90_TILE` where the Hopper bf16 body
    runs it, else :data:`CHUNK`. The plain versions keep the same contract on
    the CPU."""
    return SM90_TILE if sm90_serves(dtype, n) else CHUNK


def _acc_dtype(u: torch.Tensor) -> torch.dtype:
    """The plain versions compute in fp32, or in fp64 for fp64 input."""
    return torch.promote_types(u.dtype, torch.float32)


def selective_scan_ref(u, delta, A, B, C, D=None, z=None, delta_bias=None,
                       delta_softplus: bool = True) -> torch.Tensor:
    """Plain version, sequential in time: the correctness oracle.

    u, delta, z: (b, l, d); A: (d, n); B, C: (b, l, n); D, delta_bias: (d,).
    The (b, d, n) state (fp32, or fp64 for fp64 input) is carried one step at
    a time, so no (b, l, d, n) tensor is built. Returns (b, l, d) in u's dtype."""
    acc = _acc_dtype(u)
    delta = delta.to(acc)
    if delta_bias is not None:
        delta = delta + delta_bias.to(acc)
    if delta_softplus:
        delta = F.softplus(delta)
    u32, A32, B32, C32 = u.to(acc), A.to(acc), B.to(acc), C.to(acc)
    b, l, d = u32.shape
    h = u32.new_zeros((b, d, A32.shape[1]))
    ys = []
    for t in range(l):
        dt_t = delta[:, t, :, None]  # (b, d, 1)
        h = torch.exp(dt_t * A32) * h + (dt_t * u32[:, t, :, None]) * B32[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, C32[:, t]))
    y = torch.stack(ys, dim=1) if ys else u32.new_zeros((b, 0, d))
    if D is not None:
        y = y + u32 * D.to(acc)
    if z is not None:
        y = y * F.silu(z.to(acc))
    return y.to(u.dtype)


def selective_scan_fwd_residuals_ref(u, delta, A, B, C, D, z, delta_bias, tile: int = CHUNK):
    """Plain version of the training forward: (y, h_entries), where
    h_entries (b, ceil(l / tile), n, d) holds the state before steps 0,
    tile, 2 tile, ... (fp32, or fp64 for fp64 input); y in u's dtype."""
    acc = _acc_dtype(u)
    dl = F.softplus(delta.to(acc) + delta_bias.to(acc))
    u32, A32, B32, C32 = u.to(acc), A.to(acc), B.to(acc), C.to(acc)
    b, l, d = u32.shape
    h = u32.new_zeros((b, d, A32.shape[1]))
    ys, entries = [], []
    for t in range(l):
        if t % tile == 0:
            entries.append(h.transpose(1, 2))
        dt_t = dl[:, t, :, None]
        h = torch.exp(dt_t * A32) * h + (dt_t * u32[:, t, :, None]) * B32[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, C32[:, t]))
    y = torch.stack(ys, dim=1) if ys else u32.new_zeros((b, 0, d))
    y = (y + u32 * D.to(acc)) * F.silu(z.to(acc))
    h_entries = (torch.stack(entries, dim=1) if entries
                 else u32.new_zeros((b, 0, A32.shape[1], d)))
    return y.to(u.dtype), h_entries


def selective_scan_bwd_ref(u, delta, A, B, C, D, z, delta_bias, g, h_entries,
                           tile: int = CHUNK):
    """Plain backward, written out as the kernels compute it: for each tile
    of ``tile`` steps (h_entries' spacing), last first, a plain forward
    recompute of the tile's states from its entry state, then the explicit
    reverse recurrence

        dh_t = gy_t C_t + a_{t+1} dh_{t+1},   gy_t = g_t silu(z_t),

    with dh carried across tiles. y_pre = C.h + D u is rounded to u's dtype
    before dz, as the TPU kernel's forward stores it. Returns (du, ddelta,
    dA, dB, dC, dD, dz, ddelta_bias) in the dtypes of the corresponding
    inputs."""
    acc = _acc_dtype(u)
    raw = delta.to(acc) + delta_bias.to(acc)
    dl, sig_raw = F.softplus(raw), torch.sigmoid(raw)
    u32, A32, B32, C32 = u.to(acc), A.to(acc), B.to(acc), C.to(acc)
    D32, z32, g32 = D.to(acc), z.to(acc), g.to(acc)
    b, l, d = u32.shape
    sig_z = torch.sigmoid(z32)
    gy = g32 * z32 * sig_z
    dz_gate = g32 * sig_z * (1.0 + z32 * (1.0 - sig_z))
    du, dlt, dz = (torch.empty_like(u32) for _ in range(3))
    dB, dC = torch.empty_like(B32), torch.empty_like(C32)
    dA = torch.zeros_like(A32)
    dh = u32.new_zeros((b, d, A32.shape[1]))  # a_{t+1} dh_{t+1}
    for c in reversed(range(h_entries.shape[1])):
        t0, t1 = c * tile, min((c + 1) * tile, l)
        h = h_entries[:, c].to(acc).transpose(1, 2)  # (b, d, n)
        prev = []  # the state before each step of the tile
        for t in range(t0, t1):
            prev.append(h)
            dt_t = dl[:, t, :, None]
            h = torch.exp(dt_t * A32) * h + (dt_t * u32[:, t, :, None]) * B32[:, t, None, :]
        for t in reversed(range(t0, t1)):
            hp = prev[t - t0]
            dt_t = dl[:, t, :, None]
            a = torch.exp(dt_t * A32)
            dbu = dt_t * u32[:, t, :, None]  # (b, d, 1)
            ht = a * hp + dbu * B32[:, t, None, :]
            y_pre = (torch.einsum("bdn,bn->bd", ht, C32[:, t]) + D32 * u32[:, t]
                     ).to(u.dtype).to(acc)
            dz[:, t] = dz_gate[:, t] * y_pre
            dh = gy[:, t, :, None] * C32[:, t, None, :] + dh
            daa = dh * hp * a
            dA += torch.sum(daa * dt_t, dim=0)
            dhb = torch.einsum("bdn,bn->bd", dh, B32[:, t])
            ddelta = torch.sum(daa * A32, dim=-1) + dhb * u32[:, t]
            dlt[:, t] = ddelta * sig_raw[:, t]
            du[:, t] = dl[:, t] * dhb + gy[:, t] * D32
            dB[:, t] = torch.sum(dh * dbu, dim=1)
            dC[:, t] = torch.einsum("bdn,bd->bn", ht, gy[:, t])
            dh = a * dh
    dD = torch.sum(gy * u32, dim=(0, 1))
    ddb = torch.sum(dlt, dim=(0, 1))
    outs = (du, dlt, dA, dB, dC, dD, dz, ddb)
    like = (u, delta, A, B, C, D, z, delta_bias)
    return tuple(o.to(t.dtype) for o, t in zip(outs, like))


def _set_argtypes(fn, argtypes):
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int


_P, _I, _LLP = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)
_FWD_TAIL = [_I] * 5 + [_LLP, _P]  # Bsz, L, D, N, segments, strides, stream
_BWD_ARGS = [_P, _P] + [_I] * 4 + [_LLP, _P]  # inputs, outputs, Bsz, L, D, N, strides, stream
# The C entry points of the Hopper bf16 library with their argument lists:
# K2 (the pointers through y, h_end, dsum), K3 (h_entries after y), K4 (as
# the fp32 backward's, 13 strides).
SM90_ENTRIES = {"scan_sm90_fwd": [_P] * 11 + _FWD_TAIL,
                "scan_sm90_fwd_residuals": [_P] * 12 + _FWD_TAIL,
                "scan_sm90_bwd": _BWD_ARGS}


def fwd_interface(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a built ``csrc/selective_scan_fwd.cu``."""
    _set_argtypes(lib.selective_scan_fwd, [_P] * 11 + _FWD_TAIL)
    _set_argtypes(lib.selective_scan_fwd_residuals, [_P] * 12 + _FWD_TAIL)
    _set_argtypes(lib.selective_scan_fwd_segments, [ctypes.c_int] * 3)
    lib.selective_scan_chunk_len.restype = ctypes.c_int
    if lib.selective_scan_chunk_len() != CHUNK:
        raise RuntimeError("csrc/selective_scan_fwd.cu's kChunk differs from CHUNK")
    lib.selective_scan_error_string.argtypes = [ctypes.c_int]
    lib.selective_scan_error_string.restype = ctypes.c_char_p
    return lib


def bwd_interface(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a built ``csrc/selective_scan_bwd.cu``."""
    _set_argtypes(lib.selective_scan_bwd, _BWD_ARGS)
    lib.selective_scan_bwd_chunk_len.restype = ctypes.c_int
    lib.selective_scan_bwd_block_channels.restype = ctypes.c_int
    if lib.selective_scan_bwd_chunk_len() != CHUNK:
        raise RuntimeError("csrc/selective_scan_bwd.cu's kChunk differs from CHUNK")
    lib.selective_scan_bwd_error_string.argtypes = [ctypes.c_int]
    lib.selective_scan_bwd_error_string.restype = ctypes.c_char_p
    return lib


def sm90_interface(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a built ``csrc/selective_scan_bf16_sm90.cu``
    (``SM90_ENTRIES``)."""
    for name, argtypes in SM90_ENTRIES.items():
        _set_argtypes(getattr(lib, name), argtypes)
    _set_argtypes(lib.scan_sm90_segments, [ctypes.c_int] * 3)
    lib.scan_sm90_entry_tile.restype = ctypes.c_int
    lib.scan_sm90_block_channels.restype = ctypes.c_int
    if lib.scan_sm90_entry_tile() != SM90_TILE:
        raise RuntimeError("csrc/selective_scan_bf16_sm90.cu's kHTile differs from SM90_TILE")
    lib.scan_sm90_error_string.argtypes = [ctypes.c_int]
    lib.scan_sm90_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _fwd_library() -> ctypes.CDLL:
    return fwd_interface(load_library("selective_scan_fwd"))


@functools.cache
def _sm90_library() -> ctypes.CDLL:
    return sm90_interface(load_library(SM90_SOURCE))


@functools.cache
def _bwd_library() -> ctypes.CDLL:
    return bwd_interface(load_library("selective_scan_bwd"))


def _check_inputs(tensors: dict, extra: dict | None = None) -> tuple[int, int, int, int]:
    """Raise for anything the kernels do not take; returns (b, l, d, n)."""
    u, A = tensors["u"], tensors["A"]
    tensors = tensors | extra if extra else tensors
    bsz, L, d = u.shape
    n = A.shape[1]
    if n < 1:
        raise ValueError(f"the selective-scan kernels take d_state 1 or more, got {n}")
    if u.dtype not in KERNEL_DTYPES:
        raise TypeError(f"the selective-scan kernels take float32 or bfloat16 u; u is {u.dtype}")
    for name, t in tensors.items():
        want = torch.float32 if name in _FP32_OPERANDS else u.dtype
        if t.dtype != want:
            raise TypeError(f"the selective-scan kernels take {name} in {want} for u in "
                            f"{u.dtype}; {name} is {t.dtype}")
        if not t.is_cuda or t.device != u.device:
            raise ValueError(f"{name} must lie on u's CUDA device")
        if t.stride(-1) != 1:
            raise ValueError(f"the selective-scan kernels need unit stride along "
                             f"{name}'s last axis")
    shapes = dict(u=(bsz, L, d), delta=(bsz, L, d), z=(bsz, L, d), A=(d, n), B=(bsz, L, n),
                  C=(bsz, L, n), D=(d,), delta_bias=(d,), g=(bsz, L, d),
                  h_entries=(bsz, -(-L // entry_tile(u.dtype, n)), n, d))
    for name, t in tensors.items():
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shapes[name]}")
    if bsz > 65535:
        raise ValueError(f"the selective-scan kernels take at most 65535 batch rows, got {bsz}")
    if n != TUNED_STATE:
        return bsz, L, d, n
    widest = max([d] + [t.stride(1) for name, t in tensors.items()
                        if name in ("u", "delta", "z", "B", "C", "g")])
    if (L + CHUNK) * widest >= 2 ** 31:
        raise ValueError("the selective-scan kernels address a batch row with 32-bit offsets; "
                         f"L={L} rows of stride {widest} do not fit")
    return bsz, L, d, n


def _rows(*ts):
    """The (batch, row) strides of each tensor, as the kernels take them."""
    vals = [s for t in ts for s in (t.stride(0), t.stride(1))]
    return (ctypes.c_longlong * len(vals))(*vals)


def _tma_ready(t: torch.Tensor) -> bool:
    """Whether the tensor memory accelerator can read ``t`` as it lies: unit
    stride along its last axis, its start and every stride of an axis longer
    than 1 16-byte aligned."""
    size, st = t.element_size(), t.stride()
    return (st[-1] == 1 and t.data_ptr() % 16 == 0
            and all(s * size % 16 == 0 for s, k in zip(st[:-1], t.shape[:-1]) if k > 1))


def tma_view(t: torch.Tensor) -> torch.Tensor:
    """``t`` where the Hopper body's tensor maps can read it (``_tma_ready``),
    else a copy of it whose rows are padded to 16 bytes, as a view of their
    first ``t.shape[-1]`` elements."""
    if _tma_ready(t):
        return t
    w = t.shape[-1]
    per = 16 // t.element_size()
    buf = torch.empty((*t.shape[:-1], -(-w // per) * per), dtype=t.dtype, device=t.device)
    return buf[..., :w].copy_(t)


def _tma_operands(*ts) -> tuple[list, list]:
    """Each (b, l, w) tensor of ``ts`` through :func:`tma_view`, and the
    (batch, row) strides of each as the tensor maps take them: a stride of an
    axis of length 1 is never followed, so it is replaced by an aligned one.
    One pass over the tensors: the wrappers' host time per call counts at
    small batch."""
    views, strides = [], []
    for t in ts:
        (nb, nl, w), (sb, sr, sc) = t.shape, t.stride()
        per = 16 // t.element_size()
        # _tma_ready, written out for (b, l, w)
        if sc != 1 or t.data_ptr() % 16 or (nl > 1 and sr % per) or (nb > 1 and sb % per):
            t = tma_view(t)
            sb, sr, _ = t.stride()
        if nl == 1:
            sr = -(-w // per) * per
        views.append(t)
        strides += [sb if nb > 1 else nl * sr, sr]
    return views, strides


def _launch_fwd(u, delta, A, B, C, D, z, delta_bias, residuals: bool,
                segments: int | None = None):
    """K2 (K3 with ``residuals``). ``segments`` forces the number of
    segments of L (1: the one-pass scan); by default the kernel's own choice
    for the shape (``selective_scan_fwd_segments``, ``scan_sm90_segments``)."""
    args = dict(zip(_NAMES, (u, delta, A, B, C, D, z, delta_bias)))
    bsz, L, d, n = _check_inputs(args)
    A, D, delta_bias = A.contiguous(), D.contiguous(), delta_bias.contiguous()
    f32 = dict(dtype=torch.float32, device=u.device)
    y = torch.empty((bsz, L, d), dtype=u.dtype, device=u.device)
    h_entries = (torch.empty((bsz, -(-L // entry_tile(u.dtype, n)), n, d), **f32)
                 if residuals else None)
    if y.numel() == 0:
        return y, h_entries
    if n != TUNED_STATE:
        return _run_fwd_any(u, delta, A, B, C, D, z, delta_bias, y, h_entries)
    sm90 = sm90_serves(u.dtype, n)
    if sm90:
        lib, segments_of, error_string = (_sm90_library(), "scan_sm90_segments",
                                          "scan_sm90_error_string")
        (u, delta, B, C, z), strides = _tma_operands(u, delta, B, C, z)
        strides = (ctypes.c_longlong * len(strides))(*strides)
        entry = lib.scan_sm90_fwd_residuals if residuals else lib.scan_sm90_fwd
    else:
        lib, segments_of, error_string = (_fwd_library(), "selective_scan_fwd_segments",
                                          "selective_scan_error_string")
        strides = _rows(u, delta, B, C, z)
        entry = lib.selective_scan_fwd_residuals if residuals else lib.selective_scan_fwd
    if segments is None:
        segments = getattr(lib, segments_of)(bsz, L, d)
    # scratch of the segmented scan: each segment's end state and delta sum
    h_end = torch.empty((bsz, segments - 1, n, d), **f32)
    dsum = torch.empty((bsz, segments - 1, d), **f32)
    ptrs = [t.data_ptr() for t in (u, delta, A, B, C, D, z, delta_bias, y)]
    if residuals:
        ptrs.append(h_entries.data_ptr())
    ptrs += [h_end.data_ptr(), dsum.data_ptr()]
    stream = torch.cuda.current_stream(u.device).cuda_stream
    with torch.cuda.device(u.device):
        err = entry(*ptrs, bsz, L, d, n, segments, strides, stream)
    if err != 0:
        msg = getattr(lib, error_string)(err).decode()
        raise RuntimeError(f"selective-scan forward kernel launch failed: {msg} ({err})")
    if sm90:
        SM90_LAUNCHES["selective_scan_fwd_residuals_sm90_bf16" if residuals
                      else "selective_scan_fwd_sm90_bf16"].launches += 1
    else:
        (selective_scan_fwd_residuals if residuals else selective_scan_fwd).launches += 1
    return y, h_entries


def _any_strides(*ts) -> ctypes.Array:
    return any_shape.longs([s for t in ts for s in (t.stride(0), t.stride(1))])


def _workspace(bsz: int, d: int, n: int, backward: bool, device) -> torch.Tensor | None:
    """The any-state kernels' per-block arrays in device memory, where
    d_state is above MAX_SHARED_STATE; None (shared memory) at or below it."""
    floats = any_shape.library().scan_any_workspace_floats(bsz, d, n, int(backward))
    return torch.empty(floats, dtype=torch.float32, device=device) if floats else None


def _run_fwd_any(u, delta, A, B, C, D, z, delta_bias, y, h_entries):
    """The any-state K2 (K3 with h_entries) on checked inputs: one launch."""
    bsz, L, d = u.shape
    n = A.shape[1]
    bf16 = u.dtype == torch.bfloat16
    at = A.t().contiguous()  # the kernels take A transposed; alive until the launch
    ins = any_shape.pointers((u, delta, at, B, C, D, z, delta_bias, _workspace(bsz, d, n, False,
                                                                               u.device)))
    with torch.cuda.device(u.device):
        err = any_shape.entry("scan_any_fwd", bf16)(
            ins, y.data_ptr(), None if h_entries is None else h_entries.data_ptr(), bsz, L, d,
            n, _any_strides(u, delta, B, C, z), torch.cuda.current_stream(u.device).cuda_stream)
    any_shape.check(err, "selective-scan forward (any d_state)")
    name = "selective_scan_fwd_any" if h_entries is None else "selective_scan_fwd_residuals_any"
    ANY_LAUNCHES[name + ("_bf16" if bf16 else "")].launches += 1
    return y, h_entries


def _run_bwd_any(u, delta, A, B, C, D, z, delta_bias, g, h_entries):
    """The any-state K4 on checked inputs: one launch; the dB/dC partials of
    its 32-channel blocks and the dA, dD, ddelta_bias ones summed here."""
    bsz, L, d = u.shape
    n = A.shape[1]
    lib = any_shape.library()
    n_blk = -(-d // lib.scan_any_block_channels())
    f32 = dict(dtype=torch.float32, device=u.device)
    du, ddelta, dz = (torch.empty((bsz, L, d), dtype=u.dtype, device=u.device)
                      for _ in range(3))
    dB_part, dC_part = (torch.empty((bsz, n_blk, L, n), **f32) for _ in range(2))
    dA_part = torch.empty((bsz, d, n), **f32)
    dD_part, ddb_part = (torch.empty((bsz, d), **f32) for _ in range(2))
    states = torch.empty(lib.scan_any_state_floats(bsz, d, n), **f32)
    at = A.t().contiguous()  # the kernels take A transposed; alive until the launch
    ins = any_shape.pointers((u, delta, at, B, C, D, z, delta_bias, g, h_entries))
    outs = any_shape.pointers((du, ddelta, dz, dB_part, dC_part, dA_part, dD_part, ddb_part,
                               states, _workspace(bsz, d, n, True, u.device)))
    bf16 = u.dtype == torch.bfloat16
    with torch.cuda.device(u.device):
        err = any_shape.entry("scan_any_bwd", bf16)(
            ins, outs, states.numel(), bsz, L, d, n, _any_strides(u, delta, B, C, z, g),
            torch.cuda.current_stream(u.device).cuda_stream)
    any_shape.check(err, "selective-scan backward (any d_state)")
    ANY_LAUNCHES["selective_scan_bwd_any" + ("_bf16" if bf16 else "")].launches += 1
    return (du, ddelta, dA_part.sum(0), dB_part.sum(1).to(B.dtype), dC_part.sum(1).to(C.dtype),
            dD_part.sum(0), dz, ddb_part.sum(0))


def _launch_bwd(u, delta, A, B, C, D, z, delta_bias, g, h_entries):
    args = dict(zip(_NAMES, (u, delta, A, B, C, D, z, delta_bias)))
    bsz, L, d, n = _check_inputs(args, dict(g=g, h_entries=h_entries))
    A, D, delta_bias = A.contiguous(), D.contiguous(), delta_bias.contiguous()
    h_entries = h_entries.contiguous()
    if n != TUNED_STATE and u.numel():
        return _run_bwd_any(u, delta, A, B, C, D, z, delta_bias, g, h_entries)
    if sm90_serves(u.dtype, n):
        return _run_bwd_sm90(u, delta, A, B, C, D, z, delta_bias, g, h_entries)
    lib = _bwd_library()
    n_blk = -(-d // lib.selective_scan_bwd_block_channels())
    f32 = dict(dtype=torch.float32, device=u.device)
    du, ddelta, dz = (torch.empty((bsz, L, d), dtype=u.dtype, device=u.device)
                      for _ in range(3))
    dB_part, dC_part = (torch.empty((bsz, n_blk, L, n), **f32) for _ in range(2))
    dA_part = torch.empty((bsz, d, n), **f32)
    dD_part, ddb_part = (torch.empty((bsz, d), **f32) for _ in range(2))
    if du.numel() == 0:
        return (du, ddelta, torch.zeros_like(A), torch.zeros_like(B), torch.zeros_like(C),
                torch.zeros_like(D), dz, torch.zeros_like(delta_bias))
    ins = (ctypes.c_void_p * 10)(*(t.data_ptr() for t in (
        u, delta, A, B, C, D, z, delta_bias, g, h_entries)))
    outs = (ctypes.c_void_p * 8)(*(t.data_ptr() for t in (
        du, ddelta, dz, dB_part, dC_part, dA_part, dD_part, ddb_part)))
    stream = torch.cuda.current_stream(u.device).cuda_stream
    with torch.cuda.device(u.device):
        err = lib.selective_scan_bwd(ins, outs, bsz, L, d, n, _rows(u, delta, B, C, z, g), stream)
    if err != 0:
        msg = lib.selective_scan_bwd_error_string(err).decode()
        raise RuntimeError(f"selective-scan backward kernel launch failed: {msg} ({err})")
    selective_scan_bwd.launches += 1
    # dB and dC are summed in fp32, then cast to their inputs' dtype
    return (du, ddelta, dA_part.sum(0), dB_part.sum(1).to(B.dtype), dC_part.sum(1).to(C.dtype),
            dD_part.sum(0), dz, ddb_part.sum(0))


def _run_bwd_sm90(u, delta, A, B, C, D, z, delta_bias, g, h_entries):
    """The Hopper bf16 K4 on checked inputs: one launch, its partials packed
    as dB | dC (b, blocks, l, 2n) and dA | dD | ddelta_bias (b, d, n + 4,
    the last two columns 0), each finished by one torch.sum; views the tensor
    maps cannot read go through :func:`tma_view`."""
    bsz, L, d = u.shape
    n = A.shape[1]
    lib = _sm90_library()
    n_blk = -(-d // lib.scan_sm90_block_channels())
    f32 = dict(dtype=torch.float32, device=u.device)
    du, ddelta, dz = (torch.empty((bsz, L, d), dtype=u.dtype, device=u.device)
                      for _ in range(3))
    if du.numel() == 0:
        return (du, ddelta, torch.zeros_like(A), torch.zeros_like(B), torch.zeros_like(C),
                torch.zeros_like(D), dz, torch.zeros_like(delta_bias))
    dBC_part = torch.empty((bsz, n_blk, L, 2 * n), **f32)
    dADb_part = torch.empty((bsz, d, n + 4), **f32)
    (u, delta, B, C, z, g), strides = _tma_operands(u, delta, B, C, z, g)
    h_entries = tma_view(h_entries)
    strides.append(h_entries.stride(2))
    ins = (ctypes.c_void_p * 10)(*(t.data_ptr() for t in (
        u, delta, A, B, C, D, z, delta_bias, g, h_entries)))
    outs = (ctypes.c_void_p * 5)(*(t.data_ptr() for t in (du, ddelta, dz, dBC_part, dADb_part)))
    stream = torch.cuda.current_stream(u.device).cuda_stream
    with torch.cuda.device(u.device):
        err = lib.scan_sm90_bwd(ins, outs, bsz, L, d, n,
                                (ctypes.c_longlong * len(strides))(*strides), stream)
    if err != 0:
        msg = lib.scan_sm90_error_string(err).decode()
        raise RuntimeError(f"selective-scan backward kernel launch failed: {msg} ({err})")
    SM90_LAUNCHES["selective_scan_bwd_sm90_bf16"].launches += 1
    dBC = dBC_part.sum(1).to(B.dtype)  # summed in fp32, then cast to B's and C's dtype
    dADb = dADb_part.sum(0)
    return du, ddelta, dADb[:, :n], dBC[..., :n], dBC[..., n:], dADb[:, n], dz, dADb[:, n + 1]


def selective_scan_fwd(u, delta, A, B, C, D, z, delta_bias) -> torch.Tensor:
    """Fused inference forward (K2): softplus(delta + delta_bias), the fp32
    scan, the D skip and the silu(z) gate. Shapes as in
    :func:`selective_scan_ref`; each of u, delta, B, C, z needs unit stride
    only along its last axis. On a CUDA tensor this launches the kernel
    (activations float32 or bfloat16, A, D and delta_bias float32; at bf16
    and d_state 16 the Hopper body, at a d_state other than 16 the any-state
    variant) or raises; on the CPU it is :func:`selective_scan_ref`.
    ``selective_scan_fwd.launches`` counts the fp32 kernel's launches."""
    if u.is_cuda:
        return _launch_fwd(u, delta, A, B, C, D, z, delta_bias, residuals=False)[0]
    return selective_scan_ref(u, delta, A, B, C, D=D, z=z, delta_bias=delta_bias)


def selective_scan_fwd_residuals(u, delta, A, B, C, D, z, delta_bias):
    """Training forward (K3): (y, h_entries), h_entries (b, ceil(l / T),
    n, d) fp32 the state before each T-step tile, T = :func:`entry_tile`. The
    kernel on a CUDA tensor, :func:`selective_scan_fwd_residuals_ref` on the
    CPU. ``selective_scan_fwd_residuals.launches`` counts the fp32 kernel's
    launches."""
    if u.is_cuda:
        return _launch_fwd(u, delta, A, B, C, D, z, delta_bias, residuals=True)
    return selective_scan_fwd_residuals_ref(u, delta, A, B, C, D, z, delta_bias,
                                            tile=entry_tile(u.dtype, A.shape[1]))


def selective_scan_bwd(u, delta, A, B, C, D, z, delta_bias, g, h_entries):
    """Backward (K4): (du, ddelta, dA, dB, dC, dD, dz, ddelta_bias) for the
    output gradient g and the forward's h_entries. The kernel on a CUDA
    tensor (g and the inputs need unit stride only along their last axis),
    :func:`selective_scan_bwd_ref` on the CPU, h_entries
    :func:`entry_tile` steps apart in both.
    ``selective_scan_bwd.launches`` counts the fp32 kernel's launches."""
    if u.is_cuda:
        return _launch_bwd(u, delta, A, B, C, D, z, delta_bias, g, h_entries)
    return selective_scan_bwd_ref(u, delta, A, B, C, D, z, delta_bias, g, h_entries,
                                  tile=entry_tile(u.dtype, A.shape[1]))


class SelectiveScanFn(torch.autograd.Function):
    """The fused scan with its backward: K3 forward (keeping the tile entry
    states) and K4 backward on a CUDA tensor, the plain versions on the CPU."""

    @staticmethod
    def forward(ctx, u, delta, A, B, C, D, z, delta_bias):
        y, h_entries = selective_scan_fwd_residuals(u, delta, A, B, C, D, z, delta_bias)
        ctx.save_for_backward(u, delta, A, B, C, D, z, delta_bias, h_entries)
        return y

    @staticmethod
    def backward(ctx, g):
        if g.stride(-1) != 1:
            g = g.contiguous()
        *inputs, h_entries = ctx.saved_tensors
        return selective_scan_bwd(*inputs, g, h_entries)


def selective_scan_fused(u, delta, A, B, C, D, z, delta_bias) -> torch.Tensor:
    """The full fused scan, differentiable: :class:`SelectiveScanFn` when grad
    mode is on and an input requires grad, else the lean forward (K2 on a
    CUDA tensor)."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (u, delta, A, B, C, D, z, delta_bias)):
        return SelectiveScanFn.apply(u, delta, A, B, C, D, z, delta_bias)
    return selective_scan_fwd(u, delta, A, B, C, D, z, delta_bias)


def selective_scan_fwd_bf16(u, delta, A, B, C, D, z, delta_bias) -> torch.Tensor:
    """:func:`selective_scan_fwd` for bf16 activations, which it requires.
    At d_state 16 its launches count on
    ``SM90_LAUNCHES['selective_scan_fwd_sm90_bf16']``, whichever entry point
    reached the kernel."""
    _require_bf16(u)
    return selective_scan_fwd(u, delta, A, B, C, D, z, delta_bias)


def selective_scan_fwd_residuals_bf16(u, delta, A, B, C, D, z, delta_bias):
    """:func:`selective_scan_fwd_residuals` for bf16 activations, which it
    requires (``SM90_LAUNCHES['selective_scan_fwd_residuals_sm90_bf16']``)."""
    _require_bf16(u)
    return selective_scan_fwd_residuals(u, delta, A, B, C, D, z, delta_bias)


def selective_scan_bwd_bf16(u, delta, A, B, C, D, z, delta_bias, g, h_entries):
    """:func:`selective_scan_bwd` for bf16 activations, which it requires
    (``SM90_LAUNCHES['selective_scan_bwd_sm90_bf16']``)."""
    _require_bf16(u)
    return selective_scan_bwd(u, delta, A, B, C, D, z, delta_bias, g, h_entries)


def _require_bf16(u: torch.Tensor) -> None:
    if u.dtype != torch.bfloat16:
        raise TypeError(f"the _bf16 entry points take bfloat16 activations, got {u.dtype}")


selective_scan_fwd.launches = 0
selective_scan_fwd_residuals.launches = 0
selective_scan_bwd.launches = 0
