"""Causal depthwise conv + bias + SiLU, forward and backward: the CUDA
kernels, their plain versions and the autograd Function over them.

Kernels, both in ``csrc/causal_conv.cu``:
- forward (K1), which replaces the TPU kernel ``_fwd_kernel`` behind
  ``causal_conv1d_silu_pallas`` (si_mamba_tpu/ops/pallas/causal_conv_kernel.py).
  Bound by bytes on the H100 (one read of x, one write of y). A thread owns
  one time tile of up to four channels, moves them in one access of x and y
  of up to 8 bytes as their alignment allows, and loads its whole tile before
  the first multiply-add; :func:`fwd_plan` chooses the width, the tile and the block
  from the shape and the SM count, the C entry point checks;
- backward (K5), which replaces ``_bwd_kernel`` behind ``_cc_bwd``. Bound by
  bytes (one read of x and g, one write of dx). A thread owns four channels
  and one time tile, moves each operand 16, 8 or 4 bytes at a time as its
  alignment allows, in one of three built variants (:func:`bwd_plan`
  chooses, the C entry point checks),
  keeps four rows of x and g in flight, and writes dw and db as per-block
  partials that a second small kernel of the same call sums in a fixed order.
The source describes both designs.

Both kernels take fp32 or bf16 activations (x, g; y and dx come back in x's
dtype) with fp32 weight and bias, and compute in fp32, as the TPU kernels
do at either activation dtype; each dtype is its own variant with its own
launch count (``causal_conv1d_silu`` / ``causal_conv1d_silu_bf16`` for K1,
``causal_conv1d_silu_bwd`` / ``causal_conv1d_silu_bwd_bf16`` for K5). Both
plans count their vector widths in elements of x's dtype.

:func:`causal_conv1d_silu` is :class:`CausalConv1dSiluFn`: on a CUDA tensor
its forward and backward launch the kernels (or raise); on a CPU tensor they
are the plain versions. Nothing falls back from one to the other.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from si_mamba_tpu_torch.ops.kernels.build import load_library

# K5's geometry (csrc/causal_conv.cu: kWarps, kBwdChannels, kU): a block is
# BWD_WARPS warps on consecutive time tiles of the same BWD_BLOCK_CHANNELS
# channels (four a thread); a tile is a multiple of BWD_RING steps, at least
# two of them.
BWD_WARPS = 4
BWD_BLOCK_CHANNELS = 128
BWD_RING = 4
BWD_TILES = (64, 32, 16)  # the time tiles the plan picks from, longest first
# the (x, g and dx) vector widths K5 is built for, widest first: the Mamba-1
# view and the contiguous tensor-parallel operands, the SSD view, the rest
BWD_VARIANTS = ((4, 4), (2, 4), (1, 1))
BWD_WARPS_PER_SM = 8  # the least warps an SM the plan's tile aims for
H100_SMS = 132
# K1's geometry (csrc/causal_conv.cu): the bytes of its widest access of x
# and y; the time tiles, longest first; warps a block, most first
FWD_ACCESS_BYTES = 8
FWD_TILES = (8, 4)
FWD_WARPS = (4, 2, 1)
FWD_WARPS_PER_SM = 8  # the least warps of tiles an SM the plan's tile aims for
# the activation dtypes the kernels are built for; weight and bias are fp32
KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def _acc_dtype(x: torch.Tensor) -> torch.dtype:
    """The plain versions compute in fp32, or in fp64 for fp64 input."""
    return torch.promote_types(x.dtype, torch.float32)


def causal_conv1d_ref(x: torch.Tensor, weight: torch.Tensor,
                      bias: torch.Tensor | None = None,
                      activation: str | None = "silu") -> torch.Tensor:
    """Plain version: x (B, L, D), weight (D, W), bias (D,) -> (B, L, D).

    ``F.conv1d(x, w, groups=D, padding=W-1)[..., :L]`` written as W shifted
    multiply-adds, accumulated in fp32 and returned in x's dtype."""
    B, L, D = x.shape
    W = weight.shape[1]
    acc = _acc_dtype(x)
    x32 = x.to(acc)
    xpad = F.pad(x32, (0, 0, W - 1, 0))
    w32 = weight.to(acc)
    y = torch.zeros_like(x32) if bias is None else bias.to(acc).expand(B, L, D).clone()
    for k in range(W):
        y = y + w32[:, k] * xpad[:, k:k + L]
    if activation == "silu":
        y = F.silu(y)
    elif activation is not None:
        raise ValueError(f"unknown activation {activation!r}")
    return y.to(x.dtype)


def causal_conv1d_silu_bwd_ref(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                               g: torch.Tensor):
    """Plain backward of conv + bias + SiLU, written out as the kernel computes
    it: recompute s, ds = g * dsilu(s), dx[t] = sum_k w[k] ds[t+W-1-k],
    dw[:, k] = sum_{b,t} ds[t] x[t-W+1+k], db = sum_{b,t} ds.
    Returns (dx (B, L, D) in x's dtype, dw (D, W), db (D,))."""
    B, L, D = x.shape
    W = weight.shape[1]
    acc = _acc_dtype(x)
    x32, w32, g32 = x.to(acc), weight.to(acc), g.to(acc)
    xpad = F.pad(x32, (0, 0, W - 1, 0))  # xpad[:, t + k] = x[t - W + 1 + k]
    s = bias.to(acc).expand(B, L, D).clone()
    for k in range(W):
        s = s + w32[:, k] * xpad[:, k:k + L]
    sig = torch.sigmoid(s)
    ds = g32 * sig * (1.0 + s * (1.0 - sig))
    dspad = F.pad(ds, (0, 0, 0, W - 1))  # dspad[:, t + j] = ds[t + j], 0 past L
    dx = torch.zeros_like(x32)
    for k in range(W):
        dx = dx + w32[:, k] * dspad[:, W - 1 - k:W - 1 - k + L]
    dw = torch.stack([torch.sum(ds * xpad[:, k:k + L], dim=(0, 1)) for k in range(W)], dim=1)
    db = torch.sum(ds, dim=(0, 1))
    return dx.to(x.dtype), dw.to(weight.dtype), db.to(bias.dtype)


def interface(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C argument lists of a built ``causal_conv.cu``."""
    lib.causal_conv1d_silu_fwd.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + \
        [ctypes.c_longlong] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.causal_conv1d_silu_fwd.restype = ctypes.c_int
    lib.causal_conv1d_silu_bwd.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_longlong] + \
        [ctypes.c_int] * 4 + [ctypes.c_longlong] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.causal_conv1d_silu_bwd.restype = ctypes.c_int
    lib.causal_conv1d_silu_fwd_bf16.argtypes = lib.causal_conv1d_silu_fwd.argtypes
    lib.causal_conv1d_silu_fwd_bf16.restype = ctypes.c_int
    lib.causal_conv1d_silu_bwd_bf16.argtypes = lib.causal_conv1d_silu_bwd.argtypes
    lib.causal_conv1d_silu_bwd_bf16.restype = ctypes.c_int
    lib.causal_conv1d_error_string.argtypes = [ctypes.c_int]
    lib.causal_conv1d_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _library() -> ctypes.CDLL:
    return interface(load_library("causal_conv"))


@functools.cache
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def vector_width(ptr: int, batch: int, rows: int, batch_stride: int, row_stride: int,
                 size: int = 4, widths=(4, 2)) -> int:
    """Elements of ``size`` bytes a thread may move at once from or to a
    (batch, rows, D) operand at address ``ptr`` with unit stride along
    channels: the widest of ``widths`` for which the address is
    size·width-byte aligned and the batch and row strides (those in use: more
    than one batch, more than one row) are multiples of the width, else 1.
    The C entry points refuse any wider."""
    for width in widths:
        if ptr % (size * width) == 0 and (batch == 1 or batch_stride % width == 0) and \
                (rows == 1 or row_stride % width == 0):
            return width
    return 1


def fwd_vectors(size: int) -> tuple[int, ...]:
    """The channels a thread of K1 can move as one access of elements of
    ``size`` bytes, widest first: (2, 1) at fp32, (4, 2, 1) at bf16."""
    return tuple(v for v in (4, 2, 1) if v * size <= FWD_ACCESS_BYTES)


@dataclass(frozen=True)
class FwdPlan:
    """How K1 runs at one shape: the channels a thread moves as one access
    (``vec``, one of :func:`fwd_vectors`), the time tile, the warps a block
    and the grid (blocks over the (channel vector, tile) pairs of a batch
    row, batch rows)."""

    vec: int
    tile: int
    warps: int
    grid: tuple[int, int]


def fwd_tile(nv: int, B: int, L: int, sms: int = H100_SMS) -> int:
    """K1's time tile for ``nv`` channel vectors a row: the longest of
    FWD_TILES whose threads, one a (channel vector, tile) pair of each of the
    B rows, give every SM FWD_WARPS_PER_SM warps, else the shortest. Each tile
    re-reads the W - 1 rows before it (mostly from L2), so longer tiles move
    fewer bytes; shorter ones spread one cloud over more SMs."""
    return next((t for t in FWD_TILES if nv * -(-L // t) * B >= 32 * FWD_WARPS_PER_SM * sms),
                FWD_TILES[-1])


def fwd_block(pairs: int, B: int, sms: int = H100_SMS) -> tuple[int, tuple[int, int]]:
    """K1's warps a block and grid for ``pairs`` (channel vector, tile) pairs a
    batch row: the most of FWD_WARPS that still gives every SM a block, else
    one; the grid covers the pairs of each row, (blocks, B)."""
    warps = next((w for w in FWD_WARPS if -(-pairs // (32 * w)) * B >= sms), FWD_WARPS[-1])
    return warps, (-(-pairs // (32 * warps)), B)


def fwd_plan(x: torch.Tensor, sms: int = H100_SMS) -> FwdPlan:
    """K1's plan for x (B, L, D) with unit stride along channels: ``vec`` the
    most of :func:`fwd_vectors` that x's address and strides allow and that
    divides D (y is contiguous), the tile of :func:`fwd_tile` and the block of
    :func:`fwd_block`. 8-byte accesses at most: 16-byte ones were slower at
    every path shape (PERF.md §6)."""
    B, L, D = x.shape
    return _fwd_plan(B, L, D, x.stride(0), x.stride(1), x.element_size(),
                     x.data_ptr() % FWD_ACCESS_BYTES, sms)


@functools.lru_cache(maxsize=256)
def _fwd_plan(B: int, L: int, D: int, sb: int, sr: int, size: int, ptr: int,
              sms: int) -> FwdPlan:
    """:func:`fwd_plan` from what it reads of x: shape, batch and row strides,
    element size and address modulo the widest access. Cached: the layers of
    a model call it with the same few shapes, once a launch."""
    widths = fwd_vectors(size)
    wx = vector_width(ptr, B, L, sb, sr, size, widths)
    vec = next(v for v in widths if v <= wx and D % v == 0)
    nv = D // vec
    tile = fwd_tile(nv, B, L, sms)
    warps, grid = fwd_block(nv * -(-L // tile), B, sms)
    return FwdPlan(vec=vec, tile=tile, warps=warps, grid=grid)


@dataclass(frozen=True)
class BwdPlan:
    """How K5 runs at one shape: the vector width of x, that of g and dx (one
    of BWD_VARIANTS, in elements of x's dtype), the time tile, and the shape
    of the dw/db partials (see :func:`bwd_partials`)."""

    vx: int
    vg: int
    tile: int
    partial_shape: tuple[int, int, int]


def bwd_tile(B: int, L: int, D: int, sms: int = H100_SMS) -> int:
    """K5's time tile: the longest of BWD_TILES whose grid gives every SM at
    least BWD_WARPS_PER_SM warps (one tile a warp), else the shortest. Each
    tile re-reads W - 1 rows of x before it and W - 1 rows of x and g after it,
    3 / tile of its traffic, so longer tiles move fewer bytes, and shorter
    ones keep more loads in flight at narrow widths."""
    groups = -(-D // BWD_BLOCK_CHANNELS) * B
    for tile in BWD_TILES:
        if groups * -(-L // tile) >= BWD_WARPS_PER_SM * sms:
            return tile
    return BWD_TILES[-1]


def bwd_partials(B: int, L: int, D: int, W: int, tile: int) -> tuple[int, int, int]:
    """The shape of K5's dw/db partials, one (W + 1, D) row a block of
    BWD_WARPS tiles: (B * ceil(ceil(L / tile) / BWD_WARPS), W + 1, D)."""
    tiles = -(-L // tile)
    return (B * -(-tiles // BWD_WARPS), W + 1, D)


def bwd_plan(x: torch.Tensor, g: torch.Tensor, W: int = 4, sms: int = H100_SMS) -> BwdPlan:
    """K5's plan for x and g (B, L, D) of one dtype, each with unit stride
    along channels: the widest variant whose widths (in elements: 16, 8 or 4
    bytes a thread for fp32, 8, 4 or 2 for bf16) x's alignment and g's allow
    (dx is allocated contiguous, so its width follows from D), and the time
    tile of :func:`bwd_tile`."""
    B, L, D = x.shape
    size = x.element_size()
    wx = vector_width(x.data_ptr(), B, L, x.stride(0), x.stride(1), size)
    wg = min(vector_width(g.data_ptr(), B, L, g.stride(0), g.stride(1), size),
             vector_width(0, B, L, L * D, D, size))
    vx, vg = next(v for v in BWD_VARIANTS if v[0] <= wx and v[1] <= wg)
    tile = bwd_tile(B, L, D, sms)
    return BwdPlan(vx=vx, vg=vg, tile=tile, partial_shape=bwd_partials(B, L, D, W, tile))


def _check(lib, err: int, what: str) -> None:
    if err != 0:
        msg = lib.causal_conv1d_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} ({err})")


def _check_inputs(x, weight, bias, g=None) -> None:
    B, L, D = x.shape
    W = weight.shape[1]
    named = dict(x=x, weight=weight, bias=bias) | ({} if g is None else dict(g=g))
    if x.dtype not in KERNEL_DTYPES:
        raise TypeError(f"the causal-conv kernels take float32 or bfloat16 x; x is {x.dtype}")
    for name, t in named.items():
        want = x.dtype if name in ("x", "g") else torch.float32
        if t.dtype != want:
            raise TypeError(f"the causal-conv kernels take {name} in {want} for x in {x.dtype}; "
                            f"{name} is {t.dtype}")
        if not t.is_cuda or t.device != x.device:
            raise ValueError("x, weight, bias (and g) must lie on one CUDA device")
    if x.stride(2) != 1 or (g is not None and g.stride(2) != 1):
        raise ValueError("the causal-conv kernels need unit stride along channels")
    if weight.shape != (D, W) or bias.shape != (D,):
        raise ValueError(f"weight {tuple(weight.shape)} / bias {tuple(bias.shape)} "
                         f"do not match D={D}")
    if g is not None and g.shape != x.shape:
        raise ValueError(f"g has shape {tuple(g.shape)}, expected {tuple(x.shape)}")
    if W != 4:
        raise ValueError(f"the causal-conv kernels are built for width 4 (d_conv), got {W}")


def _aligned16(t: torch.Tensor) -> torch.Tensor:
    """t contiguous at a 16-byte aligned address (a copy only for a view
    that starts elsewhere): K1 reads its weight and bias 16 bytes at a time."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch_fwd(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    _check_inputs(x, weight, bias)
    return _run_fwd(x, _aligned16(weight), _aligned16(bias), fwd_plan(x, _sm_count(x.device)))


def _run_fwd(x, weight, bias, plan: FwdPlan) -> torch.Tensor:
    """K1 on checked inputs with ``plan``: one launch; y comes back
    contiguous in x's dtype."""
    B, L, D = x.shape
    y = torch.empty((B, L, D), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    lib = _library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    bf16 = x.dtype == torch.bfloat16
    entry = lib.causal_conv1d_silu_fwd_bf16 if bf16 else lib.causal_conv1d_silu_fwd
    with torch.cuda.device(x.device):
        err = entry(x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(), B, L, D,
                    weight.shape[1], x.stride(0), x.stride(1), plan.vec, plan.tile, plan.warps,
                    stream)
    _check(lib, err, "causal-conv forward")
    (causal_conv1d_silu_bf16 if bf16 else causal_conv1d_silu).launches += 1
    return y


def _launch_bwd(x, weight, bias, g):
    _check_inputs(x, weight, bias, g)
    return _run_bwd(x, weight.contiguous(), bias.contiguous(), g,
                    bwd_plan(x, g, weight.shape[1], _sm_count(x.device)))


def _run_bwd(x, weight, bias, g, plan: BwdPlan):
    """K5 on checked inputs with ``plan``: one C call, two launches (the
    tiles, then the fixed-order finish of dw and db). dx comes back in x's
    dtype, dw and db in fp32."""
    B, L, D = x.shape
    W = weight.shape[1]
    dx = torch.empty((B, L, D), dtype=x.dtype, device=x.device)
    dw, db = torch.empty_like(weight), torch.empty_like(bias)
    if dx.numel() == 0:
        return dx, dw.zero_(), db.zero_()
    part = torch.empty(plan.partial_shape, dtype=torch.float32, device=x.device)
    lib = _library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    bf16 = x.dtype == torch.bfloat16
    entry = lib.causal_conv1d_silu_bwd_bf16 if bf16 else lib.causal_conv1d_silu_bwd
    with torch.cuda.device(x.device):
        err = entry(
            x.data_ptr(), weight.data_ptr(), bias.data_ptr(), g.data_ptr(), dx.data_ptr(),
            dw.data_ptr(), db.data_ptr(), part.data_ptr(), part.numel(), B, L, D, W,
            x.stride(0), x.stride(1), g.stride(0), g.stride(1), plan.vx, plan.vg, plan.tile,
            stream)
    _check(lib, err, "causal-conv backward")
    (causal_conv1d_silu_bwd_bf16 if bf16 else causal_conv1d_silu_bwd).launches += 1
    return dx, dw, db


def causal_conv1d_silu_fwd(x: torch.Tensor, weight: torch.Tensor,
                           bias: torch.Tensor) -> torch.Tensor:
    """The forward alone, outside autograd: the kernel (K1) on a CUDA tensor,
    :func:`causal_conv1d_ref` on the CPU."""
    if x.is_cuda:
        return _launch_fwd(x, weight, bias)
    return causal_conv1d_ref(x, weight, bias, activation="silu")


def causal_conv1d_silu_bwd(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                           g: torch.Tensor):
    """(dx, dw, db) for the output gradient g: the kernel (K5) on a CUDA
    tensor (x and g float32 or bfloat16, W = 4; x and g need unit stride only
    along channels), :func:`causal_conv1d_silu_bwd_ref` on the CPU.
    ``causal_conv1d_silu_bwd.launches`` counts the fp32 kernel's launches,
    ``causal_conv1d_silu_bwd_bf16.launches`` the bf16 one's."""
    if x.is_cuda:
        return _launch_bwd(x, weight, bias, g)
    return causal_conv1d_silu_bwd_ref(x, weight, bias, g)


class CausalConv1dSiluFn(torch.autograd.Function):
    """Conv + bias + SiLU with its backward: K1 forward and K5 backward on a
    CUDA tensor, the plain versions on the CPU."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        ctx.save_for_backward(x, weight, bias)
        return causal_conv1d_silu_fwd(x, weight, bias)

    @staticmethod
    def backward(ctx, g):
        x, weight, bias = ctx.saved_tensors
        if g.stride(-1) != 1:
            g = g.contiguous()
        return causal_conv1d_silu_bwd(x, weight, bias, g)


def causal_conv1d_silu(x: torch.Tensor, weight: torch.Tensor,
                       bias: torch.Tensor) -> torch.Tensor:
    """Fused causal depthwise conv + bias + SiLU, differentiable. x: (B, L, D),
    unit stride along D (any batch and row stride, e.g. a column slice of the
    mixer's xz); weight (D, W) and bias (D,) fp32. On a CUDA tensor this
    launches the kernels (x float32 or bfloat16, W = 4) or raises; on the CPU
    it is the plain versions. ``causal_conv1d_silu.launches`` counts the fp32
    forward kernel's launches."""
    return CausalConv1dSiluFn.apply(x, weight, bias)


PALLAS_CONV_LANES = 128


def causal_conv1d_silu_as_jax(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                              pallas_conv: bool | None = None) -> torch.Tensor:
    """:func:`causal_conv1d_silu` handed the conv weights that the JAX
    package's conv reads. On the TPU its Pallas conv, which reads fp32
    weights, takes only widths that are a multiple of 128; any other width
    runs its XLA conv on the weights cast to the activation dtype. So where
    ``pallas_conv`` is False (by default: where x's width is not a multiple
    of 128) weight and bias are rounded to x's dtype and widened back to
    fp32, the kernels' weight dtype; at fp32 they are the weights as given."""
    if pallas_conv is None:
        pallas_conv = x.shape[-1] % PALLAS_CONV_LANES == 0
    if not pallas_conv:
        weight, bias = weight.to(x.dtype).float(), bias.to(x.dtype).float()
    return causal_conv1d_silu(x, weight, bias)


def causal_conv1d_silu_bf16(x: torch.Tensor, weight: torch.Tensor,
                            bias: torch.Tensor) -> torch.Tensor:
    """:func:`causal_conv1d_silu` for bf16 x, which it requires.
    ``causal_conv1d_silu_bf16.launches`` counts the bf16 forward kernel's
    launches, whichever entry point reached it."""
    if x.dtype != torch.bfloat16:
        raise TypeError(f"causal_conv1d_silu_bf16 takes bfloat16 x, got {x.dtype}")
    return causal_conv1d_silu(x, weight, bias)


def causal_conv1d_silu_bwd_bf16(x, weight, bias, g):
    """:func:`causal_conv1d_silu_bwd` for bf16 x and g, which it requires.
    ``causal_conv1d_silu_bwd_bf16.launches`` counts the bf16 backward
    kernel's launches, whichever entry point reached it."""
    if x.dtype != torch.bfloat16 or g.dtype != torch.bfloat16:
        raise TypeError(f"causal_conv1d_silu_bwd_bf16 takes bfloat16 x and g, got {x.dtype}, "
                        f"{g.dtype}")
    return causal_conv1d_silu_bwd(x, weight, bias, g)


causal_conv1d_silu.launches = 0
causal_conv1d_silu_bwd.launches = 0
causal_conv1d_silu_bf16.launches = 0
causal_conv1d_silu_bwd_bf16.launches = 0
