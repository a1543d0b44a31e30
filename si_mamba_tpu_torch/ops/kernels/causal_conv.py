"""Causal depthwise conv + bias + SiLU, forward and backward: the CUDA
kernels, their plain versions and the autograd Function over them.

Kernels, both in ``csrc/causal_conv.cu``:
- forward (K1), which replaces the TPU kernel ``_fwd_kernel`` behind
  ``causal_conv1d_silu_pallas`` (si_mamba_tpu/ops/pallas/causal_conv_kernel.py).
  Bound by bytes on the H100 (one read of x, one write of y);
- backward (K5), which replaces ``_bwd_kernel`` behind ``_cc_bwd``. Bound by
  bytes (one read of x and g, one write of dx); it recomputes the conv, keeps
  a window of inputs and a look-ahead of ds in registers, and writes dw and
  db as per-(batch, time tile) partials that ``torch.sum`` finishes.
The source describes both designs.

:func:`causal_conv1d_silu` is :class:`CausalConv1dSiluFn`: on a CUDA tensor
its forward and backward launch the kernels (or raise); on a CPU tensor they
are the plain versions. Nothing falls back from one to the other.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from si_mamba_tpu_torch.ops.kernels.build import load_library


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


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load_library("causal_conv")
    lib.causal_conv1d_silu_fwd.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + \
        [ctypes.c_longlong] * 2 + [ctypes.c_void_p]
    lib.causal_conv1d_silu_fwd.restype = ctypes.c_int
    lib.causal_conv1d_silu_bwd.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + \
        [ctypes.c_longlong] * 4 + [ctypes.c_void_p]
    lib.causal_conv1d_silu_bwd.restype = ctypes.c_int
    lib.causal_conv1d_time_tile.restype = ctypes.c_int
    lib.causal_conv1d_error_string.argtypes = [ctypes.c_int]
    lib.causal_conv1d_error_string.restype = ctypes.c_char_p
    return lib


def _check(lib, err: int, what: str) -> None:
    if err != 0:
        msg = lib.causal_conv1d_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} ({err})")


def _check_inputs(x, weight, bias, g=None) -> None:
    B, L, D = x.shape
    W = weight.shape[1]
    named = dict(x=x, weight=weight, bias=bias) | ({} if g is None else dict(g=g))
    for name, t in named.items():
        if t.dtype != torch.float32:
            raise TypeError(f"the causal-conv kernels take float32 inputs; {name} is {t.dtype}")
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


def _launch_fwd(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    _check_inputs(x, weight, bias)
    B, L, D = x.shape
    weight, bias = weight.contiguous(), bias.contiguous()
    y = torch.empty((B, L, D), dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        return y
    lib = _library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.causal_conv1d_silu_fwd(
            x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(),
            B, L, D, weight.shape[1], x.stride(0), x.stride(1), stream)
    _check(lib, err, "causal-conv forward")
    causal_conv1d_silu.launches += 1
    return y


def _launch_bwd(x, weight, bias, g):
    _check_inputs(x, weight, bias, g)
    B, L, D = x.shape
    W = weight.shape[1]
    weight, bias = weight.contiguous(), bias.contiguous()
    dx = torch.empty((B, L, D), dtype=torch.float32, device=x.device)
    if dx.numel() == 0:
        return dx, torch.zeros_like(weight), torch.zeros_like(bias)
    lib = _library()
    n_tiles = -(-L // lib.causal_conv1d_time_tile())
    dw_part = torch.empty((B, n_tiles, W, D), dtype=torch.float32, device=x.device)
    db_part = torch.empty((B, n_tiles, D), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.causal_conv1d_silu_bwd(
            x.data_ptr(), weight.data_ptr(), bias.data_ptr(), g.data_ptr(), dx.data_ptr(),
            dw_part.data_ptr(), db_part.data_ptr(), B, L, D, W,
            x.stride(0), x.stride(1), g.stride(0), g.stride(1), stream)
    _check(lib, err, "causal-conv backward")
    causal_conv1d_silu_bwd.launches += 1
    return dx, dw_part.sum(dim=(0, 1)).t(), db_part.sum(dim=(0, 1))


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
    tensor (float32, W = 4; x and g need unit stride only along channels),
    :func:`causal_conv1d_silu_bwd_ref` on the CPU.
    ``causal_conv1d_silu_bwd.launches`` counts kernel launches."""
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
    mixer's xz); weight (D, W); bias (D,). On a CUDA tensor this launches the
    kernels (float32, W = 4) or raises; on the CPU it is the plain versions.
    ``causal_conv1d_silu.launches`` counts forward-kernel launches."""
    return CausalConv1dSiluFn.apply(x, weight, bias)


causal_conv1d_silu.launches = 0
causal_conv1d_silu_bwd.launches = 0
