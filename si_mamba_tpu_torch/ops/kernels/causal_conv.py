"""Causal depthwise conv + bias + SiLU: the CUDA kernel and its plain version.

Kernel: ``csrc/causal_conv.cu``, which replaces the TPU kernel behind
``causal_conv1d_silu_pallas`` (si_mamba_tpu/ops/pallas/causal_conv_kernel.py,
``_fwd_kernel``). It is bound by bytes on the H100 (one read of x, one write
of y); its design, one thread per channel with the W-1 previous inputs in
registers and coalesced rows, is described in the source.

:func:`causal_conv1d_silu` takes the plain version for a tensor on the CPU
and launches the kernel for a CUDA tensor; it never falls back from one to
the other.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from si_mamba_tpu_torch.ops.kernels.build import load_library


def causal_conv1d_ref(x: torch.Tensor, weight: torch.Tensor,
                      bias: torch.Tensor | None = None,
                      activation: str | None = "silu") -> torch.Tensor:
    """Plain version: x (B, L, D), weight (D, W), bias (D,) -> (B, L, D).

    ``F.conv1d(x, w, groups=D, padding=W-1)[..., :L]`` written as W shifted
    multiply-adds, accumulated in fp32 and returned in x's dtype."""
    B, L, D = x.shape
    W = weight.shape[1]
    x32 = x.float()
    xpad = F.pad(x32, (0, 0, W - 1, 0))
    w32 = weight.float()
    y = torch.zeros_like(x32) if bias is None else bias.float().expand(B, L, D).clone()
    for k in range(W):
        y = y + w32[:, k] * xpad[:, k:k + L]
    if activation == "silu":
        y = F.silu(y)
    elif activation is not None:
        raise ValueError(f"unknown activation {activation!r}")
    return y.to(x.dtype)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load_library("causal_conv")
    lib.causal_conv1d_silu_fwd.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + \
        [ctypes.c_longlong] * 2 + [ctypes.c_void_p]
    lib.causal_conv1d_silu_fwd.restype = ctypes.c_int
    lib.causal_conv1d_error_string.argtypes = [ctypes.c_int]
    lib.causal_conv1d_error_string.restype = ctypes.c_char_p
    return lib


def _launch(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    B, L, D = x.shape
    W = weight.shape[1]
    if x.dtype != torch.float32 or weight.dtype != torch.float32 or bias.dtype != torch.float32:
        raise TypeError("the causal-conv kernel takes float32 x, weight and bias")
    if x.stride(2) != 1:
        raise ValueError("the causal-conv kernel needs unit stride along channels")
    if weight.shape != (D, W) or bias.shape != (D,):
        raise ValueError(f"weight {tuple(weight.shape)} / bias {tuple(bias.shape)} "
                         f"do not match D={D}")
    if W != 4:
        raise ValueError(f"the causal-conv kernel is built for width 4 (d_conv), got {W}")
    if not (weight.is_cuda and bias.is_cuda and weight.device == x.device == bias.device):
        raise ValueError("x, weight and bias must lie on one CUDA device")
    weight = weight.contiguous()
    bias = bias.contiguous()
    y = torch.empty((B, L, D), dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        return y
    lib = _library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.causal_conv1d_silu_fwd(
            x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(),
            B, L, D, W, x.stride(0), x.stride(1), stream)
    if err != 0:
        msg = lib.causal_conv1d_error_string(err).decode()
        raise RuntimeError(f"causal-conv kernel launch failed: {msg} ({err})")
    causal_conv1d_silu.launches += 1
    return y


def causal_conv1d_silu(x: torch.Tensor, weight: torch.Tensor,
                       bias: torch.Tensor) -> torch.Tensor:
    """Fused causal depthwise conv + bias + SiLU. x: (B, L, D), unit stride
    along D (any batch and row stride, e.g. a column slice of the mixer's
    xz); weight (D, W); bias (D,). On a CUDA tensor this launches the kernel
    (float32, W = 4) or raises; on the CPU it is
    :func:`causal_conv1d_ref`. ``causal_conv1d_silu.launches`` counts kernel
    launches."""
    if x.is_cuda:
        return _launch(x, weight, bias)
    return causal_conv1d_ref(x, weight, bias, activation="silu")


causal_conv1d_silu.launches = 0
