"""Mamba-1 selective scan forward: the CUDA kernel and its plain version.

Kernel: ``csrc/selective_scan_fwd.cu``, which replaces the lean inference
variant of the TPU kernel ``_fwd_kernel`` (``_pallas_scan_fwd(...,
emit_residuals=False)`` behind ``selective_scan_pallas``,
si_mamba_tpu/ops/pallas/selective_scan_kernel.py). On the H100 it is bound by
bytes (one read of u, dt, z, B, C and one write of y) with its exponentials
close behind; one thread per channel keeps the fp32 state in registers and
loops over time, so the (B, L, d, n) discretised tensors never reach device
memory. The source describes the design.

:func:`selective_scan_fwd` takes the plain version for a tensor on the CPU
and launches the kernel for a CUDA tensor; it never falls back from one to
the other.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from si_mamba_tpu_torch.ops.kernels.build import load_library


def selective_scan_ref(u, delta, A, B, C, D=None, z=None, delta_bias=None,
                       delta_softplus: bool = True) -> torch.Tensor:
    """Plain version, sequential in time: the correctness oracle.

    u, delta, z: (b, l, d); A: (d, n); B, C: (b, l, n); D, delta_bias: (d,).
    The (b, d, n) fp32 state is carried one step at a time, so no (b, l, d, n)
    tensor is built. Returns (b, l, d) in u's dtype."""
    delta = delta.float()
    if delta_bias is not None:
        delta = delta + delta_bias.float()
    if delta_softplus:
        delta = F.softplus(delta)
    u32, A32, B32, C32 = u.float(), A.float(), B.float(), C.float()
    b, l, d = u32.shape
    h = u32.new_zeros((b, d, A32.shape[1]))
    ys = []
    for t in range(l):
        dt_t = delta[:, t, :, None]  # (b, d, 1)
        h = torch.exp(dt_t * A32) * h + (dt_t * u32[:, t, :, None]) * B32[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, C32[:, t]))
    y = torch.stack(ys, dim=1) if ys else u32.new_zeros((b, 0, d))
    if D is not None:
        y = y + u32 * D.float()
    if z is not None:
        y = y * F.silu(z.float())
    return y.to(u.dtype)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load_library("selective_scan_fwd")
    lib.selective_scan_fwd.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + \
        [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p]
    lib.selective_scan_fwd.restype = ctypes.c_int
    lib.selective_scan_error_string.argtypes = [ctypes.c_int]
    lib.selective_scan_error_string.restype = ctypes.c_char_p
    return lib


def _launch(u, delta, A, B, C, D, z, delta_bias) -> torch.Tensor:
    bsz, L, d = u.shape
    n = A.shape[1]
    named = dict(u=u, delta=delta, A=A, B=B, C=C, D=D, z=z, delta_bias=delta_bias)
    for name, t in named.items():
        if t.dtype != torch.float32:
            raise TypeError(f"the selective-scan kernel takes float32 inputs; {name} is {t.dtype}")
        if not t.is_cuda or t.device != u.device:
            raise ValueError(f"{name} must lie on u's CUDA device")
        if t.stride(-1) != 1:
            raise ValueError(f"the selective-scan kernel needs unit stride along {name}'s last axis")
    for name, t, shape in (("delta", delta, (bsz, L, d)), ("z", z, (bsz, L, d)),
                           ("A", A, (d, n)), ("B", B, (bsz, L, n)), ("C", C, (bsz, L, n)),
                           ("D", D, (d,)), ("delta_bias", delta_bias, (d,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if n != 16:
        raise ValueError(f"the selective-scan kernel is built for d_state 16, got {n}")
    A, D, delta_bias = A.contiguous(), D.contiguous(), delta_bias.contiguous()
    y = torch.empty((bsz, L, d), dtype=torch.float32, device=u.device)
    if y.numel() == 0:
        return y
    strides = (ctypes.c_longlong * 10)(*(s for t in (u, delta, B, C, z)
                                         for s in (t.stride(0), t.stride(1))))
    lib = _library()
    stream = torch.cuda.current_stream(u.device).cuda_stream
    with torch.cuda.device(u.device):
        err = lib.selective_scan_fwd(
            u.data_ptr(), delta.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
            D.data_ptr(), z.data_ptr(), delta_bias.data_ptr(), y.data_ptr(),
            bsz, L, d, n, strides, stream)
    if err != 0:
        msg = lib.selective_scan_error_string(err).decode()
        raise RuntimeError(f"selective-scan kernel launch failed: {msg} ({err})")
    selective_scan_fwd.launches += 1
    return y


def selective_scan_fwd(u, delta, A, B, C, D, z, delta_bias) -> torch.Tensor:
    """Fused forward: softplus(delta + delta_bias), the fp32 scan, the D skip
    and the silu(z) gate. Shapes as in :func:`selective_scan_ref`; each of u,
    delta, B, C, z needs unit stride only along its last axis. On a CUDA
    tensor this launches the kernel (float32, d_state 16) or raises;
    on the CPU it is :func:`selective_scan_ref`.
    ``selective_scan_fwd.launches`` counts kernel launches."""
    if u.is_cuda:
        return _launch(u, delta, A, B, C, D, z, delta_bias)
    return selective_scan_ref(u, delta, A, B, C, D=D, z=z, delta_bias=delta_bias)


selective_scan_fwd.launches = 0
