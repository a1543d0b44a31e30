"""Mamba-1 selective scan and mixer forward in PyTorch.

Same maths and parameter layout as ``si_mamba_tpu/ops/selective_scan.py``:

    delta = softplus(dt + dt_bias)
    h_t   = exp(delta_t * A) * h_{t-1} + (delta_t * B_t) * u_t      (fp32 state)
    y_t   = C_t . h_t + D * u_t
    out   = y * silu(z)

Implementations of the scan:
- ``selective_scan_seq``: sequential in time, the oracle (the kernel's plain
  version, :func:`~si_mamba_tpu_torch.ops.kernels.selective_scan.selective_scan_ref`);
- ``selective_scan_assoc``: a log-depth scan of the affine maps (a, b) over
  the whole sequence, with (a1, b1)∘(a2, b2) = (a1·a2, a2·b1 + b2) in fp32
  (JAX's ``lax.associative_scan`` form; a plain PyTorch route, chosen only by
  asking for it: it holds several (b, l, d, n) fp32 tensors at once);
- ``selective_scan_chunked``: a log-depth scan inside chunks of time with the
  state carried across chunks, the default on the CPU;
- ``impl='pallas'``, the port's counterpart of the JAX package's Pallas
  kernels (``ops/kernels/selective_scan.py``): on a CUDA tensor the CUDA
  kernels (the lean forward without a gradient; the training forward and the
  backward through ``SelectiveScanFn`` with one), on a CPU tensor their plain
  forward and backward, as ``interpret=True`` runs the Pallas kernels off the
  TPU. ``impl='auto'`` is 'pallas' on a CUDA tensor and 'chunked' on the CPU.

:func:`mamba_mixer_apply` also takes ``impl='fused'``, the whole mixer
interior as one kernel pair (``ops/kernels/fused_mixer.py``, K10/K11), and
``'fused_interpret'``, their plain versions.

Layout is batch-major, time second: u (B, L, D).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from si_mamba_tpu_torch.ops.kernels.causal_conv import causal_conv1d_ref, causal_conv1d_silu_as_jax
from si_mamba_tpu_torch.ops.kernels.fused_mixer import fused_mamba_mixer, fused_mixer_supported
from si_mamba_tpu_torch.ops.kernels.selective_scan import selective_scan_fused, selective_scan_ref

causal_conv1d = causal_conv1d_ref
selective_scan_seq = selective_scan_ref


def _scan_in_chunk(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan of the affine maps (a, b) along dim 1 (Hillis-Steele):
    returns (prod a_{0..t}, h_t with h_{-1} = 0)."""
    T = a.shape[1]
    k = 1
    while k < T:
        b = torch.cat([b[:, :k], b[:, k:] + a[:, k:] * b[:, :-k]], dim=1)
        a = torch.cat([a[:, :k], a[:, k:] * a[:, :-k]], dim=1)
        k *= 2
    return a, b


def _step_sizes(delta, delta_bias, delta_softplus) -> torch.Tensor:
    """delta (+ delta_bias) (through softplus) in fp32."""
    delta32 = delta.float()
    if delta_bias is not None:
        delta32 = delta32 + delta_bias.float()
    return F.softplus(delta32) if delta_softplus else delta32


def _discretize(u, delta32, A, B) -> tuple[torch.Tensor, torch.Tensor]:
    """(dA, dBu), each (b, l, d, n) fp32: exp(delta A) and delta B u."""
    dA = torch.exp(delta32[..., None] * A.float())
    dBu = (delta32 * u.float())[..., None] * B.float()[:, :, None, :]
    return dA, dBu


def _read_out(y, u, D, z) -> torch.Tensor:
    """y (+ D u) (* silu(z)) in u's dtype; y: (b, l, d) fp32, C . h."""
    if D is not None:
        y = y + u.float() * D.float()
    if z is not None:
        y = y * F.silu(z.float())
    return y.to(u.dtype)


def selective_scan_assoc(u, delta, A, B, C, D=None, z=None, delta_bias=None,
                         delta_softplus: bool = True) -> torch.Tensor:
    """The log-depth scan over the whole sequence (JAX's
    ``selective_scan_assoc``): the inclusive scan of the affine maps (dA,
    dBu) along time, then the read-out. It keeps (b, l, d, n) fp32 tensors
    alive, about 2 log2(l) of them under autograd; 'chunked' bounds them."""
    dA, dBu = _discretize(u, _step_sizes(delta, delta_bias, delta_softplus), A, B)
    _, hs = _scan_in_chunk(dA, dBu)
    return _read_out(torch.einsum("bldn,bln->bld", hs, C.float()), u, D, z)


_CHUNK = 64


def selective_scan_chunked(u, delta, A, B, C, D=None, z=None, delta_bias=None,
                           delta_softplus: bool = True) -> torch.Tensor:
    """Memory-bounded scan: chunks of 64 steps, a log-depth scan inside each,
    the (b, d, n) fp32 state carried across chunks. Live temporaries are
    (b, 64, d, n), never (b, l, d, n)."""
    delta32 = _step_sizes(delta, delta_bias, delta_softplus)
    b, l, d = u.shape
    h = delta32.new_zeros((b, d, A.shape[1]))
    ys = []
    for s in range(0, l, _CHUNK):
        dA, dBu = _discretize(u[:, s:s + _CHUNK], delta32[:, s:s + _CHUNK], A,
                              B[:, s:s + _CHUNK])  # (b, T, d, n)
        acc_a, acc_b = _scan_in_chunk(dA, dBu)
        hs = acc_a * h[:, None] + acc_b
        ys.append(torch.einsum("bldn,bln->bld", hs, C[:, s:s + _CHUNK].float()))
        h = hs[:, -1]
    y = torch.cat(ys, dim=1) if ys else delta32.new_zeros((b, 0, d))
    return _read_out(y, u, D, z)


def _resolve(impl: str, x: torch.Tensor) -> str:
    """'auto' is 'pallas' on a CUDA tensor and 'chunked' on the CPU."""
    if impl == "auto":
        return "pallas" if x.is_cuda else "chunked"
    return impl


def selective_scan(u, delta, A, B, C, D=None, z=None, delta_bias=None,
                   delta_softplus: bool = True, impl: str = "auto") -> torch.Tensor:
    """Dispatch: 'auto' | 'pallas' | 'seq' | 'assoc' | 'chunked'.

    'pallas' is the fused scan of ``ops/kernels/selective_scan.py``: the CUDA
    kernels on a CUDA tensor, their plain forward and backward on the CPU. It
    takes only the full fused signature (softplus, D, z, delta_bias) and
    raises without it. 'auto' is 'pallas' on a CUDA tensor and 'chunked' on
    the CPU. 'seq', 'assoc' and 'chunked' are the plain scans, chosen
    explicitly, on any device."""
    impl = _resolve(impl, u)
    if impl == "pallas":
        missing = [name for name, given in (
            ("delta_softplus=True", delta_softplus), ("D", D is not None),
            ("z", z is not None), ("delta_bias", delta_bias is not None)) if not given]
        if missing:
            raise NotImplementedError(
                f"the fused scan needs {', '.join(missing)}; pass impl='seq' or "
                f"'chunked' for the plain scan")
        return selective_scan_fused(u, delta, A, B, C, D, z, delta_bias)
    if impl == "seq":
        return selective_scan_seq(u, delta, A, B, C, D, z, delta_bias, delta_softplus)
    if impl == "assoc":
        return selective_scan_assoc(u, delta, A, B, C, D, z, delta_bias, delta_softplus)
    if impl == "chunked":
        return selective_scan_chunked(u, delta, A, B, C, D, z, delta_bias, delta_softplus)
    raise ValueError(f"unknown impl {impl!r}")


def mamba_mixer_apply(params: dict, x: torch.Tensor, *, d_state: int, dt_rank: int,
                      impl: str = "auto") -> torch.Tensor:
    """Functional Mamba-1 mixer forward, the JAX package's parameter layout:

      in_proj_w   (d_model, 2*d_inner)   [torch in_proj.weight^T]
      conv_w      (d_inner, d_conv)      [torch conv1d.weight squeezed]
      conv_b      (d_inner,)
      x_proj_w    (d_inner, dt_rank+2*d_state)
      dt_proj_w   (dt_rank, d_inner)
      dt_proj_b   (d_inner,)
      A_log       (d_inner, d_state)
      D           (d_inner,)
      out_proj_w  (d_inner, d_model)

    x: (B, L, d_model) -> (B, L, d_model). Under 'pallas' (which 'auto' is
    on a CUDA tensor) the conv and the scan are the differentiable fused ops
    of ``ops/kernels``: their CUDA kernels on a CUDA tensor, their plain
    forward and backward on the CPU. 'seq', 'assoc' and 'chunked' (which
    'auto' is on the CPU) compose the plain conv with that plain scan, under
    autograd, on any device.

    'fused' runs the whole interior between in_proj and out_proj (conv,
    x_proj/dt_proj, scan, gate) as one kernel, ``fused_mamba_mixer`` of
    ``ops/kernels/fused_mixer.py``: K10 without a gradient, K10 with states
    and K11 with one, on a CUDA tensor; their plain versions on the CPU. It
    raises ``ValueError`` for d_inner % 128 != 0 or d_state > 32 on any
    device, as the JAX package does, and on CUDA ``NotImplementedError`` for
    a shape the kernels are not built for (d_state 16, d_conv 4, d_inner up
    to 1024). 'fused_interpret' runs the plain versions of the same
    interior on any device and at any shape, JAX's interpret mode.

    Mixed precision, as the JAX mixer: the matmul weights are cast to x's
    dtype (float32 or bfloat16), A, D and dt_bias stay fp32 and every scan
    keeps an fp32 state. The conv kernel route ('pallas') takes the fp32 conv
    weight and bias where d_inner is a multiple of 128, as the TPU conv kernel
    reads them, and at any other width the weights rounded to x's dtype, as
    the JAX package's XLA conv reads them there (``causal_conv1d_silu_as_jax``);
    the plain routes take them cast to x's dtype, as the JAX package's XLA
    conv does. The 'fused' routes hand the interior the bf16 xz with every
    interior weight in fp32, as the JAX package's ``fused_mamba_mixer`` casts
    them, and y comes back in xz's dtype for out_proj."""
    impl = _resolve(impl, x)
    cdt = x.dtype
    if cdt not in (torch.float32, torch.bfloat16):
        raise NotImplementedError(f"the mixer runs in float32 or bfloat16, not {cdt}")

    def wcast(w):
        return w if w.dtype == cdt else w.to(cdt)

    xz = x @ wcast(params["in_proj_w"])  # (B, L, 2*d_inner)
    d_inner = xz.shape[-1] // 2
    if impl in ("fused", "fused_interpret"):
        if impl == "fused" and not fused_mixer_supported(d_inner, d_state, x.shape[1]):
            raise ValueError(
                f"impl='fused' needs d_inner % 128 == 0 and d_state <= 32 (got d_inner="
                f"{d_inner}, d_state={d_state}); use impl='pallas' (per-op kernels) for this "
                f"shape")
        y = fused_mamba_mixer(xz, params["conv_w"], params["conv_b"], params["x_proj_w"],
                              params["dt_proj_w"], params["dt_proj_b"],
                              -torch.exp(params["A_log"].float()), params["D"],
                              dt_rank=dt_rank, d_state=d_state,
                              plain=impl == "fused_interpret")
        return y.to(cdt) @ wcast(params["out_proj_w"])
    xi, z = xz[..., :d_inner], xz[..., d_inner:]  # column views, no copy
    if impl == "pallas":
        xi = causal_conv1d_silu_as_jax(xi, params["conv_w"], params["conv_b"])
    else:
        xi = causal_conv1d(xi, wcast(params["conv_w"]), wcast(params["conv_b"]),
                           activation="silu")
    x_dbl = xi @ wcast(params["x_proj_w"])  # (B, L, dt_rank + 2n)
    dt = x_dbl[..., :dt_rank] @ wcast(params["dt_proj_w"])  # (B, L, d_inner)
    Bc = x_dbl[..., dt_rank:dt_rank + d_state]
    Cc = x_dbl[..., dt_rank + d_state:]
    A = -torch.exp(params["A_log"].float())
    y = selective_scan(xi, dt, A, Bc, Cc, D=params["D"], z=z,
                       delta_bias=params["dt_proj_b"], delta_softplus=True, impl=impl)
    return y.to(cdt) @ wcast(params["out_proj_w"])
