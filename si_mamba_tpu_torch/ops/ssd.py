"""Chunked scalar-decay SSM (SSD, the Mamba-2 structure) and the SSD mixer
forward in PyTorch.

Same maths and parameter layout as ``si_mamba_tpu/ops/ssd.py``. Per head h
with state size N and head dim P, and the inclusive log-decay cumsum
S[t] = sum_{r<=t} dt[r] A (A < 0, one scalar a head):

    h[t] = e^{dt[t] A} h[t-1] + dt[t] B[t] (x) x[t]
    y[t] = C[t] . h[t] + D x[t]
         = sum_{s<=t} (C[t] . B[s]) e^{S[t]-S[s]} dt[s] x[s] + D x[t]

Implementations of the core:
- :func:`ssd_scan_ref`: sequential in time, the oracle;
- :func:`ssd_chunked`: the chunked einsum form (intra-chunk masked products,
  chunk-boundary states and their carry), under autograd on any device;
- ``impl='ssd_fused'`` in :func:`ssd_mixer_apply`: the boundary-fused core of
  ``ops/kernels/ssd.py`` on the un-split (x|B|C) conv output, its CUDA kernels
  (K8 forward, K9 backward) on a CUDA tensor and their plain versions on the
  CPU, with the conv's kernels (K1, K5) before it. The tensor- and
  sequence-parallel mixers (``parallel/``) run the split core
  ``ssd_chunked_split`` (K6, K7) under the same impl name;
  :func:`ssd_fused_route` is the one predicate of every such call site.

Both take fp32 or bf16 activations with the JAX package's dtype rules: at
bf16 the matmul operands are rounded to bf16 and every product accumulates in
fp32, the decay math and the state carry stay fp32, and y comes back in bf16.

Layout is batch-major, time second.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from si_mamba_tpu_torch.ops.kernels.causal_conv import causal_conv1d_ref, causal_conv1d_silu_as_jax
from si_mamba_tpu_torch.ops.kernels.ssd import (
    HEAD_DIM,
    MAX_CHUNK,
    STATE,
    STRIP,
    _rounder,
    ssd_chunked_xbc,
    ssd_chunks_ref,
)

IMPLS = ("xla", "ssd_fused")


def _acc_dtype(x: torch.Tensor) -> torch.dtype:
    """fp32, or fp64 for fp64 input."""
    return torch.promote_types(x.dtype, torch.float32)


def ssd_scan_ref(x, dt, A, Bm, Cm, D) -> torch.Tensor:
    """Sequential oracle of the SSD recurrence.

    x: (b, l, h, p) head inputs; dt: (b, l, h) post-softplus step sizes;
    A: (h,) negative scalars; Bm, Cm: (b, l, n), one group shared by the
    heads; D: (h,) skip. Returns (b, l, h, p) in fp32 (fp64 for fp64 x)."""
    acc = _acc_dtype(x)
    x, dt, A, Bm, Cm, D = (t.to(acc) for t in (x, dt, A, Bm, Cm, D))
    b, l, h, p = x.shape
    state = x.new_zeros((b, h, Bm.shape[-1], p))
    ys = []
    for t in range(l):
        decay = torch.exp(dt[:, t] * A)  # (b, h)
        inject = (dt[:, t, :, None] * x[:, t])[:, :, None, :] * Bm[:, t, None, :, None]
        state = decay[..., None, None] * state + inject
        ys.append(torch.einsum("bn,bhnp->bhp", Cm[:, t], state))
    y = torch.stack(ys, dim=1) if ys else x.new_zeros(x.shape)
    return y + D[None, None, :, None] * x


def ssd_chunked(x, dt, A, Bm, Cm, D, *, chunk: int = 64, return_carry: bool = False):
    """Chunked SSD, the same result as :func:`ssd_scan_ref`. Shapes as there;
    L must be a multiple of ``chunk`` (the callers pad). Heads are moved next
    to the batch once, so every contraction is a batched product
    (:func:`ssd_chunks_ref`, the decay mask taken in log space).

    bf16 x (B and C bf16 too) follows ``si_mamba_tpu/ops/ssd.ssd_chunked``:
    xdt = x bf16(dt) and its decayed copy x dt bf16(e^{S_end - S}) are bf16
    products, G (.) M and h_in are rounded to bf16 as product operands, the
    decay and the carry stay fp32, y is rounded to bf16 before the D skip,
    which runs in bf16; otherwise everything is in fp32 (fp64 for fp64 x).

    ``return_carry`` adds the slice's total decay exp(sum_l dt A) (b, h) and
    the final state from a zero start (b, h, n, p), the affine map of the
    slice that sequence parallelism carries."""
    acc = _acc_dtype(x)
    b, l, h, p = x.shape
    n = Bm.shape[-1]
    if l % chunk:
        raise ValueError(f"L={l} is not a multiple of chunk={chunk}; pad first")
    nc, q = l // chunk, chunk
    dth = dt.to(acc).permute(0, 2, 1).reshape(b, h, nc, q)
    S = torch.cumsum(dth * A.to(acc)[None, :, None, None], dim=-1)  # (b, h, nc, q) <= 0
    rnd = _rounder(x.dtype)
    Bc, Cc = (rnd(t.to(acc)).reshape(b, nc, q, n) for t in (Bm, Cm))
    xh = x.permute(0, 2, 1, 3).reshape(b, h, nc, q, p)
    xdt = (xh * dth[..., None].to(x.dtype)).to(acc)  # a product in x's dtype
    y, _, state = ssd_chunks_ref(xdt, S, Bc, Cc, mm=x.dtype, round_decay=True)
    y = y.to(x.dtype).reshape(b, h, l, p).permute(0, 2, 1, 3)
    y = y + D.to(x.dtype)[None, None, :, None] * x
    if return_carry:
        # S is a per-chunk cumsum: the slice's total is the sum of every
        # chunk's last entry
        return y, torch.exp(S[..., -1].sum(-1)), state
    return y


def ssd_fused_supported(l: int, chunk: int, d_state: int, head_dim: int) -> bool:
    """The geometry the SSD kernels are built for: d_state = head_dim = 128
    and a chunk that is a multiple of 64 up to 256 and divides L."""
    return (d_state == STATE and head_dim == HEAD_DIM and chunk % STRIP == 0
            and 0 < chunk <= MAX_CHUNK and l % chunk == 0)


def ssd_fused_route(impl: str, l_padded: int, chunk: int, d_state: int, head_dim: int,
                    device) -> bool:
    """The fused-kernel routing predicate of every 'ssd_fused' call site
    (``ssd_mixer_apply``, ``parallel/tensor_parallel.ssd_mixer_tp``,
    ``parallel/seq_scan.ssd_seq_parallel``): True iff ``impl`` is
    'ssd_fused'. On a CUDA ``device`` that route launches the kernels, and a
    geometry they are not built for raises ``ValueError`` here; on the CPU it
    runs their plain versions at any geometry. Unlike the JAX predicate it
    never turns 'ssd_fused' into the einsum route. ``l_padded`` is the
    chunk-multiple length the core will see."""
    if impl not in IMPLS:
        raise ValueError(f"unknown SSD impl {impl!r}; expected one of {IMPLS}")
    if impl != "ssd_fused":
        return False
    if torch.device(device).type == "cuda" and not ssd_fused_supported(l_padded, chunk,
                                                                       d_state, head_dim):
        raise ValueError(
            f"impl='ssd_fused' on CUDA runs kernels built for d_state = head_dim = {STATE} and "
            f"a chunk that is a multiple of {STRIP} up to {MAX_CHUNK} dividing L; got d_state "
            f"{d_state}, head_dim {head_dim}, chunk {chunk}, L {l_padded}")
    return True


def ssd_fused_engaged(l: int, *, chunk: int = 128, d_state: int = 128, head_dim: int = 128,
                      device="cuda") -> bool:
    """True iff ``impl='ssd_fused'`` launches the CUDA kernels for this
    geometry on ``device`` (after padding L to a chunk multiple): a CUDA
    device and a geometry they are built for. A measurement guard: on the CPU
    the route runs the plain versions, and on CUDA another geometry raises."""
    pad = (-l) % chunk
    return (torch.device(device).type == "cuda"
            and ssd_fused_supported(l + pad, chunk, d_state, head_dim))


def ssd_mixer_apply(params: dict, u: torch.Tensor, *, n_heads: int, d_state: int,
                    chunk: int = 64, impl: str = "xla") -> torch.Tensor:
    """The SSD mixer, the JAX package's parameter layout:

      in_proj_w   (d_model, 2*d_inner + 2*d_state + n_heads)
      conv_w      (d_inner + 2*d_state, d_conv), conv_b (d_inner + 2*d_state,)
      dt_bias, A_log, D   (n_heads,)
      norm_scale  (d_inner,)
      out_proj_w  (d_inner, d_model)

    in_proj -> split z | xbc | dt_raw -> causal conv + SiLU on xbc ->
    softplus(dt_raw + dt_bias) -> pad L to a chunk multiple (zero dt: no decay,
    no input) -> SSD core -> gated RMSNorm -> out_proj. u: (b, l, d_model).

    ``impl='ssd_fused'``: the conv is ``causal_conv1d_silu`` (K1/K5) and the
    core ``ssd_chunked_xbc`` (K8/K9) on the un-split (x|B|C) block; on a CUDA
    tensor they launch their kernels or raise for a shape the kernels are not
    built for, on the CPU they are their plain versions. ``impl='xla'``: the
    plain conv and :func:`ssd_chunked` under autograd, on any device.

    Mixed precision, as the JAX mixer: u float32 or bfloat16; at bf16 the
    matmul weights are cast to bf16, softplus runs on fp32 dt_raw, A, D and
    the gated RMSNorm are fp32, and the normalised y is cast back to bf16
    before out_proj. The conv kernel route ('ssd_fused') takes the fp32 conv
    weight and bias where the conv width is a multiple of 128, as the TPU's
    Pallas conv reads them, and at any other width the weights rounded to
    bf16, as the JAX package's XLA conv reads them there
    (``causal_conv1d_silu_as_jax``); 'xla' the plain conv with them cast to
    bf16, as the JAX package's XLA conv."""
    cdt = u.dtype
    if cdt not in (torch.float32, torch.bfloat16):
        raise NotImplementedError(f"the SSD mixer runs in float32 or bfloat16, not {cdt}")

    def wcast(w):
        return w if w.dtype == cdt else w.to(cdt)

    b, l, _ = u.shape
    zxbcdt = u @ wcast(params["in_proj_w"])
    d_inner = (zxbcdt.shape[-1] - 2 * d_state - n_heads) // 2
    head_p = d_inner // n_heads
    pad = (-l) % chunk
    fused = ssd_fused_route(impl, l + pad, chunk, d_state, head_p, u.device)
    # column views of zxbcdt, no copies
    z = zxbcdt[..., :d_inner]
    xbc = zxbcdt[..., d_inner:2 * d_inner + 2 * d_state]
    dt_raw = zxbcdt[..., 2 * d_inner + 2 * d_state:]
    if fused:
        xbc = causal_conv1d_silu_as_jax(xbc, params["conv_w"], params["conv_b"])
    else:
        xbc = causal_conv1d_ref(xbc, wcast(params["conv_w"]), wcast(params["conv_b"]),
                                activation="silu")
    dt = F.softplus(dt_raw.float() + params["dt_bias"])  # (b, l, h) fp32
    A = -torch.exp(params["A_log"].float())
    D = params["D"].float()

    if fused:
        if pad:
            xbc = F.pad(xbc, (0, 0, 0, pad))
            dt = F.pad(dt, (0, 0, 0, pad))
        y = ssd_chunked_xbc(xbc, dt, A, D, d_inner=d_inner, chunk=chunk)[:, :l]
    else:
        xm = xbc[..., :d_inner]
        Bm = xbc[..., d_inner:d_inner + d_state]
        Cm = xbc[..., d_inner + d_state:]
        if pad:
            xm, Bm, Cm, dt = (F.pad(t, (0, 0, 0, pad)) for t in (xm, Bm, Cm, dt))
        y = ssd_chunked(xm.reshape(b, l + pad, n_heads, head_p), dt, A, Bm, Cm, D, chunk=chunk)
        y = y.reshape(b, l + pad, d_inner)[:, :l]

    # gated RMSNorm in fp32 (Mamba-2 normalises y * silu(z) before out_proj)
    y = y.float() * F.silu(z.float())
    y = y * torch.rsqrt(torch.mean(torch.square(y), dim=-1, keepdim=True) + 1e-5)
    y = y * params["norm_scale"].float()
    return y.to(cdt) @ wcast(params["out_proj_w"])
