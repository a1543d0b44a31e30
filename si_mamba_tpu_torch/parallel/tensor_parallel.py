"""Tensor-parallel Mamba and SSD mixers over a ``model`` mesh axis, the
counterparts of ``si_mamba_tpu/parallel/tensor_parallel.py``.

Megatron-style sharding adapted to the selective-SSM block; every rank runs
the body on its own shard of the parameters, the block input replicated:

- Mamba-1: in_proj column-sharded on d_inner (x and z halves each), the
  depthwise conv, dt_proj, A_log, D and the dt bias sharded with them, so the
  scan runs on the rank's d_inner / M channels with no communication;
  x_proj row-sharded, its partial (B, L, dt_rank + 2n) products summed
  (:func:`psum`); out_proj row-sharded, its partial outputs summed
  (:func:`psum_replicated`).
- SSD: heads shard in contiguous blocks, so z, x, dt and the x rows of the
  conv are rank-local; the small B|C projection and its conv are computed on
  every rank from replicated weights; the chunked core runs on the local
  heads with no communication (``impl='ssd_fused'``: K6, with K7 under a
  gradient); two sums close the layer, the gated RMSNorm's sum of squares over
  the full d_inner and the row-sharded out_proj.

The gradients of the replicated input and of the replicated B|C weights are
summed over the axis by :func:`enter` (identity forward, all-reduce
backward), so every rank ends with the whole gradient of every replicated
value. Parameters are plain tensors in the JAX package's layout; the
``shard_*`` functions cut a full parameter dict into rank ``rank``'s shard.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from si_mamba_tpu_torch.ops.kernels.causal_conv import (
    causal_conv1d_ref,
    causal_conv1d_silu,
    causal_conv1d_silu_as_jax,
)
from si_mamba_tpu_torch.ops.kernels.ssd import ssd_chunked_split
from si_mamba_tpu_torch.ops.selective_scan import selective_scan
from si_mamba_tpu_torch.ops.ssd import ssd_chunked, ssd_fused_route
from si_mamba_tpu_torch.parallel.collectives import enter, psum, psum_replicated
from si_mamba_tpu_torch.parallel.mesh import Mesh


def _block(n: int, rank: int, size: int) -> slice:
    """Rank ``rank``'s contiguous block of ``n`` items split ``size`` ways."""
    if n % size:
        raise ValueError(f"{n} does not split evenly over {size} ranks")
    step = n // size
    return slice(rank * step, (rank + 1) * step)


def shard_mixer_params(params: dict, rank: int, size: int) -> dict:
    """Rank ``rank``'s shard of ``mamba_mixer_apply``'s parameters: in_proj
    (d_model, 2 d_inner) keeps its [x | z] layout over the rank's channels,
    conv, dt_proj's columns and bias, A_log and D take the rank's channels,
    x_proj and out_proj the rank's rows."""
    d_inner = params["in_proj_w"].shape[1] // 2
    c = _block(d_inner, rank, size)
    w = params["in_proj_w"]
    return {
        "in_proj_w": torch.cat([w[:, c], w[:, d_inner:][:, c]], dim=1),
        "conv_w": params["conv_w"][c], "conv_b": params["conv_b"][c],
        "x_proj_w": params["x_proj_w"][c],
        "dt_proj_w": params["dt_proj_w"][:, c], "dt_proj_b": params["dt_proj_b"][c],
        "A_log": params["A_log"][c], "D": params["D"][c],
        "out_proj_w": params["out_proj_w"][c],
    }


def mamba_mixer_tp(params: dict, x: torch.Tensor, *, mesh: Mesh, d_state: int, dt_rank: int,
                   axis: str = "model", scan_impl: str = "auto") -> torch.Tensor:
    """Tensor-parallel Mamba-1 mixer on rank-local ``params`` (the layout of
    :func:`shard_mixer_params`); ``x`` (B, L, d_model) replicated over
    ``axis``. ``scan_impl`` as ``mamba_mixer_apply``: 'auto' is the kernels
    (K1, K2; K3/K4/K5 with a gradient) on a CUDA tensor and the plain chunked
    scan on the CPU, the route the JAX package takes in TP.

    x float32 or bfloat16, as ``si_mamba_tpu/parallel/tensor_parallel.
    _mixer_local``, which casts no weight: a bf16 x meets the fp32 in_proj and
    promotes to fp32 (its values exactly), so everything after it runs in fp32
    on the fp32 kernels and the mixer returns fp32."""
    ax = mesh[axis]
    if scan_impl in ("fused", "fused_interpret"):
        raise NotImplementedError("the fused mixer kernels (K10/K11) take the whole d_inner; "
                                  "the tensor-parallel mixer runs the per-op route")
    impl = ("pallas" if x.is_cuda else "chunked") if scan_impl == "auto" else scan_impl
    x = enter(x, ax)
    xz = x.to(torch.promote_types(x.dtype, params["in_proj_w"].dtype)) @ params["in_proj_w"]
    d_loc = xz.shape[-1] // 2
    xi, z = xz[..., :d_loc], xz[..., d_loc:]
    if impl == "pallas":
        xi = causal_conv1d_silu(xi, params["conv_w"], params["conv_b"])
    else:
        xi = causal_conv1d_ref(xi, params["conv_w"], params["conv_b"], activation="silu")
    x_dbl = psum(xi @ params["x_proj_w"], ax)  # (B, L, dt_rank + 2n), summed over shards
    dt = x_dbl[..., :dt_rank] @ params["dt_proj_w"]
    Bc = x_dbl[..., dt_rank:dt_rank + d_state]
    Cc = x_dbl[..., dt_rank + d_state:]
    y = selective_scan(xi, dt, -torch.exp(params["A_log"].float()), Bc, Cc, D=params["D"], z=z,
                       delta_bias=params["dt_proj_b"], delta_softplus=True, impl=impl)
    return psum_replicated(y @ params["out_proj_w"], ax)


def shard_ssd_mixer_params(params: dict, rank: int, size: int, *, n_heads: int,
                           d_state: int) -> dict:
    """Split ``ssd_mixer_apply``'s packed parameters into rank ``rank``'s TP
    shard. The in_proj output is [z | x | B | C | dt] and the conv covers
    [x | B | C]; z, x, dt, the x conv rows, dt_bias, A_log, D, the norm scale
    and out_proj's rows take the rank's contiguous block of heads, B|C stays
    whole. n_heads must divide by ``size``."""
    if n_heads % size:
        raise ValueError(f"the tensor-parallel SSD mixer shards whole heads: n_heads={n_heads} "
                         f"must be divisible by the axis size {size}")
    w = params["in_proj_w"]
    d_inner = (w.shape[1] - 2 * d_state - n_heads) // 2
    c, hs = _block(d_inner, rank, size), _block(n_heads, rank, size)
    cw, cb = params["conv_w"], params["conv_b"]
    return {
        "in_proj_z": w[:, :d_inner][:, c],
        "in_proj_x": w[:, d_inner:2 * d_inner][:, c],
        "in_proj_bc": w[:, 2 * d_inner:2 * d_inner + 2 * d_state],
        "in_proj_dt": w[:, 2 * d_inner + 2 * d_state:][:, hs],
        "conv_x_w": cw[:d_inner][c], "conv_x_b": cb[:d_inner][c],
        "conv_bc_w": cw[d_inner:], "conv_bc_b": cb[d_inner:],
        "dt_bias": params["dt_bias"][hs], "A_log": params["A_log"][hs], "D": params["D"][hs],
        "norm_scale": params["norm_scale"][c],
        "out_proj_w": params["out_proj_w"][c],
    }


def ssd_mixer_tp(params: dict, u: torch.Tensor, *, mesh: Mesh, n_heads: int, d_state: int,
                 chunk: int = 128, axis: str = "model", impl: str = "xla") -> torch.Tensor:
    """Tensor-parallel SSD mixer on rank-local ``params`` (the layout of
    :func:`shard_ssd_mixer_params`); ``u`` (b, l, d_model) replicated over
    ``axis``. The same result as ``ssd_mixer_apply`` on the packed
    parameters. ``impl='ssd_fused'``: the convs are ``causal_conv1d_silu``
    (K1, K5) and the core ``ssd_chunked_split`` (K6, K7) on the rank's heads,
    the kernels on a CUDA tensor (or an error for a geometry they are not
    built for) and their plain versions on the CPU; ``'xla'``: the plain conv
    and ``ssd_chunked`` under autograd.

    u float32 or bfloat16, as ``si_mamba_tpu/parallel/tensor_parallel.
    _ssd_mixer_local``: at bf16 every weight is cast to bf16 at its use, the
    conv weights included on both routes (the JAX package's tensor-parallel
    mixer always runs the XLA conv on bf16-cast weights, so 'ssd_fused' hands
    K1/K5 the weights rounded to bf16, held in fp32), softplus, A, D and the
    gated RMSNorm run in fp32, and the normalised y is cast to bf16 before the
    row-sharded out_proj."""
    ax = mesh[axis]
    if n_heads % ax.size:
        raise ValueError(f"ssd_mixer_tp shards whole heads: n_heads={n_heads} must be "
                         f"divisible by the '{axis}' axis size {ax.size}")
    cdt = u.dtype
    if cdt not in (torch.float32, torch.bfloat16):
        raise NotImplementedError(f"the SSD mixer runs in float32 or bfloat16, not {cdt}")

    def wc(w):
        return w if w.dtype == cdt else w.to(cdt)

    b, l, _ = u.shape
    h_loc = params["A_log"].shape[0]
    di_loc = params["in_proj_x"].shape[1]
    pad = (-l) % chunk
    fused = ssd_fused_route(impl, l + pad, chunk, d_state, di_loc // h_loc, u.device)
    if fused:
        def conv(x, w, bias):  # JAX's TP mixer runs the XLA conv at every width
            return causal_conv1d_silu_as_jax(x, w, bias, pallas_conv=False)
    else:
        def conv(x, w, bias):
            return causal_conv1d_ref(x, wc(w), wc(bias), activation="silu")

    u = enter(u, ax)
    z = u @ wc(params["in_proj_z"])  # (b, l, di/M)
    xi = u @ wc(params["in_proj_x"])
    bc = u @ wc(enter(params["in_proj_bc"], ax))  # (b, l, 2n), the same on every rank
    dt_raw = u @ wc(params["in_proj_dt"])  # (b, l, h/M)
    xi = conv(xi, params["conv_x_w"], params["conv_x_b"])
    bc = conv(bc, enter(params["conv_bc_w"], ax), enter(params["conv_bc_b"], ax))
    Bm, Cm = bc[..., :d_state], bc[..., d_state:]
    dt = F.softplus(dt_raw.float() + params["dt_bias"])
    A = -torch.exp(params["A_log"].float())
    if pad:
        xi, Bm, Cm, dt = (F.pad(t, (0, 0, 0, pad)) for t in (xi, Bm, Cm, dt))
    xh = xi.reshape(b, l + pad, h_loc, di_loc // h_loc)
    core = ssd_chunked_split if fused else ssd_chunked
    y = core(xh, dt, A, Bm, Cm, params["D"].float(), chunk=chunk)
    y = y.reshape(b, l + pad, di_loc)[:, :l]

    # gated RMSNorm over the full d_inner in fp32: one (b, l, 1) sum over the shards
    g = y.float() * F.silu(z.float())
    ssq = psum(torch.sum(torch.square(g), dim=-1, keepdim=True), ax)
    g = g * torch.rsqrt(ssq / (di_loc * ax.size) + 1e-5) * params["norm_scale"].float()
    return psum_replicated(g.to(cdt) @ wc(params["out_proj_w"]), ax)
