"""Sequence-parallel scans over a ``seq`` mesh axis, the counterparts of
``si_mamba_tpu/parallel/seq_scan.py``.

Each rank holds its L / P slice of the time axis. The recurrence is affine in
its entry state, so:

1. each rank scans its slice from a zero state, keeping its slice's map
   (decay, final state from zero);
2. one all-gather of the P maps over the axis;
3. each rank composes the earlier ranks' maps (P is small) into its entry
   state h_in;
4. the local outputs are fixed up with h_in, with no second pass over the
   data.

Communication is independent of L. The per-channel parameters (A, D, the dt
bias) are replicated: :func:`enter` sums their gradients over the axis, the
all-reduce the JAX package takes outside its ``shard_map``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from si_mamba_tpu_torch.ops.kernels.ssd import ssd_chunked_split
from si_mamba_tpu_torch.ops.ssd import ssd_chunked, ssd_fused_route
from si_mamba_tpu_torch.parallel.collectives import all_gather, enter
from si_mamba_tpu_torch.parallel.mesh import Mesh, MeshAxis


def _compose_exclusive_prefix(decay, state, axis: MeshAxis, apply_decay):
    """This rank's entry state from every rank's slice map (decay, state from
    zero): the composition of the earlier ranks' maps. Every rank runs the
    same gathers and the same masked loop over all P, so the backward runs the
    same collectives on every rank. ``apply_decay(d, h)`` broadcasts a decay
    onto the carried state."""
    all_d, all_s = all_gather(decay, axis), all_gather(state, axis)
    h = torch.zeros_like(state)
    for i in range(axis.size):
        h = torch.where(torch.tensor(i < axis.index, device=h.device),
                        apply_decay(all_d[i], h) + all_s[i], h)
    return h


def selective_scan_seq_parallel(u, delta, A, B, C, D=None, z=None, delta_bias=None, *,
                                mesh: Mesh, axis: str = "seq") -> torch.Tensor:
    """Selective scan (softplus step sizes, fp32 state) with the time axis
    sharded over ``axis``: u, delta, z (b, L/P, d) and B, C (b, L/P, n) are
    this rank's slices; A (d, n), D, delta_bias (d,) replicated. The local
    scan runs sequentially from a zero state."""
    ax = mesh[axis]
    d = u.shape[-1]
    if D is None:
        D = u.new_zeros(d, dtype=torch.float32)
    if delta_bias is None:
        delta_bias = u.new_zeros(d, dtype=torch.float32)
    A, D, delta_bias = (enter(t, ax) for t in (A, D, delta_bias))
    delta32 = F.softplus(delta.float() + delta_bias.float())
    u32 = u.float()
    dA = torch.exp(delta32[..., None] * A.float())  # (b, l, d, n)
    dBu = (delta32 * u32)[..., None] * B.float()[:, :, None, :]
    hs, h = [], dBu.new_zeros(dBu[:, 0].shape)
    for t in range(u.shape[1]):
        h = dA[:, t] * h + dBu[:, t]
        hs.append(h)
    acc_b = torch.stack(hs, dim=1)  # states from zero
    acc_a = torch.cumprod(dA, dim=1)  # decay since the slice start
    h_in = _compose_exclusive_prefix(acc_a[:, -1], acc_b[:, -1], ax, lambda a, h: a * h)
    states = acc_a * h_in[:, None] + acc_b
    y = torch.einsum("bldn,bln->bld", states, C.float()) + u32 * D.float()
    if z is not None:
        y = y * F.silu(z.float())
    return y.to(u.dtype)


def ssd_seq_parallel(x, dt, A, Bm, Cm, D, *, mesh: Mesh, axis: str = "seq", chunk: int = 64,
                     impl: str = "xla") -> torch.Tensor:
    """The chunked SSD with the time axis sharded over ``axis``: x
    (b, L/P, h, p), dt (b, L/P, h), Bm, Cm (b, L/P, n) are this rank's slices,
    A, D (h,) replicated; L/P must be a chunk multiple. Each rank runs the
    core from a zero state with its carry (``impl='ssd_fused'``: K6 with
    h_fin, and with a gradient K6 with states and h_fin and the seeded K7;
    'xla': ``ssd_chunked``), one all-gather of the (decay (b, h), state
    (b, h, n, p)) maps crosses the axis, and the fix-up is one product:
    y += C[t] e^{S_local[t]} h_in."""
    ax = mesh[axis]
    l_local = x.shape[1]
    if l_local % chunk:
        raise ValueError(f"the local slice L={l_local} is not a multiple of chunk={chunk}")
    A, D = enter(A, ax), enter(D, ax)
    core = ssd_chunked_split if ssd_fused_route(impl, l_local, chunk, Bm.shape[-1],
                                                x.shape[-1], x.device) else ssd_chunked
    y0, dec, st = core(x, dt, A, Bm, Cm, D, chunk=chunk, return_carry=True)
    h_in = _compose_exclusive_prefix(dec, st, ax, lambda d, h: d[..., None, None] * h)
    S_loc = torch.cumsum(dt.float() * A.float()[None, None, :], dim=1)  # (b, l, h)
    corr = torch.einsum("bln,bhnp->blhp", Cm.float(), h_in) * torch.exp(S_loc)[..., None]
    return y0 + corr.to(y0.dtype)
