"""The collectives of the parallel paths with their gradients, each a
``torch.autograd.Function`` over ``all_reduce`` of one :class:`MeshAxis`.

JAX derives these gradients from ``shard_map``'s transposes; here each is
written out:

- :func:`psum_replicated`: a sum whose result is the replicated block output
  (the ``out_proj`` psum of the tensor-parallel mixers): all-reduce forward,
  identity backward, since every rank then holds the whole cotangent;
- :func:`psum`: a sum whose result feeds rank-local work (the ``x_proj``
  psum, the gated RMSNorm's sum of squares): all-reduce forward and backward;
- :func:`enter`: a replicated value entering rank-local work (the block
  input, the weights every rank applies redundantly, the replicated
  parameters of the sequence-parallel scans): identity forward, all-reduce
  backward, so its gradient sums the ranks' parts;
- :func:`all_gather`: each rank's tensor stacked along a new leading axis of
  the axis size. The forward writes this rank's row of a zero-filled buffer
  and all-reduces it (adding zeros is exact); the backward all-reduces the
  cotangent buffer and takes this rank's row;
- :func:`shift`: ``lax.ppermute`` along the axis by a fixed offset, cyclic
  (rank i's tensor goes to rank i + offset), by the same zero-filled buffer;
  its backward is the reverse shift of the cotangent.

Only ``all_reduce`` is used, so the same code runs on ``nccl`` and on
``gloo``, whose support for CUDA tensors covers all-reduce. On an axis of size
1 each is the identity. Every rank must run the same collectives in the same
order, forward and backward.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from si_mamba_tpu_torch.parallel.mesh import MeshAxis


def _all_reduce(t: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    out = t.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=axis.group)
    return out


class _PsumReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return _all_reduce(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _all_reduce(x, axis)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.axis), None


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.axis), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        buf = x.new_zeros((axis.size,) + tuple(x.shape))
        buf[axis.index] = x
        dist.all_reduce(buf, group=axis.group)
        return buf

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.axis)[ctx.axis.index], None


def _shift(x: torch.Tensor, axis: MeshAxis, offset: int) -> torch.Tensor:
    buf = x.new_zeros((axis.size,) + tuple(x.shape))
    buf[(axis.index + offset) % axis.size] = x
    dist.all_reduce(buf, group=axis.group)
    return buf[axis.index]


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, offset):
        ctx.axis, ctx.offset = axis, offset
        return _shift(x, axis, offset)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.axis, -ctx.offset), None, None


def psum_replicated(x: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """Sum over ``axis`` into a replicated result; identity backward."""
    return x if axis.size == 1 else _PsumReplicated.apply(x, axis)


def psum(x: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """Sum over ``axis`` of a value that feeds rank-local work; the backward
    sums the cotangent over ``axis`` too."""
    return x if axis.size == 1 else _Psum.apply(x, axis)


def enter(x: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """A replicated value entering rank-local work: identity forward, its
    gradient summed over ``axis``."""
    return x if axis.size == 1 else _Enter.apply(x, axis)


def all_gather(x: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """(axis.size, *x.shape): every rank's ``x`` in rank order."""
    return x[None] if axis.size == 1 else _AllGather.apply(x, axis)


def shift(x: torch.Tensor, axis: MeshAxis, offset: int = 1) -> torch.Tensor:
    """The tensor of the rank ``offset`` places before this one along
    ``axis`` (cyclic): rank i's ``x`` lands on rank (i + offset) mod size,
    as ``lax.ppermute`` with the pairs (i, i + offset). Every rank's ``x``
    has one shape and dtype. The gradient shifts back."""
    return x if axis.size == 1 else _Shift.apply(x, axis, int(offset))
