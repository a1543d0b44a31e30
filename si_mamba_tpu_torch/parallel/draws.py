"""Random draws over the global batch.

The JAX train step over a ``data`` mesh draws from one replicated key with
the global batch's shapes, so the draws of a row do not depend on how the
batch is sharded. Here every rank of the axis holds the same
``torch.Generator`` (same seed, same draws so far); a :class:`RowShard` makes
each draw for the global batch, rows of all ranks, and keeps this rank's
rows [index B, (index + 1) B). So the ranks draw what the one-process step
draws for the same rows, never the same numbers for different rows, and
their generators stay in step.

Every function takes a plain ``torch.Generator`` too, and then is the torch
call it names, the same draw and the same launches. The leading dimension of
every shape is the batch.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class RowShard:
    """``generator`` drawing for ``count`` ranks' rows, this rank's the
    ``index``-th block."""

    generator: torch.Generator
    index: int
    count: int


def shard_rows(generator: torch.Generator | None, axis) -> torch.Generator | RowShard | None:
    """``generator`` as a :class:`RowShard` over the mesh axis ``axis``; the
    generator itself without an axis or on an axis of one rank."""
    if generator is None or axis is None or axis.size == 1:
        return generator
    return RowShard(generator, axis.index, axis.size)


def _draw(fn, shape, generator):
    shape = tuple(shape)
    if not isinstance(generator, RowShard):
        return fn(shape, generator)
    b = shape[0]
    full = fn((b * generator.count,) + shape[1:], generator.generator)
    return full[generator.index * b:(generator.index + 1) * b]


def rand(shape, generator, *, device=None, dtype=None) -> torch.Tensor:
    """``torch.rand(shape)``: U(0, 1)."""
    return _draw(lambda s, g: torch.rand(s, generator=g, device=device, dtype=dtype),
                 shape, generator)


def randn(shape, generator, *, device=None, dtype=None) -> torch.Tensor:
    """``torch.randn(shape)``."""
    return _draw(lambda s, g: torch.randn(s, generator=g, device=device, dtype=dtype),
                 shape, generator)


def randint(low: int, high: int, shape, generator, *, device=None) -> torch.Tensor:
    """``torch.randint(low, high, shape)``."""
    return _draw(lambda s, g: torch.randint(low, high, s, generator=g, device=device),
                 shape, generator)


def bernoulli(shape, keep: float, generator, *, device=None, dtype=None) -> torch.Tensor:
    """``torch.empty(shape).bernoulli_(keep)``: 1 with probability ``keep``."""
    return _draw(lambda s, g: torch.empty(s, device=device, dtype=dtype).bernoulli_(
        keep, generator=g), shape, generator)
