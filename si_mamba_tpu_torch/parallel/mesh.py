"""Process groups for the parallel paths: the counterpart of the JAX
package's ``parallel/mesh.py`` over ``torch.distributed``.

A :class:`Mesh` lays the ranks of the initialised default group out row-major
over named axes, as a JAX mesh lays out its devices, and gives each axis the
process group of the ranks that differ only along it, with this rank's index
in it and its size. Collectives of the model run over those groups
(``parallel/collectives.py``). The backend is the caller's choice when the
default group is set up: ``nccl`` for one GPU a rank, ``gloo`` where ranks
share a GPU or run on the CPU; nothing changes it on failure.

The ``data`` axis stays at 1: data parallelism (gradient all-reduce, global
BatchNorm statistics, per-process loaders) is ROADMAP.md queue 1, M18b.
"""

from __future__ import annotations

import dataclasses
import math
import os
from collections.abc import Sequence

import numpy as np
import torch
import torch.distributed as dist


def maybe_initialize_distributed(logger=None, backend: str = "nccl") -> bool:
    """Multi-process bring-up, env-gated as the JAX package's: with
    ``SI_MAMBA_MULTIHOST=1`` set on every process of a launch, the default
    process group is initialised from torchrun's variables (``MASTER_ADDR``,
    ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``) with ``backend``. Without it
    nothing happens (a single-process run). Returns True if initialised."""
    if os.environ.get("SI_MAMBA_MULTIHOST", "").lower() not in ("1", "true"):
        return False
    if not dist.is_initialized():
        dist.init_process_group(backend=backend, init_method="env://")
    if logger is not None:
        logger.info("torch.distributed initialised: rank %d of %d (%s)", dist.get_rank(),
                    dist.get_world_size(), dist.get_backend())
    return True


def per_process_batch(total_bs: int, process_count: int | None = None) -> int:
    """The global batch split over processes (the reference's
    ``total_bs % world_size == 0`` assertion): each process loads this many."""
    P = (dist.get_world_size() if dist.is_initialized() else 1) if process_count is None \
        else process_count
    if total_bs % P != 0:
        raise ValueError(f"total_bs={total_bs} must divide evenly over {P} processes "
                         f"(reference main.py:73 asserts the same)")
    return total_bs // P


@dataclasses.dataclass(frozen=True)
class MeshAxis:
    """One axis of a :class:`Mesh` as this rank sees it: the process group of
    the ranks along it (None when the axis has size 1), this rank's index in
    that group and the group's size."""

    name: str
    group: object
    index: int
    size: int


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Named axes over the ranks of the default group, laid out row-major."""

    axis_names: tuple[str, ...]
    shape: tuple[int, ...]
    axes: dict

    def __getitem__(self, name: str) -> MeshAxis:
        if name not in self.axes:
            raise KeyError(f"the mesh has no axis {name!r}; its axes are {self.axis_names}")
        return self.axes[name]

    def __contains__(self, name: str) -> bool:
        return name in self.axes

    def size(self, name: str) -> int:
        return self[name].size


def make_mesh(axis_names: Sequence[str] = ("data",), shape: Sequence[int] | None = None) -> Mesh:
    """A mesh over the initialised default group. ``shape`` defaults to all
    ranks on the first axis; its product must be the world size. Every rank
    must call this, in the same order as its other group creations: each
    axis's groups are created collectively. Raises ``NotImplementedError``
    for a ``data`` axis larger than 1 (ROADMAP.md queue 1, M18b)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs the default process group: call "
                           "torch.distributed.init_process_group first")
    axis_names = tuple(axis_names)
    world, rank = dist.get_world_size(), dist.get_rank()
    if shape is None:
        shape = (world,) + (1,) * (len(axis_names) - 1)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axis_names) or math.prod(shape) != world:
        raise ValueError(f"mesh shape {shape} over axes {axis_names} does not lay out "
                         f"{world} ranks")
    if "data" in axis_names and shape[axis_names.index("data")] > 1:
        raise NotImplementedError(
            "a 'data' axis larger than 1 (data parallelism: gradient all-reduce, global "
            "BatchNorm statistics, per-process loaders) is ROADMAP.md queue 1, M18b")
    grid = np.arange(world).reshape(shape)
    coord = np.unravel_index(rank, shape)
    axes = {}
    for i, name in enumerate(axis_names):
        lines = np.moveaxis(grid, i, -1).reshape(-1, shape[i])
        mine = None
        for line in lines:  # every rank creates every group, in the same order
            group = dist.new_group([int(r) for r in line]) if shape[i] > 1 else None
            if rank in line:
                mine = group
        axes[name] = MeshAxis(name, mine, int(coord[i]), shape[i])
    return Mesh(axis_names, shape, axes)


def global_host_sum(x) -> np.ndarray:
    """Sum a host-side metric array over all processes (the reference's
    ``reduce_tensor``); the array itself when single-process."""
    x = np.asarray(x)
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return x
    t = torch.from_numpy(np.ascontiguousarray(x, np.float64)).clone()
    dist.all_reduce(t)
    return t.numpy().astype(x.dtype)


def global_host_concat(x: np.ndarray) -> np.ndarray:
    """Concatenate per-process host arrays along axis 0 over all processes
    (the reference's ``gather_tensor``), in rank order, ragged row counts
    allowed; the array itself when single-process. Built from all-reduces of
    zero-filled buffers, as every collective of the port."""
    x = np.asarray(x)
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return x
    world, rank = dist.get_world_size(), dist.get_rank()
    counts = torch.zeros(world, dtype=torch.float64)
    counts[rank] = x.shape[0]
    dist.all_reduce(counts)
    n_max = int(counts.max())
    buf = torch.zeros((world, n_max) + x.shape[1:], dtype=torch.float64)
    buf[rank, :x.shape[0]] = torch.from_numpy(np.asarray(x, np.float64))
    dist.all_reduce(buf)
    return np.concatenate([buf[r, :int(counts[r])].numpy() for r in range(world)],
                          axis=0).astype(x.dtype)
