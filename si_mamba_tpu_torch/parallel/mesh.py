"""Process groups for the parallel paths: the counterpart of the JAX
package's ``parallel/mesh.py`` over ``torch.distributed``.

A :class:`Mesh` lays the ranks of the initialised default group out row-major
over named axes, as a JAX mesh lays out its devices, and gives each axis the
process group of the ranks that differ only along it, with this rank's index
in it and its size. Collectives of the model run over those groups
(``parallel/collectives.py``).

Data parallelism is a ``data`` axis: the JAX train step over a data mesh is
the one-device step over the global batch (state replicated, batch sharded on
its leading axis, gradients and metrics summed, BatchNorm statistics over the
global batch, the draws from one replicated key). Here rank r of the axis
holds rows [r B/W, (r+1) B/W) of the global batch; the BatchNorms take their
statistics over the axis (``models/embed.py``), the draws are made for the
global batch and each rank keeps its rows (``parallel/draws.py``), and the
optimizer averages the gradients over the axis (``train/optim.py``).

The JAX package's ``local_eval_mesh``, ``localize`` and ``dp_eval_jit``'s
padding (its ``mesh.py:112-163``) have no counterpart: one rank is one
device, so a rank's ragged evaluation batch is whole on its device, and the
evaluation counts are summed over the ranks (:func:`global_host_sum`).

The backend is decided once, when the default group is initialised
(:func:`backend_for`): ``nccl`` only when every rank has a card of its own,
``gloo`` otherwise (ranks that share a card, or the CPU); nothing switches it
on failure.
"""

from __future__ import annotations

import dataclasses
import math
import os
from collections.abc import Sequence

import numpy as np
import torch
import torch.distributed as dist


def local_rank() -> int:
    """This process's index on its host (torchrun's ``LOCAL_RANK``; 0 without)."""
    return int(os.environ.get("LOCAL_RANK", "0"))


def rank_device(kind="cuda") -> torch.device:
    """The device of this rank: ``cuda:LOCAL_RANK`` for ``kind`` 'cuda', the
    ranks sharing the cards when the launch puts more ranks on a host than it
    has (``LOCAL_RANK % device_count``); the CPU for 'cpu'. Raises for CUDA on
    a host without a GPU."""
    kind = torch.device(kind)
    if kind.type != "cuda":
        return kind
    if not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no GPU is available; pass "
                           "device='cpu' to run on the CPU")
    return torch.device("cuda", local_rank() % torch.cuda.device_count())


def backend_for(device) -> str:
    """``nccl`` when ``device`` is a card and every rank of this host has a
    card of its own (torchrun's ``LOCAL_WORLD_SIZE`` at most the card count),
    ``gloo`` otherwise: ranks that share a card, or the CPU."""
    if torch.device(device).type != "cuda":
        return "gloo"
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", "1"))
    return "nccl" if local_world <= torch.cuda.device_count() else "gloo"


def maybe_initialize_distributed(logger=None, device="cuda", timeout=None) -> bool:
    """Multi-process bring-up, env-gated as the JAX package's: with
    ``SI_MAMBA_MULTIHOST=1`` set on every process of a launch, the default
    process group is initialised from torchrun's variables (``MASTER_ADDR``,
    ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``) on the backend that
    :func:`backend_for` picks for ``device`` (decided here, once, and logged),
    and a card rank binds ``rank_device(device)``; ``timeout`` (a
    ``datetime.timedelta``) bounds each collective's wait. Without the
    variable nothing happens (a single-process run). Returns True if
    initialised. A failed initialisation raises: nothing falls back to one
    process."""
    if os.environ.get("SI_MAMBA_MULTIHOST", "").lower() not in ("1", "true"):
        return False
    dev = rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        kw = {} if timeout is None else {"timeout": timeout}
        dist.init_process_group(backend=backend_for(dev), init_method="env://", **kw)
    msg = (f"torch.distributed initialised: rank {dist.get_rank()} of "
           f"{dist.get_world_size()} on {dev} ({dist.get_backend()})")
    if logger is not None:
        logger.info(msg)
    else:
        print(msg, flush=True)
    return True


def rank_and_world() -> tuple[int, int]:
    """(rank, world size) of the default group; (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def barrier() -> None:
    """Wait for every rank of the default group; nothing without one."""
    if rank_and_world()[1] > 1:
        dist.barrier()


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
    axis's groups are created collectively. A ``data`` axis shards the batch
    (the module docstring); the other axes shard the model."""
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


def data_mesh() -> Mesh | None:
    """A ``('data',)`` mesh over every rank of the default group; None for a
    single process."""
    return make_mesh(("data",)) if rank_and_world()[1] > 1 else None


LOCAL_DATA = MeshAxis("data", None, 0, 1)
"""A data axis of one rank: the batch statistics and draws of a module so
marked are this rank's own, whatever the world size."""


def data_axis(mesh: Mesh | None) -> MeshAxis | None:
    """The mesh's ``data`` axis; :data:`LOCAL_DATA` for a mesh without one
    (its other axes replicate the batch); None without a mesh."""
    if mesh is None:
        return None
    return mesh["data"] if "data" in mesh else LOCAL_DATA


def model_axis_size(mesh: Mesh | None) -> int:
    """The ranks that hold one data shard: the product of the mesh's axes
    other than ``data`` (1 without a mesh)."""
    if mesh is None:
        return 1
    return math.prod(s for n, s in zip(mesh.axis_names, mesh.shape) if n != "data")


def set_data_axis(module, axis: MeshAxis | None) -> None:
    """Give every submodule of ``module`` that takes statistics over the
    batch in training (those with a ``data_axis`` attribute: the BatchNorms,
    the wavelet scores' RMS) the axis to take them over."""
    for m in module.modules():
        if hasattr(m, "data_axis"):
            m.data_axis = axis


def module_data_axis(module) -> MeshAxis | None:
    """The data axis ``set_data_axis`` gave ``module``'s batch statistics, if
    it has more than one rank; else None."""
    for m in module.modules():
        axis = getattr(m, "data_axis", None)
        if axis is not None:
            return axis if axis.size > 1 else None
    return None


def batch_axis(module) -> MeshAxis | None:
    """The axis over which ``module`` takes its training statistics: its
    ``data_axis`` if larger than 1, else None (this rank's rows). Raises
    when the world is larger than one rank and no axis was set: statistics
    taken silently over one rank's rows would be the wrong function."""
    axis = module.data_axis
    if axis is None:
        if rank_and_world()[1] > 1:
            raise RuntimeError(
                f"{type(module).__name__} takes batch statistics in training over a world "
                f"of {rank_and_world()[1]} ranks with no data axis: call parallel.set_data_axis("
                f"model, mesh['data']) (or LOCAL_DATA for rank-local statistics)")
        return None
    return axis if axis.size > 1 else None


def _host_buffer(t: torch.Tensor) -> torch.Tensor:
    """A host array's tensor where the default group's backend reduces it:
    the CPU for gloo, this rank's card for nccl."""
    if dist.get_backend() == "nccl":
        return t.to(torch.device("cuda", torch.cuda.current_device()))
    return t


def _group(axis: MeshAxis | None):
    """(process group, this rank's index, size) of ``axis``, or of the whole
    world for None."""
    if axis is None:
        rank, world_size = rank_and_world()
        return None, rank, world_size
    return axis.group, axis.index, axis.size


def global_host_sum(x, axis: MeshAxis | None = None) -> np.ndarray:
    """Sum a host-side metric array over all processes, or over the ranks of
    the mesh axis ``axis`` (the reference's ``reduce_tensor``); the array
    itself when single-process."""
    x = np.asarray(x)
    group, _, size = _group(axis)
    if size == 1:
        return x
    t = _host_buffer(torch.from_numpy(np.ascontiguousarray(x, np.float64)).clone())
    dist.all_reduce(t, group=group)
    return t.cpu().numpy().astype(x.dtype)


def global_host_concat(x: np.ndarray, axis: MeshAxis | None = None) -> np.ndarray:
    """Concatenate per-process host arrays along axis 0 over all processes,
    or over the ranks of ``axis`` (the reference's ``gather_tensor``), in
    rank order, ragged row counts allowed; the array itself when
    single-process. Built from all-reduces of zero-filled buffers, as every
    collective of the port."""
    x = np.asarray(x)
    group, rank, world_size = _group(axis)
    if world_size == 1:
        return x
    counts = torch.zeros(world_size, dtype=torch.float64)
    counts[rank] = x.shape[0]
    counts = _host_buffer(counts)
    dist.all_reduce(counts, group=group)
    counts = counts.cpu()
    n_max = int(counts.max())
    buf = torch.zeros((world_size, n_max) + x.shape[1:], dtype=torch.float64)
    buf[rank, :x.shape[0]] = torch.from_numpy(np.asarray(x, np.float64))
    buf = _host_buffer(buf)
    dist.all_reduce(buf, group=group)
    buf = buf.cpu()
    return np.concatenate([buf[r, :int(counts[r])].numpy() for r in range(world_size)],
                          axis=0).astype(x.dtype)


def _bits(t: torch.Tensor) -> torch.Tensor:
    """A tensor's elements as float64 numbers that are equal exactly when
    the elements are bitwise equal (floats by their bit patterns)."""
    t = t.detach().reshape(-1)
    if t.is_floating_point():
        t = t.view({8: torch.int64, 4: torch.int32, 2: torch.int16}[t.element_size()])
        if t.dtype == torch.int64:  # two exact halves
            t = torch.stack([t >> 32, t & 0xFFFFFFFF], dim=-1).reshape(-1)
    return t.to(torch.float64)


def check_replicas_equal(named: dict, axis: MeshAxis | None) -> None:
    """Raise, naming the first tensor that differs, unless every rank of
    ``axis`` holds bitwise the same ``named`` tensors (the same names on
    every rank). Two all-reduces (min and max) of their concatenated bit
    patterns, on the host; nothing for an axis of one rank."""
    if axis is None or axis.size == 1 or not named:
        return
    names = list(named)
    parts = [_bits(named[k]).cpu() for k in names]
    flat = torch.cat(parts)
    lo, hi = _host_buffer(flat.clone()), _host_buffer(flat.clone())
    dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=axis.group)
    dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=axis.group)
    differs = (lo != hi).cpu()
    if not bool(differs.any()):
        return
    offset = 0
    for k, p in zip(names, parts):
        n = p.numel()
        if bool(differs[offset:offset + n].any()):
            raise RuntimeError(f"the ranks of the '{axis.name}' axis hold different copies of "
                               f"{k!r}: replicated parameters and BatchNorm statistics must "
                               f"stay bitwise equal")
        offset += n
