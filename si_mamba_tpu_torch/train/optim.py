"""Optimizer and learning-rate schedules, the counterparts of
``si_mamba_tpu/train/optim.py`` (the reference's ``build_opti_sche``,
tools/builder.py:55-109):

- AdamW with the weight-decay skip-list: no decay for parameters of at most
  one dimension, biases, and any parameter whose name contains 'token';
- timm 0.4.5 CosineLRScheduler semantics stepped per epoch, with the
  reference loop's one-epoch lag (``scheduler.step(epoch)`` at the end of
  epoch e, so epoch e trains at the epoch-(e-1) value);
- global-norm gradient clipping and gradient accumulation; under tensor
  parallelism the norm is that of the logical parameters, the squared norms
  of the shards summed over the model axis and replicated values counted
  once (``clip_grad_norm_``);
- under data parallelism every gradient averaged over the ``data`` axis
  before the clip (the gradient of the global batch's mean loss), so every
  rank of the axis clips and updates alike.

PyTorch's optimizers are plain tensor code here, as optax is in the JAX
package. Schedules are functions of the update count (learning rate) or the
epoch (BatchNorm momentum).
"""

from __future__ import annotations

import math
from collections.abc import Callable, Mapping

import torch
import torch.distributed as dist
import torch.nn as nn


def _decays(name: str, param: torch.Tensor) -> bool:
    lowered = name.lower()
    return not (param.ndim <= 1 or "bias" in lowered or "token" in lowered)


def _named(params) -> list[tuple[str, torch.Tensor]]:
    if isinstance(params, nn.Module):
        return list(params.named_parameters())
    if isinstance(params, Mapping):
        return list(params.items())
    return list(params)


def wd_mask(params) -> dict[str, bool]:
    """Name -> whether weight decay applies: True for parameters of two or more
    dimensions whose name holds neither 'bias' nor 'token'. ``params``: a
    module, a name -> tensor mapping or (name, tensor) pairs."""
    return {name: _decays(name, p) for name, p in _named(params)}


def adamw_param_groups(params) -> list[list[tuple[str, torch.Tensor]]]:
    """AdamW's two parameter groups, (name, tensor) pairs in ``params``'
    order: those without weight decay, then those with it (:func:`wd_mask`)."""
    named = _named(params)
    mask = wd_mask(named)
    return [[(n, p) for n, p in named if not mask[n]], [(n, p) for n, p in named if mask[n]]]


def adamw_param_order(params) -> list[str]:
    """The parameter names in the order of :func:`build_optimizer`'s AdamW
    (its state's indices)."""
    return [n for group in adamw_param_groups(params) for n, _ in group]


def _epoch_lag(step: int, steps_per_epoch: int) -> int:
    return max(step // steps_per_epoch - 1, 0)


def cosine_warmup_epoch_schedule(base_lr: float, epochs: int, warmup_epochs: int,
                                 steps_per_epoch: int, lr_min: float = 1e-6,
                                 warmup_lr_init: float = 1e-6) -> Callable[[int], float]:
    """timm 0.4.5 CosineLRScheduler (warmup_prefix=False, one cycle) as a
    function of the update count: epoch e trains at ``_get_lr(max(e-1, 0))``,
    a linear warm-up from ``warmup_lr_init`` over ``warmup_epochs``, else
    ``lr_min + (base - lr_min)/2 (1 + cos(pi t / epochs))`` with t not shifted
    by the warm-up."""

    def schedule(step: int) -> float:
        t = _epoch_lag(step, steps_per_epoch)
        if t < warmup_epochs:
            return warmup_lr_init + (base_lr - warmup_lr_init) * t / max(warmup_epochs, 1)
        return lr_min + 0.5 * (base_lr - lr_min) * (1.0 + math.cos(math.pi * t / max(epochs, 1)))

    return schedule


def lambda_lr_schedule(base_lr: float, steps_per_epoch: int, *, decay_step: float,
                       lr_decay: float, lowest_decay: float) -> Callable[[int], float]:
    """The reference's 'LambdaLR' (utils/misc.py:28-34): epoch e trains at
    base · max(lr_decay^((e-1)/decay_step), lowest_decay), e-1 clamped at 0."""

    def schedule(step: int) -> float:
        t = _epoch_lag(step, steps_per_epoch)
        return base_lr * max(lr_decay ** (t / decay_step), lowest_decay)

    return schedule


def step_lr_schedule(base_lr: float, steps_per_epoch: int,
                     step_size: int) -> Callable[[int], float]:
    """torch StepLR(step_size, gamma=0.1) with the same one-epoch lag."""

    def schedule(step: int) -> float:
        return base_lr * 0.1 ** (_epoch_lag(step, steps_per_epoch) // step_size)

    return schedule


def bn_momentum_schedule(*, bn_momentum: float = 0.1, bn_decay: float = 0.5,
                         decay_step: float = 40,
                         lowest_decay: float = 0.01) -> Callable[[float], float]:
    """The reference's 'Lambda' BatchNorm-momentum scheduler (utils/misc.py:
    37-43, 103-133): torch momentum max(bn_momentum · bn_decay^(e /
    decay_step), lowest_decay). Returns epoch -> the flax-convention momentum
    (1 - torch momentum), the argument of ``models.embed.set_bn_momentum``."""

    def schedule(epoch: float) -> float:
        return 1.0 - max(bn_momentum * bn_decay ** (epoch / decay_step), lowest_decay)

    return schedule


def global_grad_norm(params, sharded: Mapping | None = None, axis=None) -> torch.Tensor:
    """The L2 norm of the gradients of the logical parameters. ``sharded``
    maps ``id(param)`` to ``(dim, [(local length, sharded), ...])`` for every
    parameter that holds a shard over the mesh axis ``axis``
    (``PointMamba.tp_sharding``): the squares of its sharded segments are
    summed over the axis, those of its replicated segments (whole on every
    rank) and of every other parameter counted once."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return torch.zeros(())
    local = torch.zeros((), dtype=torch.float32, device=grads[0].device)
    shards = torch.zeros_like(local)
    for p in params:
        if p.grad is None:
            continue
        g = p.grad.float()
        if sharded is None or id(p) not in sharded:
            local = local + torch.sum(g * g)
            continue
        dim, segments = sharded[id(p)]
        for part, (_, is_sharded) in zip(torch.split(g, [n for n, _ in segments], dim=dim),
                                         segments):
            if is_sharded:
                shards = shards + torch.sum(part * part)
            else:
                local = local + torch.sum(part * part)
    if axis is not None and axis.size > 1:
        dist.all_reduce(shards, group=axis.group)
    return torch.sqrt(local + shards)


def average_replicated_grads(params, sharded: Mapping, axis) -> None:
    """Average over the mesh axis ``axis``, in place, the gradients of the
    parameters that every rank holds whole (all but those in ``sharded``).
    Over a model axis they agree across the ranks up to the order of the
    atomic adds in some of PyTorch's CUDA backward kernels (index and gather
    backward); averaging makes them bitwise equal, so the ranks' replicated
    copies take the same update and cannot drift apart. Over the data axis
    (``sharded`` empty) it is the data-parallel gradient average. One
    all-reduce of their concatenation."""
    grads = [p.grad for p in params if p.grad is not None and id(p) not in sharded]
    if axis is None or axis.size == 1 or not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=axis.group)
    flat.div_(axis.size)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def clip_grad_norm_(params, max_norm: float, sharded: Mapping | None = None,
                    axis=None) -> torch.Tensor:
    """Scale the gradients in place to a global norm of at most ``max_norm``,
    as ``torch.nn.utils.clip_grad_norm_`` (coefficient max_norm / (norm +
    1e-6), capped at 1); without ``sharded`` it is that function. Returns the
    norm before clipping."""
    params = [p for p in params if p.grad is not None]
    if sharded is None:
        return torch.nn.utils.clip_grad_norm_(params, max_norm)
    norm = global_grad_norm(params, sharded, axis)
    coef = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    for p in params:
        p.grad.mul_(coef.to(p.grad.dtype))
    return norm


class Optimizer:
    """A torch optimizer driven as the JAX package's optax chain: gradients
    accumulate over ``step_per_update`` backward passes and are averaged
    (``optax.MultiSteps``), then clipped to a global norm of ``grad_clip``,
    and the update runs at ``schedule(count)``, ``count`` being the number of
    updates made so far. :meth:`step` follows each backward pass. Under
    data parallelism every gradient is first averaged over ``data_axis``.
    Under tensor parallelism ``sharded`` and ``axis`` (as
    :func:`global_grad_norm`) make the clip's norm that of the logical
    parameters, and the replicated parameters' gradients are then averaged
    over the model axis (:func:`average_replicated_grads`)."""

    def __init__(self, torch_optimizer: torch.optim.Optimizer,
                 schedule: Callable[[int], float], grad_clip: float | None = None,
                 step_per_update: int = 1, sharded: Mapping | None = None, axis=None,
                 data_axis=None):
        self.torch_optimizer = torch_optimizer
        self.schedule = schedule
        self.grad_clip = grad_clip
        self.sharded, self.axis, self.data_axis = sharded, axis, data_axis
        self.step_per_update = int(step_per_update)
        self.count = 0  # updates made
        self.micro = 0  # backward passes since the last update
        self.last_grad_norm: torch.Tensor | None = None  # pre-clip, of the last update

    @property
    def params(self) -> list[torch.Tensor]:
        return [p for g in self.torch_optimizer.param_groups for p in g["params"]]

    def step(self) -> bool:
        """Count one backward pass; on every ``step_per_update``-th, update
        the parameters and clear their gradients. Returns whether it updated."""
        self.micro += 1
        if self.micro < self.step_per_update:
            return False
        params = [p for p in self.params if p.grad is not None]
        if self.step_per_update > 1:
            for p in params:
                p.grad.div_(self.step_per_update)
        if self.data_axis is not None:
            average_replicated_grads(params, {}, self.data_axis)
        if self.axis is not None:
            average_replicated_grads(params, self.sharded, self.axis)
        if self.grad_clip is not None and self.grad_clip > 0:
            self.last_grad_norm = clip_grad_norm_(params, self.grad_clip, self.sharded,
                                                  self.axis)
        lr = self.schedule(self.count)
        for group in self.torch_optimizer.param_groups:
            group["lr"] = lr
        self.torch_optimizer.step()
        self.torch_optimizer.zero_grad(set_to_none=True)
        self.count += 1
        self.micro = 0
        return True


def build_optimizer(params, *, opt_type: str = "AdamW", lr: float = 3e-4,
                    weight_decay: float = 0.05, epochs: int = 300,
                    warmup_epochs: int = 10, steps_per_epoch: int = 1,
                    grad_clip: float | None = 10.0, sched_type: str = "CosLR",
                    step_per_update: int = 1, sched_kwargs: dict | None = None,
                    tp: tuple | None = None, data_axis=None) -> tuple[Optimizer, Callable]:
    """Returns (optimizer, schedule), the JAX ``build_optimizer``'s (tx,
    schedule). ``params``: a module, a name -> tensor mapping or (name, tensor)
    pairs; the names decide the weight-decay groups (:func:`wd_mask`).
    ``tp``: a tensor-parallel model's ``tp_sharding()``, (axis, {name:
    segments}), for the clip's global norm over the logical parameters.
    ``data_axis``: the mesh's ``data`` axis, over which the gradients are
    averaged (data parallelism)."""
    if sched_type == "CosLR":
        schedule = cosine_warmup_epoch_schedule(lr, epochs, warmup_epochs, steps_per_epoch)
    elif sched_type == "LambdaLR":
        kw = sched_kwargs or {}
        schedule = lambda_lr_schedule(
            lr, steps_per_epoch, decay_step=float(kw.get("decay_step", 40)),
            lr_decay=float(kw.get("lr_decay", 0.7)),
            lowest_decay=float(kw.get("lowest_decay", 0.02)))
    elif sched_type == "StepLR":
        schedule = step_lr_schedule(lr, steps_per_epoch, epochs)  # epochs is the step size
    elif sched_type == "const":
        schedule = lambda step: lr  # noqa: E731
    else:
        raise NotImplementedError(sched_type)

    named = _named(params)
    lr0 = schedule(0)
    if opt_type == "AdamW":
        groups = [{"params": [p for _, p in group], "weight_decay": wd}
                  for group, wd in zip(adamw_param_groups(named), (0.0, weight_decay))]
        opt = torch.optim.AdamW([g for g in groups if g["params"]], lr=lr0,
                                betas=(0.9, 0.999), eps=1e-8)
    elif opt_type == "Adam":
        opt = torch.optim.Adam([p for _, p in named], lr=lr0, betas=(0.9, 0.999), eps=1e-8)
    elif opt_type == "SGD":
        opt = torch.optim.SGD([p for _, p in named], lr=lr0, momentum=0.9, nesterov=True)
    else:
        raise NotImplementedError(opt_type)
    sharded, axis = None, None
    if tp is not None:
        axis, segments = tp
        sharded = {id(p): segments[n] for n, p in named if n in segments}
    return (Optimizer(opt, schedule, grad_clip, step_per_update, sharded, axis, data_axis),
            schedule)
