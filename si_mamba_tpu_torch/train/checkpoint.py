"""Checkpoints in the reference's ``.pth`` format (``SURVEY.md`` §5.4), the
counterpart of ``si_mamba_tpu/train/checkpoint.py`` (which writes orbax
directories, a format this package does not read: ``scripts/export_torch.py``
turns one into a ``.pth``).

``<exp_dir>/<prefix>.pth`` holds ``{base_model, optimizer, epoch, metrics,
best_metrics}`` as the reference writes it, ``base_model`` in the reference's
keys (this package's module names). ``optimizer`` is the torch optimizer's
``state_dict`` with what ``train/optim.py:Optimizer`` adds (its update count
``count``, its backward passes since the last update ``micro`` and, between
updates, their summed gradients ``accumulated``). Two more keys make a resumed
run continue bitwise: the train state's ``step`` and the state of the
generator the steps draw from (``rng``).

Over several ranks rank 0 writes, and every rank reads (a barrier orders a
read after the write). The replicas are bitwise equal (the runners check it
every epoch), so rank 0's copy, and its generator's state, are every rank's.
A tensor-parallel model's mixer tensors, with the optimizer's state and
gradients of them, are gathered over the model axis first
(``utils/weights.gather_state_dict``), so the file is the whole model in the
reference's keys; each rank takes its shard back on resume.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Callable

import torch
import torch.nn as nn

from si_mamba_tpu_torch.parallel.collectives import all_gather
from si_mamba_tpu_torch.parallel.mesh import barrier, rank_and_world
from si_mamba_tpu_torch.train.logging_utils import print_log
from si_mamba_tpu_torch.utils.weights import (
    ORBAX_NOT_READ,
    _strip_prefixes,
    gather_state_dict,
    shard_state_dict,
)


def checkpoint_path(exp_dir: str, prefix: str) -> str:
    return os.path.join(exp_dir, f"{prefix}.pth")


def check_pth(path: str) -> None:
    """Raise for what a ``.pth`` path must not be: an orbax directory."""
    if os.path.isdir(path):
        raise NotImplementedError(f"{path}: {ORBAX_NOT_READ}")


def _to_cpu(obj: Any) -> Any:
    """A copy of ``obj`` with every tensor copied to the CPU."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def _optimizer_payload(optimizer) -> dict:
    out = dict(optimizer.torch_optimizer.state_dict())
    out["count"], out["micro"] = optimizer.count, optimizer.micro
    if optimizer.micro:
        out["accumulated"] = {i: p.grad for i, p in enumerate(optimizer.params)
                              if p.grad is not None}
    return out


def _tp(model):
    return model.tp_sharding() if hasattr(model, "tp_sharding") else None


def _gather(named: dict, axis, cfg) -> dict:
    """Name-keyed tensors of this rank (a state dict, or the optimizer's
    per-parameter tensors by parameter name) -> the whole model's, the mixer
    tensors gathered over ``axis``. Every rank of the axis must call it."""
    parts = [dict(named) for _ in range(axis.size)]
    for k, v in named.items():
        if ".mixer." in k:
            rows = all_gather(v.detach(), axis)
            for r in range(axis.size):
                parts[r][k] = rows[r]
    return gather_state_dict(parts, cfg)


def _per_param(optimizer, model, payload: dict, convert) -> dict:
    """``payload`` with every per-parameter tensor (the optimizer's state,
    the accumulated gradients) passed through ``convert``, a function of a
    name-keyed dict."""
    names = {id(p): n for n, p in model.named_parameters()}
    order = [names[id(p)] for p in optimizer.params]
    out = dict(payload)
    state = {i: dict(s) for i, s in payload["state"].items()}
    kinds = sorted({k for s in state.values() for k, v in s.items()
                    if isinstance(v, torch.Tensor) and v.ndim > 0})
    for kind in kinds:
        conv = convert({order[i]: s[kind] for i, s in state.items() if kind in s})
        for i, s in state.items():
            if kind in s:
                s[kind] = conv[order[i]]
    out["state"] = state
    if "accumulated" in payload:
        conv = convert({order[i]: g for i, g in payload["accumulated"].items()})
        out["accumulated"] = {i: conv[order[i]] for i in payload["accumulated"]}
    return out


def _load_optimizer(optimizer, payload: dict) -> None:
    optimizer.torch_optimizer.load_state_dict({"state": payload["state"],
                                               "param_groups": payload["param_groups"]})
    optimizer.count, optimizer.micro = int(payload["count"]), int(payload["micro"])
    params = optimizer.params
    for p in params:
        p.grad = None
    for i, g in payload.get("accumulated", {}).items():
        params[i].grad = g.to(params[i].device, params[i].dtype)


class _BackgroundWriter:
    """One save at a time on a background thread; a failed save raises from
    the next :meth:`wait`."""

    def __init__(self):
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def submit(self, fn: Callable[[], None]) -> None:
        self.wait()
        self._thread = threading.Thread(target=self._run, args=(fn,), daemon=True)
        self._thread.start()

    def _run(self, fn) -> None:
        try:
            fn()
        except BaseException as e:  # re-raised on the caller's thread by wait()
            self._error = e

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err


_WRITER = _BackgroundWriter()


def wait_for_saves() -> None:
    """Block until an async save has written its file; re-raise its error."""
    _WRITER.wait()


def _write(path: str, payload: dict) -> None:
    """torch.save to a temporary file, synced, then renamed over ``path``: a
    crash mid-save leaves the previous file whole."""
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        torch.save(payload, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def save_checkpoint(exp_dir: str, prefix: str, state, epoch: int,
                    metrics: dict | None = None, best_metrics: dict | None = None,
                    async_save: bool = False,
                    generator: torch.Generator | None = None) -> None:
    """Write ``<exp_dir>/<prefix>.pth`` from the train state (its model and
    optimizer) and ``generator``'s state. With ``async_save`` the file is
    written on a background thread from CPU copies taken now, while training
    goes on; a later save, :func:`load_checkpoint` and
    :func:`wait_for_saves` wait for it. Over several ranks every rank calls
    it and rank 0 writes (a tensor-parallel model's shards gathered)."""
    model, tp = state.model, _tp(state.model)
    base, opt = model.state_dict(), _optimizer_payload(state.optimizer)
    if tp is not None:
        axis, cfg = tp[0], model.config
        base = _gather(base, axis, cfg)
        opt = _per_param(state.optimizer, model, opt, lambda d: _gather(d, axis, cfg))
    if rank_and_world()[0] != 0:
        return
    payload = _to_cpu({
        "base_model": base,
        "optimizer": opt,
        "epoch": int(epoch),
        "metrics": dict(metrics or {}),
        "best_metrics": dict(best_metrics or {}),
        "step": int(state.step),
        "rng": generator.get_state() if generator is not None else None,
    })
    os.makedirs(exp_dir, exist_ok=True)
    path = checkpoint_path(exp_dir, prefix)
    if async_save:
        _WRITER.submit(lambda: _write(path, payload))
    else:
        _WRITER.wait()
        _write(path, payload)


def load_checkpoint(exp_dir: str, prefix: str) -> dict | None:
    """The payload of ``<exp_dir>/<prefix>.pth`` (tensors only, on the CPU),
    or None if there is none."""
    wait_for_saves()
    path = checkpoint_path(exp_dir, prefix)
    check_pth(os.path.join(exp_dir, prefix))
    if not os.path.exists(path):
        return None
    return torch.load(path, map_location="cpu", weights_only=True)


def resume_state(exp_dir: str, state, generator: torch.Generator | None = None):
    """Restore ``ckpt-last`` into the train state (model, optimizer, step)
    and ``generator``. Returns (state, the epoch to start from,
    best_metrics), or (state, 0, {}) without a checkpoint. Over several
    ranks every rank reads, after a barrier; a tensor-parallel model takes
    its shard."""
    barrier()
    payload = load_checkpoint(exp_dir, "ckpt-last")
    if payload is None:
        return state, 0, {}
    model, tp = state.model, _tp(state.model)
    base, opt = payload["base_model"], payload["optimizer"]
    if tp is not None:
        axis, cfg = tp[0], model.config

        def shard(d):
            return shard_state_dict(d, cfg, axis.index, axis.size)

        base = shard(base)
        opt = _per_param(state.optimizer, model, opt, shard)
    model.load_state_dict(base, strict=True)
    _load_optimizer(state.optimizer, opt)
    state.step = int(payload["step"])
    if generator is not None and payload.get("rng") is not None:
        generator.set_state(payload["rng"])
    return state, int(payload["epoch"]) + 1, dict(payload.get("best_metrics", {}))


def transfer_pretrained(model: nn.Module, pretrained: dict, logger=None
                        ) -> tuple[list[str], list[str], list[str]]:
    """Load a pretrained state dict (reference keys; ``module.``,
    ``MAE_encoder.`` and ``base_model.`` prefixes stripped) into ``model``
    where the key and shape match, ``strict=False``; every other entry keeps
    the model's initialisation. Logs and returns (missing, unexpected,
    shape-mismatched) keys."""
    sd = _strip_prefixes(pretrained)
    own = model.state_dict()
    missing = sorted(set(own) - set(sd))
    unexpected = sorted(set(sd) - set(own))
    # a 0-d entry may come as shape (1,), which load_state_dict takes (as
    # numpy's ascontiguousarray makes a 0-d array 1-d)
    mismatched = sorted(k for k in set(own) & set(sd)
                        if tuple(torch.as_tensor(sd[k]).shape)
                        not in {tuple(own[k].shape), (1,) if own[k].ndim == 0 else None})
    model.load_state_dict({k: torch.as_tensor(v) for k, v in sd.items()
                           if k in own and k not in mismatched}, strict=False)
    if missing:
        print_log(f"missing_keys ({len(missing)}): {missing[:20]}...", logger)
    if unexpected:
        print_log(f"unexpected_keys ({len(unexpected)}): {unexpected[:20]}...", logger)
    if mismatched:
        print_log(f"shape-mismatched (kept new init): {mismatched}", logger)
    return missing, unexpected, mismatched
