"""Logging and metrics, the counterparts of
``si_mamba_tpu/train/logging_utils.py``: named loggers with a rank-0 file
handler (the reference's utils/logger.py), the JSONL scalar stream (the
TensorBoard replacement), the multi-item AverageMeter, the one-step-late
metric readback of the train loop, and Acc_Metric model selection."""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Sequence

import torch
import torch.distributed as dist


def _rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def get_logger(name: str, log_file: str | None = None, rank: int = 0,
               level=logging.INFO) -> logging.Logger:
    logger = logging.getLogger(name)
    if getattr(logger, "_si_mamba_configured", False):
        return logger
    fmt = logging.Formatter("%(asctime)s - %(name)s - %(levelname)s - %(message)s")
    sh = logging.StreamHandler()
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if log_file is not None and rank == 0:
        os.makedirs(os.path.dirname(log_file) or ".", exist_ok=True)
        fh = logging.FileHandler(log_file, "a")
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    logger.setLevel(level if rank == 0 else logging.ERROR)
    logger.propagate = False
    logger._si_mamba_configured = True
    return logger


def print_log(msg: str, logger: logging.Logger | str | None = None):
    if logger is None:
        print(msg)
    elif isinstance(logger, str):
        get_logger(logger).info(msg)
    else:
        logger.info(msg)


class ScalarWriter:
    """Append-only JSONL scalar stream, one line a record, written by rank 0
    only (``torch.distributed``'s rank when a group is initialised, else 0)."""

    def __init__(self, path: str | None, rank: int | None = None):
        if rank is None:
            rank = _rank()
        self.path = path if rank == 0 else None
        if self.path:
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            self._f = open(self.path, "a")
        else:
            self._f = None

    def add_scalar(self, tag: str, value: float, step: int):
        if self._f:
            self._f.write(json.dumps({"tag": tag, "value": float(value),
                                      "step": int(step), "ts": time.time()}) + "\n")
            self._f.flush()

    def close(self):
        if self._f:
            self._f.close()


class AverageMeter:
    """Multi-item running averages (reference utils/AverageMeter.py:2-42)."""

    def __init__(self, items: Sequence[str] | None = None):
        self.items = list(items) if items else None
        n = len(self.items) if self.items else 1
        self._val = [0.0] * n
        self._sum = [0.0] * n
        self._count = [0] * n

    def update(self, values):
        if not isinstance(values, (list, tuple)):
            values = [values]
        for i, v in enumerate(values):
            self._val[i] = float(v)
            self._sum[i] += float(v)
            self._count[i] += 1

    def val(self, idx: int | None = None):
        return self._val if idx is None else self._val[idx]

    def avg(self, idx: int | None = None):
        avgs = [s / max(c, 1) for s, c in zip(self._sum, self._count)]
        return avgs if idx is None else avgs[idx]


class DeferredMeters:
    """One-step-late readback of a train loop's metrics.

    Reading a device tensor on the host (``float``, ``.item()``) waits for
    everything queued on the stream, the step just launched included, so the
    host could not prepare the next batch while the device computes.
    ``push(m)`` instead starts a copy of this step's metrics into pinned host
    memory behind an event, then reads the previous step's, whose event has
    completed by then or soon will: one step stays in flight. ``flush()``
    reads the last. The averages are those of reading every step at once.
    """

    def __init__(self, meter: AverageMeter, keys: Sequence[str]):
        self.meter = meter
        self.keys = tuple(keys)
        self._pending = None

    def _drain(self):
        values, event = self._pending
        if event is not None:
            event.synchronize()
        self.meter.update([float(v) for v in values])

    def push(self, metrics) -> None:
        values = torch.stack([torch.as_tensor(metrics[k]).detach().reshape(())
                              for k in self.keys])
        event = None
        if values.is_cuda:
            host = torch.empty(values.shape, dtype=values.dtype, pin_memory=True)
            host.copy_(values, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
            values = host
        if self._pending is not None:
            self._drain()
        self._pending = (values, event)

    def flush(self) -> None:
        if self._pending is not None:
            self._drain()
            self._pending = None


class AccMetric:
    """Accuracy metric with better_than (reference runner_finetune.py:54-72)."""

    def __init__(self, acc: float = 0.0):
        self.acc = float(acc)

    def better_than(self, other: "AccMetric") -> bool:
        return self.acc > other.acc

    def state_dict(self):
        return {"acc": self.acc}
