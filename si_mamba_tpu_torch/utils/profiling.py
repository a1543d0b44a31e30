"""Profiling helpers, the counterparts of ``si_mamba_tpu/utils/profiling.py``:
a ``torch.profiler`` trace written as a Chrome trace, and the latency and
throughput harness with the JAX package's keys."""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: str | None):
    """Profile the block with ``torch.profiler`` (the CPU, and CUDA when a
    GPU is present) and write ``<log_dir>/trace_<time>_<pid>.json``, a
    Chrome trace (chrome://tracing, Perfetto), unless ``log_dir`` is None.
    Yields the profiler, whose ``key_averages()`` sums the events by name."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    if log_dir is not None:
        os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    if log_dir is not None:
        prof.export_chrome_trace(os.path.join(
            log_dir, f"trace_{time.strftime('%Y%m%d_%H%M%S')}_{os.getpid()}.json"))


def _fence(out) -> None:
    """Wait for the work behind ``out``: ``torch.cuda.synchronize()`` when it
    holds a CUDA tensor, nothing for CPU results."""
    stack = [out]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                torch.cuda.synchronize(x.device)
                return
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)


def time_fn(fn: Callable, *args, iters: int = 20, warmup: int = 2) -> dict:
    """Median / percentile wall-clock latency of ``fn(*args)``, each call
    fenced: {p50_ms, p90_ms, mean_ms, iters}."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    _fence(out)
    lat = []
    for _ in range(iters):
        t0 = time.perf_counter()
        _fence(fn(*args))
        lat.append(time.perf_counter() - t0)
    lat = np.asarray(lat)
    return {"p50_ms": float(np.median(lat) * 1e3), "p90_ms": float(np.percentile(lat, 90) * 1e3),
            "mean_ms": float(lat.mean() * 1e3), "iters": iters}


def throughput_fn(fn: Callable, *args, items_per_call: int, iters: int = 10) -> dict:
    """Steady-state items/s with the calls queued back to back and one fence
    at the end: {items_per_sec, step_ms}."""
    _fence(fn(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    _fence(out)
    dt = (time.perf_counter() - t0) / iters
    return {"items_per_sec": items_per_call / dt, "step_ms": dt * 1e3}
