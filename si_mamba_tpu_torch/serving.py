"""Batch inference for the ``PointMamba`` classifier.

Usage::

    from si_mamba_tpu_torch.serving import Predictor
    p = Predictor.from_checkpoint("pointmamba.pth", model_cfg=dict(cls_dim=40))
    probs = p.predict_proba(clouds)      # (n, npoints, 3), any n
    labels = p.predict(clouds)

The predictor runs on ``device`` ("cuda" unless the caller says otherwise;
with no GPU it raises rather than running on the CPU). It is deterministic:
eval-mode forward, FPS from index 0, no random numbers. Requests are chunked
at ``max_batch``; PyTorch runs eagerly, so no shape buckets are needed.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Optional

import numpy as np
import torch

from si_mamba_tpu_torch.models.point_mamba import PointMamba, PointMambaConfig
from si_mamba_tpu_torch.ops.pointops import fps, gather_points
from si_mamba_tpu_torch.utils.device import resolve_device
from si_mamba_tpu_torch.utils.weights import ORBAX_NOT_READ, as_state_dict, load_state_dict_file


def _fps_to_npoints(points: torch.Tensor, npoints: int) -> torch.Tensor:
    """Deterministic eval resampling to ``npoints`` (FPS from index 0);
    identity when the cloud already has ``npoints``."""
    if points.shape[1] > npoints:
        return gather_points(points, fps(points, npoints))
    return points


class Predictor:
    """Chunked batch predictor for ``PointMamba``.

    ``input_points``: the accepted request N, an int or a sequence of ints
    (default ``(npoints,)``); a request with another N raises unless
    ``allow_recompile`` (a name kept from the JAX package's API, where each
    new N compiles a new program). N < npoints always raises: the serve path
    FPS-downsamples and cannot upsample."""

    def __init__(self, model: PointMamba, npoints: int = 1024, max_batch: int = 64,
                 input_points=None, allow_recompile: bool = False, device="cuda"):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.npoints = int(npoints)
        self.max_batch = int(max_batch)
        if input_points is None:
            input_points = self.npoints
        if isinstance(input_points, int):
            input_points = (input_points,)
        self.input_points = tuple(int(n) for n in input_points)
        bad = [n for n in self.input_points if n < self.npoints]
        if bad:
            raise ValueError(
                f"input_points {bad} < npoints={self.npoints}: the serve path "
                f"FPS-downsamples each request to npoints and cannot upsample")
        self.allow_recompile = allow_recompile

    @classmethod
    def from_checkpoint(cls, path, model_cfg: Optional[dict] = None, npoints: int = 1024,
                        max_batch: int = 64, perf: bool = False,
                        input_points: Optional[int] = None,
                        allow_recompile: bool = False, device="cuda") -> "Predictor":
        """``path``: a reference-format ``.pth`` (this package's ``ckpt-*.pth``
        among them) or a state dict (numpy arrays or tensors) in the
        reference's keys; anything else is taken for an orbax checkpoint and
        raises. ``model_cfg``: PointMambaConfig
        overrides. The weights load with ``strict=True``."""
        if perf:
            raise NotImplementedError(
                "perf=True (bf16 + subspace eigensolver) is ROADMAP.md queue 1, M20")
        if isinstance(path, Mapping):
            sd = as_state_dict(path)
        elif str(path).endswith(".pth"):
            sd = load_state_dict_file(str(path))
        else:
            raise NotImplementedError(f"{path!r}: {ORBAX_NOT_READ}")
        model = PointMamba(PointMambaConfig.from_dict(model_cfg or {}))
        model.load_state_dict(sd, strict=True)
        return cls(model, npoints=npoints, max_batch=max_batch, input_points=input_points,
                   allow_recompile=allow_recompile, device=device)

    @torch.inference_mode()
    def _forward(self, part: np.ndarray) -> np.ndarray:
        pts = torch.from_numpy(part).to(self.device)
        logits = self.model(_fps_to_npoints(pts, self.npoints))
        return logits.float().cpu().numpy()

    def logits(self, clouds: np.ndarray) -> np.ndarray:
        """clouds: (n, N, 3), any n, chunked at max_batch -> (n, cls_dim)."""
        clouds = np.ascontiguousarray(clouds, np.float32)
        n = clouds.shape[0]
        if n == 0:
            return np.zeros((0, self.model.config.cls_dim), np.float32)
        if clouds.shape[1] < self.npoints:
            raise ValueError(
                f"request has {clouds.shape[1]} points < npoints={self.npoints}: the "
                f"serve path cannot upsample — resample on the host")
        if clouds.shape[1] not in self.input_points and not self.allow_recompile:
            raise ValueError(
                f"request has {clouds.shape[1]} points but the predictor accepts "
                f"{self.input_points}; resample on the host or construct with "
                f"allow_recompile=True / input_points="
                f"{self.input_points + (clouds.shape[1],)}")
        return np.concatenate([self._forward(clouds[s:s + self.max_batch])
                               for s in range(0, n, self.max_batch)], axis=0)

    def predict_proba(self, clouds: np.ndarray) -> np.ndarray:
        logits = self.logits(clouds)
        e = np.exp(logits - logits.max(axis=-1, keepdims=True))
        return e / e.sum(axis=-1, keepdims=True)

    def predict(self, clouds: np.ndarray) -> np.ndarray:
        return self.logits(clouds).argmax(axis=-1)

    def warmup(self) -> None:
        """Run one full batch of every accepted N (builds the kernels and
        warms the allocator before serving)."""
        for n_pts in self.input_points:
            self.logits(np.zeros((self.max_batch, n_pts, 3), np.float32))


class MicroBatcher:
    """Deadline-driven request coalescing in front of a batch predictor.

    ``submit`` enqueues one cloud and returns a ``concurrent.futures.Future``;
    one dispatcher thread coalesces requests into a batch and fires when
    either ``max_batch`` are waiting or the oldest has waited
    ``max_delay_ms``. ``fn`` is any ``(b, N, 3) ndarray -> (b, ...)`` batch
    function (e.g. ``Predictor.predict_proba``). Requests with different N
    are never mixed into one batch: an N change flushes the current batch.
    Thread-safe; use as a context manager or call ``stop()``.
    """

    _STOP = object()

    def __init__(self, fn, *, max_batch: int = 64, max_delay_ms: float = 5.0):
        import queue as _queue
        import threading

        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self._fn = fn
        self._max_batch = int(max_batch)
        self._delay = float(max_delay_ms) / 1e3
        self._q: "_queue.Queue" = _queue.Queue()
        self.n_requests = 0
        self.n_batches = 0
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._stopped = False
        self._thread.start()

    def submit(self, cloud: np.ndarray):
        """Enqueue one (N, 3) cloud; returns a Future of ``fn``'s row for it."""
        from concurrent.futures import Future

        cloud = np.asarray(cloud, np.float32)
        if cloud.ndim != 2 or cloud.shape[-1] != 3:
            raise ValueError(f"expected one (N, 3) cloud, got {cloud.shape}")
        if self._stopped:
            raise RuntimeError("MicroBatcher is stopped")
        fut: Future = Future()
        self._q.put((cloud, fut))
        return fut

    def _fire(self, batch) -> None:
        self.n_batches += 1
        self.n_requests += len(batch)
        try:
            out = self._fn(np.stack([c for c, _ in batch]))
        except BaseException as e:  # propagate to every waiter in the batch
            for _, f in batch:
                if not f.cancelled():
                    f.set_exception(e)
            return
        for i, (_, f) in enumerate(batch):
            if not f.cancelled():
                f.set_result(np.asarray(out[i]))

    def _loop(self) -> None:
        import queue as _queue
        import time

        carry = None  # an item whose N didn't match the batch being built
        while True:
            item = carry if carry is not None else self._q.get()
            carry = None
            if item is self._STOP:
                break
            batch = [item]
            n_pts = item[0].shape[0]
            deadline = time.monotonic() + self._delay
            while len(batch) < self._max_batch:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=left)
                except _queue.Empty:
                    break
                if nxt is self._STOP or nxt[0].shape[0] != n_pts:
                    carry = nxt  # flush now; handle the stop/new-N item next
                    break
                batch.append(nxt)
            self._fire(batch)
            if carry is self._STOP:
                break
        self._drain()

    def _drain(self) -> None:
        """Fail anything still queued after stop (no silent hangs)."""
        import queue as _queue

        while True:
            try:
                item = self._q.get_nowait()
            except _queue.Empty:
                break
            if item is not self._STOP and not item[1].cancelled():
                item[1].set_exception(RuntimeError("MicroBatcher stopped"))

    @property
    def mean_batch_size(self) -> float:
        return self.n_requests / max(self.n_batches, 1)

    def stop(self) -> None:
        """Drain in-flight work, then stop the dispatcher (idempotent)."""
        if not self._stopped:
            self._stopped = True
            self._q.put(self._STOP)
        self._thread.join()
        self._drain()  # catch submits that raced the stop flag

    def __enter__(self) -> "MicroBatcher":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
