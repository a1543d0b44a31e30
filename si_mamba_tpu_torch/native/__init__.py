"""ctypes bindings of the host point-cloud ops (``pointops.cpp``), the
counterparts of ``si_mamba_tpu/native``: batched farthest point sampling and
brute-force kNN on the host, for preprocessing and checks.

The library is built with ``g++`` on first use into the repository's
``build/`` directory (``build/pointops-<hash>.so``, the hash covering the
source and the flags, as ``ops/kernels/build.py`` builds the CUDA sources),
never next to the source. A failed build raises; nothing falls back to numpy
on its own. The numpy loops are the plain versions, chosen with
``plain=True``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

from si_mamba_tpu_torch.ops.kernels.build import BUILD_DIR

SOURCE = Path(__file__).resolve().parent / "pointops.cpp"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-ffp-contract=off")
_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"pointops-{digest}.so"


def build() -> Path:
    """Compile ``pointops.cpp`` unless it is built; raise if g++ fails."""
    out = library_path()
    if out.exists():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the host point ops need a C++ compiler")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([gxx, *GXX_FLAGS, "-o", str(tmp), str(SOURCE), "-lpthread"],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for {SOURCE}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a reader never sees half a library
    return out


def _load() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            lib.fps_batch_f32.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                ctypes.c_int64, ctypes.c_int64, ctypes.POINTER(ctypes.c_int64)]
            lib.knn_batch_f32.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_int64)]
            lib.fps_batch_f32.restype = lib.knn_batch_f32.restype = None
            _LIB = lib
        return _LIB


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _iptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def fps_cpu(points: np.ndarray, n_samples: int, start: int = 0, plain: bool = False) -> np.ndarray:
    """Batched FPS on the host. points: (B, N, D) or (N, D) float32 ->
    indices (B, n_samples) or (n_samples,) int64, from ``start``, ties to the
    first index. ``plain=True`` runs the numpy loop."""
    single = points.ndim == 2
    pts = np.ascontiguousarray(points[None] if single else points, np.float32)
    B, N, D = pts.shape
    out = np.empty((B, n_samples), np.int64)
    if not plain:
        _load().fps_batch_f32(_fptr(pts), B, N, D, n_samples, start, _iptr(out))
    else:
        for b in range(B):
            min_d = np.full(N, np.inf)
            far = start
            for i in range(n_samples):
                out[b, i] = far
                d = np.sum((pts[b] - pts[b, far]) ** 2, axis=-1)
                min_d = np.minimum(min_d, d)
                far = int(np.argmax(min_d))
    return out[0] if single else out


def knn_cpu(query: np.ndarray, points: np.ndarray, k: int, plain: bool = False) -> np.ndarray:
    """Batched brute-force kNN on the host. query (B, Q, D), points (B, N, D)
    (or both without the batch axis) -> int64 (B, Q, k), nearest first.
    ``plain=True`` runs the numpy version."""
    single = query.ndim == 2
    q = np.ascontiguousarray(query[None] if single else query, np.float32)
    p = np.ascontiguousarray(points[None] if single else points, np.float32)
    B, Q, D = q.shape
    N = p.shape[1]
    out = np.empty((B, Q, k), np.int64)
    if not plain:
        _load().knn_batch_f32(_fptr(q), _fptr(p), B, Q, N, D, k, _iptr(out))
    else:
        for b in range(B):
            d = ((q[b][:, None, :] - p[b][None, :, :]) ** 2).sum(-1)
            out[b] = np.argsort(d, axis=-1)[:, :k]
    return out[0] if single else out


def native_available() -> bool:
    """Whether the library builds and loads here."""
    try:
        _load()
    except (OSError, RuntimeError):
        return False
    return True
