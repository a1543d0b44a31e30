"""Build the CUDA sources under ``csrc/`` with ``nvcc`` and load them with ctypes.

Each source compiles on its own into a shared library with a plain C
interface, ``build/<name>-<hash>.so`` beside the package, where the hash
covers the source, the headers under ``csrc/`` and the flags, so an edited
source is never served by a stale library. :func:`build` starts one ``nvcc`` per missing library, all at
once, and waits for them; :func:`load_library` builds on first use. Nothing
here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
SOURCES = ("causal_conv", "selective_scan_fwd", "selective_scan_bwd", "ssd_xbc_fwd",
           "ssd_xbc_bwd", "fused_mixer_fwd", "fused_mixer_bwd", "mamba_any", "ssd_xbc_bf16_sm90",
           "selective_scan_bf16_sm90")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names=SOURCES) -> dict[str, str]:
    """Compile every library in ``names`` that is not built yet, one ``nvcc``
    process per source, all started together. Returns ``{name: compiler
    output}`` (with ptxas' register and spill report) for the sources compiled
    now; raises if any compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode == 0:
            os.replace(tmp, out)  # atomic: a reader never sees half a library
        else:
            failed.append(name)
            tmp.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n" +
                           "\n".join(logs[n] for n in failed))
    return logs


def load_library(name: str) -> ctypes.CDLL:
    """The ctypes handle of ``csrc/<name>.cu``, built first if needed."""
    path = library_path(name)
    if not path.exists():
        build((name,))
    return ctypes.CDLL(str(path))


class LaunchCount:
    """The launch count of a kernel variant that has no wrapper function of
    its own to carry it: ``.launches``, as every wrapper carries its count."""

    def __init__(self) -> None:
        self.launches = 0

    def __repr__(self) -> str:
        return f"LaunchCount({self.launches})"
