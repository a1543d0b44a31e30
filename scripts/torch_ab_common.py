"""What the port's same-call kernel A/B scripts (``scripts/torch_*_ab.py``)
share: building the kernel sources of a tree with the port's nvcc flags, and
timing the kernels of two trees in turns this, other, other, this."""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path
from typing import Callable

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
ORDER = ("this", "other", "other", "this")


def build(src_dir: Path, names: tuple[str, ...], tag: str) -> tuple[dict[str, ctypes.CDLL], str]:
    """Build ``<src_dir>/<name>.cu`` for each name into ``build/ab/<tag>``,
    one nvcc each, all started together. Returns the loaded libraries and
    ptxas' register and spill lines."""
    from si_mamba_tpu_torch.ops.kernels.build import NVCC_FLAGS, _nvcc

    out_dir = ROOT / "build" / "ab" / tag
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {name: subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o",
                                     str(out_dir / f"{name}.so"), str(src_dir / f"{name}.cu")],
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for name in names}
    libs, report = {}, []
    for name, proc in procs.items():
        out = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src_dir / name}.cu:\n{out}")
        report += [f"{name}: {line.strip()}" for line in out.splitlines()
                   if "registers" in line or "spill" in line]
        libs[name] = ctypes.CDLL(str(out_dir / f"{name}.so"))
    return libs, "\n".join(report)


def round_robin(binds: dict[str, Callable[[], None]],
                kernels: dict[str, Callable[[str], object]],
                timers: dict[str, Callable[[Callable[[], object], int], float]],
                rounds: int, calls: Callable[[str], int] = lambda name: 20,
                this_only: dict[str, Callable[[], object]] | None = None) -> dict:
    """Time every kernel of both trees, ``rounds`` times in the turns of
    ORDER. ``binds[tree]()`` points the wrappers at a tree's libraries;
    ``kernels[name](tree)`` makes one call; each timer takes a callable and a
    call count and returns ms a call. ``this_only`` kernels run in this
    tree's turns alone. Returns times[timer][tree][kernel], a list of ms."""
    this_only = this_only or {}
    times = {how: {tree: {k: [] for k in kernels} for tree in binds} for how in timers}
    for how in timers:
        times[how]["this"].update({k: [] for k in this_only})
    for _ in range(rounds):
        for tree in ORDER:
            binds[tree]()
            for how, timer in timers.items():
                for name, fn in kernels.items():
                    times[how][tree][name].append(
                        timer(lambda fn=fn: fn(tree), calls(name)))
                if tree == "this":
                    for name, fn in this_only.items():
                        times[how][tree][name].append(timer(fn, calls(name)))
    return times


def means(times: dict) -> dict:
    """The mean of each list of round_robin's times."""
    return {how: {tree: {k: sum(v) / len(v) for k, v in by_kernel.items()}
                  for tree, by_kernel in by_tree.items()} for how, by_tree in times.items()}


def other_over_this(mean: dict, kernels) -> dict:
    """The other tree's mean time over this tree's, per timer and kernel."""
    return {how: {k: m["other"][k] / m["this"][k] for k in kernels} for how, m in mean.items()}
