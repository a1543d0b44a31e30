#!/usr/bin/env python3
"""Time the causal-conv kernels (K5 backward, K1 forward beside it) of the
PyTorch port built from two source trees, in one process on one card.

    python scripts/torch_conv_kernel_ab.py --other <dir with causal_conv.cu> [--out FILE]

``--other`` is typically the ``si_mamba_tpu_torch/csrc`` of another commit
unpacked with ``git archive``. Both trees are built with the port's nvcc
flags into ``build/ab/`` (``torch_ab_common.build``). A tree whose backward
writes per-(batch, time tile) partials (``causal_conv1d_time_tile``, the
earlier C interface) is called through its own C argument list and its dw and
db finished by ``torch.sum``, as its wrapper did.

The kernels run at B=32, L=512, fp32, W=4 on the four shapes the train steps
give them (SHAPES): the Mamba-1 conv input (width 768, a column view of xz,
row stride 1536), the SSD one (width 1024, a column view of the 1798-wide
in_proj output), and the tensor-parallel SSD shard's x (384) and B|C (256)
convs, contiguous; and on a fifth that no path gives them, the Mamba-1 width
at an odd row stride (1537), which takes K5's scalar (1, 1) variant. g is a
seeded contiguous output gradient. Before timing,
each tree's K1 and K5 are held against the plain versions (K5 within 1e-4 of
each output's max) and this tree's K5 is run twice, bitwise equal. Then both
trees' kernels are timed in turns this, other, other, this (ROUNDS times),
each as device time (20 calls captured in a CUDA graph and replayed) and as
eager time (20 back-to-back wrapper calls), and this tree's K5 also at each
time tile the plan picks from, forced through the C entry point. The script prints one JSON line: the mean times per tree,
timer and kernel, the ratios, this tree's plan and K5's bound (``bound_ms``,
as chip_smoke.py counts it) at each shape, each K5 call's peak allocation
(``peak_mb``), K5's device time by kernel name, ptxas' registers and spills
for both trees, and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
from dataclasses import asdict, replace
from pathlib import Path

import numpy as np
import torch

from torch_ab_common import ROOT, build, by_kernel, means, other_over_this, peak_mb, round_robin

ROUNDS = 5
B, L, W = 32, 512, 4
# name: (width D, row width of the buffer x is a column view of, column offset)
SHAPES = {"mamba1": (768, 1536, 0), "ssd": (1024, 1798, 768), "tp_x": (384, 384, 0),
          "tp_bc": (256, 256, 0), "odd_stride": (768, 1537, 0)}


def _operands(device, shape: str, seed: int) -> tuple:
    D, width, off = SHAPES[shape]
    rng = np.random.default_rng(seed)
    buf = torch.from_numpy(rng.standard_normal((B, L, width), dtype=np.float32)).to(device)
    w = torch.from_numpy((rng.standard_normal((D, W)) * 0.5).astype(np.float32)).to(device)
    b = torch.from_numpy((rng.standard_normal(D) * 0.1).astype(np.float32)).to(device)
    g = torch.from_numpy(rng.standard_normal((B, L, D), dtype=np.float32)).to(device)
    return buf[..., off:off + D], w, b, g


def _tile_backward(lib: ctypes.CDLL):
    """The backward of a tree with per-(batch, time tile) partials (the
    earlier C interface), finished by torch.sum as its wrapper did."""
    lib.causal_conv1d_silu_bwd.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + \
        [ctypes.c_longlong] * 4 + [ctypes.c_void_p]
    lib.causal_conv1d_silu_bwd.restype = ctypes.c_int
    lib.causal_conv1d_time_tile.restype = ctypes.c_int
    tile = lib.causal_conv1d_time_tile()

    def backward(x, w, b, g):
        Bx, Lx, D = x.shape
        f32 = dict(dtype=torch.float32, device=x.device)
        dx = torch.empty((Bx, Lx, D), **f32)
        dw_part = torch.empty((Bx, -(-Lx // tile), W, D), **f32)
        db_part = torch.empty((Bx, -(-Lx // tile), D), **f32)
        err = lib.causal_conv1d_silu_bwd(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), g.data_ptr(), dx.data_ptr(),
            dw_part.data_ptr(), db_part.data_ptr(), Bx, Lx, D, W, x.stride(0), x.stride(1),
            g.stride(0), g.stride(1), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"the other tree's conv backward failed ({err})")
        return dx, dw_part.sum(dim=(0, 1)).t(), db_part.sum(dim=(0, 1))
    return backward


def _tree(lib: ctypes.CDLL, ptxas: str) -> dict:
    """Callables over one tree's library: K1 through the port's wrapper (its
    C interface is the same in every tree), K5 through the wrapper where the
    C interface is this tree's."""
    from si_mamba_tpu_torch.ops.kernels import causal_conv as kc

    tiled = hasattr(lib, "causal_conv1d_time_tile")
    kc.interface(lib)

    def bind():
        kc._library = lambda: lib

    backward = _tile_backward(lib) if tiled else kc._launch_bwd
    return dict(bind=bind, forward=kc._launch_fwd, backward=backward, tiled=tiled,
                ptxas=ptxas)


def _check(tree: dict, args, where: str) -> None:
    """The tree's K1 and K5 against the plain versions at the tolerances of
    chip_smoke.py."""
    from si_mamba_tpu_torch.ops.kernels import causal_conv as kc

    tree["bind"]()
    x, w, b, g = args
    y, y_ref = tree["forward"](x, w, b), kc.causal_conv1d_ref(x, w, b)
    got, want = tree["backward"](*args), kc.causal_conv1d_silu_bwd_ref(*args)
    torch.cuda.synchronize()
    if not torch.allclose(y, y_ref, rtol=1e-5, atol=1e-6):
        raise AssertionError(f"K1 at {where}: max |diff| {(y - y_ref).abs().max().item()}")
    for name, a, r in zip(("dx", "dw", "db"), got, want):
        err = (a - r).abs().max().item()
        if err > 1e-4 * r.abs().max().item():
            raise AssertionError(f"K5 at {where}: {name} max |diff| {err}, "
                                 f"max {r.abs().max().item()}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, type=Path)
    ap.add_argument("--out", type=Path, help="also write the JSON line to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_conv_kernel_ab: no CUDA device")
    import chip_smoke as cs
    from si_mamba_tpu_torch.ops.kernels import causal_conv as kc

    card = cs.card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    trees = {}
    for name, src in (("this", ROOT / "si_mamba_tpu_torch" / "csrc"), ("other", args.other)):
        libs, report = build(src, ("causal_conv",), name)
        trees[name] = _tree(libs["causal_conv"], report)
    if trees["this"]["tiled"]:
        raise SystemExit("torch_conv_kernel_ab: this tree's backward has the earlier interface")
    device = torch.device("cuda", 0)
    ops = {shape: _operands(device, shape, seed) for seed, shape in enumerate(SHAPES)}
    for tree_name, tree in trees.items():
        for shape, a in ops.items():
            _check(tree, a, f"{shape} ({tree_name})")
    trees["this"]["bind"]()
    for shape, a in ops.items():
        first, again = kc._launch_bwd(*a), kc._launch_bwd(*a)
        torch.cuda.synchronize()
        if not all(torch.equal(p, q) for p, q in zip(first, again)):
            raise AssertionError(f"two K5 runs at {shape} differ")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    plans = {shape: asdict(kc.bwd_plan(a[0], a[3], W, sms)) for shape, a in ops.items()}
    bounds = {shape: cs.conv_bwd_bound(B, L, D, W)[0] for shape, (D, _, _) in SHAPES.items()}

    kernels = {}
    for shape, a in ops.items():
        kernels[f"K5 {shape}"] = lambda tree, a=a: trees[tree]["backward"](*a)
        kernels[f"K1 {shape}"] = lambda tree, a=a: trees[tree]["forward"](*a[:3])
    forced = {}
    for shape, a in ops.items():
        x, D = a[0], SHAPES[shape][0]
        for t in kc.BWD_TILES:
            plan = replace(kc.bwd_plan(x, a[3], W, sms), tile=t,
                           partial_shape=kc.bwd_partials(B, L, D, W, t))
            forced[f"K5 {shape} tile {t}"] = lambda a=a, plan=plan: kc._run_bwd(*a, plan)
    # device: CUDA-graph replays, the kernels' own time; eager: back-to-back
    # wrapper calls, the host's cost of a call included
    times = round_robin({name: tree["bind"] for name, tree in trees.items()}, kernels,
                        {"device": cs.graph_ms, "eager": cs.time_ms}, ROUNDS,
                        this_only=forced)
    mean = means(times)
    peaks, kernel_ms = {}, {}
    for tree_name, tree in trees.items():
        tree["bind"]()
        peaks[tree_name] = {shape: peak_mb(lambda a=a: tree["backward"](*a))
                            for shape, a in ops.items()}
        kernel_ms[tree_name] = {shape: by_kernel(lambda a=a: tree["backward"](*a))
                                for shape, a in ops.items()}
    line = json.dumps({"card": card, "rounds": ROUNDS, "plans": plans, "bound_ms": bounds,
                       "mean_ms": mean,
                       "other_over_this": other_over_this(mean, kernels), "peak_mb": peaks,
                       "by_kernel": kernel_ms,
                       "ptxas": {t: trees[t]["ptxas"] for t in trees}, "ms": times})
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
