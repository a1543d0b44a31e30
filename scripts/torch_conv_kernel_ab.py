#!/usr/bin/env python3
"""Time the causal-conv kernels (K1 forward at fp32 and bf16, K5 backward) of
the PyTorch port built from two source trees, in one process on one card.

    python scripts/torch_conv_kernel_ab.py --other <dir with causal_conv.cu> [--out FILE]

``--other`` is typically the ``si_mamba_tpu_torch/csrc`` of another commit
unpacked with ``git archive``. Both trees are built with the port's nvcc
flags into ``build/ab/`` (``torch_ab_common.build``). A tree whose forward
takes no launch plan (up to PR 14: ``causal_conv1d_silu_fwd_bf16_kernel``
in its source) is called through its own C argument lists, with the vector
width its wrapper chose; a tree whose backward writes per-(batch, time tile)
partials (``causal_conv1d_time_tile``, up to PR 9) through its own C argument
list, its dw and db finished by ``torch.sum``, as its wrapper did.

The kernels run at B=32, L=512, W=4 on the shapes the paths give them
(SHAPES): the Mamba-1 conv input (width 768, a column view of xz, row stride
1536), the SSD one (width 1024, a column view of the 1798-wide in_proj output
from column 768), the tensor-parallel SSD shard's x (384) and B|C (256)
convs, contiguous, and the tensor-parallel Mamba-1 rank's xi (384, a column
view of its 768-wide xz); and on one that no path gives them, the Mamba-1
width at an odd row stride (1537), which takes K5's scalar (1, 1) variant.
K1 runs at fp32 and bf16 at each of them, and at the serving sizes (CLOUDS)
at the two mixer views; K5 at fp32. g is a seeded contiguous output
gradient. Before timing, each tree's K1 and K5 are held against the plain
versions (K1 fp32 within rtol 1e-5 / atol 1e-6, bf16 within one bf16 ulp at
a floor of 1e-2 of max|y|; K5 within 1e-4 of each output's max) and this
tree's K5 is run twice, bitwise equal. Then both trees' kernels are timed in
turns this, other, other, this (ROUNDS times), each as device time (20 calls
captured in a CUDA graph and replayed) and as eager time (20 back-to-back
wrapper calls); this tree's K1 also at each vector width (up to its plan's)
and time tile, with the plan's block for that tile, and its K5 at each time
tile, forced through the C entry points. The script prints one JSON line: the
mean times per tree, timer and kernel, the ratios, this tree's plans and
bounds (``bound_ms``, as
chip_smoke.py counts them), each K5 call's peak allocation (``peak_mb``),
K5's device time by kernel name, ptxas' registers and spills for both trees,
and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import itertools
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
          "tp_bc": (256, 256, 0), "tp_mamba1": (384, 768, 0), "odd_stride": (768, 1537, 0)}
CLOUDS = (1, 20, 64)  # the serving request sizes, at the two mixer views
DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}


def _operands(device, shape: str, seed: int, batch: int = B,
              dtype: torch.dtype = torch.float32) -> tuple:
    """(x, w, b, g): x a column view of a seeded buffer in ``dtype``, the
    weight and bias fp32, g contiguous in ``dtype``."""
    D, width, off = SHAPES[shape]
    rng = np.random.default_rng(seed)
    buf = torch.from_numpy(rng.standard_normal((batch, L, width), dtype=np.float32))
    w = torch.from_numpy((rng.standard_normal((D, W)) * 0.5).astype(np.float32)).to(device)
    b = torch.from_numpy((rng.standard_normal(D) * 0.1).astype(np.float32)).to(device)
    g = torch.from_numpy(rng.standard_normal((batch, L, D), dtype=np.float32))
    return buf.to(device, dtype)[..., off:off + D], w, b, g.to(device, dtype)


def _earlier_forward(lib: ctypes.CDLL):
    """The forward of a tree whose C entry points take no plan (up to PR 14),
    called as its wrapper called it (the port's input checks, contiguous
    weight and bias, the device guard): (x, w, bias, y, B, L, D, W, x_sb,
    x_sr, stream) at fp32, and at bf16 the vector width that wrapper chose (8
    channels where D and x's alignment allow, else 1) before the stream."""
    from si_mamba_tpu_torch.ops.kernels import causal_conv as kc

    head = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 2
    lib.causal_conv1d_silu_fwd.argtypes = head + [ctypes.c_void_p]
    lib.causal_conv1d_silu_fwd_bf16.argtypes = head + [ctypes.c_int, ctypes.c_void_p]

    def forward(x, w, b):
        kc._check_inputs(x, w, b)
        Bx, Lx, D = x.shape
        w, b = w.contiguous(), b.contiguous()
        y = torch.empty((Bx, Lx, D), dtype=x.dtype, device=x.device)
        args = (x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), Bx, Lx, D, W,
                x.stride(0), x.stride(1))
        stream = torch.cuda.current_stream(x.device).cuda_stream
        with torch.cuda.device(x.device):
            if x.dtype == torch.bfloat16:
                vec = 8 if D % 8 == 0 and kc.vector_width(
                    x.data_ptr(), Bx, Lx, x.stride(0), x.stride(1), 2, (8,)) == 8 else 1
                err = lib.causal_conv1d_silu_fwd_bf16(*args, vec, stream)
            else:
                err = lib.causal_conv1d_silu_fwd(*args, stream)
        if err:
            raise RuntimeError(f"the other tree's conv forward failed ({err})")
        return y
    return forward


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


def _tree(lib: ctypes.CDLL, ptxas: str, src: Path) -> dict:
    """Callables over one tree's library: K1 and K5 through the port's
    wrappers where the C interface is this tree's, else through the tree's
    own argument lists."""
    from si_mamba_tpu_torch.ops.kernels import causal_conv as kc

    tiled = hasattr(lib, "causal_conv1d_time_tile")
    planless = "causal_conv1d_silu_fwd_bf16_kernel" in (src / "causal_conv.cu").read_text()
    kc.interface(lib)

    def bind():
        kc._library = lambda: lib

    return dict(bind=bind, forward=_earlier_forward(lib) if planless else kc._launch_fwd,
                backward=_tile_backward(lib) if tiled else kc._launch_bwd, tiled=tiled,
                planless=planless, ptxas=ptxas)


def _check_forward(tree: dict, x, w, b, where: str) -> None:
    """The tree's K1 against the plain version at chip_smoke.py's limits."""
    import chip_smoke as cs
    from si_mamba_tpu_torch.ops.kernels import causal_conv as kc

    tree["bind"]()
    y, y_ref = tree["forward"](x, w, b), kc.causal_conv1d_ref(x, w, b)
    torch.cuda.synchronize()
    if x.dtype == torch.bfloat16:
        ulps = cs._bf16_ulps(y, y_ref, 1e-2)
        if ulps > 1:
            raise AssertionError(f"K1 at {where}: {ulps:.2f} bf16 ulps from the plain version")
    elif not torch.allclose(y, y_ref, rtol=1e-5, atol=1e-6):
        raise AssertionError(f"K1 at {where}: max |diff| {(y - y_ref).abs().max().item()}")


def _check_backward(tree: dict, args, where: str) -> None:
    """The tree's K5 against the plain version at chip_smoke.py's limit."""
    from si_mamba_tpu_torch.ops.kernels import causal_conv as kc

    tree["bind"]()
    got, want = tree["backward"](*args), kc.causal_conv1d_silu_bwd_ref(*args)
    torch.cuda.synchronize()
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
        trees[name] = _tree(libs["causal_conv"], report, src)
    if trees["this"]["tiled"] or trees["this"]["planless"]:
        raise SystemExit("torch_conv_kernel_ab: this tree has an earlier C interface")
    device = torch.device("cuda", 0)
    ops = {shape: _operands(device, shape, seed) for seed, shape in enumerate(SHAPES)}
    # K1's operands: name -> (x, w, b)
    fwd_ops = {}
    for (dname, dtype), (seed, shape) in itertools.product(DTYPES.items(), enumerate(SHAPES)):
        fwd_ops[f"K1 {shape} {dname}"] = _operands(device, shape, seed, dtype=dtype)[:3]
    for (dname, dtype), shape, batch in itertools.product(DTYPES.items(), ("mamba1", "ssd"),
                                                          CLOUDS):
        fwd_ops[f"K1 {shape} {dname} B={batch}"] = _operands(device, shape, 100 + batch,
                                                             batch, dtype)[:3]
    for tree_name, tree in trees.items():
        for shape, a in ops.items():
            _check_backward(tree, a, f"{shape} ({tree_name})")
        for name, a in fwd_ops.items():
            _check_forward(tree, *a, f"{name} ({tree_name})")
    trees["this"]["bind"]()
    for shape, a in ops.items():
        first, again = kc._launch_bwd(*a), kc._launch_bwd(*a)
        torch.cuda.synchronize()
        if not all(torch.equal(p, q) for p, q in zip(first, again)):
            raise AssertionError(f"two K5 runs at {shape} differ")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    plans = {shape: asdict(kc.bwd_plan(a[0], a[3], W, sms)) for shape, a in ops.items()}
    fwd_plans = {name: asdict(kc.fwd_plan(a[0], sms)) for name, a in fwd_ops.items()}
    bounds = {f"K5 {shape}": cs.conv_bwd_bound(B, L, D, W)[0]
              for shape, (D, _, _) in SHAPES.items()}
    bounds |= {name: cs.conv_fwd_bound(*a[0].shape, W, a[0].element_size())[0]
               for name, a in fwd_ops.items()}

    kernels = {}
    for shape, a in ops.items():
        kernels[f"K5 {shape}"] = lambda tree, a=a: trees[tree]["backward"](*a)
    for name, a in fwd_ops.items():
        kernels[name] = lambda tree, a=a: trees[tree]["forward"](*a)
    forced = {}
    for shape, a in ops.items():
        x, D = a[0], SHAPES[shape][0]
        for t in kc.BWD_TILES:
            plan = replace(kc.bwd_plan(x, a[3], W, sms), tile=t,
                           partial_shape=kc.bwd_partials(B, L, D, W, t))
            forced[f"K5 {shape} tile {t}"] = lambda a=a, plan=plan: kc._run_bwd(*a, plan)
    for name, (x, w, b) in fwd_ops.items():
        widest = kc.fwd_plan(x, sms).vec
        for vec, t in itertools.product(kc.fwd_vectors(x.element_size()), kc.FWD_TILES):
            if vec > widest:
                continue
            warps, grid = kc.fwd_block(x.shape[2] // vec * -(-x.shape[1] // t), x.shape[0], sms)
            plan = kc.FwdPlan(vec=vec, tile=t, warps=warps, grid=grid)
            forced[f"{name} vec {vec} tile {t}"] = (
                lambda x=x, w=w, b=b, plan=plan: kc._run_fwd(x, w, b, plan))
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
    line = json.dumps({"card": card, "rounds": ROUNDS, "plans": plans, "fwd_plans": fwd_plans,
                       "bound_ms": bounds, "mean_ms": mean,
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
