#!/usr/bin/env python3
"""Time the Mamba-1 selective-scan kernels (K2 lean forward, K3 forward with
tile entry states, K4 backward) of the PyTorch port built from two source
trees, in one process on one card.

    python scripts/torch_scan_kernel_ab.py --other <dir with selective_scan_fwd.cu, selective_scan_bwd.cu>
    python scripts/torch_scan_kernel_ab.py --dtype bf16 --other <dir>

``--other`` is typically the ``si_mamba_tpu_torch/csrc`` of another commit
unpacked with ``git archive``. Both trees are built with the port's nvcc
flags into ``build/ab/`` (``torch_ab_common.build``).

fp32 (the default): a tree whose forward has no ``selective_scan_fwd_segments``
(the earlier one-pass forward) is called through its own C argument lists.
The kernels run on the scan's inputs as layer 0's mixer makes them
(``chip_smoke.scan_operands``: L=512, d_inner 768, d_state 16, fp32, strided
views): K2 at B = 1, 20 and 64 clouds (the serving request sizes) and 32, K3
and K4 at B=32 (the train batch). This tree's K2 is also timed with its
segmented scan turned off (one segment), beside its own choice.

bf16: this tree's Hopper body (``csrc/selective_scan_bf16_sm90.cu``) against
the other tree's bf16 scan (the bf16 entry points of ``selective_scan_fwd.cu``
/ ``selective_scan_bwd.cu``, h_entries every 16 steps, in trees before the
Hopper body; else its own Hopper body), each called through its own tree's
wrappers (``selective_scan_fwd_bf16``, ``..._residuals_bf16``,
``selective_scan_bwd_bf16`` of the ``ops/kernels/selective_scan.py`` beside
``--other``, loaded from that file), so that the eager times compare the two
trees' host cost a call as a model pays it, on perf mode's operands
(``chip_smoke.perf_operands``, bf16 views as the bf16 mixer makes them): K2 at
B = 1, 20, 32 and 64, K3 and K4 at B=32 and at the part-segmentation shape
(B=16, L=256). Each tree's outputs are held against the plain versions at
``chip_smoke.bf16_kernel_phase``'s tolerances first; the script also prints
each call's device time by kernel name at B=32 and ptxas' register and spill
report of both trees.

Either way the kernels run in turns this, other, other, this (ROUNDS times),
each as device time (20 calls captured in a CUDA graph and replayed) and as
eager time (20 back-to-back wrapper calls, host cost included). Before timing,
each tree's outputs are held against the plain versions at B=32. The script
prints one JSON line: each kernel's mean time per tree and timer, the ratios,
the segment counts, the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import torch

from torch_ab_common import ROOT, build, means, other_over_this, round_robin

ROUNDS = 5
BATCHES = (1, 20, 32, 64)
NAMES = ("selective_scan_fwd", "selective_scan_bwd")


def _one_pass_forward(lib: ctypes.CDLL):
    """The forward of a tree without segments (the earlier C interface):
    fn(args, residuals) -> (y, h_entries)."""
    from si_mamba_tpu_torch.ops.kernels import selective_scan as ks

    tail = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p]
    for fn, n_ptr in ((lib.selective_scan_fwd, 9), (lib.selective_scan_fwd_residuals, 10)):
        fn.argtypes, fn.restype = [ctypes.c_void_p] * n_ptr + tail, ctypes.c_int

    def forward(args, residuals):
        u, delta, A, B, C, D, z, db = args
        bsz, L, d = u.shape
        n = A.shape[1]
        y = torch.empty((bsz, L, d), dtype=torch.float32, device=u.device)
        h = torch.empty((bsz, -(-L // ks.CHUNK), n, d), dtype=torch.float32, device=u.device)
        ptrs = [t.data_ptr() for t in (u, delta, A, B, C, D, z, db, y)]
        stream = torch.cuda.current_stream(u.device).cuda_stream
        strides = ks._rows(u, delta, B, C, z)
        if residuals:
            err = lib.selective_scan_fwd_residuals(*ptrs, h.data_ptr(), bsz, L, d, n, strides,
                                                   stream)
        else:
            err = lib.selective_scan_fwd(*ptrs, bsz, L, d, n, strides, stream)
        if err:
            raise RuntimeError(f"the other tree's scan forward failed ({err})")
        return y, h
    return forward


def _tree(libs: dict[str, ctypes.CDLL]) -> dict:
    """Callables over one tree's libraries, through the port's wrappers where
    the C interface is this tree's."""
    from si_mamba_tpu_torch.ops.kernels import selective_scan as ks

    bwd_lib = ks.bwd_interface(libs["selective_scan_bwd"])
    fwd_lib = libs["selective_scan_fwd"]

    def bind():
        ks._bwd_library = lambda: bwd_lib
        if segmented:
            ks._fwd_library = lambda: fwd_lib

    segmented = hasattr(fwd_lib, "selective_scan_fwd_segments")
    if segmented:
        ks.fwd_interface(fwd_lib)
        forward = lambda args, residuals, segments=None: ks._launch_fwd(  # noqa: E731
            *args, residuals=residuals, segments=segments)
    else:
        forward = _one_pass_forward(fwd_lib)
    backward = lambda args, g, h: ks._launch_bwd(*args, g, h)  # noqa: E731
    return dict(bind=bind, forward=forward, backward=backward, segmented=segmented)


def _check(tree: dict, args, g) -> None:
    """The tree's K2, K3 and K4 against the plain versions at the tolerances
    of chip_smoke.py."""
    from si_mamba_tpu_torch.ops.kernels import selective_scan as ks

    tree["bind"]()
    y2, _ = tree["forward"](args, False)
    y3, h3 = tree["forward"](args, True)
    y_ref, h_ref = ks.selective_scan_fwd_residuals_ref(*args)
    got = tree["backward"](args, g, h3)
    want = ks.selective_scan_bwd_ref(*args, g, h3)
    torch.cuda.synchronize()
    if not torch.equal(y2, y3):
        raise AssertionError("K3's y differs from K2's")
    for name, a, b, tol in [("y", y3, y_ref, 1e-4), ("h_entries", h3, h_ref, 1e-4),
                            *((f"K4 {i}", x, w, 1e-3) for i, (x, w) in enumerate(zip(got, want)))]:
        err = (a - b).abs().max().item()
        if err > tol * b.abs().max().item():
            raise AssertionError(f"{name}: max |diff| {err}, max {b.abs().max().item()}")


BF16_SHAPES = {f"B={b}": (b, 512) for b in BATCHES} | {"seg B=16 L=256": (16, 256)}


def _wrappers_of(csrc: Path):
    """The ``ops/kernels/selective_scan.py`` beside the tree's ``csrc``,
    loaded as a module of its own (its imports of the port resolve to this
    tree's package)."""
    path = csrc.parent / "ops" / "kernels" / "selective_scan.py"
    spec = importlib.util.spec_from_file_location("other_selective_scan", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _bf16_tree(mod, bind) -> dict:
    """A tree's bf16 K2/K3/K4 through its own wrappers (module ``mod``, its
    libraries set by ``bind``): the public ``selective_scan_*_bf16`` calls a
    model makes, so the eager times carry each tree's host cost a call."""
    tile = mod.entry_tile(torch.bfloat16, 16) if hasattr(mod, "entry_tile") else mod.CHUNK
    return dict(bind=bind, tile=tile,
                forward=lambda args, residuals: (mod.selective_scan_fwd_residuals_bf16(*args)
                                                 if residuals else
                                                 (mod.selective_scan_fwd_bf16(*args), None)),
                backward=lambda args, g, h: mod.selective_scan_bwd_bf16(*args, g, h))


def _other_bf16(other: Path) -> tuple[dict, str]:
    """The bf16 K2/K3/K4 of another tree through that tree's wrappers, on the
    libraries built from its sources: the widened fp32 bodies of
    selective_scan_fwd.cu / selective_scan_bwd.cu, and its Hopper body where
    it has one. Returns the tree and its ptxas report."""
    mod = _wrappers_of(other)
    sm90 = getattr(mod, "SM90_SOURCE", None)
    libs, report = build(other, NAMES + ((sm90,) if sm90 else ()), "other_bf16")
    fwd_lib, bwd_lib = mod.fwd_interface(libs[NAMES[0]]), mod.bwd_interface(libs[NAMES[1]])
    mod._fwd_library, mod._bwd_library = (lambda: fwd_lib), (lambda: bwd_lib)
    if sm90:
        sm90_lib = mod.sm90_interface(libs[sm90])
        mod._sm90_library = lambda: sm90_lib
    return _bf16_tree(mod, lambda: None) | dict(mod=mod), report


def _sm90(libs: dict[str, ctypes.CDLL]) -> dict:
    """This tree's Hopper bf16 body through the port's wrappers."""
    from si_mamba_tpu_torch.ops.kernels import selective_scan as ks

    lib = ks.sm90_interface(libs[ks.SM90_SOURCE])

    def bind():
        ks._sm90_library = lambda: lib

    return _bf16_tree(ks, bind) | dict(lib=lib)


def _check_bf16_tree(tree: dict, args, g) -> None:
    """A tree's bf16 K2, K3 and K4 against the plain versions (with its own
    h_entries tile) at chip_smoke.bf16_kernel_phase's tolerances."""
    import chip_smoke as cs
    from si_mamba_tpu_torch.ops.kernels import selective_scan as ks

    tree["bind"]()
    y2, _ = tree["forward"](args, False)
    y3, h3 = tree["forward"](args, True)
    y_ref, h_ref = ks.selective_scan_fwd_residuals_ref(*args, tile=tree["tile"])
    got, again = tree["backward"](args, g, h3), tree["backward"](args, g, h3)
    want = ks.selective_scan_bwd_ref(*args, g, h3, tile=tree["tile"])
    torch.cuda.synchronize()
    if not torch.equal(y2, y3) or not all(torch.equal(a, c) for a, c in zip(got, again)):
        raise AssertionError("K3's y differs from K2's, or two K4 runs differ")
    cs._check_bf16("y", y3, y_ref)
    cs._check_bf16("h_entries", h3, h_ref)
    for k, a, r in zip(("du", "ddelta", "dA", "dB", "dC", "dD", "dz", "ddelta_bias"), got, want):
        cs._check_bf16(k, a, r, ulps=2, floor=2e-2, rel=1e-3)


def main_bf16(other: Path) -> int:
    import chip_smoke as cs
    from si_mamba_tpu_torch.ops.kernels import selective_scan as ks
    from torch_ab_common import by_kernel

    card = cs.card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    this_libs, this_report = build(ROOT / "si_mamba_tpu_torch" / "csrc", (ks.SM90_SOURCE,),
                                   "this_bf16")
    older, other_report = _other_bf16(other)
    trees = {"this": _sm90(this_libs), "other": older}
    device = torch.device("cuda", 0)
    ops = {name: cs.perf_operands(device, b, l)[3] for name, (b, l) in BF16_SHAPES.items()}
    grads = {name: torch.from_numpy(np.random.default_rng(3).standard_normal(
        ops[name][0].shape, dtype=np.float32)).to(device, torch.bfloat16)
        for name in ("B=32", "seg B=16 L=256")}
    for name in grads:
        for tree in trees.values():
            _check_bf16_tree(tree, ops[name], grads[name])
    h = {}
    for name, tree in trees.items():
        tree["bind"]()
        h[name] = {shape: tree["forward"](ops[shape], True)[1] for shape in grads}

    kernels = {f"K2 {name}": (lambda tree, a=ops[name]: trees[tree]["forward"](a, False))
               for name in ops if name.startswith("B=")}
    for name in grads:
        kernels[f"K3 {name}"] = lambda tree, a=ops[name]: trees[tree]["forward"](a, True)
        kernels[f"K4 {name}"] = lambda tree, a=ops[name], g=grads[name], n=name: trees[tree][
            "backward"](a, g, h[tree][n])
    times = round_robin({name: tree["bind"] for name, tree in trees.items()}, kernels,
                        {"device": cs.graph_ms, "eager": cs.time_ms}, ROUNDS)
    mean = means(times)
    split = {}
    for tree in ("this", "other"):
        trees[tree]["bind"]()
        split[tree] = {k: by_kernel(lambda k=k: kernels[k](tree))
                       for k in ("K2 B=32", "K3 B=32", "K4 B=32")}
    segments = {b: trees["this"]["lib"].scan_sm90_segments(b, 512, 768) for b in BATCHES}
    print(json.dumps({"card": card, "dtype": "bf16", "rounds": ROUNDS, "segments": segments,
                      "mean_ms": mean, "other_over_this": other_over_this(mean, kernels),
                      "by_kernel": split, "ptxas": {"this": this_report, "other": other_report},
                      "ms": times}), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, type=Path)
    ap.add_argument("--dtype", choices=("fp32", "bf16"), default="fp32")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_scan_kernel_ab: no CUDA device")
    if args.dtype == "bf16":
        return main_bf16(args.other)
    import chip_smoke as cs

    card = cs.card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    trees = {"this": _tree(build(ROOT / "si_mamba_tpu_torch" / "csrc", NAMES, "this")[0]),
             "other": _tree(build(args.other, NAMES, "other")[0])}
    if not trees["this"]["segmented"]:
        raise SystemExit("torch_scan_kernel_ab: this tree's forward has no segments")
    device = torch.device("cuda", 0)
    ops = {b: cs.scan_operands(device, b) for b in BATCHES}
    full = ops[32]
    g = torch.from_numpy(np.random.default_rng(3).standard_normal(full[0].shape,
                                                                   dtype=np.float32)).to(device)
    for tree in trees.values():
        _check(tree, full, g)
    trees["this"]["bind"]()
    h32 = trees["this"]["forward"](full, True)[1]

    kernels = {}
    for b in BATCHES:
        kernels[f"K2 B={b}"] = lambda tree, a=ops[b]: trees[tree]["forward"](a, False)
    kernels["K3 B=32"] = lambda tree: trees[tree]["forward"](full, True)
    kernels["K4 B=32"] = lambda tree: trees[tree]["backward"](full, g, h32)
    one_pass = {f"K2 B={b} one segment": (lambda a=ops[b]: trees["this"]["forward"](
        a, False, segments=1)) for b in BATCHES}
    # device: CUDA-graph replays, the kernels' own time; eager: back-to-back
    # wrapper calls, which at small batch the host's cost per call can exceed
    times = round_robin({name: tree["bind"] for name, tree in trees.items()}, kernels,
                        {"device": cs.graph_ms, "eager": cs.time_ms}, ROUNDS,
                        this_only=one_pass)
    mean = means(times)
    from si_mamba_tpu_torch.ops.kernels import selective_scan as ks

    trees["this"]["bind"]()
    segments = {b: ks._fwd_library().selective_scan_fwd_segments(b, 512, 768) for b in BATCHES}
    print(json.dumps({"card": card, "rounds": ROUNDS, "segments": segments, "mean_ms": mean,
                      "other_over_this": other_over_this(mean, kernels),
                      "ms": times}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
