#!/usr/bin/env python3
"""Time the Mamba-1 selective-scan kernels (K2 lean forward, K3 forward with
tile entry states, K4 backward) of the PyTorch port built from two source
trees, in one process on one card.

    python scripts/torch_scan_kernel_ab.py --other <dir with selective_scan_fwd.cu, selective_scan_bwd.cu>

``--other`` is typically the ``si_mamba_tpu_torch/csrc`` of another commit
unpacked with ``git archive``. Both trees are built with the port's nvcc
flags into ``build/ab/`` (``torch_ab_common.build``). A tree whose forward has no
``selective_scan_fwd_segments`` (the earlier one-pass forward) is called through
its own C argument lists. The kernels run on the scan's inputs as layer 0's
mixer makes them (``chip_smoke.scan_operands``: L=512, d_inner 768, d_state
16, fp32, strided views): K2 at B = 1, 20 and 64 clouds (the serving request
sizes) and 32, K3 and K4 at B=32 (the train batch), in turns this, other,
other, this (ROUNDS times), each as device time (20 calls captured in a CUDA
graph and replayed) and as eager time (20 back-to-back wrapper calls, host
cost included). This tree's K2 is also timed with its segmented scan turned
off (one segment), beside its own choice. Before timing, each tree's outputs
are held against the plain versions at B=32. The script prints one JSON line:
each kernel's mean time per tree and timer, the ratios, the segment counts,
the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, type=Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_scan_kernel_ab: no CUDA device")
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
