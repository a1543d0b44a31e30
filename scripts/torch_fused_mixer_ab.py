#!/usr/bin/env python3
"""Time the fused Mamba-1 mixer kernels (K10 lean forward, K10 with chunk
entry states, K11 backward) of the PyTorch port built from two source trees,
in one process on one card.

    python scripts/torch_fused_mixer_ab.py --other <dir with fused_mixer_fwd.cu, fused_mixer_bwd.cu>

``--other`` is typically the ``si_mamba_tpu_torch/csrc`` of another commit
unpacked with ``git archive``. Both trees are built with the port's nvcc
flags into ``build/ab/`` (``torch_ab_common.build``). A tree whose kernels take
the folded W_dt = x_proj[:, :R] @ dt_proj (the earlier C interface, without
``fused_mixer_fwd_segments``) is called through its own argument lists and
given W_dt and W_bc folded once, outside the timing; this tree takes x_proj
and dt_proj. The kernels run on the interior's inputs as layer 0's mixer
makes them (``chip_smoke.mixer_inputs``: L=512, d_inner 768, d_state 16,
dt_rank 24, fp32): K10 lean at B = 1, 20 and 64 clouds (the serving request
sizes) and 32, K10 with states and K11 at B=32 (the train batch), in turns
this, other, other, this (ROUNDS times), each as device time (calls captured
in a CUDA graph and replayed) and as eager time (back-to-back wrapper calls,
host cost included). In this tree's turns it also times lean K10 forced to
one segment at each batch where the kernel would cut L, and K11 at
K11_BATCHES, beside the occupancy calculator's count of batch rows (clusters)
the card holds at once, to show K11's waves. Before timing, each tree's
outputs at B=32 are held against this tree's plain versions (rel-to-max
1e-4; the other tree's weight gradients through the chain rule of the fold).
The script prints one JSON line: each kernel's mean time per tree and timer,
the ratios, this tree's segment counts, K11's waves, ptxas' register report,
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

ROUNDS = 3
BATCHES = (1, 20, 32, 64)
K11_BATCHES = (8, 16, 22, 23, 32, 44)  # K11's waves: 22 rows a wave if one block an SM
NAMES = ("fused_mixer_fwd", "fused_mixer_bwd")


def _this_tree(libs: dict[str, ctypes.CDLL]) -> dict:
    """Callables over this tree's libraries, through the port's wrappers."""
    from si_mamba_tpu_torch.ops.kernels import fused_mixer as kfm

    fwd_lib = kfm.fwd_interface(libs["fused_mixer_fwd"])
    bwd_lib = kfm.bwd_interface(libs["fused_mixer_bwd"])

    def bind():
        kfm._fwd_library = lambda: fwd_lib
        kfm._bwd_library = lambda: bwd_lib

    return dict(bind=bind, inputs=lambda args: args,
                forward=lambda a, states: kfm._launch_fwd(a, states=states),
                backward=lambda a, h, g: kfm._launch_bwd(a, h, g))


def _folded_tree(libs: dict[str, ctypes.CDLL]) -> dict:
    """Callables over a tree whose kernels take W_dt and W_bc folded."""
    from si_mamba_tpu_torch.ops.kernels import fused_mixer as kfm

    fwd, bwd = libs["fused_mixer_fwd"].fused_mixer_fwd, libs["fused_mixer_bwd"].fused_mixer_bwd
    fwd.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    bwd.argtypes = [ctypes.POINTER(ctypes.c_void_p)] * 2 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fwd.restype = bwd.restype = ctypes.c_int

    def inputs(args):
        xz, conv_wt, conv_b, x_proj, dt_proj, dtb, at, d = args
        r = dt_proj.shape[0]
        wdt = x_proj[:, :r] @ dt_proj
        return (xz, conv_wt, conv_b, wdt, dtb, x_proj[:, r:].contiguous(), at, d,
                wdt.t().contiguous())

    def forward(a, states):
        xz, n = a[0], a[6].shape[0]
        b, l, di = xz.shape[0], xz.shape[1], xz.shape[2] // 2
        y = torch.empty((b, l, di), dtype=torch.float32, device=xz.device)
        h = torch.empty((b, -(-l // kfm.CHUNK), n, di), dtype=torch.float32, device=xz.device)
        err = fwd(*(t.data_ptr() for t in a[:8]), y.data_ptr(), h.data_ptr() if states else None,
                  b, l, di, n, kfm.CONV, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"the other tree's fused forward failed ({err})")
        return y, h

    def backward(a, h, g):
        xz, conv_wt, conv_b, wdt, dtb, wbc, at, d, wdt_t = a
        b, l, di, n = xz.shape[0], xz.shape[1], xz.shape[2] // 2, at.shape[0]
        f32 = dict(dtype=torch.float32, device=xz.device)
        dxz = torch.empty((b, l, 2 * di), **f32)
        parts = [torch.empty(s, **f32) for s in (
            (b, di, di), (b, di, 2 * n), (b, kfm.CONV, di), (b, di), (b, n, di), (b, di), (b, di))]
        ins = kfm._pointers((xz, g, conv_wt, conv_b, wdt, wdt_t, dtb, wbc, wbc.t().contiguous(),
                             at, d, h))
        err = bwd(ins, kfm._pointers((dxz, *parts)), b, l, di, n, kfm.CONV,
                  torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"the other tree's fused backward failed ({err})")
        dwdt, dwbc, dconv_wt, dconv_b, dat, dd, ddtb = (t.sum(dim=0) for t in parts)
        return dxz, dconv_wt, dconv_b, dwdt, ddtb, dwbc, dat, dd

    return dict(bind=lambda: None, inputs=inputs, forward=forward, backward=backward,
                folded=True)


def _check(tree: dict, args, g) -> None:
    """The tree's K10 (both variants) and K11 against this tree's plain
    versions, each output within 1e-4 of its max."""
    from si_mamba_tpu_torch.ops.kernels import fused_mixer as kfm

    tree["bind"]()
    a = tree["inputs"](args)
    y_lean, _ = tree["forward"](a, False)
    y, h = tree["forward"](a, True)
    got = list(tree["backward"](a, h, g))
    y_ref, h_ref = kfm.fused_mixer_fwd_ref(*args, chunk=kfm.CHUNK, emit_states=True)
    want = kfm.fused_mixer_bwd_ref(*args, h, g, chunk=kfm.CHUNK)
    if tree.get("folded"):  # d W_dt and d W_bc on to d x_proj and d dt_proj
        dwdt, dwbc = got[3], got[5]
        r = args[4].shape[0]
        got[3:6] = [torch.cat([dwdt @ args[4].t(), dwbc], dim=1), args[3][:, :r].t() @ dwdt,
                    got[4]]
    torch.cuda.synchronize()
    if not torch.equal(y, y_lean):
        raise AssertionError("K10 with states differs from the lean K10")
    for name, x, w in [("y", y, y_ref), ("h_entries", h, h_ref),
                       *((f"K11 output {i}", x, w) for i, (x, w) in enumerate(zip(got, want)))]:
        err = (x - w).abs().max().item()
        if err > 1e-4 * w.abs().max().item():
            raise AssertionError(f"{name}: max |diff| {err}, max {w.abs().max().item()}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, type=Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_fused_mixer_ab: no CUDA device")
    import chip_smoke as cs
    from si_mamba_tpu_torch.ops.kernels import fused_mixer as kfm

    card = cs.card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    this_libs, ptxas = build(ROOT / "si_mamba_tpu_torch" / "csrc", NAMES, "this")
    other_libs, _ = build(args.other, NAMES, "other")
    trees = {"this": _this_tree(this_libs),
             "other": (_folded_tree(other_libs)
                       if not hasattr(other_libs["fused_mixer_fwd"], "fused_mixer_fwd_segments")
                       else _this_tree(other_libs))}
    device = torch.device("cuda", 0)
    d_inner = 768

    def make_inputs(b):
        mixer, p, xz = cs.mixer_inputs(device, b)
        return kfm.kernel_inputs(
            xz, p["conv_w"], p["conv_b"], p["x_proj_w"], p["dt_proj_w"], p["dt_proj_b"],
            -torch.exp(p["A_log"]), p["D"], dt_rank=mixer.dt_rank, d_state=mixer.d_state)

    inputs = {b: make_inputs(b) for b in sorted({*BATCHES, *K11_BATCHES})}
    full = inputs[32]
    g = {b: torch.from_numpy(np.random.default_rng(3).standard_normal(
        (b, 512, d_inner), dtype=np.float32)).to(device) for b in K11_BATCHES}
    for tree in trees.values():
        _check(tree, full, g[32])
    per_tree = {name: {b: tree["inputs"](inputs[b]) for b in BATCHES}
                for name, tree in trees.items()}
    h32 = {}
    for name, tree in trees.items():
        tree["bind"]()
        h32[name] = tree["forward"](per_tree[name][32], True)[1]

    kernels = {f"K10 B={b}": (lambda tree, b=b: trees[tree]["forward"](per_tree[tree][b], False))
               for b in BATCHES}
    kernels["K10 states B=32"] = lambda tree: trees[tree]["forward"](per_tree[tree][32], True)
    kernels["K11 B=32"] = lambda tree: trees[tree]["backward"](per_tree[tree][32], h32[tree],
                                                              g[32])
    # this tree alone: lean K10 with its segmented scan turned off where it
    # would cut L, and K11 across batch sizes to show its waves
    trees["this"]["bind"]()
    segments = {b: kfm._fwd_library().fused_mixer_fwd_segments(b, 512, d_inner)
                for b in BATCHES}
    this_only = {f"K10 B={b} one segment": (lambda b=b: kfm._launch_fwd(
        inputs[b], states=False, segments=1)) for b in BATCHES if segments[b] > 1}
    h_at = {b: kfm._launch_fwd(inputs[b], states=True)[1] for b in K11_BATCHES}
    this_only |= {f"K11 B={b} sweep": (lambda b=b: kfm._launch_bwd(inputs[b], h_at[b], g[b]))
                  for b in K11_BATCHES}
    # device: CUDA-graph replays, the kernels' own time; eager: back-to-back
    # wrapper calls, which at small batch the host's cost per call can exceed
    times = round_robin({name: tree["bind"] for name, tree in trees.items()}, kernels,
                        {"device": cs.graph_ms, "eager": cs.time_ms}, ROUNDS,
                        calls=lambda name: 5 if name.startswith("K11") else 20,
                        this_only=this_only)
    mean = means(times)
    trees["this"]["bind"]()
    clusters = kfm._bwd_library().fused_mixer_bwd_max_active_clusters(d_inner)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    k11_waves = {"sms": sms, "blocks_a_row": d_inner // 128, "max_active_clusters": clusters,
                 "waves": {b: -(-b // clusters) if clusters > 0 else None for b in K11_BATCHES}}
    print(json.dumps({"card": card, "rounds": ROUNDS, "segments": segments, "mean_ms": mean,
                      "other_over_this": other_over_this(mean, kernels), "k11_waves": k11_waves,
                      "ptxas": ptxas, "ms": times}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
