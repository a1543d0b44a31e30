#!/usr/bin/env python3
"""Time the SSD kernels of the PyTorch port, the boundary-fused core (K8
lean, K8 with states, K9) and the split core (K6 lean, with states, with
h_fin; K7 from 0 and seeded), built from two source trees, in one process on
one card.

    python scripts/torch_ssd_kernel_ab.py --other <dir with ssd_xbc_fwd.cu, ssd_xbc_bwd.cu>

``--other`` is typically the ``si_mamba_tpu_torch/csrc`` of another commit
unpacked with ``git archive``. Both trees are built with the port's nvcc
flags into ``build/ab/`` (``torch_ab_common.build``). A tree with the
chunk-parallel K8/K9 (it has ``ssd_tc.cuh``) is called through this tree's
``run_fwd`` / ``run_bwd``; a tree without them (the earlier one-block-a-
(batch, head) kernels) through its own C argument lists, its per-head
dB | dC partials summed as its wrapper did. Likewise a tree whose K6/K7 take
scratch is called through ``run_split_fwd`` / ``run_split_bwd``, one whose
K7 writes per-head dB | dC partials (K6/K7 on the one-block body) through
its own argument lists. K8/K9 run on the SSD classifier's inputs as layer
0's mixer makes them (L=512, chunk 256, 6 heads of 128, d_state 128, the
conv output as in ``chip_smoke.py``): lean K8 at B = 1, 20, 32 and 64
clouds, K8 with states and K9 at B=32; K6/K7 at the tensor-parallel shard
(B=32, 3 heads, x and the B|C halves as ``ssd_mixer_tp`` makes them). In
turns this, other, other, this (ROUNDS times), each as device time (calls
captured in a CUDA graph and replayed) and as eager time (back-to-back
wrapper calls, the host's cost included). Before timing, each tree's outputs
are held against the plain versions at B=32 (every output within 1e-4 of
its max, as in ``chip_smoke.py``), and each tree's lean K8 calls and K6/K7
calls are measured for the memory they allocate at their peak (outputs and
scratch). The script prints one JSON line: each kernel's mean time per tree
and timer, the ratios, the times of every round, the peak allocations,
ptxas' register and spill lines, the card's name and power limit, and this
tree's device time by kernel name (``torch.profiler``) for lean K8 at one
cloud, K8 with states, K9, K6 with states and K7 at B=32.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

import numpy as np
import torch

from torch_ab_common import ROOT, build, by_kernel, means, other_over_this, peak_mb, round_robin

ROUNDS = 5
BATCHES = (1, 20, 32, 64)
NAMES = ("ssd_xbc_fwd", "ssd_xbc_bwd")


def _one_block_tree(libs: dict[str, ctypes.CDLL]) -> tuple:
    """(forward, backward) of a tree with the earlier C interface: grid
    (h, b), per-head dB | dC partials (b, h, l, 2n) and dD partials (b, h, nc)
    that the wrapper sums."""
    fwd, bwd = libs["ssd_xbc_fwd"], libs["ssd_xbc_bwd"]
    i, ll, p = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
    fwd.ssd_xbc_fwd.argtypes = [p] * 6 + [i] * 7 + [ll] * 2 + [p]
    bwd.ssd_xbc_bwd.argtypes = [p] * 11 + [i] * 7 + [ll] * 4 + [p]
    fwd.ssd_xbc_fwd.restype = bwd.ssd_xbc_bwd.restype = i

    def forward(xbc, dt, S, D, d, chunk, states):
        b, l, total = xbc.shape
        h, n = dt.shape[1], (total - d) // 2
        y = torch.empty((b, l, d), device=xbc.device)
        h_in = torch.empty((b, l // chunk, h, n, d // h), device=xbc.device) if states else None
        err = fwd.ssd_xbc_fwd(xbc.data_ptr(), dt.data_ptr(), S.data_ptr(), D.data_ptr(),
                              y.data_ptr(), h_in.data_ptr() if states else None, b, l, h, d, n,
                              d // h, chunk, xbc.stride(0), xbc.stride(1),
                              torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"the other tree's SSD forward failed ({err})")
        return y, h_in

    def backward(xbc, dt, S, D, h_in, dy, d, chunk):
        b, l, total = xbc.shape
        h, n, nc = dt.shape[1], (total - d) // 2, l // chunk
        f32 = dict(dtype=torch.float32, device=xbc.device)
        dxbc = torch.empty((b, l, total), **f32)
        part = torch.empty((b, h, l, 2 * n), **f32)
        ddt, dS = torch.empty((b, h, nc, chunk), **f32), torch.empty((b, h, nc, chunk), **f32)
        dD = torch.empty((b, h, nc), **f32)
        err = bwd.ssd_xbc_bwd(xbc.data_ptr(), dt.data_ptr(), S.data_ptr(), D.data_ptr(),
                              h_in.data_ptr(), dy.data_ptr(), dxbc.data_ptr(), part.data_ptr(),
                              ddt.data_ptr(), dS.data_ptr(), dD.data_ptr(), b, l, h, d, n,
                              d // h, chunk, xbc.stride(0), xbc.stride(1), dy.stride(0),
                              dy.stride(1), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"the other tree's SSD backward failed ({err})")
        dxbc[..., d:] = part.sum(dim=1)
        return dxbc, ddt, dS, dD.sum(dim=(0, 2))
    return forward, backward


def _one_block_split(libs: dict[str, ctypes.CDLL]) -> tuple:
    """(split forward, split backward) of a tree whose K6/K7 run the earlier
    one-block body: no scratch, per-head dB | dC partials (b, h, l, 2n) that
    the wrapper sums."""
    fwd, bwd = libs["ssd_xbc_fwd"], libs["ssd_xbc_bwd"]
    i, ll, p = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
    fwd.ssd_split_fwd.argtypes = [p] * 8 + [i] * 6 + [ll] * 6 + [p]
    bwd.ssd_split_bwd.argtypes = [p] * 12 + [i] * 6 + [ll] * 8 + [p]
    fwd.ssd_split_fwd.restype = bwd.ssd_split_bwd.restype = i

    def forward(x, dt, S, Bm, Cm, chunk, states, hfin):
        b, l, d = x.shape
        h, n = dt.shape[1], Bm.shape[-1]
        f32 = dict(dtype=torch.float32, device=x.device)
        y = torch.empty((b, l, d), **f32)
        h_in = torch.empty((b, l // chunk, h, n, d // h), **f32) if states else None
        h_fin = torch.empty((b, h, n, d // h), **f32) if hfin else None
        err = fwd.ssd_split_fwd(x.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), dt.data_ptr(),
                                S.data_ptr(), y.data_ptr(), h_in.data_ptr() if states else None,
                                h_fin.data_ptr() if hfin else None, b, l, h, n, d // h, chunk,
                                x.stride(0), x.stride(1), Bm.stride(0), Bm.stride(1),
                                Cm.stride(0), Cm.stride(1),
                                torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"the other tree's split SSD forward failed ({err})")
        return y, h_in, h_fin

    def backward(x, dt, S, Bm, Cm, h_in, dy, chunk, dh_fin):
        b, l, d = x.shape
        h, n = dt.shape[1], Bm.shape[-1]
        f32 = dict(dtype=torch.float32, device=x.device)
        dx, part = torch.empty((b, l, d), **f32), torch.empty((b, h, l, 2 * n), **f32)
        ddt, dS = torch.empty_like(dt), torch.empty_like(S)
        err = bwd.ssd_split_bwd(x.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), dt.data_ptr(),
                                S.data_ptr(), h_in.data_ptr(), dy.data_ptr(),
                                None if dh_fin is None else dh_fin.data_ptr(), dx.data_ptr(),
                                part.data_ptr(), ddt.data_ptr(), dS.data_ptr(), b, l, h, n, d // h,
                                chunk, x.stride(0), x.stride(1), Bm.stride(0), Bm.stride(1),
                                Cm.stride(0), Cm.stride(1), dy.stride(0), dy.stride(1),
                                torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"the other tree's split SSD backward failed ({err})")
        dbc = part.sum(dim=1)
        return dx, ddt, dS, dbc[..., :n], dbc[..., n:]
    return forward, backward


def _interfaces(fwd: ctypes.CDLL, bwd: ctypes.CDLL) -> tuple[ctypes.CDLL, ctypes.CDLL]:
    """Both libraries of a tree with the chunk-parallel kernels, declared as
    this tree declares them; a tree from before the bf16 entry points (no
    ``ssd_xbc_fwd_bf16``) gets the same declarations of its fp32 ones."""
    from si_mamba_tpu_torch.ops.kernels import ssd as kssd

    if hasattr(fwd, "ssd_xbc_fwd_bf16"):
        return kssd.fwd_interface(fwd), kssd.bwd_interface(bwd)
    for lib, entries, error_string in ((fwd, kssd.FWD_ENTRIES, "ssd_xbc_fwd_error_string"),
                                       (bwd, kssd.BWD_ENTRIES, "ssd_xbc_bwd_error_string")):
        for name, argtypes in entries.items():
            getattr(lib, name).argtypes, getattr(lib, name).restype = argtypes, ctypes.c_int
        getattr(lib, error_string).argtypes = [ctypes.c_int]
        getattr(lib, error_string).restype = ctypes.c_char_p
    return fwd, bwd


def _tree(src: Path, tag: str) -> dict:
    """The forward and backward of the tree at ``src``, the split ones, and
    ptxas' report."""
    from si_mamba_tpu_torch.ops.kernels import ssd as kssd

    libs, report = build(src, NAMES, tag)
    if (src / "ssd_tc.cuh").exists():
        fwd, bwd = _interfaces(libs["ssd_xbc_fwd"], libs["ssd_xbc_bwd"])

        def forward(xbc, dt, S, D, d, chunk, states):
            return kssd.run_fwd(fwd, xbc, dt, S, D, d, chunk, states,
                                torch.cuda.current_stream().cuda_stream)

        def backward(xbc, dt, S, D, h_in, dy, d, chunk):
            return kssd.run_bwd(bwd, xbc, dt, S, D, h_in, dy, d, chunk,
                                torch.cuda.current_stream().cuda_stream)
    else:
        forward, backward = _one_block_tree(libs)
    if "dbc_part" in (src / "ssd_xbc_bwd.cu").read_text():
        split_forward, split_backward = _one_block_split(libs)
    else:
        sfwd, sbwd = _interfaces(libs["ssd_xbc_fwd"], libs["ssd_xbc_bwd"])

        def split_forward(x, dt, S, Bm, Cm, chunk, states, hfin):
            return kssd.run_split_fwd(sfwd, x, dt, S, Bm, Cm, chunk, states, hfin,
                                      torch.cuda.current_stream().cuda_stream)

        def split_backward(x, dt, S, Bm, Cm, h_in, dy, chunk, dh_fin):
            return kssd.run_split_bwd(sbwd, x, dt, S, Bm, Cm, h_in, dy, chunk, dh_fin,
                                      torch.cuda.current_stream().cuda_stream)
    return dict(forward=forward, backward=backward, split_forward=split_forward,
                split_backward=split_backward, ptxas=report)


def _hold(pairs) -> None:
    """Each (name, got, want) within 1e-4 of want's max."""
    for name, a, b in pairs:
        err = (a - b).abs().max().item()
        if err > 1e-4 * b.abs().max().item():
            raise AssertionError(f"{name}: max |diff| {err}, max {b.abs().max().item()}")


def _check(tree: dict, args, h_in, dy) -> None:
    """The tree's K8 (both variants) and K9 against the plain versions."""
    from si_mamba_tpu_torch.ops.kernels import ssd as kssd

    xbc, dth, S, D, d, chunk = args
    y, h = tree["forward"](*args, True)
    y_ref, h_ref = kssd.ssd_xbc_fwd_ref(*args, emit_states=True)
    got = tree["backward"](xbc, dth, S, D, h_in, dy, d, chunk)
    want = kssd.ssd_xbc_bwd_ref(xbc, dth, S, D, h_in, dy, d, chunk)
    torch.cuda.synchronize()
    _hold([("y", y, y_ref), ("h_in", h, h_ref),
           *((f"K9 {k}", x, w) for k, x, w in zip(("dxbc", "ddt", "dS", "dD"), got, want))])


def _check_split(tree: dict, args, h_in, dy, dh_fin) -> None:
    """The tree's K6 (with states and h_fin) and K7 (from 0, seeded) against
    the plain versions."""
    from si_mamba_tpu_torch.ops.kernels import ssd as kssd

    x, dth, S, Bm, Cm, chunk = args
    got = tree["split_forward"](*args, True, True)
    want = kssd.ssd_split_fwd_ref(*args, emit_states=True, emit_hfin=True)
    pairs = list(zip(("K6 y", "K6 h_in", "K6 h_fin"), got, want))
    for seed in (None, dh_fin):
        got = tree["split_backward"](*args[:5], h_in, dy, chunk, seed)
        want = kssd.ssd_split_bwd_ref(*args[:5], h_in, dy, chunk, dh_fin=seed)
        tag = "K7" if seed is None else "K7 seeded"
        pairs += [(f"{tag} {k}", a, w) for k, a, w in zip(("dx", "ddt", "dS", "dB", "dC"), got,
                                                        want)]
    torch.cuda.synchronize()
    _hold(pairs)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, type=Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_ssd_kernel_ab: no CUDA device")
    import chip_smoke as cs
    from si_mamba_tpu_torch.ops.kernels import ssd as kssd

    card = cs.card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    trees = {"this": _tree(ROOT / "si_mamba_tpu_torch" / "csrc", "this"),
             "other": _tree(args.other, "other")}
    device = torch.device("cuda", 0)
    ops = {}
    for b in BATCHES:
        _, dth, S, _, _, xbc, D, chunk = cs._split_operands(device, heads=6, batch=b)
        ops[b] = (xbc, dth, S, D, 768, chunk)
    full = ops[32]
    dy = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (32, 512, 768), dtype=np.float32)).to(device)
    _, h_in = kssd.ssd_xbc_fwd_ref(*full, emit_states=True)
    for tree in trees.values():
        _check(tree, full, h_in, dy)

    x, dth3, S3, Bm, Cm, _, _, chunk3 = cs._split_operands(device, heads=3)
    split = (x, dth3, S3, Bm, Cm, chunk3)
    rng = np.random.default_rng(6)
    dy3 = torch.from_numpy(rng.standard_normal(x.shape, dtype=np.float32)).to(device)
    dh_fin = torch.from_numpy(0.1 * rng.standard_normal((32, 3, 128, 128),
                                                        dtype=np.float32)).to(device)
    _, h_in3, _ = kssd.ssd_split_fwd_ref(*split, emit_states=True)
    for tree in trees.values():
        _check_split(tree, split, h_in3, dy3, dh_fin)

    kernels = {f"K8 lean B={b}": (lambda tree, a=ops[b]: trees[tree]["forward"](*a, False))
               for b in BATCHES}
    kernels["K8 states B=32"] = lambda tree: trees[tree]["forward"](*full, True)
    kernels["K9 B=32"] = lambda tree: trees[tree]["backward"](*full[:4], h_in, dy, *full[4:])
    for name, states, hfin in (("lean", False, False), ("states", True, False),
                               ("hfin", False, True)):
        kernels[f"K6 {name} B=32"] = (lambda tree, st=states, hf=hfin:
                                      trees[tree]["split_forward"](*split, st, hf))
    for name, seed in (("K7 B=32", None), ("K7 seeded B=32", dh_fin)):
        kernels[name] = (lambda tree, seed=seed:
                         trees[tree]["split_backward"](*split[:5], h_in3, dy3, chunk3, seed))
    times = round_robin({tree: (lambda: None) for tree in trees}, kernels,
                        {"device": cs.graph_ms, "eager": cs.time_ms}, ROUNDS,
                        calls=lambda name: 10 if name.startswith(("K9", "K7")) else 20)
    mean = means(times)
    peaked = [f"K8 lean B={b}" for b in BATCHES] + [k for k in kernels if k.startswith("K6")] + \
        ["K7 B=32", "K7 seeded B=32"]
    peaks = {tree: {k: peak_mb(lambda t=tree, k=k: kernels[k](t)) for k in peaked}
             for tree in trees}
    kernel_ms = {k: by_kernel(lambda k=k: kernels[k]("this"))
                 for k in ("K8 lean B=1", "K8 states B=32", "K9 B=32", "K6 states B=32",
                           "K7 B=32")}
    print(json.dumps({"card": card, "rounds": ROUNDS, "mean_ms": mean, "by_kernel": kernel_ms,
                      "other_over_this": other_over_this(mean, kernels), "peak_mb": peaks,
                      "ptxas": {t: trees[t]["ptxas"] for t in trees}, "ms": times}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
