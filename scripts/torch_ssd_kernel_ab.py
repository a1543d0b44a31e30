#!/usr/bin/env python3
"""Time the SSD kernels of the PyTorch port, the boundary-fused core (K8
lean, K8 with states, K9) and the split core (K6 lean, with states, with
h_fin; K7 from 0 and seeded), fp32 and bf16, built from two source trees, in
one process on one card.

    python scripts/torch_ssd_kernel_ab.py --other <dir with ssd_xbc_fwd.cu, ssd_xbc_bwd.cu>
        [--json out.json]

``--other`` is typically the ``si_mamba_tpu_torch/csrc`` of another commit
unpacked with ``git archive``. Both trees are built with the port's nvcc
flags into ``build/ab/`` (``torch_ab_common.build``). A tree with the
chunk-parallel K8/K9 (it has ``ssd_tc.cuh``) is called through this tree's
``run_fwd`` / ``run_bwd``; a tree without them (the earlier one-block-a-
(batch, head) kernels) through its own C argument lists, its per-head
dB | dC partials summed as its wrapper did. Likewise a tree whose K6/K7 take
scratch is called through ``run_split_fwd`` / ``run_split_bwd``, one whose
K7 writes per-head dB | dC partials (K6/K7 on the one-block body) through
its own argument lists. A tree with the Hopper bf16 body
(``ssd_xbc_bf16_sm90.cu``) runs the bf16 K8/K9 calls that body serves
(with or without h_fin or a seed where its source has them)
through ``run_sm90_fwd`` / ``run_sm90_bwd``, as the wrappers route them; one
whose entry points take no h_fin or dh_fin through its own argument lists
(``_NoCarry``).

fp32: K8/K9 on the SSD classifier's inputs as layer 0's mixer makes them
(L=512, chunk 256, 6 heads of 128, d_state 128, the conv output as in
``chip_smoke.py``): lean K8 at B = 1, 20, 32 and 64 clouds, K8 with states
and K9 at B=32; K6/K7 at the tensor-parallel shard (B=32, 3 heads, x and the
B|C halves as ``ssd_mixer_tp`` makes them). bf16, the two bf16 SSD-fused
presets' shapes: lean K8 at 1, 20, 32 and 64 clouds, K8 with states and K9
at B 32, L 512, chunk 256 (cfgs/finetune_modelnet_ssd_fused.yaml) and lean
K8, K8 with states and K9 at B 128, L 512, chunk 128
(cfgs/pretrain_ssd_fused.yaml's decoder); K8 with h_fin and K9 seeded at B
32; and the bf16 entry points that keep the chunk-parallel body at B 32 (K6
with states, K7). In turns this, other, other, this (ROUNDS times), each as device time
(calls captured in a CUDA graph and replayed) and as eager time
(back-to-back wrapper calls, the host's cost included). Before timing, each
tree's outputs are held against the plain versions: fp32 every output within
1e-4 of its max; bf16 by ``chip_smoke.py``'s rules (a bf16 output within 2
bf16 ulps of the plain version at B 32, against the fp64 truth at B 128; fp32
outputs within 1e-3 of their max; K9 twice bitwise equal). Each tree's lean
K8 calls and K6/K7 calls are measured for the memory they allocate at their
peak (outputs and scratch). The script prints one JSON line (also written to
``--json``): each kernel's mean time per tree and timer, the ratios, the
times of every round, the peak allocations, ptxas' register and spill lines,
the card's name and power limit, this tree's device time by kernel name
(``torch.profiler``) for the fp32 lean K8 at one cloud, K8 with states, K9,
K6 with states and K7 at B=32, and both trees' for the bf16 K8 (lean at B
32, with states at both shapes) and K9 at both shapes.
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


class _NoCarry:
    """A Hopper bf16 body whose C entry points take no h_fin or dh_fin (and
    whose scratch has no seed's slot), called with this tree's argument lists:
    the two arguments dropped, the unseeded scratch asked for."""

    def __init__(self, lib):
        from si_mamba_tpu_torch.ops.kernels import ssd as kssd

        self._lib = lib
        fwd, bwd = kssd.SM90_ENTRIES["ssd_sm90_fwd"], kssd.SM90_ENTRIES["ssd_sm90_bwd"]
        lib.ssd_sm90_fwd.argtypes, lib.ssd_sm90_fwd.restype = fwd[:8] + fwd[9:], ctypes.c_int
        lib.ssd_sm90_bwd.argtypes, lib.ssd_sm90_bwd.restype = bwd[:6] + bwd[7:], ctypes.c_int
        lib.ssd_sm90_bwd_scratch_floats.argtypes = [ctypes.c_int] * 4
        lib.ssd_sm90_bwd_scratch_floats.restype = ctypes.c_longlong
        lib.ssd_sm90_error_string.argtypes = [ctypes.c_int]
        lib.ssd_sm90_error_string.restype = ctypes.c_char_p
        self.ssd_sm90_error_string = lib.ssd_sm90_error_string

    def ssd_sm90_fwd(self, *a):
        return self._lib.ssd_sm90_fwd(*a[:8], *a[9:])

    def ssd_sm90_bwd(self, *a):
        return self._lib.ssd_sm90_bwd(*a[:6], *a[7:])


def _tree(src: Path, tag: str) -> dict:
    """The forward and backward of the tree at ``src``, the split ones, and
    ptxas' report. A tree with the Hopper bf16 body (``ssd_xbc_bf16_sm90.cu``)
    takes it for the bf16 calls it serves (``kssd.sm90_serves``), as the
    wrappers route them; the others take the tree's chunk-parallel body."""
    from si_mamba_tpu_torch.ops.kernels import ssd as kssd

    sm90 = (src / "ssd_xbc_bf16_sm90.cu").exists()
    libs, report = build(src, NAMES + (("ssd_xbc_bf16_sm90",) if sm90 else ()), tag)
    if (src / "ssd_tc.cuh").exists():
        fwd, bwd = _interfaces(libs["ssd_xbc_fwd"], libs["ssd_xbc_bwd"])
        # a Hopper body with the carries (its source names dh_fin) serves them too
        carries = sm90 and "dh_fin" in (src / "ssd_xbc_bf16_sm90.cu").read_text()
        lib90 = None if not sm90 else (kssd.sm90_interface(libs["ssd_xbc_bf16_sm90"])
                                       if carries else _NoCarry(libs["ssd_xbc_bf16_sm90"]))

        def served(xbc, d, chunk, carry):
            n = (xbc.shape[-1] - d) // 2
            return (lib90 is not None and (carries or not carry)
                    and kssd.sm90_serves(xbc.dtype, chunk, n, n))

        def forward(xbc, dt, S, D, d, chunk, states, hfin=False):
            stream = torch.cuda.current_stream().cuda_stream
            if served(xbc, d, chunk, hfin):
                return kssd.run_sm90_fwd(lib90, xbc, dt, S, D, d, chunk, states, stream,
                                         hfin=hfin)
            return kssd.run_fwd(fwd, xbc, dt, S, D, d, chunk, states, stream, hfin=hfin)

        def backward(xbc, dt, S, D, h_in, dy, d, chunk, dh_fin=None):
            stream = torch.cuda.current_stream().cuda_stream
            if served(xbc, d, chunk, dh_fin is not None):
                return kssd.run_sm90_bwd(lib90, xbc, dt, S, D, h_in, dy, d, chunk, stream,
                                         dh_fin=dh_fin)
            return kssd.run_bwd(bwd, xbc, dt, S, D, h_in, dy, d, chunk, stream, dh_fin=dh_fin)
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


def _check_bf16(tree: dict, args, h_in, dy, dh_fin, truth: bool) -> None:
    """The tree's bf16 K8 (lean, with states, with h_fin) and K9 (from 0,
    seeded; each twice, bitwise equal) against the plain versions at bf16,
    by ``chip_smoke.py``'s rules: with ``truth`` a bf16 output against the
    fp64 truth (``_hold_bf16_truth``), else within 2 bf16 ulps of the plain
    version; the fp32 outputs within 1e-3 of their max (``_hold_bf16``)."""
    import chip_smoke as cs
    from si_mamba_tpu_torch.ops.kernels import ssd as kssd

    xbc, dth, S, D, d, chunk = args
    y, h = tree["forward"](*args, True)
    y_lean = tree["forward"](*args, False)[0]
    y_hf, h_fin = tree["forward"](*args, False, hfin=True)[::2]
    y_ref, h_ref, hf_ref = kssd.ssd_xbc_fwd_ref(*args, emit_states=True, emit_hfin=True)
    torch.cuda.synchronize()
    if not torch.equal(y, y_lean):
        raise AssertionError("bf16 K8's y with states differs from the lean y")
    where = f"B={xbc.shape[0]}, chunk {chunk}"

    def hold16(name, got, want, exact):
        if truth:
            cs._hold_bf16_truth(f"{name} at {where}", got, want, exact())
        else:
            cs._hold_bf16(f"{name} at {where}", got, want)

    hold16("bf16 K8 y", y, y_ref, lambda: kssd.ssd_xbc_fwd_ref(*cs._f64(args))[0])
    hold16("bf16 K8 y with h_fin", y_hf, y_ref, lambda: kssd.ssd_xbc_fwd_ref(*cs._f64(args))[0])
    cs._hold_bf16(f"bf16 K8 h_in at {where}", h, h_ref)
    cs._hold_bf16(f"bf16 K8 h_fin at {where}", h_fin, hf_ref)
    for seed in (None, dh_fin):
        bargs = (xbc, dth, S, D, h_in, dy, d, chunk)
        got = tree["backward"](*bargs, dh_fin=seed)
        again = tree["backward"](*bargs, dh_fin=seed)
        want = kssd.ssd_xbc_bwd_ref(*bargs, dh_fin=seed)
        torch.cuda.synchronize()
        if not all(torch.equal(a, c) for a, c in zip(got, again)):
            raise AssertionError(f"two bf16 K9 runs differ at {where}")
        tag = "bf16 K9" if seed is None else "bf16 K9 seeded"
        hold16(f"{tag} dxbc", got[0], want[0],
               lambda: kssd.ssd_xbc_bwd_ref(*cs._f64(bargs), dh_fin=cs._f64((seed,))[0])[0])
        for k, a, w in zip(("ddt", "dS", "dD"), got[1:], want[1:]):
            cs._hold_bf16(f"{tag} {k} at {where}", a, w)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, type=Path)
    ap.add_argument("--json", type=Path, help="also write the JSON line to this file")
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
    # bf16: the two bf16 SSD-fused presets' shapes (B 32, chunk 256; B 128,
    # chunk 128), lean K8 at the request sizes, K8 with h_fin and K9 seeded,
    # and the entry points that keep the chunk-parallel body (K6, K7) at B 32
    bf = torch.bfloat16
    bops = {}
    for b, c in [(b, 256) for b in BATCHES] + [(128, 128)]:
        _, dth, S, _, _, xbc, D, _ = cs._split_operands(device, heads=6, batch=b, chunk=c,
                                                        dtype=bf)
        bops[(b, c)] = (xbc, dth, S, D, 768, c)
    rng16 = np.random.default_rng(7)
    bf_bwd = {}
    for key in ((32, 256), (128, 128)):
        a = bops[key]
        dy16 = torch.from_numpy(rng16.standard_normal((key[0], 512, 768), dtype=np.float32)
                                ).to(device, bf)
        seed16 = torch.from_numpy(0.1 * rng16.standard_normal((key[0], 6, 128, 128),
                                                              dtype=np.float32)).to(device)
        bf_bwd[key] = (kssd.ssd_xbc_fwd_ref(*a, emit_states=True)[1], dy16, seed16)
        for tree in trees.values():
            _check_bf16(tree, a, *bf_bwd[key], truth=key[0] == 128)
    for b in BATCHES:
        kernels[f"bf16 K8 lean B={b}"] = (lambda tree, a=bops[(b, 256)]:
                                          trees[tree]["forward"](*a, False))
    for key, tag in (((32, 256), "B=32"), ((128, 128), "B=128 q128")):
        a, (h16, dy16, seed16) = bops[key], bf_bwd[key]
        if key[0] == 128:
            kernels[f"bf16 K8 lean {tag}"] = lambda tree, a=a: trees[tree]["forward"](*a, False)
        kernels[f"bf16 K8 states {tag}"] = lambda tree, a=a: trees[tree]["forward"](*a, True)
        kernels[f"bf16 K9 {tag}"] = (lambda tree, a=a, h16=h16, dy16=dy16:
                                     trees[tree]["backward"](*a[:4], h16, dy16, *a[4:]))
    a, (h16, dy16, seed16) = bops[(32, 256)], bf_bwd[(32, 256)]
    kernels["bf16 K8 hfin B=32"] = lambda tree: trees[tree]["forward"](*a, False, hfin=True)
    kernels["bf16 K9 seeded B=32"] = (lambda tree: trees[tree]["backward"](
        *a[:4], h16, dy16, *a[4:], dh_fin=seed16))
    x16, dth16, S16, B16, C16, _, _, c16 = cs._split_operands(device, heads=3, dtype=bf)
    split16 = (x16, dth16, S16, B16, C16, c16)
    dy3_16 = dy3.to(bf)
    _, h_in3_16, _ = kssd.ssd_split_fwd_ref(*split16, emit_states=True)
    kernels["bf16 K6 states B=32"] = lambda tree: trees[tree]["split_forward"](*split16, True,
                                                                               False)
    kernels["bf16 K7 B=32"] = (lambda tree: trees[tree]["split_backward"](
        *split16[:5], h_in3_16, dy3_16, c16, None))
    times = round_robin({tree: (lambda: None) for tree in trees}, kernels,
                        {"device": cs.graph_ms, "eager": cs.time_ms}, ROUNDS,
                        calls=lambda name: 10 if "K9" in name or "K7" in name
                        or "B=128" in name else 20)
    mean = means(times)
    peaked = [f"K8 lean B={b}" for b in BATCHES] + [k for k in kernels if k.startswith("K6")] + \
        ["K7 B=32", "K7 seeded B=32"]
    peaks = {tree: {k: peak_mb(lambda t=tree, k=k: kernels[k](t)) for k in peaked}
             for tree in trees}
    kernel_ms = {k: by_kernel(lambda k=k: kernels[k]("this"))
                 for k in ("K8 lean B=1", "K8 states B=32", "K9 B=32", "K6 states B=32",
                           "K7 B=32")}
    # the bf16 K8/K9 launches' device time by kernel name, in both trees
    bf16_split = {tree: {k: by_kernel(lambda k=k, tree=tree: kernels[k](tree))
                         for k in ("bf16 K8 lean B=32", "bf16 K8 states B=32", "bf16 K9 B=32",
                                   "bf16 K8 states B=128 q128", "bf16 K9 B=128 q128")}
                  for tree in trees}
    line = json.dumps({"card": card, "rounds": ROUNDS, "mean_ms": mean, "by_kernel": kernel_ms,
                       "bf16_by_kernel": bf16_split,
                       "other_over_this": other_over_this(mean, kernels), "peak_mb": peaks,
                       "ptxas": {t: trees[t]["ptxas"] for t in trees}, "ms": times})
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
