#!/usr/bin/env python3
"""Where a tile's time goes in the Hopper bf16 scan body
(``csrc/selective_scan_bf16_sm90.cu``), on one card.

    python scripts/torch_scan_phase_trace.py [--batch 32] [--length 512]

The script builds the source with ``-DSCAN_PHASE_TRACE``, which turns its
``SCAN_STAMP`` hooks into reads of ``%globaltimer`` (ns) at each phase
boundary of the lean forward (K2) and the backward (K4) for lanes 0 of warps
0 and 2 of one block (batch row 3, channel block 2), and runs K2 and K4 on
perf mode's operands (``chip_smoke.perf_operands``) through the port's
wrappers. It prints one JSON line: for each kernel and warp the mean time of
each phase over the tiles (the first and last left out), in microseconds, the
tile's total, and the card's name and power limit. The stamps cost a few
instructions a phase; they are for the split, not for the total (time the
kernels with ``scripts/torch_scan_kernel_ab.py``).

Phases, K2 (16-step tiles; stamp k of tile i at slot 8 i + k): ``wait`` (the
tile's copies), ``scalars`` (the per-(step, channel) pass), ``barrier``,
``issue`` (the lane's share of a later tile's copies), ``scan`` (the 16 steps
and the stores, to the next tile's wait). K4 (8-step tiles; slot 2048 + 8 i +
k): ``wait``, ``scalars``, ``barrier``, ``issue``, ``rebuild``,
``step_back``, ``barrier_b``, ``partials`` (the warps' dB/dC sums and the du,
ddt, dz stores, to the next tile's wait).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys

import numpy as np
import torch

from torch_ab_common import ROOT, build

SLOTS = 4096  # stamps per traced lane (kStampSlots)
FWD = ("wait", "scalars", "barrier", "issue", "scan")
BWD = ("wait", "scalars", "barrier", "issue", "rebuild", "step_back", "barrier_b", "partials")


def phases(stamps: list[int], base: int, names: tuple[str, ...], tiles: int) -> dict:
    """Mean µs of each phase over tiles 1 .. tiles - 2; the last phase runs to
    the next tile's first stamp."""
    rows = [stamps[base + 8 * i:base + 8 * i + len(names)] + [stamps[base + 8 * (i + 1)]]
            for i in range(1, tiles - 1)]
    out = {name: float(np.mean([(r[k + 1] - r[k]) / 1e3 for r in rows]))
           for k, name in enumerate(names)}
    out["tile"] = float(np.mean([(r[-1] - r[0]) / 1e3 for r in rows]))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--length", type=int, default=512)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_scan_phase_trace: no CUDA device")
    import chip_smoke as cs
    from si_mamba_tpu_torch.ops.kernels import selective_scan as ks

    libs = build(ROOT / "si_mamba_tpu_torch" / "csrc", (ks.SM90_SOURCE,), "phase_trace",
                 ("-DSCAN_PHASE_TRACE",))[0]
    lib = ks.sm90_interface(libs[ks.SM90_SOURCE])
    lib.scan_phase_trace_read.argtypes = [ctypes.c_void_p]
    ks._sm90_library = lambda: lib
    device = torch.device("cuda", 0)
    a = cs.perf_operands(device, args.batch, args.length)[3]
    g = torch.from_numpy(np.random.default_rng(3).standard_normal(
        a[0].shape, dtype=np.float32)).to(device, torch.bfloat16)
    h = ks._launch_fwd(*a, residuals=True)[1]
    if lib.scan_sm90_segments(args.batch, args.length, a[0].shape[2]) != 1:
        raise SystemExit("torch_scan_phase_trace: the forward is segmented at this batch")
    buf = (ctypes.c_ulonglong * (2 * SLOTS))()
    result = {"card": cs.card_line(), "batch": args.batch, "length": args.length}
    for name, call, base, names, tiles in (
            ("K2", lambda: ks._launch_fwd(*a, residuals=False), 0, FWD, -(-args.length // 16)),
            ("K4", lambda: ks._launch_bwd(*a, g, h), 2048, BWD, -(-args.length // ks.SM90_TILE))):
        for _ in range(3):
            call()
        torch.cuda.synchronize()
        if lib.scan_phase_trace_read(ctypes.addressof(buf)):
            raise RuntimeError("could not read the stamps")
        for warp, off in (("warp 0", 0), ("warp 2", SLOTS)):
            stamps = list(buf[off:off + SLOTS])
            result[f"{name} {warp}"] = phases(stamps, base, names, tiles)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
