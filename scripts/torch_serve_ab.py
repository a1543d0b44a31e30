#!/usr/bin/env python3
"""Perf-mode serving latency of the PyTorch port with the bf16 Mamba-1 scan
of two source trees, in one process on one card: ``Predictor.logits`` p50 at
1, 20 and 64 clouds.

    python scripts/torch_serve_ab.py --other <root of another checkout> [--rounds 8]

``--other`` is typically another commit unpacked with ``git archive`` into a
directory that ``.gitignore`` lists (``build/parent``). The predictor is this
tree's perf-mode classifier (``chip_smoke.MODELNET40_PERF`` from seed 0,
``Predictor.from_checkpoint(..., perf=True)``). Its mixers reach the scan
through ``ops/selective_scan.py``'s ``selective_scan_fused``; the other tree's
turns point that name at the other tree's ``selective_scan_fused`` (its
``ops/kernels/selective_scan.py`` on the libraries built from its csrc,
``torch_scan_kernel_ab._other_bf16``), so the two turns differ in the scan's
wrappers and kernels and in nothing else. The trees take turns this, other,
other, this, ``--rounds`` times; a turn serves ``--requests`` requests a size
after one more (host clock to the logits' host copy, as
``chip_smoke.serving_phase``). The script prints one JSON line: each tree's
p50 a size over all its requests and the p50 of each of its turns, the other
tree's over this tree's, the largest difference of the two trees' logits on
the 20-cloud request against the largest logit, the scan launches of each
tree's turns (each on its own tree's counts), and the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

from torch_ab_common import ORDER
from torch_scan_kernel_ab import _other_bf16

SIZES = (1, 20, 64)


def scan_launches(mod) -> int:
    """The scan launches counted in a tree's ``ops/kernels/selective_scan.py``
    (``mod``): its K2 counts, and its Hopper body's where it has one."""
    counts = [getattr(getattr(mod, name), "launches", 0)
              for name in ("selective_scan_fwd", "selective_scan_fwd_bf16")]
    return sum(counts) + sum(c.launches for c in getattr(mod, "SM90_LAUNCHES", {}).values())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path, required=True)
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--requests", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_serve_ab: no CUDA device")
    import chip_smoke as cs
    from si_mamba_tpu_torch.models import PointMamba, PointMambaConfig
    from si_mamba_tpu_torch.ops import selective_scan as ops_scan
    from si_mamba_tpu_torch.ops.kernels import selective_scan as ks
    from si_mamba_tpu_torch.serving import Predictor

    torch.backends.cuda.matmul.allow_tf32 = False
    other = _other_bf16(args.other / "si_mamba_tpu_torch" / "csrc")[0]["mod"]
    fused = {"this": ops_scan.selective_scan_fused, "other": other.selective_scan_fused}
    mods = {"this": ks, "other": other}
    cfg = cs.MODELNET40_PERF
    model = PointMamba(PointMambaConfig.from_dict(cfg), generator=torch.Generator().manual_seed(0))
    predictor = Predictor.from_checkpoint(model.state_dict(), model_cfg=cfg, perf=True,
                                          npoints=cs.NPOINTS, max_batch=64,
                                          device=torch.device("cuda", 0))
    requests = {n: cs.clouds(n, seed=n) for n in SIZES}
    times = {tree: {n: [] for n in SIZES} for tree in fused}
    turns = {tree: {n: [] for n in SIZES} for tree in fused}
    logits, launches = {}, {tree: 0 for tree in fused}
    for tree in fused:  # warm-up, each tree's libraries loaded
        ops_scan.selective_scan_fused = fused[tree]
        predictor.warmup()
        logits[tree] = predictor.logits(requests[20])
    for _ in range(args.rounds):
        for tree in ORDER:
            ops_scan.selective_scan_fused = fused[tree]
            before = scan_launches(mods[tree])
            for n, batch in requests.items():
                predictor.logits(batch)
                got = []
                for _ in range(args.requests):
                    t0 = time.perf_counter()
                    out = predictor.logits(batch)  # host numpy: synchronised
                    got.append((time.perf_counter() - t0) * 1e3)
                if out.shape != (n, cfg["cls_dim"]) or not np.isfinite(out).all():
                    raise AssertionError(f"bad logits for a request of {n}: {out.shape}")
                times[tree][n] += got
                turns[tree][n].append(statistics.median(got))
            launches[tree] += scan_launches(mods[tree]) - before
    ops_scan.selective_scan_fused = fused["this"]
    p50 = {tree: {str(n): statistics.median(times[tree][n]) for n in SIZES} for tree in fused}
    print(json.dumps({
        "card": cs.card_line(), "rounds": args.rounds, "requests": args.requests, "p50_ms": p50,
        "p50_ms_by_turn": {tree: {str(n): v for n, v in per.items()} for tree, per in turns.items()},
        "other_over_this": {n: p50["other"][n] / p50["this"][n] for n in p50["this"]},
        "logits_20_max_abs_diff": float(np.abs(logits["this"] - logits["other"]).max()),
        "logits_20_max_abs": float(np.abs(logits["other"]).max()),
        "scan_launches": launches}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
