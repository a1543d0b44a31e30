"""The part-segmentation trainer with and without a thread that assembles
the batches ahead, alternated in one process on the card.

Usage (from the repository root, on a machine with a GPU):

    python scripts/torch_seg_loader_ab.py [--trainval 160] [--test 64]

It writes a seeded tree in ShapeNetPart's layout under build/seg_ab/ (as
``chip_smoke.py`` does), then trains cfgs/part_segmentation.yaml's model (full
width, seeded weights) for one epoch through ``runner_seg.seg_run``, as the CLI
does, on loaders (``data/loader.py``) with ``prefetch=0`` (the batches
assembled between the steps, as the CLI's seg path builds them) and
``prefetch=4`` (one thread assembling up to four ahead), in the order 0, 4, 4,
0 after a warm-up run (which builds the kernels). For each run it prints the
train steps' p50 and the evaluation forwards' median (host clock,
synchronised, as ``chip_smoke.py`` times them) and the wall time of the whole
run. Imports no JAX.
"""

from __future__ import annotations

import argparse
import os
import statistics
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from si_mamba_tpu_torch.data.loader import Loader  # noqa: E402
from si_mamba_tpu_torch.data.shapenetpart import PartNormalDataset  # noqa: E402
from si_mamba_tpu_torch.train import runner_seg as rs  # noqa: E402
from si_mamba_tpu_torch.train.config import get_config  # noqa: E402
from si_mamba_tpu_torch.train.registry import build_model_from_cfg  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _timed(make, times: list):
    """``make``'s step, each call timed from a synchronised start to a
    synchronised end."""
    def build(*a, **k):
        step = make(*a, **k)

        def run(*sa, **sk):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = step(*sa, **sk)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
            return out

        return run

    return build


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--trainval", type=int, default=160)
    parser.add_argument("--test", type=int, default=64)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_seg_loader_ab: no GPU")
    work = ROOT / "build" / "seg_ab"
    tree = work / "shapenetpart"
    if not (tree / "synsetoffset2category.txt").exists():
        chip_smoke.write_shapenetpart_tree(tree, args.trainval, args.test)
    config = get_config(str(ROOT / "cfgs" / "part_segmentation.yaml"))
    bs, npts = int(config.total_bs), int(config.npoints)
    print(chip_smoke.card_line(), flush=True)
    real = (rs.make_seg_train_step, rs.make_seg_eval_step)
    try:
        for i, prefetch in enumerate((4, 0, 4, 4, 0)):  # the first warms up
            steps, evals = [], []
            rs.make_seg_train_step = _timed(real[0], steps)
            rs.make_seg_eval_step = _timed(real[1], evals)
            model, cfg = build_model_from_cfg(config.model, "cuda", 0)
            loaders = [Loader(PartNormalDataset(str(tree), npts, split, seed=0), bs,
                              shuffle=shuffle, drop_last=shuffle, seed=0, prefetch=prefetch)
                       for split, shuffle in (("trainval", True), ("test", False))]
            t = time.perf_counter()
            rs.seg_run(cfg, *loaders, str(work / f"run{i}"), epochs=1,
                       lr=float(config.optimizer.kwargs.lr), weight_decay=0.05,
                       warmup_epochs=0, device="cuda", model=model)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            print(f"{'warm-up, ' if i == 0 else ''}prefetch {prefetch}: {len(steps)} steps, "
                  f"p50 {statistics.median(steps[1:]):.3f} ms; {len(evals)} evaluation forwards, "
                  f"median {statistics.median(evals):.3f} ms; run {wall:.3f} s", flush=True)
    finally:
        rs.make_seg_train_step, rs.make_seg_eval_step = real


if __name__ == "__main__":
    main()
