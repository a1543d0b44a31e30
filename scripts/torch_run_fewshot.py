#!/usr/bin/env python
"""Few-shot protocol sweep on the PyTorch port: the port's CLI
(``si_mamba_tpu_torch.train.cli.main``) once a fold, then the mean and
standard deviation of the folds' best accuracy, as scripts/run_fewshot.py does
for the JAX package (reference README.md:181 table).

    python scripts/torch_run_fewshot.py --config cfgs/fewshot.yaml \
        --way 5 --shot 10 --folds 10 [--finetune_model <pretrain ckpt>] \
        [--device cpu] [--num_workers 0]

Each fold is one full train (experiment ``<config stem>/<exp>_w<way>s<shot>_f<fold>``)
reading ModelNetFewshot/<way>way_<shot>shot/<fold>.pkl under the dataset
config's DATA_PATH. Prints the same JSON summary line as scripts/run_fewshot.py,
{way, shot, folds, accs, mean, std}, the best ``Metric/ACC`` of each fold's
scalars.jsonl, and writes it next to the fold experiments. ``--device`` and
``--num_workers`` are handed to the CLI (default: the card)."""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def best_acc(exp_path: str) -> float:
    """The largest ``Metric/ACC`` value of an experiment's scalars.jsonl."""
    accs = []
    with open(os.path.join(exp_path, "scalars.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            if rec.get("tag") == "Metric/ACC":
                accs.append(float(rec["value"]))
    if not accs:
        raise RuntimeError(f"no Metric/ACC records in {exp_path}")
    return max(accs)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", default="cfgs/fewshot.yaml")
    p.add_argument("--way", type=int, default=5)
    p.add_argument("--shot", type=int, default=10)
    p.add_argument("--folds", type=int, default=10)
    p.add_argument("--exp_name", default="sweep")
    p.add_argument("--finetune_model", default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None)
    p.add_argument("--num_workers", default=None)
    args = p.parse_args(argv)

    from si_mamba_tpu_torch.train import cli

    accs = []
    stem = os.path.splitext(os.path.basename(args.config))[0]
    for fold in range(args.folds):
        exp = f"{args.exp_name}_w{args.way}s{args.shot}_f{fold}"
        fold_argv = ["--config", args.config, "--exp_name", exp, "--way", str(args.way),
                     "--shot", str(args.shot), "--fold", str(fold), "--seed", str(args.seed)]
        fold_argv += (["--finetune_model", args.finetune_model]
                      if args.finetune_model else ["--scratch_model"])
        for flag in ("device", "num_workers"):
            if getattr(args, flag) is not None:
                fold_argv += [f"--{flag}", str(getattr(args, flag))]
        cli.main(fold_argv)
        acc = best_acc(os.path.join("experiments", stem, exp))
        accs.append(acc)
        print(f"[fewshot] fold {fold}: best acc {acc:.4f}", flush=True)

    summary = {"way": args.way, "shot": args.shot, "folds": args.folds, "accs": accs,
               "mean": float(np.mean(accs)), "std": float(np.std(accs))}
    out = os.path.join("experiments", stem, f"{args.exp_name}_w{args.way}s{args.shot}.json")
    with open(out, "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
