"""Export a JAX run's orbax checkpoint, optimizer state included, to a ``.pth``
that the PyTorch port's ``--resume`` reads.

Usage (where JAX is installed):
    python scripts/torch_export_optax_state.py --exp_dir experiments/<config>/<exp_name> \\
        [--prefix ckpt-last] [--config <exp_dir>/config.yaml] [--out <exp_dir>/<prefix>.pth]

The file holds what the port's ``train/checkpoint.py`` writes: ``base_model``
(the weights and BatchNorm statistics in the reference's keys), ``optimizer``
(AdamW's moments and step count mapped from optax's ``ScaleByAdamState`` by
``si_mamba_tpu_torch/utils/weights.adamw_state_from_jax``, and the update
count), ``epoch``, ``step``, the metrics, and no generator state. To resume
with the port, put it as ``ckpt-last.pth`` beside the run's ``config.yaml`` in
the port's experiment directory (one without the orbax directories, which
the port refuses) and run its CLI with ``--resume``. Unlike
``scripts/export_torch.py`` (weights only), the resumed run keeps Adam's
moments. A checkpoint saved between the micro-steps of gradient accumulation
is refused.
"""

from __future__ import annotations

import argparse
import os
import re
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

_KEY = re.compile(r"\['([^']*)'\]")


def _nest(flat: dict, prefix: str) -> dict:
    """The tree under ``prefix`` of a path-keyed dict (the JAX checkpoint's
    ``opt_state``: keys such as ``[1][0].mu['encoder']['conv1']['kernel']``)."""
    tree: dict = {}
    for key, leaf in flat.items():
        if not key.startswith(prefix + "["):
            continue
        *parents, last = _KEY.findall(key[len(prefix):])
        node = tree
        for name in parents:
            node = node.setdefault(name, {})
        node[last] = leaf
    return tree


def adam_state(opt_state: dict):
    """(mu, nu, count) of the one ``ScaleByAdamState`` in a path-keyed optax
    state; raises for a state saved mid-accumulation."""
    import numpy as np

    if int(np.asarray(opt_state.get(".mini_step", 0))) != 0:
        raise ValueError("the checkpoint was saved between gradient-accumulation micro-steps")
    heads = {k[:-len(".count")] for k in opt_state if k.endswith(".count")
             and any(x.startswith(k[:-len(".count")] + ".mu[") for x in opt_state)}
    if len(heads) != 1:
        raise ValueError(f"expected one Adam state in the optimizer state, found {len(heads)}")
    head = heads.pop()
    return (_nest(opt_state, head + ".mu"), _nest(opt_state, head + ".nu"),
            int(np.asarray(opt_state[head + ".count"])))


def _floats(metrics) -> dict:
    """Metric values as Python floats (orbax restores numpy scalars, which the
    port's weights-only load refuses)."""
    return {k: float(v) for k, v in dict(metrics).items()}


def export(exp_dir: str, prefix: str = "ckpt-last", config_path: str | None = None,
           out: str | None = None) -> str:
    """Write the ``.pth``; returns its path."""
    import torch

    from si_mamba_tpu.train.checkpoint import load_checkpoint
    from si_mamba_tpu.train.config import get_config
    from si_mamba_tpu_torch.train.registry import build_model_from_cfg
    from si_mamba_tpu_torch.utils.weights import FROM_JAX, adamw_state_from_jax

    payload = load_checkpoint(exp_dir, prefix)
    if payload is None:
        raise SystemExit(f"no checkpoint '{prefix}' in {exp_dir}")
    config = get_config(config_path or os.path.join(exp_dir, "config.yaml"))
    model, _ = build_model_from_cfg(config.model, "cpu", 0)
    mu, nu, count = adam_state(payload["opt_state"])
    meta = payload.get("meta", {})
    base = FROM_JAX[type(model).__name__](payload["params"], payload["batch_stats"])
    model.load_state_dict(base, strict=True)  # the weights fit the config's model
    out = out or os.path.join(exp_dir, f"{prefix}.pth")
    torch.save({"base_model": base, "optimizer": adamw_state_from_jax(mu, nu, count, model),
                "epoch": int(meta.get("epoch", 0)), "step": int(meta.get("step", count)),
                "metrics": _floats(meta.get("metrics", {})),
                "best_metrics": _floats(meta.get("best_metrics", {})), "rng": None}, out)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--exp_dir", required=True, help="the JAX run's experiment directory")
    ap.add_argument("--prefix", default="ckpt-last", help="the checkpoint's prefix")
    ap.add_argument("--config", default=None,
                    help="the run's config (default: <exp_dir>/config.yaml)")
    ap.add_argument("--out", default=None, help="output .pth (default: <exp_dir>/<prefix>.pth)")
    args = ap.parse_args(argv)
    out = export(args.exp_dir, args.prefix, args.config, args.out)
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
