#!/usr/bin/env python3
"""Per-kernel device-time profile of the port's train step on the card, the
counterpart of ``scripts/profile_train_step.py``.

Runs the same steps as that script: the ModelNet40 finetune step at B=32,
1024 points, bf16 with the subspace eigensolver; ``--ssd`` the SSD mixer
(its plain route), ``--ssd-fused`` the SSD mixer on the kernels at chunk 256
(on the card a geometry they do not take raises, so no plain route is
profiled under that name);
``--hardest`` the cfgs/finetune_scan_hardest.yaml geometry (2048 points,
128 groups, 15 classes); ``--pretrain`` the MAE pretraining step at B=128,
bf16 with the Jacobi wavelet bases (K_STEPS / 2 steps, as there). It times
K_STEPS steps by the host clock, ended by a synchronise, then profiles
K_STEPS more under ``torch.profiler`` (``si_mamba_tpu_torch/utils/
profiling.trace``; with ``--trace`` its Chrome trace too) and sums the device-side events only: kernels, memcpys and
memsets. Those are leaves, so no time is counted twice (the JAX script had to
drop its ``while`` wrappers for that; ``control_flow_wrapper_ms_per_step`` is
0 here). Categories follow the card's kernel names (``CATS``): the port's own
kernels by family (conv K1/K5, scan K2-K4, SSD K6-K9, fused mixer K10/K11),
cuBLAS / CUTLASS GEMMs, cuSOLVER's eigh and QR, sort and top-k, elementwise
and reductions, copies.

The JSON holds the JAX script's keys (``step_wall_ms``,
``leaf_device_ms_per_step``, ``control_flow_wrapper_ms_per_step``, ``note``,
``categories_ms``, ``top_ops_ms``, ``top_ops_by_category``), each op with its
calls per step beside its time, under the JAX script's file names in
``--out`` (default ``chiprun_out/profiles/``), never under ``benchmarks/``.
With ``--device cpu`` it runs on the CPU and sums each operator's own CPU
time instead (a rehearsal; no device time). It imports no JAX.

    python scripts/torch_profile_train_step.py [--pretrain] [--ssd | --ssd-fused]
        [--hardest] [--out DIR] [--device cuda|cpu] [--trace]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

K_STEPS = 10

# (category, predicate on the kernel's name), the first that matches wins:
# the port's kernels by family first (their names are the csrc/ functions)
CATS = [
    ("conv_kernels", lambda n: "causal_conv1d" in n or "conv_any_" in n),
    ("scan_kernels", lambda n: "selective_scan" in n or "scan_any_" in n
     or "::scan_fwd<" in n or "::scan_bwd(" in n),
    ("ssd_kernels", lambda n: any(f"::{k}<" in n for k in (
        "fwd_prep", "fwd_carry", "fwd_y", "bwd_prep", "bwd_carry", "bwd_dgm", "bwd_dx",
        "bwd_dbc", "bwd_ds"))),
    ("fused_mixer_kernels", lambda n: "fused_mixer" in n or "gemm_f32(" in n
     or "sum_parts(" in n),
    ("eigh_qr", lambda n: any(k in n.lower() for k in (
        "syev", "geqr", "orgqr", "ormqr", "potrf", "trsm", "larf", "sytrd", "stedc", "steqr",
        "cusolver", "lapack", "jacobi", "householder"))),
    ("matmul", lambda n: any(k in n.lower() for k in (
        "gemm", "xmma", "cutlass", "cublas", "gemv", "sm90_", "sm80_", "ampere_", "hopper_",
        "dot_kernel", "splitk", "aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm"))
     or "nvjet" in n),
    ("sort_topk", lambda n: any(k in n.lower() for k in ("sort", "topk", "top_k", "radix",
                                                         "bitonic"))),
    ("copy", lambda n: any(k in n.lower() for k in ("memcpy", "memset", "copy", "cat_",
                                                    "transpose", "gather", "scatter",
                                                    "index"))),
    ("elementwise_reduce", lambda n: any(k in n.lower() for k in (
        "elementwise", "reduce", "norm", "softmax", "foreach", "multi_tensor", "adam", "fill",
        "arange", "cumsum", "scan"))),
]


def categorize(name: str) -> str:
    for cat, pred in CATS:
        if pred(name):
            return cat
    return "other"


def _finetune(device, mixer: str, scan_impl: str | None, hardest: bool, over: dict):
    """(one step returning its loss, steps to profile): the finetune step of
    ``scripts/profile_train_step.py:capture``."""
    from si_mamba_tpu_torch.models import PointMamba, PointMambaConfig
    from si_mamba_tpu_torch.train.optim import build_optimizer
    from si_mamba_tpu_torch.train.train_state import TrainState, make_classifier_train_step

    B, N = over.pop("batch", 32), over.pop("points", 1024)
    kw = {"scan_impl": scan_impl} if scan_impl else {}
    if scan_impl == "ssd_fused":
        kw["ssd_chunk"] = 256  # the measured presets' chunk
    if hardest:
        N = 2048
        kw.update(num_group=128, cls_dim=15)
    cfg = PointMambaConfig.from_dict(dict(dtype="bfloat16", spectral_method="subspace",
                                          mixer=mixer, **kw, **over))
    model = PointMamba(cfg, generator=torch.Generator().manual_seed(0)).to(device)
    rng = np.random.default_rng(0)
    pts = torch.from_numpy(rng.standard_normal((B, N, 3)).astype(np.float32)).to(device)
    labels = torch.from_numpy(rng.integers(0, cfg.cls_dim, B).astype(np.int64)).to(device)
    optimizer, _ = build_optimizer(model, lr=3e-4, epochs=300, warmup_epochs=10,
                                   steps_per_epoch=300)
    state = TrainState.create(model, optimizer)
    step_fn = make_classifier_train_step(model)
    generator = torch.Generator(device).manual_seed(1)

    def step():
        return step_fn(state, pts, labels, generator)[1]["loss"]

    return step, K_STEPS


def _pretrain(device, mixer: str, scan_impl: str | None, over: dict):
    """(one step returning its loss, steps to profile): the pretraining step
    of ``scripts/profile_train_step.py:capture_pretrain``, K_STEPS / 2 steps."""
    from si_mamba_tpu_torch.models.point_mae import PointMAEConfig, PointMAEMamba
    from si_mamba_tpu_torch.train.optim import build_optimizer
    from si_mamba_tpu_torch.train.runner_pretrain import make_pretrain_step
    from si_mamba_tpu_torch.train.train_state import TrainState

    B, N = over.pop("batch", 128), over.pop("points", 1024)
    kw = {"scan_impl": scan_impl} if scan_impl else {}
    cfg = PointMAEConfig(dtype="bfloat16", wavelet_solver="jacobi", mixer=mixer, **kw, **over)
    with torch.device(device):
        model = PointMAEMamba(cfg, generator=torch.Generator(device).manual_seed(0))
    rng = np.random.default_rng(0)
    pts = torch.from_numpy(rng.standard_normal((B, N, 3)).astype(np.float32)).to(device)
    optimizer, _ = build_optimizer(model, lr=1e-3, epochs=300, warmup_epochs=10,
                                   steps_per_epoch=400)
    state = TrainState.create(model, optimizer)
    step_fn = make_pretrain_step(model)
    generator = torch.Generator(device).manual_seed(3)

    def step():
        return step_fn(state, pts, generator, 0.5)[1]["loss"]

    return step, max(1, K_STEPS // 2)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def capture(device, *, pretrain: bool = False, mixer: str = "mamba",
            scan_impl: str | None = None, hardest: bool = False, over: dict | None = None,
            trace_dir: str | None = None):
    """Warm up, time ``steps`` steps, then profile ``steps`` more (the
    Chrome trace written under ``trace_dir`` unless it is None). Returns
    (wall ms a step, steps, {kernel name: (total us, calls)})."""
    from si_mamba_tpu_torch.utils.profiling import trace

    over = dict(over or {})
    step, steps = (_pretrain(device, mixer, scan_impl, over) if pretrain
                   else _finetune(device, mixer, scan_impl, hardest, over))
    losses = [step()]
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(steps):
        losses.append(step())
    _sync(device)
    wall_ms = (time.perf_counter() - t0) / steps * 1e3
    if not all(np.isfinite(float(v)) for v in losses):
        raise RuntimeError(f"a step's loss is not finite: {[float(v) for v in losses]}")
    on_card = torch.device(device).type == "cuda"
    # on the card only the device's events (kernels, copies, sets) are summed
    with trace(trace_dir) as prof:
        for _ in range(steps):
            step()
        _sync(device)
    events = {}
    for evt in prof.key_averages():
        if on_card:
            if "CUDA" not in str(getattr(evt, "device_type", "")):
                continue
            us = getattr(evt, "self_device_time_total", None)
            if us is None:
                us = evt.self_cuda_time_total
        else:
            us = evt.self_cpu_time_total
        if us > 0:
            total, calls = events.get(evt.key, (0.0, 0))
            events[evt.key] = (total + us, calls + evt.count)
    return wall_ms, steps, events


def summarize(wall_ms: float, steps: int, events: dict, on_card: bool) -> dict:
    """The JSON of ``scripts/profile_train_step.py`` from a capture: every
    time in ms a step, each op with its calls a step."""
    rows = sorted(events.items(), key=lambda kv: -kv[1][0])
    per_step = lambda us: us / 1e3 / steps  # noqa: E731
    cats = {}
    for name, (us, _) in rows:
        c = categorize(name)
        cats[c] = cats.get(c, 0.0) + per_step(us)

    def op(name, us, calls):
        return {"op": name[:120], "ms": round(per_step(us), 4), "calls": calls / steps}

    return {
        "step_wall_ms": round(wall_ms, 3),
        "leaf_device_ms_per_step": round(per_step(sum(us for us, _ in events.values())), 3),
        "control_flow_wrapper_ms_per_step": 0.0,
        "note": ("device-side kernel, memcpy and memset events only (leaves: no wrapper "
                 "double-books them); calls a step beside each op"
                 if on_card else "CPU rehearsal: each operator's own CPU time, no device time"),
        "categories_ms": {k: round(v, 3) for k, v in sorted(cats.items(), key=lambda kv: -kv[1])},
        "top_ops_ms": [op(name, us, calls) for name, (us, calls) in rows[:60]],
        "top_ops_by_category": {
            cat: [op(name, us, calls) for name, (us, calls) in rows
                  if categorize(name) == cat][:40]
            for cat in sorted({categorize(n) for n, _ in rows})},
    }


def file_name(pretrain: bool, ssd: bool, ssd_fused: bool, hardest: bool) -> str:
    """The JAX script's file name for this flag combination."""
    geo = "pretrain" if pretrain else "hardest" if hardest else None
    variant = "ssd_fused" if ssd_fused else "ssd" if ssd else None
    if geo and variant:
        return f"profile_{geo}_{variant}_step.json"
    if geo:
        return f"profile_{geo}_step.json"
    if variant:
        return f"profile_{variant}_step.json"
    return "profile_train_step.json"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pretrain", action="store_true")
    ap.add_argument("--ssd", action="store_true")
    ap.add_argument("--ssd-fused", action="store_true")
    ap.add_argument("--hardest", action="store_true")
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "profiles"))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--trace", action="store_true",
                    help="also write the Chrome trace under <out>/traces (tens of MB)")
    args = ap.parse_args(argv)
    out_dir = Path(args.out).resolve()
    if out_dir == (ROOT / "benchmarks").resolve() or (ROOT / "benchmarks").resolve() in \
            out_dir.parents:
        raise SystemExit("the profiles go to chiprun_out/, not under benchmarks/")
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu for a rehearsal on the CPU")
    device = torch.device("cuda", 0) if args.device == "cuda" else torch.device("cpu")
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    mixer = "ssd" if (args.ssd or args.ssd_fused) else "mamba"
    wall_ms, steps, events = capture(device, pretrain=args.pretrain, mixer=mixer,
                                     scan_impl="ssd_fused" if args.ssd_fused else None,
                                     hardest=args.hardest,
                                     trace_dir=str(out_dir / "traces") if args.trace else None)
    out = summarize(wall_ms, steps, events, device.type == "cuda")
    out_dir.mkdir(parents=True, exist_ok=True)
    dst = out_dir / file_name(args.pretrain, args.ssd, args.ssd_fused, args.hardest)
    dst.write_text(json.dumps(out, indent=1))
    print(json.dumps({"step_wall_ms": out["step_wall_ms"],
                      "leaf_ms": out["leaf_device_ms_per_step"],
                      "categories": out["categories_ms"]}, indent=1))
    print(f"written: {dst}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
