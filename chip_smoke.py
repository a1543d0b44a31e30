#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``si_mamba_tpu_torch``).

Run from the repository root on a machine with one CUDA GPU:

    python3 chip_smoke.py

It needs ``nvcc`` (the CUDA toolkit) and builds the kernels from
``si_mamba_tpu_torch/csrc`` into ``build/``. Phases, each fatal on failure:

1. device: requires CUDA, prints ``nvidia-smi``'s name and power limit, turns
   TF32 off for matmuls and convolutions;
2. build: both CUDA sources, one ``nvcc`` each, in parallel;
3. kernels: at the serving path's full-width shapes (B=32, L=512, d_inner=768,
   d_state=16, fp32, strided views as the mixer makes them) each kernel is
   held against its plain PyTorch version on the card and timed beside it
   (and, for the conv, beside ``F.conv1d(groups=D)`` + ``F.silu``);
4. serving: a ``Predictor`` over the ModelNet40 ``PointMamba`` (12 x 384,
   L=512, seeded random weights) answers requests of 1, 20 and 64 clouds of
   1024 points; every forward must launch each kernel 12 times, and its
   logits must match a second model with the plain scan (``scan_impl='seq'``)
   on the same card;
5. profile: for each request size, the median over 10 forwards of the
   model's three pieces (``embed``: FPS, kNN, patch encoder, pos-embed;
   ``sequence``: graph, ``eigh``, SAST ordering; ``classify``: the Mamba stack
   and the head), each ended by ``torch.cuda.synchronize()`` and so including
   its launch cost; then one forward under ``torch.profiler``: device time by
   kernel name (top 8), the summed kernel and copy time, and its share of the
   forward's wall time (the device's busy share).

The last four lines of standard output are the serving and profile record,
the kernels' record (each one JSON object), the card's name and power limit,
and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent

# The published ModelNet40 finetune model (cfgs/finetune_modelnet.yaml, model
# section), in eval mode; written out because the card's host has no pyyaml.
MODELNET40 = dict(trans_dim=384, depth=12, cls_dim=40, group_size=32, num_group=64,
                  encoder_dims=384, rms_norm=False, drop_path=0.3, drop_out=0.0,
                  method="SAST", reverse=True, knn_graph=20, k_top_eigenvectors=4,
                  alpha=100.0, smallest=True, symmetric=True, self_loop=False,
                  binary=True, matrix="laplacian", add_after_layer=False)
NPOINTS = 1024
REQUEST_SIZES = (1, 20, 64)
REPEATS = 5
PROFILE_REPEATS = 10

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and fp32 (non-tensor) op/s.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(bytes_moved: float, ops: float) -> tuple[float, str]:
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def mixer_inputs(device):
    """The conv's and the scan's inputs as layer 0's mixer makes them, at
    B=32, L=512 (views into xz and x_dbl, as on the serving path)."""
    from si_mamba_tpu_torch.models.layers import MambaMixer

    mixer = MambaMixer(MODELNET40["trans_dim"], out_proj_div=MODELNET40["depth"] ** 0.5)
    mixer.reset_parameters(torch.Generator().manual_seed(1))
    p = {k: v.detach().to(device) for k, v in mixer.params().items()}
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((32, 512, MODELNET40["trans_dim"]),
                                             dtype=np.float32)).to(device)
    xz = x @ p["in_proj_w"]
    return mixer, p, xz


def kernel_phase(device) -> list[dict]:
    from si_mamba_tpu_torch.ops.kernels.causal_conv import causal_conv1d_ref, causal_conv1d_silu
    from si_mamba_tpu_torch.ops.kernels.selective_scan import (
        selective_scan_fwd,
        selective_scan_ref,
    )

    mixer, p, xz = mixer_inputs(device)
    d_inner, n, dt_rank = mixer.d_inner, mixer.d_state, mixer.dt_rank
    xi, z = xz[..., :d_inner], xz[..., d_inner:]
    B, L, D = xi.shape
    W = p["conv_w"].shape[1]
    records = []

    # K1: causal conv + SiLU
    y1 = causal_conv1d_silu(xi, p["conv_w"], p["conv_b"])
    y1_ref = causal_conv1d_ref(xi, p["conv_w"], p["conv_b"])
    torch.cuda.synchronize()
    err1 = (y1 - y1_ref).abs().max().item()
    if not torch.allclose(y1, y1_ref, rtol=1e-5, atol=1e-6):
        raise AssertionError(f"causal-conv kernel disagrees with its plain version: "
                             f"max |diff| {err1}")
    conv_w3 = p["conv_w"][:, None, :]
    xi_t = xi.transpose(1, 2)
    lib = lambda: F.silu(F.conv1d(xi_t, conv_w3, p["conv_b"], padding=W - 1, groups=D)[..., :L])
    bound_ms, bound_by = bound(2 * B * L * D * 4 + D * (W + 1) * 4, B * L * D * (2 * W + 5))
    records.append(dict(
        name="causal_conv1d_silu", route="cuda",
        source="si_mamba_tpu_torch/csrc/causal_conv.cu",
        replaces="si_mamba_tpu/ops/pallas/causal_conv_kernel.py:52",
        max_abs_err=err1,
        ms=time_ms(lambda: causal_conv1d_silu(xi, p["conv_w"], p["conv_b"]), 50),
        plain_ms=time_ms(lambda: causal_conv1d_ref(xi, p["conv_w"], p["conv_b"]), 20),
        library_ms=time_ms(lib, 20), bound_ms=bound_ms, bound_by=bound_by))
    log(f"causal conv ok: max |diff| {err1:.3e}")

    # K2: selective scan forward, on the conv's output as on the path
    x_dbl = y1 @ p["x_proj_w"]
    dt = x_dbl[..., :dt_rank] @ p["dt_proj_w"]
    Bc, Cc = x_dbl[..., dt_rank:dt_rank + n], x_dbl[..., dt_rank + n:]
    A = -torch.exp(p["A_log"])
    args = (y1, dt, A, Bc, Cc, p["D"], z, p["dt_proj_b"])
    y2 = selective_scan_fwd(*args)
    y2_ref = selective_scan_ref(*args[:5], D=p["D"], z=z, delta_bias=p["dt_proj_b"])
    torch.cuda.synchronize()
    err2 = (y2 - y2_ref).abs().max().item()
    scale = y2_ref.abs().max().item()
    if not torch.allclose(y2, y2_ref, rtol=1e-4, atol=1e-5 * scale):
        raise AssertionError(f"selective-scan kernel disagrees with its plain version: "
                             f"max |diff| {err2}, max |y| {scale}")
    # bytes: u, dt, z, B, C read once, y written once, plus A, D, dt_bias;
    # operations per (b, l, d): softplus 4, skip + gate 6, and per state 7
    # (exp, 2 mul, 2 fma) with each exp counted as one operation
    scan_bytes = (4 * B * L * D + 2 * B * L * n + D * n + 2 * D) * 4
    bound_ms, bound_by = bound(scan_bytes, B * L * D * (10 + 7 * n))
    records.append(dict(
        name="selective_scan_fwd", route="cuda",
        source="si_mamba_tpu_torch/csrc/selective_scan_fwd.cu",
        replaces="si_mamba_tpu/ops/pallas/selective_scan_kernel.py:115",
        max_abs_err=err2,
        ms=time_ms(lambda: selective_scan_fwd(*args), 20),
        plain_ms=time_ms(lambda: selective_scan_ref(*args[:5], D=p["D"], z=z,
                                                    delta_bias=p["dt_proj_b"]), 2, warmup=1),
        library_ms=None, bound_ms=bound_ms, bound_by=bound_by))
    log(f"selective scan ok: max |diff| {err2:.3e} (max |y| {scale:.3e})")
    for r in records:
        r["kernel_ms"] = r["ms"]
    return records


def clouds(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    pts = rng.standard_normal((n, NPOINTS, 3)).astype(np.float32)
    return pts / np.abs(pts).max(axis=(1, 2), keepdims=True)


def serving_phase(device) -> tuple[dict, dict]:
    from si_mamba_tpu_torch.models import PointMamba, PointMambaConfig
    from si_mamba_tpu_torch.ops.kernels.causal_conv import causal_conv1d_silu
    from si_mamba_tpu_torch.ops.kernels.selective_scan import selective_scan_fwd
    from si_mamba_tpu_torch.serving import Predictor

    cfg = PointMambaConfig.from_dict(MODELNET40)
    model = PointMamba(cfg, generator=torch.Generator().manual_seed(0))
    predictor = Predictor(model, npoints=NPOINTS, max_batch=64, device=device)
    predictor.warmup()
    requests = {n: clouds(n, seed=n) for n in REQUEST_SIZES}

    # the main path: counts from 0, then only the requests
    causal_conv1d_silu.launches = selective_scan_fwd.launches = 0
    latency, logits, forwards = {}, {}, 0
    for n, batch in requests.items():
        times = []
        for _ in range(REPEATS):
            t0 = time.perf_counter()
            out = predictor.logits(batch)  # returns host numpy: synchronised
            times.append(time.perf_counter() - t0)
            forwards += -(-n // predictor.max_batch)
        if out.shape != (n, cfg.cls_dim) or not np.isfinite(out).all():
            raise AssertionError(f"bad logits for a request of {n}: {out.shape}")
        latency[n], logits[n] = times, out
    launches = {"causal_conv1d_silu": causal_conv1d_silu.launches,
                "selective_scan_fwd": selective_scan_fwd.launches}
    for name, count in launches.items():
        if count != cfg.depth * forwards:
            raise AssertionError(f"{name} launched {count} times in {forwards} forwards; "
                                 f"expected {cfg.depth} per forward")
    log(f"served {forwards} forwards; launches {launches}")

    # the same weights with the plain scan and conv, on the same card
    seq_model = PointMamba(PointMambaConfig.from_dict({**MODELNET40, "scan_impl": "seq"}))
    seq_model.load_state_dict(model.state_dict(), strict=True)
    seq = Predictor(seq_model, npoints=NPOINTS, max_batch=64, device=device)
    n_cmp = 20
    ref = seq.logits(requests[n_cmp])
    scale = float(np.abs(ref).max())
    err = float(np.abs(logits[n_cmp] - ref).max())
    if not np.allclose(logits[n_cmp], ref, atol=1e-3 * scale, rtol=2e-3):
        raise AssertionError(f"kernel logits disagree with the plain scan: max |diff| "
                             f"{err}, max |logit| {scale}")
    with torch.inference_mode():
        pts = torch.from_numpy(requests[n_cmp]).to(device)
        _, feat = predictor.model(pts, return_features=True)
        _, feat_ref = seq_model(pts, return_features=True)
    feat_err = (feat - feat_ref).abs().max().item()
    feat_scale = feat_ref.abs().max().item()
    if not torch.allclose(feat, feat_ref, atol=1e-3 * feat_scale, rtol=2e-3):
        raise AssertionError(f"pooled features disagree with the plain scan: max |diff| "
                             f"{feat_err}, max |feature| {feat_scale}")
    log(f"kernel path == plain path on {n_cmp} clouds: logits max |diff| {err:.3e} "
        f"(max |logit| {scale:.3e}), features max |diff| {feat_err:.3e} "
        f"(max |feature| {feat_scale:.3e})")

    serving = {}
    for n, times in latency.items():
        p50 = statistics.median(times)
        serving[str(n)] = {"p50_ms": p50 * 1e3, "clouds_per_s": n / p50,
                           "latencies_ms": [t * 1e3 for t in times]}
        log(f"request of {n:2d} clouds: p50 {p50 * 1e3:.3f} ms, {n / p50:.2f} clouds/s")
    return launches, serving, predictor.model, requests


def piece_times(model, pts) -> dict[str, float]:
    """One forward through the model's own pieces, ms per piece."""
    out, t = {}, time.perf_counter()

    def mark(name):
        nonlocal t
        torch.cuda.synchronize()
        now = time.perf_counter()
        out[name] = (now - t) * 1e3
        t = now

    tokens, pos, center = model.embed(pts)
    mark("embed")
    x, pos_seq = model.sequence(tokens, pos, center)
    mark("sequence")
    model.classify(x, pos_seq)
    mark("classify")
    return out


def device_profile(model, pts) -> dict:
    """One forward under torch.profiler: device-side events (kernels,
    copies) only, since an operator's own row repeats its kernels' time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model(pts)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.count, e.self_device_time_total / 1e3) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[2])
    device_ms = sum(r[2] for r in rows)
    if device_ms <= 0:
        raise AssertionError("the profiler saw no device time in a forward on the card")
    return {"wall_ms": wall_ms, "device_ms": device_ms, "busy_share": device_ms / wall_ms,
            "top": [{"name": k[:90], "count": c, "device_ms": ms} for k, c, ms in rows[:8]]}


def profile_phase(model, requests) -> dict:
    device = next(model.parameters()).device
    result = {}
    with torch.inference_mode():
        for n, batch in requests.items():
            pts = torch.from_numpy(batch).to(device)
            for _ in range(2):
                piece_times(model, pts)
            runs = [piece_times(model, pts) for _ in range(PROFILE_REPEATS)]
            med = {k: statistics.median(r[k] for r in runs) for k in runs[0]}
            prof = device_profile(model, pts)
            result[str(n)] = {"piece_ms_median": med, "profile": prof}
            log(f"{n:2d} clouds: " + ", ".join(f"{k} {v:.3f} ms" for k, v in med.items()) +
                f"; device {prof['device_ms']:.3f} of {prof['wall_ms']:.3f} ms wall "
                f"(busy {prof['busy_share']:.3f})")
            for row in prof["top"]:
                log(f"    {row['device_ms']:9.3f} ms  x{row['count']:<5d} {row['name']}")
    return result


def main() -> int:
    if not (ROOT / "si_mamba_tpu_torch" / "csrc").is_dir():
        raise SystemExit("chip_smoke: run it from a checkout of the repository "
                         "(si_mamba_tpu_torch/ is missing)")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs on the GPU only")
    from si_mamba_tpu_torch.ops.kernels.build import build

    device = torch.device("cuda", 0)
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    log(f"tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, "
        f"cudnn {torch.backends.cudnn.allow_tf32}")

    t0 = time.perf_counter()
    for name, out in build().items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"{name}: {line.strip()}")
    log(f"kernels built in {time.perf_counter() - t0:.1f} s")

    records = kernel_phase(device)
    launches, serving, model, requests = serving_phase(device)
    for r in records:
        r["launches"] = launches[r["name"]]
    profile = profile_phase(model, requests)
    print(json.dumps({"serving": serving, "profile": profile, "card": card}), flush=True)
    print(json.dumps({"kernels": records}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
