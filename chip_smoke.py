#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``si_mamba_tpu_torch``).

Run from the repository root on a machine with one CUDA GPU:

    python3 chip_smoke.py

It needs ``nvcc`` (the CUDA toolkit) and builds the kernels from
``si_mamba_tpu_torch/csrc`` into ``build/``. Phases, each fatal on failure:

1. device: requires CUDA, prints ``nvidia-smi``'s name and power limit, turns
   TF32 off for matmuls and convolutions;
2. build: the seven CUDA sources, one ``nvcc`` each, in parallel, before
   any rank of phases 11-14 starts;
3. kernels: at the serving path's full-width shapes (B=32, L=512, d_inner=768,
   d_state=16, fp32, strided views as the mixer makes them) each kernel is
   held against its plain PyTorch version on the card and timed beside it:
   the conv forward and, for a seeded output gradient, its backward (both
   also beside ``F.conv1d(groups=D)`` + ``F.silu`` and its autograd
   backward; the backward run twice, bitwise equal, and also timed as
   CUDA-graph device time), the lean scan forward (also at B = 1, 20 and 64,
   the serving request sizes; each timed as back-to-back calls and as
   CUDA-graph device time), the scan forward that keeps its tile entry states (its y equal to
   the lean kernel's, its states to the plain version's) and the scan
   backward (every gradient against the plain backward, two runs bitwise
   equal);
4. SSD kernels: at the SSD mixer's shapes (B=32, L=512, chunk 256, 6 heads,
   n = p = 128, fp32): the conv forward and backward at width 1024 on the
   column view of the (32, 512, 1798) ``in_proj`` output (row stride 1798),
   then the SSD core's lean forward (also at B = 1, 20 and 64, the serving
   request sizes), its forward with states (y equal, states against the
   plain version) and its backward for a seeded output gradient (two runs
   bitwise equal), each within 1e-4 of its plain version's max and timed
   beside it as back-to-back calls and as CUDA-graph device time; their
   ``bound_ms`` at the rate their 3xTF32 tensor-core products can use (three
   TF32 products for each against the dense TF32 peak), and in the log
   beside it the bound at the fp32 rate of the CUDA cores; then the conv
   forward and backward, held and timed the same way, at the tensor-parallel
   SSD step's two contiguous conv operands on each rank (the 384-wide x shard
   and the 256-wide B|C at B=32, L=512), whose backward runs other time tiles;
4b. fused-mixer kernels: at the serving path's shapes, with xz as layer 0's
   ``in_proj`` makes it, the whole-mixer forward lean and with its chunk
   entry states (y equal, states against the plain version; the lean one
   also at B = 1, 20 and 64, as back-to-back calls and as CUDA-graph device
   time) and its
   backward for a seeded output gradient (every gradient against the plain
   backward, two runs bitwise equal), each timed beside its plain version;
   then the same interior through the per-op route (K1, the x_proj and
   dt_proj GEMMs, K2; with a gradient K1/K3 forward and K4/K5 + the GEMMs'
   autograd backward) and through ``fused_mamba_mixer``, each timed without
   a gradient, as a training forward and as the backward alone;
4c. split SSD kernels: at the tensor-parallel shard's shapes (B=32, L=512,
   chunk 256, 3 heads of 128, d_state 128; x the x conv's output, B and C the
   halves of the B|C conv's output, row stride 256, as ``ssd_mixer_tp``
   makes them) the split forward lean, with states, with the final state and
   with both (the same y from each) and the backward from 0 and seeded with a
   final-state cotangent (two runs bitwise equal), each within 1e-4 of its
   plain version's max and timed beside it as back-to-back calls and as
   CUDA-graph device time, with ``bound_ms`` at the 3xTF32 rate as in phase
   4; every variant held again at chunk 128 (4 chunks); then the lean
   forward and the backward at 6 heads on the full mixer's column groups,
   beside K8/K9 on the same block;
5. serving: a ``Predictor`` over the ModelNet40 ``PointMamba`` (12 x 384,
   L=512, seeded random weights) answers requests of 1, 20 and 64 clouds of
   1024 points; every forward must launch the conv and lean scan kernels 12
   times each and no other kernel, and its logits must match a second model
   with the plain scan (``scan_impl='seq'``) on the same card;
6. profile: for each request size, the median over 10 forwards of the
   model's three pieces (``embed``: FPS, kNN, patch encoder, pos-embed;
   ``sequence``: graph, ``eigh``, SAST ordering; ``classify``: the Mamba stack
   and the head), each ended by ``torch.cuda.synchronize()`` and so including
   its launch cost; then one forward under ``torch.profiler``: device time by
   kernel name (top 8), the summed kernel and copy time, and its share of the
   forward's wall time (the device's busy share);
7. train: ``make_train_step`` over the same model at its training settings
   (drop_path 0.3, head dropout 0.5), AdamW at the timm stepped cosine
   (lr 3e-4, wd 0.05, 300 epochs with 10 of warm-up, clip 10, 2 steps an
   epoch), TRAIN_STEPS steps at batch 32 on 8192-point clouds (FPS to 1200,
   1024 kept, scale + translate). Every step must launch the conv forward and
   backward and the training scan forward and backward 12 times each and no
   other kernel, give a finite loss, and move every mixer parameter and the
   BatchNorm statistics; then an eval forward must take the lean scan again.
   p50 step time, clouds/s and peak memory are printed, then one more step
   timed as the two halves that the step composes (the input pipeline;
   forward, backward and optimizer) and one under ``torch.profiler``, which
   also gives the device time of building the in_proj output's gradient from
   its column views' gradients (autograd's slice backward and the adds)
   beside the conv backward's own;
8. gradients: one train-mode step's loss and every parameter gradient of the
   kernel path against the plain path (``scan_impl='seq'``), same weights and
   clouds, drop rates 0, at B=4, within 1e-3 of the largest gradient;
9. the SSD classifier (``mixer='ssd'``, ``scan_impl='ssd_fused'``, chunk 256:
   the ModelNet40 model with the SSD lines of
   cfgs/finetune_modelnet_ssd_fused.yaml, fp32, exact ``eigh``) through
   phases 5-8: each serving forward must launch the conv and the lean SSD
   forward 12 times each and nothing else, its logits match
   ``scan_impl='xla'``; each train step launch the conv forward and backward,
   the SSD forward with states and the SSD backward 12 times each and nothing
   else; the B=4 gradients match ``scan_impl='xla'``;
10. the whole-mixer route (the Mamba-1 model with ``scan_impl='fused'``)
   through phases 5-8: each serving forward must launch the lean fused
   forward 12 times and nothing else (neither the conv nor the scan), its
   logits match ``scan_impl='seq'``; each train step launch the fused forward
   with states and the fused backward 12 times each and nothing else, and an
   eval forward after them the lean one; the B=4 gradients match 'seq'.
11-14. the parallel paths, on 2 ranks: processes spawned on the one card with
   a ``gloo`` group (NCCL refuses two ranks on one device) over a file
   rendezvous in ``build/``. 11: the SSD classifier with its mixers over a
   2-rank model axis (3 heads a rank, weights cut from the single-process
   model's by ``shard_state_dict``) serves requests of 1, 20 and 64 clouds;
   each forward must launch the conv 24 times and the lean split forward 12
   times, nothing else (no K8), its logits match the single-process 'xla'
   model. 12: TRAIN_STEPS TP train steps at batch 32 from 8192-point clouds,
   each launching the conv forward and backward 24 times and the split
   forward with states and the split backward 12 times, nothing else, the
   same finite losses on both ranks, every parameter and statistic moved;
   then at B=4, drop rates 0, a global-norm clip at half the norm: the
   gradients gathered over the ranks match the single-process 'xla' model's.
   13: ``ssd_seq_parallel(impl='ssd_fused')`` over a 2-rank seq axis (B=32,
   L=512, 6 heads, chunk 128): the split forward with the final state once a
   rank without a gradient, with one the forward with states and final state
   and the seeded backward; y and every gradient against the single-process
   plain ``ssd_chunked``. 14: one forward of the Mamba-1 model with its
   mixers over the model axis (``scan_impl='pallas'``): the conv and the lean
   scan 12 times a rank, logits matching 'seq'. A rank that fails fails the
   script.
15. the finetune harness (before phases 11-14, in this process): the port's
   CLI (``si_mamba_tpu_torch.train.cli.main``) on a ModelNet40-format tree
   written under build/harness/ from a seed (64 train clouds, 40 test
   clouds, 8192 points with normals) with cfgs/finetune_modelnet.yaml at
   max_epoch 1: the FPS caches built on the card, then the finetune (epochs 0
   and 1 of two steps at batch 32, a validation after each; every step must
   launch the conv forward and backward and the training scan forward and
   backward 12 times each and nothing else, every eval forward the conv and
   the lean scan 12 times each; losses finite; ckpt-best.pth, ckpt-last.pth,
   config.yaml and scalars.jsonl written, the snapshot reading back to the
   config), ``--test`` of ckpt-last.pth (the last validation's accuracy and
   logits), ``--resume`` of the finished run (epoch 1 restored, no kernel
   launched) and one ``validate_vote`` of 10 passes (the eval kernels 12 x 10
   times a batch).

Each path (serving, train, SSD serving, SSD train, fused serving, fused
train, the harness's finetune, test and vote runs, and on each rank TP SSD
serving, TP SSD train, SP, SP train, TP Mamba-1 serving) is driven with every
launch count set to 0 just before it and read just after. The last five
lines of standard output are the harness's record, the serving, profile,
train and gradient record of the three models, the kernels' record (each one
JSON object; every kernel names its ``main_path`` and its launches on every
path, rank 0's for the parallel paths), the card's name and power limit, and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import pickle
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
# The SSD classifier: the same model with the SSD lines of
# cfgs/finetune_modelnet_ssd.yaml:12 and cfgs/finetune_modelnet_ssd_fused.yaml:11,15,
# at fp32 with exact eigh (the preset's bf16 and subspace switches are perf mode).
MODELNET40_SSD = dict(MODELNET40, mixer="ssd", ssd_chunk=256, scan_impl="ssd_fused")
# The whole-mixer route: the ModelNet40 model with scan_impl 'fused' (the JAX
# package's opt-in `mamba_mixer_apply(impl='fused')`).
MODELNET40_FUSED = dict(MODELNET40, scan_impl="fused")
NPOINTS = 1024
REQUEST_SIZES = (1, 20, 64)
REPEATS = 5
PROFILE_REPEATS = 10
TRAIN_BATCH = 32
TRAIN_POINTS = 8192
TRAIN_STEPS = 8
PARITY_BATCH = 4
GRAD_TOL = 1e-3
# the kernels of the Mamba-1 main path: a train step's, an eval forward's
TRAIN_KERNELS = ("causal_conv1d_silu", "selective_scan_fwd_residuals", "selective_scan_bwd",
                 "causal_conv1d_silu_bwd")
EVAL_KERNELS = ("causal_conv1d_silu", "selective_scan_fwd")

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, fp32 (non-tensor) op/s and
# dense TF32 tensor-core op/s.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
TF32_OPS_PER_S = 495e12


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


def graph_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` calls captured in one CUDA
    graph and replayed (CUDA events): the kernels' own time, without the
    host's cost of each call, which exceeds a small launch's device time."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(bytes_moved: float, ops: float, ops_per_s: float = FP32_OPS_PER_S) -> tuple[float, str]:
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S * 1e3, ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def mixer_inputs(device, batch: int = 32):
    """The conv's and the scan's inputs as layer 0's mixer makes them, at
    B=batch, L=512 (views into xz and x_dbl, as on the serving path)."""
    from si_mamba_tpu_torch.models.layers import MambaMixer

    mixer = MambaMixer(MODELNET40["trans_dim"], out_proj_div=MODELNET40["depth"] ** 0.5)
    mixer.reset_parameters(torch.Generator().manual_seed(1))
    p = {k: v.detach().to(device) for k, v in mixer.params().items()}
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((batch, 512, MODELNET40["trans_dim"]),
                                             dtype=np.float32)).to(device)
    xz = x @ p["in_proj_w"]
    return mixer, p, xz


def scan_operands(device, batch: int = 32) -> tuple:
    """The scan's inputs (u, dt, A, B, C, D, z, dt_bias) as layer 0's mixer
    makes them at B=batch, L=512: u the conv kernel's output, B and C column
    views of x_dbl, z the column view of xz."""
    from si_mamba_tpu_torch.ops.kernels.causal_conv import causal_conv1d_silu_fwd

    mixer, p, xz = mixer_inputs(device, batch)
    d_inner, n, dt_rank = mixer.d_inner, mixer.d_state, mixer.dt_rank
    u = causal_conv1d_silu_fwd(xz[..., :d_inner], p["conv_w"], p["conv_b"])
    x_dbl = u @ p["x_proj_w"]
    dt = x_dbl[..., :dt_rank] @ p["dt_proj_w"]
    return (u, dt, -torch.exp(p["A_log"]), x_dbl[..., dt_rank:dt_rank + n],
            x_dbl[..., dt_rank + n:], p["D"], xz[..., d_inner:], p["dt_proj_b"])


def _rel_err(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(max |got - want|, that over max |want|)."""
    err = (got - want).abs().max().item()
    return err, err / max(want.abs().max().item(), 1e-30)


def conv_bwd_bound(B: int, L: int, C: int, W: int) -> tuple[float, str]:
    """K5's bound: x and g read, dx written (plus w, b, dw, db); operations
    per element: s 2W+1, sigmoid 4, ds 4, dx 2W, dw and db 2W+2."""
    return bound((3 * B * L * C + 2 * C * (W + 1)) * 4, B * L * C * (6 * W + 11))


def conv_records(x, w, b, g) -> tuple[dict, dict]:
    """K1 and K5 on x (B, L, C), a column view as a mixer makes it, and a
    seeded output gradient g: each against its plain version, then timed
    beside it and beside ``F.conv1d(groups=C)`` + ``F.silu`` (for K5, the
    autograd backward of that). Returns the two records' measured fields."""
    from si_mamba_tpu_torch.ops.kernels import causal_conv as kc

    B, L, C = x.shape
    W = w.shape[1]
    where = f"width {C}, row stride {x.stride(1)}"
    y, y_ref = kc.causal_conv1d_silu_fwd(x, w, b), kc.causal_conv1d_ref(x, w, b)
    torch.cuda.synchronize()
    err1 = (y - y_ref).abs().max().item()
    if not torch.allclose(y, y_ref, rtol=1e-5, atol=1e-6):
        raise AssertionError(f"causal-conv kernel at {where} disagrees with its plain "
                             f"version: max |diff| {err1}")
    xt, w3 = x.transpose(1, 2), w[:, None, :]
    bound_ms, bound_by = bound(2 * B * L * C * 4 + C * (W + 1) * 4, B * L * C * (2 * W + 5))
    fwd = dict(shape=[B, L, C], row_stride=x.stride(1), max_abs_err=err1,
               ms=time_ms(lambda: kc.causal_conv1d_silu_fwd(x, w, b), 50),
               plain_ms=time_ms(lambda: kc.causal_conv1d_ref(x, w, b), 20),
               library_ms=time_ms(lambda: F.silu(F.conv1d(xt, w3, b, padding=W - 1,
                                                          groups=C)[..., :L]), 20),
               bound_ms=bound_ms, bound_by=bound_by)

    # K5. Tolerance rel-to-max 1e-4: dw and db are sums over B*L terms, taken
    # per time tile, per block and then over the blocks, in another order than
    # the plain version's; that order is fixed, so two runs are bitwise equal.
    args = (x, w, b, g)
    got, want = kc.causal_conv1d_silu_bwd(*args), kc.causal_conv1d_silu_bwd_ref(*args)
    again = kc.causal_conv1d_silu_bwd(*args)
    torch.cuda.synchronize()
    if not all(torch.equal(p, q) for p, q in zip(got, again)):
        raise AssertionError(f"two conv backward runs at {where} on the same inputs differ")
    err5 = 0.0
    for name, a, r in zip(("dx", "dw", "db"), got, want):
        err, rel = _rel_err(a, r)
        err5 = max(err5, err)
        if rel > 1e-4:
            raise AssertionError(f"conv backward kernel at {where}: {name} disagrees with the "
                                 f"plain backward: max |diff| {err} ({rel:.3e} of max)")
    x_lib = xt.detach().requires_grad_()
    w_lib, b_lib = (t.detach().clone().requires_grad_() for t in (w3, b))
    y_lib = F.silu(F.conv1d(x_lib, w_lib, b_lib, padding=W - 1, groups=C)[..., :L])
    bound_ms, bound_by = conv_bwd_bound(B, L, C, W)
    plan = kc.bwd_plan(x, g, W, torch.cuda.get_device_properties(x.device).multi_processor_count)
    bwd = dict(shape=[B, L, C], row_stride=x.stride(1), max_abs_err=err5,
               plan=dict(vx=plan.vx, vg=plan.vg, tile=plan.tile),
               ms=time_ms(lambda: kc.causal_conv1d_silu_bwd(*args), 50),
               device_ms=graph_ms(lambda: kc.causal_conv1d_silu_bwd(*args), 20),
               plain_ms=time_ms(lambda: kc.causal_conv1d_silu_bwd_ref(*args), 10),
               library_ms=time_ms(lambda: torch.autograd.grad(
                   y_lib, (x_lib, w_lib, b_lib), g.transpose(1, 2), retain_graph=True), 20),
               bound_ms=bound_ms, bound_by=bound_by)
    log(f"conv at {where}: forward max |diff| {err1:.3e}, backward {err5:.3e} (two runs "
        f"bitwise equal; {bwd['ms']:.6f} ms, device {bwd['device_ms']:.6f} ms, plan "
        f"{bwd['plan']})")
    return fwd, bwd


def tp_conv_phase(device) -> dict:
    """K1 and K5 at the two conv shapes of the tensor-parallel SSD train step
    on each of its TP ranks, B=32, L=512: the rank's x shard (d_inner / TP
    channels) and B|C (2 d_state), both contiguous as that mixer's products
    make them, with seeded weights and output gradient. Returns, by kernel
    name, the K1 and K5 figures at each width."""
    from si_mamba_tpu_torch.models.layers import SSDMixer

    mixer = SSDMixer(MODELNET40["trans_dim"])
    rng = np.random.default_rng(5)
    out = {"causal_conv1d_silu": {}, "causal_conv1d_silu_bwd": {}}
    for what, C in (("x_shard", mixer.d_inner // TP), ("bc", 2 * mixer.d_state)):
        x, g = (torch.from_numpy(rng.standard_normal((TRAIN_BATCH, 512, C), dtype=np.float32))
                .to(device) for _ in range(2))
        w = torch.from_numpy((rng.standard_normal((C, 4)) * 0.5).astype(np.float32)).to(device)
        b = torch.from_numpy((rng.standard_normal(C) * 0.1).astype(np.float32)).to(device)
        fwd, bwd = conv_records(x, w, b, g)
        out["causal_conv1d_silu"][what] = fwd
        out["causal_conv1d_silu_bwd"][what] = bwd
    return out


def kernel_phase(device) -> list[dict]:
    """The serving path's kernels at its shapes: K1 and K5 (with a seeded
    output gradient) on the column view of xz, K2 on K1's output."""
    from si_mamba_tpu_torch.ops.kernels import selective_scan as ks

    mixer, p, xz = mixer_inputs(device)
    xi = xz[..., :mixer.d_inner]
    B, L, D = xi.shape
    g = torch.from_numpy(np.random.default_rng(3).standard_normal((B, L, D), dtype=np.float32))
    fwd, bwd = conv_records(xi, p["conv_w"], p["conv_b"], g.to(device))
    records = [
        dict(name="causal_conv1d_silu", route="cuda",
             source="si_mamba_tpu_torch/csrc/causal_conv.cu",
             replaces="si_mamba_tpu/ops/pallas/causal_conv_kernel.py:52", **fwd),
        dict(name="causal_conv1d_silu_bwd", route="cuda",
             source="si_mamba_tpu_torch/csrc/causal_conv.cu",
             replaces="si_mamba_tpu/ops/pallas/causal_conv_kernel.py:58", **bwd)]

    # K2: selective scan forward, on the conv's output as on the path, at the
    # train batch and at each serving request size
    args = scan_operands(device)
    fig = scan_fwd_figures(args)
    sizes = {str(b): scan_fwd_figures(scan_operands(device, b)) for b in REQUEST_SIZES}
    records.append(dict(
        name="selective_scan_fwd", route="cuda",
        source="si_mamba_tpu_torch/csrc/selective_scan_fwd.cu",
        replaces="si_mamba_tpu/ops/pallas/selective_scan_kernel.py:115", **fig,
        plain_ms=time_ms(lambda: ks.selective_scan_ref(*args[:5], D=args[5], z=args[6],
                                                       delta_bias=args[7]), 2, warmup=1),
        library_ms=None, at_request_sizes=sizes))
    log("selective scan ok: " + "; ".join(
        f"B={f['shape'][0]}: {f['ms']:.6f} ms, device {f['device_ms']:.6f} ms "
        f"({f['segments']} segments), max |diff| {f['max_abs_err']:.3e}"
        for f in (fig, *sizes.values())))
    return records


def scan_fwd_figures(args) -> dict:
    """K2 on ``args`` against its plain version (rtol 1e-4, atol 1e-5 of
    max|y|), then timed as back-to-back wrapper calls (``ms``, the host's
    cost of a call included) and as device time (``device_ms``, CUDA-graph
    replays)."""
    from si_mamba_tpu_torch.ops.kernels import selective_scan as ks

    B, L, D = args[0].shape
    n = args[2].shape[1]
    y = ks.selective_scan_fwd(*args)
    y_ref = ks.selective_scan_ref(*args[:5], D=args[5], z=args[6], delta_bias=args[7])
    torch.cuda.synchronize()
    err = (y - y_ref).abs().max().item()
    scale = y_ref.abs().max().item()
    if not torch.allclose(y, y_ref, rtol=1e-4, atol=1e-5 * scale):
        raise AssertionError(f"selective-scan kernel at B={B} disagrees with its plain "
                             f"version: max |diff| {err}, max |y| {scale}")
    # bytes: u, dt, z, B, C read once, y written once, plus A, D, dt_bias;
    # operations per (b, l, d): softplus 4, skip + gate 6, and per state 7
    # (exp, 2 mul, 2 fma) with each exp counted as one operation
    scan_bytes = (4 * B * L * D + 2 * B * L * n + D * n + 2 * D) * 4
    bound_ms, bound_by = bound(scan_bytes, B * L * D * (10 + 7 * n))
    return dict(shape=[B, L, D], max_abs_err=err,
                ms=time_ms(lambda: ks.selective_scan_fwd(*args), 20),
                device_ms=graph_ms(lambda: ks.selective_scan_fwd(*args), 20),
                segments=ks._fwd_library().selective_scan_fwd_segments(B, L, D),
                bound_ms=bound_ms, bound_by=bound_by)


def backward_kernel_phase(device) -> list[dict]:
    """The scan's training kernels at the serving path's shapes, with a
    seeded output gradient: K3 (scan forward with residuals) and K4 (scan
    backward), each against its plain version, then timed."""
    from si_mamba_tpu_torch.ops.kernels import selective_scan as ks

    # K3: the scan forward that keeps its tile entry states, on the conv's output
    args = scan_operands(device)
    B, L, D = args[0].shape
    n = args[2].shape[1]
    rng = np.random.default_rng(3)
    g = torch.from_numpy(rng.standard_normal((B, L, D), dtype=np.float32)).to(device)
    records = []
    y3, h3 = ks.selective_scan_fwd_residuals(*args)
    y2 = ks.selective_scan_fwd(*args)
    y_ref, h_ref = ks.selective_scan_fwd_residuals_ref(*args)
    torch.cuda.synchronize()
    if not torch.equal(y3, y2):
        raise AssertionError(f"the training scan forward's y differs from the lean "
                             f"kernel's: max |diff| {(y3 - y2).abs().max().item()}")
    err3, rel_y = _rel_err(y3, y_ref)
    err_h, rel_h = _rel_err(h3, h_ref)
    if rel_y > 1e-4 or rel_h > 1e-4:
        raise AssertionError(f"training scan forward disagrees with its plain version: "
                             f"y {err3} ({rel_y:.3e}), h_entries {err_h} ({rel_h:.3e})")
    nc = h3.shape[1]
    scan_bytes = (4 * B * L * D + 2 * B * L * n + D * n + 2 * D) * 4
    bound_ms, bound_by = bound(scan_bytes + B * nc * n * D * 4, B * L * D * (10 + 7 * n))
    records.append(dict(
        name="selective_scan_fwd_residuals", route="cuda",
        source="si_mamba_tpu_torch/csrc/selective_scan_fwd.cu",
        replaces="si_mamba_tpu/ops/pallas/selective_scan_kernel.py:407",
        max_abs_err=max(err3, err_h),
        ms=time_ms(lambda: ks.selective_scan_fwd_residuals(*args), 20),
        plain_ms=time_ms(lambda: ks.selective_scan_fwd_residuals_ref(*args), 2, warmup=1),
        library_ms=None, bound_ms=bound_ms, bound_by=bound_by))
    log(f"training scan forward ok: y == lean y; vs plain y {err3:.3e}, h_entries "
        f"{err_h:.3e} (T = {ks.CHUNK}, {nc} entries per channel)")

    # K4: scan backward, from the kernel's own h_entries. Tolerance
    # rel-to-max 1e-3: dA, dB, dC, dD and ddelta_bias are sums over channels
    # or over B*L, taken in another order than the plain version's.
    bwd_args = (*args, g, h3)
    got = ks.selective_scan_bwd(*bwd_args)
    again = ks.selective_scan_bwd(*bwd_args)
    want = ks.selective_scan_bwd_ref(*bwd_args)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError("two scan backward runs on the same inputs differ")
    err4 = 0.0
    for name, a, b in zip(("du", "ddelta", "dA", "dB", "dC", "dD", "dz", "ddelta_bias"),
                          got, want):
        err, rel = _rel_err(a, b)
        err4 = max(err4, err)
        if rel > 1e-3:
            raise AssertionError(f"scan backward kernel: {name} disagrees with the plain "
                                 f"backward: max |diff| {err} ({rel:.3e} of max)")
    # bytes: u, dt, z, g, B, C, h_entries (and A, D, dt_bias) read once; du,
    # ddelta, dz, dB, dC (and dA, dD, ddelta_bias) written once. Operations per
    # state element: one exp and about 19 fp32 operations; per (b, l, d) about 20.
    bwd_bytes = (7 * B * L * D + 4 * B * L * n + B * nc * n * D + 2 * D * n + 4 * D) * 4
    bound_ms, bound_by = bound(bwd_bytes, B * L * D * (20 * n + 20))
    records.append(dict(
        name="selective_scan_bwd", route="cuda",
        source="si_mamba_tpu_torch/csrc/selective_scan_bwd.cu",
        replaces="si_mamba_tpu/ops/pallas/selective_scan_kernel.py:211",
        max_abs_err=err4,
        ms=time_ms(lambda: ks.selective_scan_bwd(*bwd_args), 20),
        plain_ms=time_ms(lambda: ks.selective_scan_bwd_ref(*bwd_args), 1, warmup=1),
        library_ms=None, bound_ms=bound_ms, bound_by=bound_by))
    log(f"scan backward ok: max |diff| {err4:.3e}, two runs bitwise equal")
    return records


def tc_bound(bytes_moved: float, ops: float) -> dict:
    """``bound_ms`` and ``bound_by`` of a kernel whose products run as 3xTF32
    on the tensor cores: three TF32 products for each, against the dense TF32
    peak."""
    bound_ms, bound_by = bound(bytes_moved, 3 * ops, TF32_OPS_PER_S)
    return dict(bound_ms=bound_ms, bound_by=bound_by)


def ssd_fwd_at_clouds(device) -> dict:
    """Lean K8 at each serving request size, on the conv output of layer 0's
    SSD mixer, against its plain version (rel-to-max 1e-4), timed as
    back-to-back wrapper calls (``ms``, the host's cost of a call included)
    and as device time (``device_ms``, CUDA-graph replays)."""
    from si_mamba_tpu_torch.ops.kernels import ssd as kssd

    out = {}
    for batch in REQUEST_SIZES:
        _, dth, S, _, _, xbc, D, chunk = _split_operands(device, heads=6, batch=batch)
        args = (xbc, dth, S, D, dth.shape[1] * kssd.HEAD_DIM, chunk)
        y = kssd.ssd_xbc_fwd(*args)
        y_ref = kssd.ssd_xbc_fwd_ref(*args)[0]
        torch.cuda.synchronize()
        err, rel = _rel_err(y, y_ref)
        if rel > 1e-4:
            raise AssertionError(f"SSD forward kernel at B={batch} disagrees with its plain "
                                 f"version: max |diff| {err} ({rel:.3e} of max)")
        out[batch] = dict(max_abs_err=err, ms=time_ms(lambda: kssd.ssd_xbc_fwd(*args), 20),
                          device_ms=graph_ms(lambda: kssd.ssd_xbc_fwd(*args), 20))
        log(f"ssd_xbc_fwd at {batch} clouds: {out[batch]}")
    return out


def ssd_kernel_phase(device) -> tuple[list[dict], dict]:
    """The SSD path's kernels at its shapes, as layer 0's SSD mixer makes its
    inputs at B=32, L=512: K1 and K5 at width 1024 on the column view of the
    (32, 512, 1798) in_proj output, then K8 (both variants; lean K8 also at
    the serving request sizes) and K9 (run twice, bitwise equal) on K1's
    output. Returns the K8/K9 records and the K1/K5 figures at this shape."""
    from si_mamba_tpu_torch.models.layers import SSDMixer
    from si_mamba_tpu_torch.ops.kernels import causal_conv as kc
    from si_mamba_tpu_torch.ops.kernels import ssd as kssd

    depth = MODELNET40["depth"]
    mixer = SSDMixer(MODELNET40["trans_dim"], out_proj_div=depth ** 0.5,
                     chunk=MODELNET40_SSD["ssd_chunk"])
    mixer.reset_parameters(torch.Generator().manual_seed(1))
    p = {k: v.detach().to(device) for k, v in mixer.params().items()}
    d, n, h, chunk = mixer.d_inner, mixer.d_state, mixer.n_heads, mixer.chunk
    rng = np.random.default_rng(4)
    u = torch.from_numpy(rng.standard_normal((32, 512, MODELNET40["trans_dim"]),
                                             dtype=np.float32)).to(device)
    zxbcdt = u @ p["in_proj_w"]  # (32, 512, 1798)
    xbc_in = zxbcdt[..., d:2 * d + 2 * n]  # width 1024, row stride 1798
    B, L, C = xbc_in.shape
    g = torch.from_numpy(rng.standard_normal((B, L, C), dtype=np.float32)).to(device)
    conv_shape = dict(zip(("causal_conv1d_silu", "causal_conv1d_silu_bwd"),
                          conv_records(xbc_in, p["conv_w"], p["conv_b"], g)))

    # K8, both variants, on K1's output
    xbc = kc.causal_conv1d_silu_fwd(xbc_in, p["conv_w"], p["conv_b"])
    dt = F.softplus(zxbcdt[..., 2 * d + 2 * n:] + p["dt_bias"])  # (B, L, h)
    A = -torch.exp(p["A_log"])
    nc = L // chunk
    dth = dt.transpose(1, 2).reshape(B, h, nc, chunk).contiguous()
    S = torch.cumsum(dth * A[None, :, None, None], dim=-1)
    args = (xbc, dth, S, p["D"], d, chunk)
    y_lean = kssd.ssd_xbc_fwd(*args)
    y, h_in = kssd.ssd_xbc_fwd_states(*args)
    y_ref, h_ref = kssd.ssd_xbc_fwd_ref(*args, emit_states=True)
    torch.cuda.synchronize()
    if not torch.equal(y, y_lean):
        raise AssertionError(f"the SSD forward with states differs from the lean one: "
                             f"max |diff| {(y - y_lean).abs().max().item()}")
    err_y, rel_y = _rel_err(y, y_ref)
    err_h, rel_h = _rel_err(h_in, h_ref)
    if rel_y > 1e-4 or rel_h > 1e-4:
        raise AssertionError(f"SSD forward kernel disagrees with its plain version: y {err_y} "
                             f"({rel_y:.3e} of max), h_in {err_h} ({rel_h:.3e} of max)")
    # operations, the products the function needs: in every chunk the lower
    # triangle (s <= t, the rest is masked to 0) of G = C B^T, once for the
    # heads, and per head of (G (.) M)(dt x), each q(q+1)/2 * 2k; per head
    # C h_in (2qnp) in every chunk but the first, whose h_in is 0, and the
    # carry B^T (dt x T_end) (2qnp) in every chunk but the last, whose state
    # nothing reads. Bytes: xbc, dt, S, D read once, y (and h_in) written once
    q, hp = chunk, d // h
    tri = q * (q + 1)  # 2 * q(q+1)/2: the multiply-adds of a triangle, per unit of k
    fwd_ops = B * (nc * (tri * n + h * tri * hp) + (nc - 1) * h * 4 * q * n * hp)
    fwd_bytes = (B * L * (d + 2 * n) + 2 * B * h * L + h + B * L * d) * 4
    hin_bytes = B * nc * h * n * hp * 4
    records = []
    for name, fn, extra, err in (
            ("ssd_xbc_fwd", lambda: kssd.ssd_xbc_fwd(*args), 0, err_y),
            ("ssd_xbc_fwd_states", lambda: kssd.ssd_xbc_fwd_states(*args), hin_bytes,
             max(err_y, err_h))):
        records.append(dict(
            name=name, route="cuda", source="si_mamba_tpu_torch/csrc/ssd_xbc_fwd.cu",
            replaces="si_mamba_tpu/ops/pallas/ssd_kernel.py:540", max_abs_err=err,
            ms=time_ms(fn, 20), device_ms=graph_ms(fn, 20),
            plain_ms=time_ms(lambda: kssd.ssd_xbc_fwd_ref(*args, emit_states=bool(extra)), 3),
            library_ms=None, **tc_bound(fwd_bytes + extra, fwd_ops)))
    records[0]["at_clouds"] = ssd_fwd_at_clouds(device)
    log(f"SSD forward ok: states y == lean y; vs plain y {err_y:.3e} ({rel_y:.3e} of max), "
        f"h_in {err_h:.3e} ({rel_h:.3e} of max)")

    # K9 for a seeded output gradient, from the kernel's own h_in; two runs
    # on the same inputs must be bitwise equal (no atomics)
    dy = torch.from_numpy(rng.standard_normal((B, L, d), dtype=np.float32)).to(device)
    bwd_args = (xbc, dth, S, p["D"], h_in, dy, d, chunk)
    got = kssd.ssd_xbc_bwd(*bwd_args)
    again = kssd.ssd_xbc_bwd(*bwd_args)
    want = kssd.ssd_xbc_bwd_ref(*bwd_args)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError("two SSD backward runs on the same inputs differ")
    err9, rels = 0.0, {}
    for name, a, b in zip(("dxbc", "ddt", "dS", "dD"), got, want):
        err, rels[name] = _rel_err(a, b)
        err9 = max(err9, err)
        if rels[name] > 1e-4:
            raise AssertionError(f"SSD backward kernel: {name} max |diff| {err} "
                                 f"({rels[name]:.3e} of max)")
    # operations, the products the function needs, lower triangles only: in
    # every chunk G once, per head GM^T dy and dy (dt x)^T (tri * p each), and
    # dG B and dG^T C once on dG summed over the heads (B and C are shared);
    # per head dy h_in^T (which also gives dE) and the carry (C E)^T dy
    # (2qnp each) in every chunk but the first, whose h_in is 0 and whose dh
    # nothing reads, and B dh and (dt x T_end) dh^T in every chunk but the
    # last, whose dh is 0. Bytes: xbc, dy, h_in, dt, S, D read, dxbc, ddt,
    # dS, dD written
    bwd_ops = B * (nc * (3 * tri * n + h * 2 * tri * hp) + (nc - 1) * h * 8 * q * n * hp)
    bwd_bytes = (2 * B * L * (d + 2 * n) + B * L * d + 4 * B * h * L + 2 * h) * 4 + hin_bytes
    bwd = lambda: kssd.ssd_xbc_bwd(*bwd_args)  # noqa: E731
    records.append(dict(
        name="ssd_xbc_bwd", route="cuda", source="si_mamba_tpu_torch/csrc/ssd_xbc_bwd.cu",
        replaces="si_mamba_tpu/ops/pallas/ssd_kernel.py:623", max_abs_err=err9,
        rel_err_of_max=rels, ms=time_ms(bwd, 10), device_ms=graph_ms(bwd, 10),
        plain_ms=time_ms(lambda: kssd.ssd_xbc_bwd_ref(*bwd_args), 2, warmup=1),
        library_ms=None, **tc_bound(bwd_bytes, bwd_ops)))
    log("SSD backward ok: two runs bitwise equal; " +
        ", ".join(f"{k} {v:.3e} of max" for k, v in rels.items()))
    fp32_bounds = (bound(fwd_bytes, fwd_ops), bound(fwd_bytes + hin_bytes, fwd_ops),
                   bound(bwd_bytes, bwd_ops))
    for r, (fp32_ms, fp32_by) in zip(records, fp32_bounds):
        log(f"{r['name']}: {r['ms']:.6f} ms, device {r['device_ms']:.6f} ms (plain "
            f"{r['plain_ms']:.6f}, bound {r['bound_ms']:.6f} by {r['bound_by']} at the TF32 "
            f"rate, {fp32_ms:.6f} by {fp32_by} at the fp32 rate)")
    return records, conv_shape


def _split_bounds(B, L, h, chunk, n=128, hp=128):
    """(forward ops by variant, forward bytes by variant, backward ops by
    seed, backward bytes by seed) of the split core at these shapes: the
    products the function needs, lower triangles only, nothing whose operand
    is zero (as K8/K9's bounds), with no D terms."""
    nc, q, d = L // chunk, chunk, h * hp
    tri = q * (q + 1)  # 2 * q(q+1)/2: the multiply-adds of a triangle, per unit of k
    state = 2 * q * n * hp  # one (q, n, p) product
    # C h_in in every chunk but the first (its h_in is 0); the carry
    # B^T (dt x T_end) in every chunk but the last, unless h_fin is read
    fwd_ops = {hfin: B * (nc * (tri * n + h * tri * hp)
                          + h * state * ((nc - 1) + (nc if hfin else nc - 1)))
               for hfin in (False, True)}
    base = (B * L * d + 2 * B * L * n + 2 * B * h * L + B * L * d) * 4  # x, B, C, dt, S in; y out
    hin_bytes, hfin_bytes = B * nc * h * n * hp * 4, B * h * n * hp * 4
    fwd_bytes = {(st, hf): base + (hin_bytes if st else 0) + (hfin_bytes if hf else 0)
                 for st in (False, True) for hf in (False, True)}
    # per head GM^T dy and dy (dt x)^T, once dG B and dG^T C and G; dy h_in^T
    # and the carry (C E)^T dy in every chunk but the first; B dh and
    # (dt x T_end) dh^T in every chunk but the last, unless seeded
    bwd_ops = {seed: B * (nc * (3 * tri * n + h * 2 * tri * hp)
                          + h * 2 * state * (nc - 1) + h * 2 * state * (nc if seed else nc - 1))
               for seed in (False, True)}
    bwd_base = (3 * B * L * d + 4 * B * L * n + 4 * B * h * L) * 4 + hin_bytes
    bwd_bytes = {seed: bwd_base + (hfin_bytes if seed else 0) for seed in (False, True)}
    return fwd_ops, fwd_bytes, bwd_ops, bwd_bytes


def _split_operands(device, heads: int, batch: int = 32, chunk: int = MODELNET40_SSD["ssd_chunk"]):
    """The split core's operands at B=batch, L=512 as the mixers make them
    (dt and S cut into chunks of ``chunk``, the SSD classifier's 256 unless
    given). For
    3 heads (the tensor-parallel shard at TP = 2): x the x conv's output and
    B, C the two halves of the B|C conv's output (row stride 256), from rank
    0's shard of layer 0's SSD mixer; for 6 heads: x, B and C the column
    groups of the full mixer's (x|B|C) conv output (row stride 1024), with
    that xbc for K8/K9. Returns (x, dt, S, B, C, xbc or None, D, chunk)."""
    from si_mamba_tpu_torch.models.layers import SSDMixer
    from si_mamba_tpu_torch.ops.kernels import causal_conv as kc
    from si_mamba_tpu_torch.parallel.tensor_parallel import shard_ssd_mixer_params

    depth = MODELNET40["depth"]
    mixer = SSDMixer(MODELNET40["trans_dim"], out_proj_div=depth ** 0.5,
                     chunk=MODELNET40_SSD["ssd_chunk"])
    mixer.reset_parameters(torch.Generator().manual_seed(1))
    full = {k: v.detach().to(device) for k, v in mixer.params().items()}
    d, n = mixer.d_inner, mixer.d_state
    u = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (batch, 512, MODELNET40["trans_dim"]), dtype=np.float32)).to(device)
    if heads == mixer.n_heads:
        zxbcdt = u @ full["in_proj_w"]
        xbc = kc.causal_conv1d_silu_fwd(zxbcdt[..., d:2 * d + 2 * n], full["conv_w"],
                                        full["conv_b"])
        x, Bm, Cm = xbc[..., :d], xbc[..., d:d + n], xbc[..., d + n:]
        dt = F.softplus(zxbcdt[..., 2 * d + 2 * n:] + full["dt_bias"])
        A, D = -torch.exp(full["A_log"]), full["D"]
    else:
        p = shard_ssd_mixer_params(full, 0, mixer.n_heads // heads, n_heads=mixer.n_heads,
                                   d_state=n)
        x = kc.causal_conv1d_silu_fwd(u @ p["in_proj_x"], p["conv_x_w"], p["conv_x_b"])
        bc = kc.causal_conv1d_silu_fwd(u @ p["in_proj_bc"], p["conv_bc_w"], p["conv_bc_b"])
        Bm, Cm, xbc = bc[..., :n], bc[..., n:], None
        dt = F.softplus(u @ p["in_proj_dt"] + p["dt_bias"])
        A, D = -torch.exp(p["A_log"]), p["D"]
    B, L, h = dt.shape
    dth = dt.transpose(1, 2).reshape(B, h, L // chunk, chunk).contiguous()
    S = torch.cumsum(dth * A[None, :, None, None], dim=-1)
    return x, dth, S, Bm, Cm, xbc, D, chunk


SPLIT_FWD = (("ssd_split_fwd", False, False), ("ssd_split_fwd_states", True, False),
             ("ssd_split_fwd_hfin", False, True), ("ssd_split_fwd_states_hfin", True, True))
SPLIT_BWD = (("ssd_split_bwd", False), ("ssd_split_bwd_seeded", True))


def _hold_split_kernels(args, dy, dh_fin) -> tuple[dict, torch.Tensor]:
    """Every K6 and K7 variant once on ``args`` (x, dt, S, B, C, chunk), each
    against its plain version: the four forwards give the same y, and y, h_in
    and h_fin lie within 1e-4 of the plain version's max; both backwards (from
    0, and seeded with ``dh_fin``) for the output gradient ``dy`` run twice,
    bitwise equal, each gradient within 1e-4 of its max. Returns
    {name: (max |diff|, {output: its max |diff| over its max})} and K6's h_in."""
    from si_mamba_tpu_torch.ops.kernels import ssd as kssd

    chunk = args[-1]
    y_ref, h_ref, hf_ref = kssd.ssd_split_fwd_ref(*args, emit_states=True, emit_hfin=True)
    y_lean = kssd.ssd_split_fwd(*args)
    errors, h_in = {}, None
    for name, states, hfin in SPLIT_FWD:
        out = getattr(kssd, name)(*args)
        out = out if isinstance(out, tuple) else (out,)
        torch.cuda.synchronize()
        if not torch.equal(out[0], y_lean):
            raise AssertionError(f"{name}'s y differs from the lean forward's at chunk {chunk}: "
                                 f"max |diff| {(out[0] - y_lean).abs().max().item()}")
        errs = {"y": _rel_err(out[0], y_ref)}
        if states:
            errs["h_in"] = _rel_err(out[1], h_ref)
            h_in = out[1]
        if hfin:
            errs["h_fin"] = _rel_err(out[-1], hf_ref)
        errors[name] = errs
    for name, seeded in SPLIT_BWD:
        seed = dh_fin if seeded else None
        bwd_args = (*args[:5], h_in, dy) + ((seed,) if seeded else ()) + (chunk,)
        fn = getattr(kssd, name)
        got, again = fn(*bwd_args), fn(*bwd_args)
        want = kssd.ssd_split_bwd_ref(*args[:5], h_in, dy, chunk, dh_fin=seed)
        torch.cuda.synchronize()
        errors[name] = {}
        for key, a, a2, w in zip(("dx", "ddt", "dS", "dB", "dC"), got, again, want):
            if not torch.equal(a, a2):
                raise AssertionError(f"{name}: {key} differs between two runs at chunk {chunk}")
            errors[name][key] = _rel_err(a, w)
    for name, errs in errors.items():
        for key, (err, rel) in errs.items():
            if rel > 1e-4:
                raise AssertionError(f"{name} at chunk {chunk}: {key} disagrees with the plain "
                                     f"version: max |diff| {err} ({rel:.3e} of max)")
    return {name: (max(e for e, _ in errs.values()), {k: r for k, (_, r) in errs.items()})
            for name, errs in errors.items()}, h_in


def split_kernel_phase(device) -> list[dict]:
    """K6 (lean, with states, with h_fin, with both) and K7 (from 0 and
    seeded with a dh_fin) at the tensor-parallel shard's shapes (B=32, L=512,
    chunk 256, 3 heads of 128, d_state 128; x, B and C strided as
    ``ssd_mixer_tp`` makes them), each against its plain version and timed
    beside it as back-to-back calls and as CUDA-graph device time; every
    variant held again at chunk 128 (4 chunks, so the carry launches run);
    then K6 lean and K7 at 6 heads on the full mixer's column groups, beside
    K8 and K9 on the same xbc."""
    from si_mamba_tpu_torch.ops.kernels import ssd as kssd

    x, dth, S, Bm, Cm, _, _, chunk = _split_operands(device, heads=3)
    B, L, d = x.shape
    h = dth.shape[1]
    args = (x, dth, S, Bm, Cm, chunk)
    rng = np.random.default_rng(5)
    dy = torch.from_numpy(rng.standard_normal((B, L, d), dtype=np.float32)).to(device)
    dh_fin = torch.from_numpy(0.1 * rng.standard_normal((B, h, 128, 128),
                                                        dtype=np.float32)).to(device)
    held, h_in = _hold_split_kernels(args, dy, dh_fin)
    x4, dth4, S4, B4, C4, *_ = _split_operands(device, heads=3, chunk=128)
    held4, _ = _hold_split_kernels((x4, dth4, S4, B4, C4, 128), dy, dh_fin)
    log(f"split SSD kernels ok at {h} heads, chunk {chunk} and 128: the four forwards give the "
        f"same y, two runs of each backward bitwise equal; of the max at chunk {chunk}: " +
        "; ".join(f"{k} {v[1]}" for k, v in held.items()) + "; at chunk 128: " +
        "; ".join(f"{k} {v[1]}" for k, v in held4.items()))

    fwd_ops, fwd_bytes, bwd_ops, bwd_bytes = _split_bounds(B, L, h, chunk)
    calls = {name: (lambda fn=getattr(kssd, name): fn(*args)) for name, *_ in SPLIT_FWD}
    plains = {name: (lambda st=st, hf=hf: kssd.ssd_split_fwd_ref(*args, emit_states=st,
                                                                 emit_hfin=hf))
              for name, st, hf in SPLIT_FWD}
    work = {name: (fwd_bytes[(st, hf)], fwd_ops[hf]) for name, st, hf in SPLIT_FWD}
    for name, seeded in SPLIT_BWD:
        extra = (dh_fin,) if seeded else ()
        calls[name] = lambda fn=getattr(kssd, name), extra=extra: fn(
            x, dth, S, Bm, Cm, h_in, dy, *extra, chunk)
        plains[name] = lambda seed=dh_fin if seeded else None: kssd.ssd_split_bwd_ref(
            x, dth, S, Bm, Cm, h_in, dy, chunk, dh_fin=seed)
        work[name] = (bwd_bytes[seeded], bwd_ops[seeded])
    records = []
    for name, call in calls.items():
        fwd = "fwd" in name
        records.append(dict(
            name=name, route="cuda",
            source="si_mamba_tpu_torch/csrc/ssd_xbc_" + ("fwd.cu" if fwd else "bwd.cu"),
            replaces="si_mamba_tpu/ops/pallas/ssd_kernel.py:" + ("119" if fwd else "216"),
            shape=dict(B=B, L=L, heads=h, chunk=chunk, x_row_stride=x.stride(1),
                       bc_row_stride=Bm.stride(1)),
            max_abs_err=held[name][0], rel_err_of_max=held[name][1],
            rel_err_of_max_at_chunk_128=held4[name][1],
            ms=time_ms(call, 20 if fwd else 10), device_ms=graph_ms(call, 20 if fwd else 10),
            plain_ms=time_ms(plains[name], 3 if fwd else 2, warmup=1),
            library_ms=None, **tc_bound(*work[name])))

    # K6 lean and K7 at 6 heads, beside K8 and K9 on the same (x|B|C) block
    x6, dth6, S6, B6, C6, xbc, D, _ = _split_operands(device, heads=6)
    dy6 = torch.from_numpy(rng.standard_normal((B, L, x6.shape[-1]), dtype=np.float32)).to(device)
    _, h_in6 = kssd.ssd_split_fwd_states(x6, dth6, S6, B6, C6, chunk)
    _, h_in8 = kssd.ssd_xbc_fwd_states(xbc, dth6, S6, D, x6.shape[-1], chunk)
    six = {"ssd_split_fwd_ms": time_ms(lambda: kssd.ssd_split_fwd(x6, dth6, S6, B6, C6, chunk),
                                       20),
           "ssd_xbc_fwd_ms": time_ms(lambda: kssd.ssd_xbc_fwd(xbc, dth6, S6, D, x6.shape[-1],
                                                              chunk), 20),
           "ssd_split_bwd_ms": time_ms(lambda: kssd.ssd_split_bwd(x6, dth6, S6, B6, C6, h_in6,
                                                                  dy6, chunk), 10),
           "ssd_xbc_bwd_ms": time_ms(lambda: kssd.ssd_xbc_bwd(xbc, dth6, S6, D, h_in8, dy6,
                                                              x6.shape[-1], chunk), 10)}
    for r in records:
        r["at_6_heads"] = six
        fp32_ms, fp32_by = bound(*work[r["name"]])
        log(f"{r['name']}: {r['ms']:.6f} ms, device {r['device_ms']:.6f} ms (plain "
            f"{r['plain_ms']:.6f}, bound {r['bound_ms']:.6f} by {r['bound_by']} at the TF32 "
            f"rate, {fp32_ms:.6f} by {fp32_by} at the fp32 rate)")
    log("at 6 heads (the full mixer's x|B|C block): " +
        ", ".join(f"{k} {v:.6f}" for k, v in six.items()))
    return records


def per_op_interior(xz, p, dt_rank: int, n: int):
    """The mixer interior through the per-op route, as ``mamba_mixer_apply``
    runs it under 'pallas': K1 (K5 backward), the x_proj and dt_proj GEMMs,
    K2 (K3/K4 with a gradient)."""
    from si_mamba_tpu_torch.ops.kernels.causal_conv import causal_conv1d_silu
    from si_mamba_tpu_torch.ops.kernels.selective_scan import selective_scan_fused

    d_inner = xz.shape[-1] // 2
    xi = causal_conv1d_silu(xz[..., :d_inner], p["conv_w"], p["conv_b"])
    x_dbl = xi @ p["x_proj_w"]
    dt = x_dbl[..., :dt_rank] @ p["dt_proj_w"]
    return selective_scan_fused(xi, dt, -torch.exp(p["A_log"]), x_dbl[..., dt_rank:dt_rank + n],
                                x_dbl[..., dt_rank + n:], p["D"], xz[..., d_inner:],
                                p["dt_proj_b"])


def fused_fwd_at_clouds(device) -> dict:
    """Lean K10 at each serving request size against its plain version
    (rel-to-max 1e-4), timed as back-to-back wrapper calls (``ms``, the
    host's cost of a call included) and as device time (``device_ms``,
    CUDA-graph replays), with the segment count the kernel took."""
    from si_mamba_tpu_torch.ops.kernels import fused_mixer as kfm

    out = {}
    for batch in REQUEST_SIZES:
        mixer, p, xz = mixer_inputs(device, batch)
        args = kfm.kernel_inputs(xz, p["conv_w"], p["conv_b"], p["x_proj_w"], p["dt_proj_w"],
                                 p["dt_proj_b"], -torch.exp(p["A_log"]), p["D"],
                                 dt_rank=mixer.dt_rank, d_state=mixer.d_state)
        y = kfm.fused_mixer_fwd(*args)
        y_ref = kfm.fused_mixer_fwd_ref(*args, chunk=kfm.CHUNK)[0]
        torch.cuda.synchronize()
        err, rel = _rel_err(y, y_ref)
        if rel > 1e-4:
            raise AssertionError(f"fused forward kernel at B={batch} disagrees with its plain "
                                 f"version: max |diff| {err} ({rel:.3e} of max)")
        out[batch] = dict(max_abs_err=err, ms=time_ms(lambda: kfm.fused_mixer_fwd(*args), 20),
                          device_ms=graph_ms(lambda: kfm.fused_mixer_fwd(*args), 20),
                          segments=kfm._fwd_library().fused_mixer_fwd_segments(
                              batch, xz.shape[1], mixer.d_inner))
        log(f"fused_mixer_fwd at {batch} clouds: {out[batch]}")
    return out


def fused_mixer_phase(device) -> tuple[list[dict], dict]:
    """K10 (lean and with states) and K11 at the serving path's shapes (B=32,
    L=512, d_inner 768, d_state 16, xz as layer 0's in_proj makes it), each
    against its plain version and timed beside it; then the same interior
    through the per-op route and through ``fused_mamba_mixer``, forward
    (no gradient), training forward and backward. Returns the three records
    and the route timings."""
    from si_mamba_tpu_torch.ops.kernels import fused_mixer as kfm

    mixer, p, xz = mixer_inputs(device)
    d_inner, n, dt_rank = mixer.d_inner, mixer.d_state, mixer.dt_rank
    weights = [p["conv_w"], p["conv_b"], p["x_proj_w"], p["dt_proj_w"], p["dt_proj_b"],
               -torch.exp(p["A_log"]), p["D"]]
    args = kfm.kernel_inputs(xz, *weights, dt_rank=dt_rank, d_state=n)
    B, L, _ = xz.shape
    W, nc = args[1].shape[0], -(-L // kfm.CHUNK)
    y_lean = kfm.fused_mixer_fwd(*args)
    y, h_entries = kfm.fused_mixer_fwd_states(*args)
    y_ref, h_ref = kfm.fused_mixer_fwd_ref(*args, chunk=kfm.CHUNK, emit_states=True)
    torch.cuda.synchronize()
    if not torch.equal(y, y_lean):
        raise AssertionError(f"the fused forward with states differs from the lean one: "
                             f"max |diff| {(y - y_lean).abs().max().item()}")
    err_y, rel_y = _rel_err(y, y_ref)
    err_h, rel_h = _rel_err(h_entries, h_ref)
    if rel_y > 1e-4 or rel_h > 1e-4:
        raise AssertionError(f"fused forward kernel disagrees with its plain version: y {err_y} "
                             f"({rel_y:.3e} of max), h_entries {err_h} ({rel_h:.3e} of max)")
    # operations the function needs, per (b, t): the rank-R pair, xi @ x_proj
    # (2 d (R + 2n)) and dt_low @ dt_proj (2 R d); per channel the conv
    # (2W + 1), SiLU 4, softplus 4, skip and gate 6, and 7 per state (as K2's
    # bound). Bytes: xz read and y written once, the weights read once
    # (h_entries written once).
    per_channel = 2 * W + 1 + 4 + 10 + 7 * n
    pair_ops = 2 * d_inner * (dt_rank + 2 * n) + 2 * dt_rank * d_inner
    fwd_ops = B * L * (pair_ops + d_inner * per_channel)
    weight_bytes = sum(t.numel() for t in args[1:]) * 4
    fwd_bytes = B * L * 3 * d_inner * 4 + weight_bytes
    hent_bytes = B * nc * n * d_inner * 4
    records = []
    for name, fn, extra, err in (
            ("fused_mixer_fwd", lambda: kfm.fused_mixer_fwd(*args), 0, err_y),
            ("fused_mixer_fwd_states", lambda: kfm.fused_mixer_fwd_states(*args), hent_bytes,
             max(err_y, err_h))):
        bound_ms, bound_by = bound(fwd_bytes + extra, fwd_ops)
        records.append(dict(
            name=name, route="cuda", source="si_mamba_tpu_torch/csrc/fused_mixer_fwd.cu",
            replaces="si_mamba_tpu/ops/pallas/fused_mixer_kernel.py:243", max_abs_err=err,
            ms=time_ms(fn, 20),
            plain_ms=time_ms(lambda: kfm.fused_mixer_fwd_ref(*args, chunk=kfm.CHUNK,
                                                             emit_states=bool(extra)), 2, warmup=1),
            library_ms=None, bound_ms=bound_ms, bound_by=bound_by,
            segments=kfm._fwd_library().fused_mixer_fwd_segments(B, L, d_inner)))
    log(f"fused forward ok: states y == lean y; vs plain y {err_y:.3e} ({rel_y:.3e} of max), "
        f"h_entries {err_h:.3e} ({rel_h:.3e} of max)")
    records[0]["at_clouds"] = fused_fwd_at_clouds(device)

    # K11 for a seeded output gradient, from the kernel's own h_entries.
    # Tolerance rel-to-max 1e-4: the weight gradients are sums over B*L terms,
    # per chunk and block and then over the batch, in another order than the
    # plain version's.
    g = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (B, L, d_inner), dtype=np.float32)).to(device)
    bwd_args = (*args, h_entries, g)
    got = kfm.fused_mixer_bwd(*bwd_args)
    want = kfm.fused_mixer_bwd_ref(*bwd_args, chunk=kfm.CHUNK)
    again = kfm.fused_mixer_bwd(*bwd_args)
    torch.cuda.synchronize()
    err11, rels = 0.0, {}
    for name, a, w, a2 in zip(("dxz", "dconv_wt", "dconv_b", "dx_proj", "ddt_proj", "ddtb",
                               "dat", "dd"), got, want, again):
        err, rels[name] = _rel_err(a, w)
        err11 = max(err11, err)
        if rels[name] > 1e-4:
            raise AssertionError(f"fused backward kernel: {name} max |diff| {err} "
                                 f"({rels[name]:.3e} of max)")
        if not torch.equal(a, a2):
            raise AssertionError(f"fused backward kernel: {name} differs between two runs")
    # operations the function needs: the forward's recompute, the pair's four
    # products of the backward (d_dtlow = ddt_raw dt_proj^T, dxi's
    # [d_dtlow | dB | dC] x_proj^T, d x_proj and d dt_proj: twice the
    # forward's pair), the scan backward (20 per state and 20 per channel, as
    # K4's bound) and the conv backward (6W + 11, as K5's). Bytes: xz, g and
    # h_entries read, dxz written, the weights read and their gradients
    # written once.
    scan_conv_bwd = d_inner * (20 * n + 20 + 6 * W + 11)
    bwd_ops = fwd_ops + B * L * (2 * pair_ops + scan_conv_bwd)
    bwd_bytes = B * L * 5 * d_inner * 4 + hent_bytes + 2 * weight_bytes
    bound_ms, bound_by = bound(bwd_bytes, bwd_ops)
    records.append(dict(
        name="fused_mixer_bwd", route="cuda", source="si_mamba_tpu_torch/csrc/fused_mixer_bwd.cu",
        replaces="si_mamba_tpu/ops/pallas/fused_mixer_kernel.py:292", max_abs_err=err11,
        rel_err_of_max=rels, ms=time_ms(lambda: kfm.fused_mixer_bwd(*bwd_args), 10),
        plain_ms=time_ms(lambda: kfm.fused_mixer_bwd_ref(*bwd_args, chunk=kfm.CHUNK), 1,
                         warmup=1),
        library_ms=None, bound_ms=bound_ms, bound_by=bound_by))
    log("fused backward ok, two runs bitwise equal: " +
        ", ".join(f"{k} {v:.3e} of max" for k, v in rels.items()))

    # the same interior through the two routes: forward without a gradient,
    # the training forward, and the backward alone (autograd.grad over the
    # graph the training forward kept), xz and every weight a leaf
    leaves = [t.detach().clone().requires_grad_() for t in (xz, *weights)]
    lp = dict(zip(("conv_w", "conv_b", "x_proj_w", "dt_proj_w", "dt_proj_b"), leaves[1:6]))
    lp["A_log"], lp["D"] = torch.log(-leaves[6]), leaves[7]
    routes = {
        "per_op": lambda: per_op_interior(leaves[0], lp, dt_rank, n),
        "fused": lambda: kfm.fused_mamba_mixer(*leaves, dt_rank=dt_rank, d_state=n)}
    timings = {}
    for route, fn in routes.items():
        with torch.no_grad():
            fwd_ms = time_ms(fn, 10)
        train_fwd_ms = time_ms(fn, 10)
        out = fn()
        bwd_ms = time_ms(lambda: torch.autograd.grad(out, leaves, g, retain_graph=True), 10)
        timings[route] = {"fwd_ms": fwd_ms, "train_fwd_ms": train_fwd_ms, "bwd_ms": bwd_ms}
        del out
    records[0]["per_op_route_ms"] = timings["per_op"]["fwd_ms"]
    records[1]["per_op_route_ms"] = timings["per_op"]["train_fwd_ms"]
    records[2]["per_op_route_ms"] = timings["per_op"]["bwd_ms"]
    for r in records:
        log(f"{r['name']}: {r['ms']:.6f} ms (plain {r['plain_ms']:.6f}, per-op route "
            f"{r['per_op_route_ms']:.6f}, bound {r['bound_ms']:.6f} by {r['bound_by']})")
    log(f"mixer interior, per-op route {timings['per_op']}; fused route {timings['fused']}")
    return records, timings


def clouds(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    pts = rng.standard_normal((n, NPOINTS, 3)).astype(np.float32)
    return pts / np.abs(pts).max(axis=(1, 2), keepdims=True)


def _wrappers() -> dict:
    """Every kernel wrapper of the port by its record name; each counts its
    launches in ``.launches``."""
    from si_mamba_tpu_torch.ops.kernels import causal_conv as kc
    from si_mamba_tpu_torch.ops.kernels import fused_mixer as kfm
    from si_mamba_tpu_torch.ops.kernels import selective_scan as ks
    from si_mamba_tpu_torch.ops.kernels import ssd as kssd

    return {"causal_conv1d_silu": kc.causal_conv1d_silu,
            "selective_scan_fwd": ks.selective_scan_fwd,
            "selective_scan_fwd_residuals": ks.selective_scan_fwd_residuals,
            "selective_scan_bwd": ks.selective_scan_bwd,
            "causal_conv1d_silu_bwd": kc.causal_conv1d_silu_bwd,
            "ssd_xbc_fwd": kssd.ssd_xbc_fwd,
            "ssd_xbc_fwd_states": kssd.ssd_xbc_fwd_states,
            "ssd_xbc_bwd": kssd.ssd_xbc_bwd,
            "fused_mixer_fwd": kfm.fused_mixer_fwd,
            "fused_mixer_fwd_states": kfm.fused_mixer_fwd_states,
            "fused_mixer_bwd": kfm.fused_mixer_bwd,
            "ssd_split_fwd": kssd.ssd_split_fwd,
            "ssd_split_fwd_states": kssd.ssd_split_fwd_states,
            "ssd_split_fwd_hfin": kssd.ssd_split_fwd_hfin,
            "ssd_split_fwd_states_hfin": kssd.ssd_split_fwd_states_hfin,
            "ssd_split_bwd": kssd.ssd_split_bwd,
            "ssd_split_bwd_seeded": kssd.ssd_split_bwd_seeded}


def _launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in _wrappers().items()}


def _reset_launch_counts() -> None:
    for fn in _wrappers().values():
        fn.launches = 0


def _expect(depth: int, names) -> dict[str, int]:
    """``depth`` launches of each kernel in ``names``, none of the others."""
    return {k: (depth if k in names else 0) for k in _launch_counts()}


def serving_phase(device, base: dict = MODELNET40, plain_impl: str = "seq",
                  kernels=EVAL_KERNELS):
    """Requests of REQUEST_SIZES clouds through a ``Predictor`` over the model
    of ``base``; every forward must launch each of ``kernels`` once a block and
    nothing else, and the logits match the model with ``plain_impl``.
    Returns (launches, latency record, model, requests)."""
    from si_mamba_tpu_torch.models import PointMamba, PointMambaConfig
    from si_mamba_tpu_torch.serving import Predictor

    cfg = PointMambaConfig.from_dict(base)
    model = PointMamba(cfg, generator=torch.Generator().manual_seed(0))
    predictor = Predictor(model, npoints=NPOINTS, max_batch=64, device=device)
    predictor.warmup()
    requests = {n: clouds(n, seed=n) for n in REQUEST_SIZES}

    _reset_launch_counts()  # the main path: counts from 0, then only the requests
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
    launches = _launch_counts()
    want = _expect(cfg.depth * forwards, kernels)
    if launches != want:
        raise AssertionError(f"{forwards} forwards launched {launches}; expected {want} "
                             f"({cfg.depth} per forward of {kernels}, nothing else)")
    log(f"served {forwards} forwards ({cfg.mixer} mixer, scan_impl={cfg.scan_impl!r}); "
        f"launches {launches}")

    # the same weights through the plain path, on the same card
    plain_model = PointMamba(PointMambaConfig.from_dict({**base, "scan_impl": plain_impl}))
    plain_model.load_state_dict(model.state_dict(), strict=True)
    plain = Predictor(plain_model, npoints=NPOINTS, max_batch=64, device=device)
    n_cmp = 20
    ref = plain.logits(requests[n_cmp])
    scale = float(np.abs(ref).max())
    err = float(np.abs(logits[n_cmp] - ref).max())
    if not np.allclose(logits[n_cmp], ref, atol=1e-3 * scale, rtol=2e-3):
        raise AssertionError(f"kernel logits disagree with scan_impl={plain_impl!r}: max "
                             f"|diff| {err}, max |logit| {scale}")
    with torch.inference_mode():
        pts = torch.from_numpy(requests[n_cmp]).to(device)
        _, feat = predictor.model(pts, return_features=True)
        _, feat_ref = plain_model(pts, return_features=True)
    feat_err = (feat - feat_ref).abs().max().item()
    feat_scale = feat_ref.abs().max().item()
    if not torch.allclose(feat, feat_ref, atol=1e-3 * feat_scale, rtol=2e-3):
        raise AssertionError(f"pooled features disagree with scan_impl={plain_impl!r}: max "
                             f"|diff| {feat_err}, max |feature| {feat_scale}")
    log(f"kernel path == scan_impl={plain_impl!r} on {n_cmp} clouds: logits max |diff| "
        f"{err:.3e} (max |logit| {scale:.3e}), features max |diff| {feat_err:.3e} "
        f"(max |feature| {feat_scale:.3e})")
    del plain, plain_model

    serving = {"logits_max_abs_diff": err, "logits_max_abs": scale}
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


def device_profile(fn) -> dict:
    """One call of ``fn`` under torch.profiler: device-side events (kernels,
    copies) only, since an operator's own row repeats its kernels' time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.count, e.self_device_time_total / 1e3) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[2])
    device_ms = sum(r[2] for r in rows)
    if device_ms <= 0:
        raise AssertionError("the profiler saw no device time in a call on the card")
    return {"wall_ms": wall_ms, "device_ms": device_ms, "busy_share": device_ms / wall_ms,
            "top": [{"name": k[:90], "count": c, "device_ms": ms} for k, c, ms in rows[:8]]}


def view_grad_profile(fn, batch: int, length: int, full: int, widths) -> dict:
    """One call of ``fn`` (a train step) under torch.profiler with shapes: the
    device time of building the in_proj output's gradient (batch, length,
    full) from the gradients of its column views, which autograd's slice
    backward does as a zero fill of the full buffer and a copy a view
    (``aten::slice_backward`` on a (batch, length, w) gradient, w in
    ``widths``), then the adds of the full-width gradients; beside it the
    conv backward's own device time (its tile and finishing kernels). Fails
    when the step shows no such slice backward or no conv backward."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        fn()
        torch.cuda.synchronize()
    views = [[batch, length, w] for w in widths]
    out = {"slice_backward": [0, 0.0], "add": [0, 0.0], "conv_bwd": [0, 0.0]}
    for e in prof.key_averages(group_by_input_shape=True):
        shapes = [list(x) for x in (e.input_shapes or [])]
        if e.key == "aten::slice_backward" and shapes and shapes[0] in views:
            row = out["slice_backward"]
        elif e.key in ("aten::add", "aten::add_") and shapes[:2] == [[batch, length, full]] * 2:
            row = out["add"]
        elif e.device_type == DeviceType.CUDA and "causal_conv1d_silu_bwd" in e.key:
            row = out["conv_bwd"]
        else:
            continue
        row[0] += e.count
        row[1] += (e.device_time_total if e.device_type != DeviceType.CUDA
                   else e.self_device_time_total) / 1e3
    if not out["slice_backward"][0] or not out["conv_bwd"][0]:
        raise AssertionError(f"the profiled step shows no slice backward of a {views} view "
                             f"or no conv backward: {out}")
    return {k: {"count": n, "device_ms": ms} for k, (n, ms) in out.items()}


def in_proj_views(model) -> tuple[int, tuple[int, ...]]:
    """The width of the first mixer's in_proj output and the widths of the
    column views that the mixer takes of it: x and z (d_inner each) for the
    Mamba-1 mixer; z, x|B|C and dt for the SSD mixer."""
    from si_mamba_tpu_torch.models.layers import MambaMixer, SSDMixer

    mixer = next(m for m in model.modules() if isinstance(m, (MambaMixer, SSDMixer)))
    if isinstance(mixer, SSDMixer):
        widths = (mixer.d_inner, mixer.d_inner + 2 * mixer.d_state, mixer.n_heads)
    else:
        widths = (mixer.d_inner,)
    return mixer.in_proj.out_features, widths


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
            prof = device_profile(lambda: model(pts))
            result[str(n)] = {"piece_ms_median": med, "profile": prof}
            log(f"{n:2d} clouds: " + ", ".join(f"{k} {v:.3f} ms" for k, v in med.items()) +
                f"; device {prof['device_ms']:.3f} of {prof['wall_ms']:.3f} ms wall "
                f"(busy {prof['busy_share']:.3f})")
            for row in prof["top"]:
                log(f"    {row['device_ms']:9.3f} ms  x{row['count']:<5d} {row['name']}")
    return result


def _train_clouds(n: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    pts = rng.standard_normal((n, TRAIN_POINTS, 3)).astype(np.float32)
    pts /= np.abs(pts).max(axis=(1, 2), keepdims=True)
    return pts, rng.integers(0, MODELNET40["cls_dim"], n)


def train_phase(device, card: str, base: dict = MODELNET40, kernels=TRAIN_KERNELS,
                eval_kernels=EVAL_KERNELS, view_grads: bool = True) -> tuple[dict, dict]:
    """TRAIN_STEPS steps of the port's finetune step at the ModelNet40
    settings over the model of ``base``; every step must launch each of
    ``kernels`` once a block and nothing else, an eval forward after them
    each of ``eval_kernels``. With ``view_grads``, a profiled step measures
    how the in_proj output's gradient is assembled from its column views'
    (``view_grad_profile``). Returns (record, launches over the steps)."""
    from si_mamba_tpu_torch.data import transforms
    from si_mamba_tpu_torch.models import PointMamba, PointMambaConfig
    from si_mamba_tpu_torch.train.optim import build_optimizer
    from si_mamba_tpu_torch.train.runner_finetune import (
        finetune_update,
        make_input_pipeline,
        make_train_step,
    )
    from si_mamba_tpu_torch.train.train_state import TrainState

    cfg = PointMambaConfig.from_dict(base)
    model = PointMamba(cfg, generator=torch.Generator().manual_seed(0)).to(device)
    optimizer, schedule = build_optimizer(model, opt_type="AdamW", lr=3e-4, weight_decay=0.05,
                                          epochs=300, warmup_epochs=10, steps_per_epoch=2,
                                          grad_clip=10.0)
    state = TrainState.create(model, optimizer)
    step = make_train_step(model, NPOINTS, rotation=False)
    pts_np, labels_np = _train_clouds(TRAIN_BATCH, seed=7)
    points = torch.from_numpy(pts_np).to(device)
    labels = torch.from_numpy(labels_np).to(device)
    generator = torch.Generator(device=device).manual_seed(0)
    params0 = {k: v.detach().clone() for k, v in model.named_parameters()}
    stats0 = {k: v.clone() for k, v in model.named_buffers() if "running" in k}

    expect = _expect(cfg.depth, kernels)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    _reset_launch_counts()  # the main path: counts from 0, then only the steps
    times, losses, per_step = [], [], []
    for _ in range(TRAIN_STEPS):
        before = _launch_counts()
        t0 = time.perf_counter()
        state, metrics = step(state, points, labels, generator)
        loss = metrics["loss"].item()  # a host copy: synchronises
        times.append(time.perf_counter() - t0)
        now = _launch_counts()
        per_step.append({k: now[k] - before[k] for k in now})
        losses.append(loss)
        if per_step[-1] != expect:
            raise AssertionError(f"train step {len(losses)} launched {per_step[-1]}, "
                                 f"expected {expect}")
        if not np.isfinite(loss):
            raise AssertionError(f"train step {len(losses)} gave loss {loss}")
    launches = _launch_counts()
    peak = torch.cuda.max_memory_allocated(device)

    moved = {k for k, v in model.named_parameters() if not torch.equal(v.detach(), params0[k])}
    mixer_params = [k for k in params0 if ".mixer." in k]
    stuck = [k for k in mixer_params if k not in moved]
    if stuck or len(moved) < 0.9 * len(params0):
        raise AssertionError(f"parameters did not move: {sorted(set(params0) - moved)}")
    stats_stuck = [k for k, v in model.named_buffers() if k in stats0 and torch.equal(v, stats0[k])]
    if stats_stuck:
        raise AssertionError(f"BatchNorm statistics did not move: {stats_stuck}")

    # one more step as the two halves that the step composes (input pipeline,
    # then forward + backward + optimizer), each ended by a synchronise; then
    # one step under the profiler
    pieces, t = {}, time.perf_counter()

    def mark(name):
        nonlocal t
        torch.cuda.synchronize()
        now = time.perf_counter()
        pieces[name] = (now - t) * 1e3
        t = now

    pts = make_input_pipeline(NPOINTS, rotation=False)(points, generator)
    mark("input")
    state, _ = finetune_update(state, pts, labels, generator)
    mark("update")
    prof = device_profile(lambda: step(state, points, labels, generator))
    log("train step pieces: " + ", ".join(f"{k} {v:.3f} ms" for k, v in pieces.items()) +
        f"; profiled step: device {prof['device_ms']:.3f} of {prof['wall_ms']:.3f} ms wall "
        f"(busy {prof['busy_share']:.3f})")
    for row in prof["top"]:
        log(f"    {row['device_ms']:9.3f} ms  x{row['count']:<5d} {row['name']}")
    views = None
    if view_grads:
        full, widths = in_proj_views(model)
        views = view_grad_profile(lambda: step(state, points, labels, generator), TRAIN_BATCH,
                                  cfg.seq_len, full, widths)
        log(f"in_proj gradient ({full} wide) from its views {widths} (device ms, count): " +
            ", ".join(f"{k} {v['device_ms']:.3f} x{v['count']}" for k, v in views.items()))

    # an eval forward after training takes the lean forward kernel again
    _reset_launch_counts()
    with torch.inference_mode():
        logits = model.eval()(points[:, :NPOINTS])
    counts = _launch_counts()
    if counts != _expect(cfg.depth, eval_kernels):
        raise AssertionError(f"an eval forward after training launched {counts}")
    if logits.shape != (TRAIN_BATCH, cfg.cls_dim) or not torch.isfinite(logits).all():
        raise AssertionError("bad eval logits after training")

    # the input pipeline's FPS (8192 -> 1200 points, a host loop) on its own
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    transforms.fps_resample(points, generator, NPOINTS, point_all=1200)
    torch.cuda.synchronize()
    fps_ms = (time.perf_counter() - t0) * 1e3

    p50 = statistics.median(times[1:])
    record = {"batch": TRAIN_BATCH, "points": TRAIN_POINTS, "steps": TRAIN_STEPS,
              "p50_step_ms": p50 * 1e3, "clouds_per_s": TRAIN_BATCH / p50,
              "step_ms": [t * 1e3 for t in times], "losses": losses,
              "lr": [schedule(i) for i in range(TRAIN_STEPS)],
              "max_memory_allocated_bytes": peak, "fps_resample_ms": fps_ms,
              "piece_ms": pieces, "profile": prof, "view_grad": views,
              "params_moved": len(moved), "params": len(params0),
              "launches_per_step": expect, "card": card}
    log(f"train ({cfg.mixer} mixer, scan_impl={cfg.scan_impl!r}): {TRAIN_STEPS} steps at "
        f"batch {TRAIN_BATCH}, p50 {p50 * 1e3:.3f} ms (steps 2 onward), {TRAIN_BATCH / p50:.2f} clouds/s, peak memory "
        f"{peak / 2**30:.3f} GiB, losses {['%.4f' % v for v in losses]}; "
        f"fps_resample alone {fps_ms:.3f} ms; {card}")
    log(f"train launches {launches}; {len(moved)} of {len(params0)} parameters moved")
    return record, launches


def gradient_phase(device, base: dict = MODELNET40, plain_impl: str = "seq") -> dict:
    """One train-mode forward + backward of the kernel path and of the plain
    path (``plain_impl``), same weights and clouds, drop rates 0: the loss
    and every parameter gradient. The tolerance has the form of
    tests/test_full_parity.py:541-545 (there 1.5e-2 across frameworks),
    tightened for one framework on one card: each leaf within GRAD_TOL of
    the largest gradient, dominant leaves (above a tenth of it) within
    GRAD_TOL relative. The sums of the kernels and of the plain path run in
    other orders; the worst leaf measured on the H100 was 1.3e-5 of the
    largest gradient."""
    from si_mamba_tpu_torch.models import PointMamba, PointMambaConfig
    from si_mamba_tpu_torch.models.point_mamba import cross_entropy_loss_acc

    no_drop = {**base, "drop_path": 0.0, "cls_head_dropout": 0.0}
    model = PointMamba(PointMambaConfig.from_dict(no_drop),
                       generator=torch.Generator().manual_seed(5)).to(device)
    plain = PointMamba(PointMambaConfig.from_dict({**no_drop, "scan_impl": plain_impl})).to(device)
    plain.load_state_dict(model.state_dict(), strict=True)
    pts_np, labels_np = _train_clouds(PARITY_BATCH, seed=11)
    pts = torch.from_numpy(pts_np[:, :NPOINTS]).to(device)
    labels = torch.from_numpy(labels_np).to(device)
    losses = {}
    for name, m in (("kernel", model), ("plain", plain)):
        per, _ = cross_entropy_loss_acc(m.train()(pts), labels)
        loss = per.mean()
        loss.backward()
        losses[name] = loss.item()
    if not np.isclose(losses["kernel"], losses["plain"], rtol=2e-4, atol=0):
        raise AssertionError(f"losses differ: {losses}")
    grads = {k: p.grad for k, p in model.named_parameters()}
    ref = {k: p.grad for k, p in plain.named_parameters()}
    gmax = max(g.abs().max().item() for g in ref.values())
    worst_leaf, worst_dominant = 0.0, 0.0
    for k, g in grads.items():
        diff = (g - ref[k]).abs().max().item()
        worst_leaf = max(worst_leaf, diff / gmax)
        if diff >= GRAD_TOL * gmax:
            raise AssertionError(f"{k}: gradient differs by {diff} (max gradient {gmax})")
        bmax = ref[k].abs().max().item()
        if bmax > 0.1 * gmax:
            worst_dominant = max(worst_dominant, diff / bmax)
            if diff / bmax >= GRAD_TOL:
                raise AssertionError(f"{k}: gradient differs by {diff / bmax:.3e} relative")
    log(f"gradients at B={PARITY_BATCH} ({base.get('mixer', 'mamba')} mixer, scan_impl="
        f"{base.get('scan_impl', 'auto')!r}, against "
        f"scan_impl={plain_impl!r}): loss kernel {losses['kernel']:.7f}, plain "
        f"{losses['plain']:.7f}; worst leaf |diff| {worst_leaf:.3e} of max gradient "
        f"{gmax:.3e}, worst dominant leaf {worst_dominant:.3e} relative")
    return {"batch": PARITY_BATCH, "plain_impl": plain_impl, "losses": losses, "max_grad": gmax,
            "worst_leaf_diff_over_max_grad": worst_leaf,
            "worst_dominant_leaf_rel_diff": worst_dominant, "leaves": len(grads)}


# ---------------------------------------------------------------------------
# the parallel paths: two ranks on the one card
# ---------------------------------------------------------------------------
# Two processes share cuda:0, so their group runs on gloo (NCCL refuses two
# ranks on one device); every collective of the port is an all_reduce, which
# gloo takes on CUDA tensors. The parent builds the kernels before the ranks
# start, and each rank saves its record under build/ for the parent.

TP = 2
# phase 13: the full SSD mixer's core (6 heads of 128, d_state 128) at B=32,
# L=512 over the 2 ranks, two chunks of 128 a rank
SP_SHAPE = dict(B=32, L=512, h=6, p=128, n=128, chunk=128)


def _counts_expect(per_forward: dict, times: int) -> dict[str, int]:
    """``times`` x the launches in ``per_forward`` of each kernel, none of the others."""
    return {k: per_forward.get(k, 0) * times for k in _launch_counts()}


def _full_state(base: dict, seed: int) -> dict:
    """The single-process model's state dict, weights from ``seed``."""
    from si_mamba_tpu_torch.models import PointMamba, PointMambaConfig

    return PointMamba(PointMambaConfig.from_dict(base),
                      generator=torch.Generator().manual_seed(seed)).state_dict()


def _tp_model(base: dict, mesh, sd: dict, rank: int):
    from si_mamba_tpu_torch.models import PointMamba, PointMambaConfig
    from si_mamba_tpu_torch.utils.weights import shard_state_dict

    cfg = PointMambaConfig.from_dict({**base, "tp_axis": "model"})
    model = PointMamba(cfg, mesh=mesh)
    model.load_state_dict(shard_state_dict(sd, cfg, rank, TP), strict=True)
    return model


def tp_serving_rank(device, mesh, rank: int) -> tuple[dict, dict]:
    """Phase 11: the SSD classifier with its mixers over the 2-rank model axis
    serves requests of REQUEST_SIZES clouds; every forward must launch the
    conv 24 times (x and B|C, 12 blocks) and the lean K6 12 times, nothing
    else, and the logits match the single-process 'xla' model."""
    from si_mamba_tpu_torch.models import PointMamba, PointMambaConfig
    from si_mamba_tpu_torch.serving import Predictor

    sd = _full_state(MODELNET40_SSD, seed=0)
    predictor = Predictor(_tp_model(MODELNET40_SSD, mesh, sd, rank), npoints=NPOINTS,
                          max_batch=64, device=device)
    predictor.warmup()
    requests = {n: clouds(n, seed=n) for n in REQUEST_SIZES}
    _reset_launch_counts()  # the main path: counts from 0, then only the requests
    latency, logits, forwards = {}, {}, 0
    for n, batch in requests.items():
        times = []
        for _ in range(REPEATS):
            t0 = time.perf_counter()
            out = predictor.logits(batch)
            times.append(time.perf_counter() - t0)
            forwards += -(-n // predictor.max_batch)
        if out.shape != (n, MODELNET40["cls_dim"]) or not np.isfinite(out).all():
            raise AssertionError(f"bad TP logits for a request of {n}: {out.shape}")
        latency[n], logits[n] = times, out
    launches = _launch_counts()
    want = _counts_expect({"causal_conv1d_silu": 24, "ssd_split_fwd": 12}, forwards)
    if launches != want:
        raise AssertionError(f"rank {rank}: {forwards} TP forwards launched {launches}; "
                             f"expected {want}")
    plain_model = PointMamba(PointMambaConfig.from_dict({**MODELNET40_SSD, "scan_impl": "xla"}))
    plain_model.load_state_dict(sd, strict=True)
    ref = Predictor(plain_model, npoints=NPOINTS, max_batch=64, device=device).logits(
        requests[20])
    scale = float(np.abs(ref).max())
    err = float(np.abs(logits[20] - ref).max())
    if not np.allclose(logits[20], ref, atol=1e-3 * scale, rtol=2e-3):
        raise AssertionError(f"rank {rank}: TP logits disagree with the single-process 'xla' "
                             f"model: max |diff| {err}, max |logit| {scale}")
    record = {"logits_max_abs_diff": err, "logits_max_abs": scale, "forwards": forwards}
    for n, times in latency.items():
        p50 = statistics.median(times)
        record[str(n)] = {"p50_ms": p50 * 1e3, "clouds_per_s": n / p50,
                          "latencies_ms": [t * 1e3 for t in times]}
    if rank == 0:
        log(f"rank 0: TP SSD serving ok, {forwards} forwards launched {launches}; " +
            ", ".join(f"{n} clouds p50 {record[str(n)]['p50_ms']:.3f} ms" for n in latency))
    return launches, record


def tp_train_rank(device, mesh, rank: int) -> tuple[dict, dict]:
    """Phase 12: TRAIN_STEPS steps of the finetune step on the TP SSD
    classifier at batch 32 from 8192-point clouds (the settings of phase 7),
    one generator seed on both ranks; every step must launch the conv
    forward and backward 24 times each and K6 with states and K7 12 times
    each, nothing else; the loss finite; every parameter and BatchNorm
    statistic moved. Then at B = 4, drop rates 0, one forward and backward
    and a global-norm clip at half the norm; the rank-local gradients go back
    for the parent to gather, rank 0's beside the single-process 'xla'
    model's."""
    from si_mamba_tpu_torch.models import PointMamba, PointMambaConfig
    from si_mamba_tpu_torch.models.point_mamba import cross_entropy_loss_acc
    from si_mamba_tpu_torch.train.optim import build_optimizer, clip_grad_norm_
    from si_mamba_tpu_torch.train.runner_finetune import make_train_step
    from si_mamba_tpu_torch.train.train_state import TrainState

    model = _tp_model(MODELNET40_SSD, mesh, _full_state(MODELNET40_SSD, seed=0), rank).to(device)
    optimizer, _ = build_optimizer(model, opt_type="AdamW", lr=3e-4, weight_decay=0.05,
                                   epochs=300, warmup_epochs=10, steps_per_epoch=2,
                                   grad_clip=10.0, tp=model.tp_sharding())
    state = TrainState.create(model, optimizer)
    step = make_train_step(model, NPOINTS, rotation=False)
    pts_np, labels_np = _train_clouds(TRAIN_BATCH, seed=7)
    points, labels = torch.from_numpy(pts_np).to(device), torch.from_numpy(labels_np).to(device)
    generator = torch.Generator(device=device).manual_seed(0)
    params0 = {k: v.detach().clone() for k, v in model.named_parameters()}
    stats0 = {k: v.clone() for k, v in model.named_buffers() if "running" in k}
    expect = _counts_expect({"causal_conv1d_silu": 24, "causal_conv1d_silu_bwd": 24,
                             "ssd_split_fwd_states": 12, "ssd_split_bwd": 12}, 1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    _reset_launch_counts()  # the main path: counts from 0, then only the steps
    times, losses = [], []
    for i in range(TRAIN_STEPS):
        before = _launch_counts()
        t0 = time.perf_counter()
        state, metrics = step(state, points, labels, generator)
        losses.append(metrics["loss"].item())
        times.append(time.perf_counter() - t0)
        now = _launch_counts()
        got = {k: now[k] - before[k] for k in now}
        if got != expect:
            raise AssertionError(f"rank {rank}: TP train step {i + 1} launched {got}, "
                                 f"expected {expect}")
        if not np.isfinite(losses[-1]):
            raise AssertionError(f"rank {rank}: TP train step {i + 1} gave loss {losses[-1]}")
    launches = _launch_counts()
    peak = torch.cuda.max_memory_allocated(device)
    stuck = [k for k, v in model.named_parameters() if torch.equal(v.detach(), params0[k])]
    stats_stuck = [k for k, v in model.named_buffers() if k in stats0 and torch.equal(v, stats0[k])]
    if stuck or stats_stuck:
        raise AssertionError(f"rank {rank}: did not move: {stuck + stats_stuck}")
    p50 = statistics.median(times[1:])
    record = {"batch": TRAIN_BATCH, "points": TRAIN_POINTS, "steps": TRAIN_STEPS,
              "p50_step_ms": p50 * 1e3, "clouds_per_s": TRAIN_BATCH / p50,
              "step_ms": [t * 1e3 for t in times], "losses": losses,
              "max_memory_allocated_bytes": peak, "launches_per_step": expect}
    if rank == 0:
        log(f"rank 0: TP SSD train ok, p50 {p50 * 1e3:.3f} ms, losses {losses}")
    del state, optimizer, model

    # the gradients at B = 4 with a clip below the norm
    no_drop = {**MODELNET40_SSD, "drop_path": 0.0, "cls_head_dropout": 0.0}
    sd = _full_state(no_drop, seed=5)
    model = _tp_model(no_drop, mesh, sd, rank).to(device)
    pts_np, labels_np = _train_clouds(PARITY_BATCH, seed=11)
    pts = torch.from_numpy(pts_np[:, :NPOINTS]).to(device)
    lab = torch.from_numpy(labels_np).to(device)
    per, _ = cross_entropy_loss_acc(model.train()(pts), lab)
    per.mean().backward()
    axis, segments = model.tp_sharding()
    named = dict(model.named_parameters())
    sharded = {id(named[k]): v for k, v in segments.items()}
    norm = float(clip_grad_norm_(named.values(), float("inf"), sharded, axis))
    clip = 0.5 * norm
    clip_grad_norm_(named.values(), clip, sharded, axis)
    grads = {k: p.grad.detach().cpu() for k, p in named.items()}
    record["gradients"] = {"batch": PARITY_BATCH, "loss": per.mean().item(), "norm": norm,
                           "clip": clip}
    ref = None
    if rank == 0:
        plain = PointMamba(PointMambaConfig.from_dict({**no_drop, "scan_impl": "xla"})).to(device)
        plain.load_state_dict(sd, strict=True)
        per_ref, _ = cross_entropy_loss_acc(plain.train()(pts), lab)
        per_ref.mean().backward()
        ref_norm = float(torch.nn.utils.clip_grad_norm_(plain.parameters(), clip))
        ref = {"loss": per_ref.mean().item(), "norm": ref_norm,
               "grads": {k: p.grad.detach().cpu() for k, p in plain.named_parameters()}}
    return launches, dict(record, grads=grads, reference=ref)


def sp_rank(device, rank: int) -> tuple[dict, dict, dict]:
    """Phase 13: ``ssd_seq_parallel(impl='ssd_fused')`` on 2 ranks at B=32,
    L=512 (256 a rank), 6 heads, n = p = 128, chunk 128 (two chunks a rank:
    the carry inside the kernel and the one across ranks). Without a
    gradient it must launch K6 with h_fin once a rank, with one K6 with
    states and h_fin and the seeded K7 once each; y and the gradients of x,
    dt, A, B, C and D match the single-process plain ``ssd_chunked`` on the
    card. Returns (launches without, with a gradient, record)."""
    from si_mamba_tpu_torch.ops.ssd import ssd_chunked
    from si_mamba_tpu_torch.parallel import make_mesh
    from si_mamba_tpu_torch.parallel.seq_scan import ssd_seq_parallel

    mesh = make_mesh(("seq",), (TP,))
    B, L, h, p, n, chunk = (SP_SHAPE[k] for k in ("B", "L", "h", "p", "n", "chunk"))
    rng = np.random.default_rng(13)
    host = {"x": rng.standard_normal((B, L, h, p), dtype=np.float32),
            "dt": np.log1p(np.exp(rng.standard_normal((B, L, h), dtype=np.float32) - 3.0)),
            "A": -np.exp(rng.standard_normal(h, dtype=np.float32)),
            "Bm": 0.3 * rng.standard_normal((B, L, n), dtype=np.float32),
            "Cm": 0.3 * rng.standard_normal((B, L, n), dtype=np.float32),
            "D": rng.standard_normal(h, dtype=np.float32)}
    w = torch.from_numpy(rng.standard_normal((B, L, h, p), dtype=np.float32)).to(device)
    full = {k: torch.from_numpy(np.ascontiguousarray(v, np.float32)).to(device)
            for k, v in host.items()}
    part = slice(rank * (L // TP), (rank + 1) * (L // TP))
    names = ("x", "dt", "A", "Bm", "Cm", "D")
    local = {k: (v[:, part].contiguous() if v.dim() > 1 else v) for k, v in full.items()}

    def run():
        return ssd_seq_parallel(*(local[k] for k in names), mesh=mesh, chunk=chunk,
                                impl="ssd_fused")

    with torch.no_grad():
        run()  # warm-up
        torch.cuda.synchronize()
        _reset_launch_counts()  # the no-gradient path
        y = run()
        torch.cuda.synchronize()
        fwd_launches = _launch_counts()
        fwd_ms = time_ms(run, 5)
    want = _counts_expect({"ssd_split_fwd_hfin": 1}, 1)
    if fwd_launches != want:
        raise AssertionError(f"rank {rank}: SP forward launched {fwd_launches}, expected {want}")

    leaves = {k: v.clone().requires_grad_() for k, v in local.items()}

    def train():
        for v in leaves.values():
            v.grad = None
        out = ssd_seq_parallel(*(leaves[k] for k in names), mesh=mesh, chunk=chunk,
                               impl="ssd_fused")
        torch.sum(out * w[:, part]).backward()
        return out

    _reset_launch_counts()  # the gradient path
    y_g = train()
    torch.cuda.synchronize()
    train_launches = _launch_counts()
    want = _counts_expect({"ssd_split_fwd_states_hfin": 1, "ssd_split_bwd_seeded": 1}, 1)
    if train_launches != want:
        raise AssertionError(f"rank {rank}: SP train launched {train_launches}, expected {want}")
    got = {k: v.grad.clone() for k, v in leaves.items()}
    train_ms = time_ms(train, 3)

    ref_leaves = {k: v.clone().requires_grad_() for k, v in full.items()}
    y_ref = ssd_chunked(*(ref_leaves[k] for k in names), chunk=chunk)
    torch.sum(y_ref * w).backward()
    errs = {"y": _rel_err(y, y_ref[:, part].detach()), "y_grad_path": _rel_err(
        y_g.detach(), y_ref[:, part].detach())}
    for k in names:
        want_g = ref_leaves[k].grad if k in ("A", "D") else ref_leaves[k].grad[:, part]
        errs[f"d{k}"] = _rel_err(got[k], want_g)
    bad = {k: v for k, v in errs.items() if v[1] > (1e-4 if k.startswith("y") else GRAD_TOL)}
    if bad:
        raise AssertionError(f"rank {rank}: SP disagrees with the plain chunked core: {bad}")
    if rank == 0:
        log(f"rank 0: SP ok, forward {fwd_ms:.3f} ms, forward + backward {train_ms:.3f} ms")
    return fwd_launches, train_launches, {
        "shape": dict(B=B, L=L, heads=h, chunk=chunk, ranks=TP), "fwd_ms": fwd_ms,
        "fwd_bwd_ms": train_ms, "rel_err_of_max": {k: v[1] for k, v in errs.items()}}


def tp_mamba_rank(device, mesh, rank: int) -> tuple[dict, dict]:
    """Phase 14: one forward of the full-width Mamba-1 model with its mixers
    over the model axis, ``scan_impl='pallas'``: K1 and K2 12 times a rank,
    nothing else; the logits match the single-process 'seq' model."""
    from si_mamba_tpu_torch.models import PointMamba, PointMambaConfig

    base = {**MODELNET40, "scan_impl": "pallas"}
    sd = _full_state(base, seed=0)
    model = _tp_model(base, mesh, sd, rank).to(device).eval()
    pts = torch.from_numpy(clouds(20, seed=20)).to(device)
    with torch.inference_mode():
        model(pts)  # warm-up
        torch.cuda.synchronize()
        _reset_launch_counts()
        t0 = time.perf_counter()
        logits = model(pts)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = _launch_counts()
    want = _counts_expect({"causal_conv1d_silu": 12, "selective_scan_fwd": 12}, 1)
    if launches != want:
        raise AssertionError(f"rank {rank}: Mamba-1 TP forward launched {launches}, "
                             f"expected {want}")
    plain = PointMamba(PointMambaConfig.from_dict({**MODELNET40, "scan_impl": "seq"}))
    plain.load_state_dict(sd, strict=True)
    with torch.inference_mode():
        ref = plain.to(device).eval()(pts)
    scale = ref.abs().max().item()
    err = (logits - ref).abs().max().item()
    if not torch.allclose(logits, ref, atol=1e-3 * scale, rtol=2e-3):
        raise AssertionError(f"rank {rank}: Mamba-1 TP logits disagree with 'seq': max |diff| "
                             f"{err}, max |logit| {scale}")
    return launches, {"clouds": 20, "forward_ms": ms, "logits_max_abs_diff": err,
                      "logits_max_abs": scale}


def parallel_rank(rank: int, rdzv: str, out_dir: str) -> None:
    """One rank of phases 11-14 (a spawned process on cuda:0, gloo over the
    loopback interface; a collective that waits 10 minutes fails)."""
    import datetime

    import torch.distributed as dist

    from si_mamba_tpu_torch.parallel import make_mesh

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dist.init_process_group("gloo", init_method=f"file://{rdzv}", rank=rank, world_size=TP,
                            timeout=datetime.timedelta(minutes=10))
    try:
        mesh = make_mesh(("model",), (TP,))
        paths, out = {}, {}
        paths["tp_ssd_serving"], out["tp_ssd_serving"] = tp_serving_rank(device, mesh, rank)
        paths["tp_ssd_train"], out["tp_ssd_train"] = tp_train_rank(device, mesh, rank)
        paths["sp"], paths["sp_train"], out["sp"] = sp_rank(device, rank)
        paths["tp_mamba_serving"], out["tp_mamba_serving"] = tp_mamba_rank(device, mesh, rank)
        torch.save({"paths": paths, "records": out}, f"{out_dir}/parallel_rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def parallel_phases(card: str) -> tuple[dict, dict]:
    """Phases 11-14 on TP = 2 ranks, spawned on the one card. Returns (each
    path's launches on rank 0, the record); fails unless both ranks ran
    every phase with the same launches and the same losses, and the
    gathered B = 4 gradients match the single-process model's."""
    import torch.multiprocessing as mp

    from si_mamba_tpu_torch.models import PointMambaConfig
    from si_mamba_tpu_torch.utils.weights import gather_state_dict

    out_dir = ROOT / "build"
    rdzv = out_dir / "parallel_rdzv"
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")  # the ranks share this host
    rdzv.unlink(missing_ok=True)
    t0 = time.perf_counter()
    mp.start_processes(parallel_rank, args=(str(rdzv), str(out_dir)), nprocs=TP,
                       start_method="spawn", join=True)
    wall = time.perf_counter() - t0
    ranks = [torch.load(out_dir / f"parallel_rank{r}.pt", weights_only=False) for r in range(TP)]
    if ranks[0]["paths"] != ranks[1]["paths"]:
        raise AssertionError(f"the ranks launched differently: {[r['paths'] for r in ranks]}")
    train = [r["records"]["tp_ssd_train"] for r in ranks]
    if train[0]["losses"] != train[1]["losses"]:  # bitwise: the ranks hold one model
        raise AssertionError(f"the ranks' losses differ: {[t['losses'] for t in train]}")

    cfg = PointMambaConfig.from_dict({**MODELNET40_SSD, "tp_axis": "model"})
    grads = gather_state_dict([t.pop("grads") for t in train], cfg)
    ref = train[0].pop("reference")
    train[1].pop("reference")
    g0 = train[0]["gradients"]
    if not np.isclose(g0["loss"], ref["loss"], rtol=2e-4, atol=0) or not np.isclose(
            g0["norm"], ref["norm"], rtol=1e-4):
        raise AssertionError(f"TP loss {g0['loss']} / norm {g0['norm']} against single-process "
                             f"{ref['loss']} / {ref['norm']}")
    gmax = max(g.abs().max().item() for g in ref["grads"].values())
    worst_leaf, worst_dominant = 0.0, 0.0
    for k, want in ref["grads"].items():
        diff = (grads[k] - want).abs().max().item()
        worst_leaf = max(worst_leaf, diff / gmax)
        if diff >= GRAD_TOL * gmax:
            raise AssertionError(f"TP gradient {k} differs by {diff} (max gradient {gmax})")
        bmax = want.abs().max().item()
        if bmax > 0.1 * gmax:
            worst_dominant = max(worst_dominant, diff / bmax)
    g0.update(reference_loss=ref["loss"], reference_norm=ref["norm"], max_grad=gmax,
              worst_leaf_diff_over_max_grad=worst_leaf,
              worst_dominant_leaf_rel_diff=worst_dominant)
    rec = ranks[0]["records"]
    log(f"TP SSD serving (2 ranks, gloo, one card): " + ", ".join(
        f"{n} clouds p50 {rec['tp_ssd_serving'][str(n)]['p50_ms']:.3f} ms" for n in REQUEST_SIZES)
        + f"; logits vs 'xla' max |diff| {rec['tp_ssd_serving']['logits_max_abs_diff']:.3e}")
    for r, t in enumerate(train):
        log(f"TP SSD train rank {r}: p50 {t['p50_step_ms']:.3f} ms, {t['clouds_per_s']:.2f} "
            f"clouds/s, peak {t['max_memory_allocated_bytes'] / 2**30:.3f} GiB, losses "
            f"{['%.4f' % v for v in t['losses']]}")
    log(f"TP gradients at B={PARITY_BATCH}, clipped at {g0['clip']:.4f} (norm {g0['norm']:.4f}, "
        f"single-process {ref['norm']:.4f}): worst leaf {worst_leaf:.3e} of max gradient "
        f"{gmax:.3e}, worst dominant leaf {worst_dominant:.3e} relative")
    log(f"SP: {rec['sp']}")
    log(f"Mamba-1 TP: {rec['tp_mamba_serving']}; ranks' wall {wall:.1f} s")
    record = {"ranks": TP, "backend": "gloo", "wall_s": wall, "card": card,
              "tp_ssd_serving": rec["tp_ssd_serving"],
              "tp_ssd_train": {f"rank{r}": t for r, t in enumerate(train)},
              "sp": rec["sp"], "tp_mamba_serving": rec["tp_mamba_serving"]}
    return ranks[0]["paths"], record


# phase 15: the finetune harness through its CLI, at the preset's full model
HARNESS_CLASSES = 40
HARNESS_TRAIN = 64  # two steps an epoch at the preset's total_bs 32, drop_last
HARNESS_TEST = 80  # 40 copies of one cloud, then 40 distinct clouds, each set labelled 0..39
HARNESS_FPS_CHECK = 4  # train clouds whose cached FPS is held against the CPU's
HARNESS_VOTES = 10


def write_modelnet_tree(root: Path, splits: dict, n_classes: int = HARNESS_CLASSES) -> Path:
    """A ModelNet40-format tree: ``modelnet40_shape_names.txt``, one list a
    split, and each cloud (N, 6: x y z and a normal) as comma-separated text
    under its class. ``splits``: split -> [(label, cloud), ...]."""
    names = [f"class{c:02d}" for c in range(n_classes)]
    root.mkdir(parents=True, exist_ok=True)
    (root / "modelnet40_shape_names.txt").write_text("\n".join(names) + "\n")
    for split, clouds in splits.items():
        ids = []
        for k, (label, cloud) in enumerate(clouds):
            (root / names[label]).mkdir(exist_ok=True)
            ids.append(f"{names[label]}_{split}{k:04d}")
            np.savetxt(root / names[label] / f"{ids[-1]}.txt", cloud, fmt="%.6f", delimiter=",")
        (root / f"modelnet40_{split}.txt").write_text("\n".join(ids) + "\n")
    return root


class _LogCapture:
    """The messages of the port's logger while it is entered."""

    def __enter__(self):
        import logging

        class Handler(logging.Handler):
            def emit(inner, record):
                self.messages.append(record.getMessage())

        self.messages, self.handler = [], Handler()
        self.logger = logging.getLogger("si_mamba_tpu_torch")
        self.logger.addHandler(self.handler)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self.handler)


def harness_phase(device, card: str) -> tuple[dict, dict]:
    """The finetune harness through ``si_mamba_tpu_torch.train.cli.main``,
    in-process, on a ModelNet40-format tree written under build/harness/ from
    a seed: 64 train clouds (labels 0..39 in turn) and 80 test clouds: 40
    copies of one cloud labelled 0..39, so that every validation gets at
    least one right and the run saves ckpt-best, then 40 distinct clouds
    labelled 0..39, so that a fault that swaps or mixes rows shows in the
    logits; 8192 points each. The FPS cache built on the card is held against
    ``fps_indices`` on the CPU for a few train clouds. The
    experiment config is cfgs/finetune_modelnet.yaml (the published model at
    full width and depth) with max_epoch 1 and its dataset entries on the
    tree. Runs: the finetune (epochs 0 and 1, two steps each, a validation
    after each), ``--test`` of its ckpt-last.pth, ``--resume`` of the
    finished run, and one ``validate_vote`` of 10 passes. Returns (each
    run's launches, the record)."""
    import shutil
    import types

    from si_mamba_tpu_torch.data.datasets import ModelNet, fps_indices
    from si_mamba_tpu_torch.train import checkpoint as ckpt
    from si_mamba_tpu_torch.train import cli
    from si_mamba_tpu_torch.train import runner_finetune as rf
    from si_mamba_tpu_torch.train.config import get_config
    from si_mamba_tpu_torch.train.registry import build_model_from_cfg
    from si_mamba_tpu_torch.train.yaml_subset import load as yaml_load
    from si_mamba_tpu_torch.utils.weights import load_state_dict_file

    t_phase = time.perf_counter()
    work = ROOT / "build" / "harness"
    shutil.rmtree(work, ignore_errors=True)
    rng = np.random.default_rng(11)
    t0 = time.perf_counter()
    def cloud():
        return rng.standard_normal((TRAIN_POINTS, 6)).astype(np.float32)

    copied = cloud()
    train_clouds = [(i % HARNESS_CLASSES, cloud()) for i in range(HARNESS_TRAIN)]
    data = write_modelnet_tree(work / "modelnet40", {
        "train": train_clouds,
        "test": [(c % HARNESS_CLASSES, copied if c < HARNESS_CLASSES else cloud())
                 for c in range(HARNESS_TEST)]})
    write_s = time.perf_counter() - t0
    (work / "modelnet40.yaml").write_text(
        f"NAME: ModelNet\nDATA_PATH: {data}\nN_POINTS: {TRAIN_POINTS}\n"
        f"NUM_CATEGORY: {HARNESS_CLASSES}\nUSE_NORMALS: FALSE\n")
    exp_cfg = work / "harness_modelnet.yaml"
    exp_cfg.write_text(f"_base_: {ROOT}/cfgs/finetune_modelnet.yaml\nmax_epoch: 1\ndataset:\n" + "".join(
        f"  {name}: {{_base_: {work}/modelnet40.yaml, others: {{subset: '{subset}'}}}}\n"
        for name, subset in (("train", "train"), ("val", "test"), ("test", "test"))))
    config = get_config(str(exp_cfg))
    if (config.model.trans_dim, config.model.depth, config.total_bs) != (384, 12, TRAIN_BATCH):
        raise AssertionError(f"the harness config is not the preset's: {config.model}")
    depth = int(config.model.depth)

    # the FPS caches (8192 of 8192 points, the preset's N_POINTS) on the card
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for subset in ("train", "test"):
        ModelNet(str(data), subset=subset, npoints=TRAIN_POINTS, device=device)
    torch.cuda.synchronize()
    cache_s = time.perf_counter() - t0
    # the cache's points are those the CPU's FPS picks from the written text
    with open(data / f"modelnet40_train_{TRAIN_POINTS}pts_fps.dat", "rb") as f:
        cached, _ = pickle.load(f)
    t0 = time.perf_counter()
    for k in range(HARNESS_FPS_CHECK):
        written = np.loadtxt(data / f"class{k:02d}" / f"class{k:02d}_train{k:04d}.txt",
                             delimiter=",").astype(np.float32)
        rows = fps_indices(torch.from_numpy(written[None, :, :3]), TRAIN_POINTS)[0].numpy()
        if not np.array_equal(cached[k], written[rows]):
            raise AssertionError(f"train cloud {k}: the FPS cache built on the card differs from "
                                 f"fps_indices on the CPU")
    fps_check_s = time.perf_counter() - t0

    steps, validations, saves = [], [], []
    real = (rf.make_train_step, rf.validate, ckpt.save_checkpoint)

    def delta(before):
        now = _launch_counts()
        return {k: now[k] - before[k] for k in now}

    def timed_train_step(*a, **k):
        step = real[0](*a, **k)

        def run(*sa, **sk):
            torch.cuda.synchronize()
            before, t = _launch_counts(), time.perf_counter()
            state, metrics = step(*sa, **sk)
            loss = metrics["loss"].item()
            steps.append({"ms": (time.perf_counter() - t) * 1e3, "loss": loss,
                          "launches": delta(before)})
            return state, metrics

        return run

    def timed_validate(eval_step, state, loader, epoch=0):
        logits = []

        def recording(st, pts):
            logits.append(eval_step(st, pts))
            return logits[-1]

        torch.cuda.synchronize()
        before, t = _launch_counts(), time.perf_counter()
        acc = real[1](recording, state, loader, epoch)
        validations.append({"ms": (time.perf_counter() - t) * 1e3, "acc": acc,
                            "forwards": len(logits), "launches": delta(before),
                            "logits": torch.cat(logits).float().cpu()})
        return acc

    def timed_save(exp_dir, prefix, *a, **k):
        t = time.perf_counter()
        real[2](exp_dir, prefix, *a, **k)
        saves.append({"prefix": prefix, "ms": (time.perf_counter() - t) * 1e3})

    cwd = os.getcwd()
    os.chdir(work)  # the CLI's experiments/ tree
    rf.make_train_step, rf.validate, ckpt.save_checkpoint = timed_train_step, timed_validate, timed_save
    paths = {}
    try:
        base = ["--config", str(exp_cfg), "--device", "cuda"]
        with _LogCapture() as train_log:
            _reset_launch_counts()  # the harness's main path: the finetune run
            t0 = time.perf_counter()
            state, best = cli.main(base + ["--exp_name", "run"])
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            paths["harness_train"] = _launch_counts()
        exp = work / "experiments" / "harness_modelnet" / "run"
        train_val = list(validations)

        _reset_launch_counts()
        validations.clear()
        test_acc = cli.main(base + ["--exp_name", "test", "--test", "--ckpts",
                                    str(exp / "ckpt-last.pth")])
        paths["harness_eval"] = _launch_counts()
        test_val = validations[0]

        with _LogCapture() as resume_log:
            _reset_launch_counts()
            resumed, _ = cli.main(base + ["--exp_name", "run", "--resume"])
            resume_counts = _launch_counts()
    finally:
        rf.make_train_step, rf.validate, ckpt.save_checkpoint = real
        os.chdir(cwd)

    # the finetune run: 2 epochs of 2 steps, each step the train kernels once a
    # block and no other kernel; each validation forward the eval kernels
    n_steps = 2 * (HARNESS_TRAIN // TRAIN_BATCH)
    if len(steps) != n_steps or state.step != n_steps:
        raise AssertionError(f"the finetune run took {len(steps)} steps, expected {n_steps}")
    for i, s in enumerate(steps):
        if s["launches"] != _expect(depth, TRAIN_KERNELS):
            raise AssertionError(f"harness train step {i} launched {s['launches']}")
        if not np.isfinite(s["loss"]):
            raise AssertionError(f"harness train step {i} gave loss {s['loss']}")
    for v in train_val + [test_val]:
        if v["launches"] != _expect(depth * v["forwards"], EVAL_KERNELS):
            raise AssertionError(f"a harness validation of {v['forwards']} forwards launched "
                                 f"{v['launches']}")
    if len(train_val) != 2 or any(v["acc"] < 100.0 / HARNESS_TEST for v in train_val):
        raise AssertionError(f"validation accuracies {[v['acc'] for v in train_val]}: the "
                             f"{HARNESS_CLASSES} copies of one cloud give at least one right")
    for v in train_val:
        copies = v["logits"][:HARNESS_CLASSES]
        spread = (copies - copies[:1]).abs().max().item()
        if spread > 1e-4 * copies.abs().max().item():
            raise AssertionError(f"one batch's copies of one cloud got logits {spread} apart")
    expect_total = {k: sum(s["launches"][k] for s in steps) +
                    sum(v["launches"][k] for v in train_val) for k in _launch_counts()}
    if paths["harness_train"] != expect_total:
        raise AssertionError(f"the finetune run launched {paths['harness_train']} in all, its "
                             f"steps and validations {expect_total}")
    files = {p.name for p in exp.iterdir()}
    missing = {"ckpt-best.pth", "ckpt-last.pth", "config.yaml", "scalars.jsonl"} - files
    if missing:
        raise AssertionError(f"the finetune run did not write {missing}")
    # best (when the accuracy rose), then last, each epoch
    order, best_acc = [], 0.0
    for v in train_val:
        if v["acc"] > best_acc:
            order.append("ckpt-best")
            best_acc = v["acc"]
        order.append("ckpt-last")
    if [s["prefix"] for s in saves] != order:
        raise AssertionError(f"checkpoints saved in the order {saves}, the accuracies "
                             f"{[v['acc'] for v in train_val]} give {order}")
    best_epoch = torch.load(exp / "ckpt-best.pth", map_location="cpu", weights_only=True)["epoch"]
    if train_val[best_epoch]["acc"] != best_acc:
        raise AssertionError(f"ckpt-best.pth holds epoch {best_epoch}, the best is {best_acc}")
    with open(exp / "config.yaml") as f:
        if yaml_load(f.read()) != config:
            raise AssertionError("the config snapshot does not read back to the config")
    scalars = [json.loads(line) for line in (exp / "scalars.jsonl").read_text().splitlines()]
    tags = [(r["tag"], r["step"]) for r in scalars]
    if tags != [(t, e) for e in (0, 1) for t in ("Loss/Epoch/Loss", "LR", "Metric/ACC")]:
        raise AssertionError(f"scalars.jsonl holds {tags}")
    if not all(np.isfinite(r["value"]) for r in scalars):
        raise AssertionError(f"non-finite scalars: {scalars}")
    last_acc = [r["value"] for r in scalars if r["tag"] == "Metric/ACC"][-1]

    # --test of ckpt-last: the last validation's accuracy, and its logits
    if test_acc != last_acc:
        raise AssertionError(f"--test gave {test_acc}, the last validation {last_acc}")
    if paths["harness_eval"] != _expect(depth * test_val["forwards"], EVAL_KERNELS):
        raise AssertionError(f"--test launched {paths['harness_eval']}")
    want = train_val[-1]["logits"]
    test_diff = (test_val["logits"] - want).abs().max().item()
    if test_diff > 1e-4 * want.abs().max().item():
        raise AssertionError(f"--test logits differ from the last validation's by {test_diff}")
    if not torch.equal(test_val["logits"].argmax(-1), want.argmax(-1)):
        raise AssertionError("--test predicts other classes than the last validation")

    # --resume of the finished run restores epoch 1 and trains nothing
    payload = torch.load(exp / "ckpt-last.pth", map_location="cpu", weights_only=True)
    if payload["epoch"] != 1 or resumed.step != n_steps:
        raise AssertionError(f"--resume restored epoch {payload['epoch']}, step {resumed.step}")
    if any(resume_counts.values()) or not any("training already complete" in m
                                             for m in resume_log.messages):
        raise AssertionError(f"--resume of a finished run launched {resume_counts}: "
                             f"{resume_log.messages}")

    # one validate_vote of HARNESS_VOTES passes over the test loader
    model, _ = build_model_from_cfg(config.model, device)
    model.load_state_dict(load_state_dict_file(str(exp / "ckpt-last.pth")), strict=True)
    args = types.SimpleNamespace(device="cuda", seed=0, num_workers=4, way=-1, shot=-1, fold=-1)
    loader = cli.build_loader(config.dataset.test, args, "test", TRAIN_BATCH, False, False)
    vote_step = rf.make_vote_step(model, NPOINTS, rotation=False, times=HARNESS_VOTES)
    _reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vote_acc = rf.validate_vote(vote_step, rf.TrainState(0, model, None), loader, seed=0)
    torch.cuda.synchronize()
    vote_ms = (time.perf_counter() - t0) * 1e3
    paths["harness_vote"] = _launch_counts()
    if paths["harness_vote"] != _expect(depth * HARNESS_VOTES * len(loader), EVAL_KERNELS):
        raise AssertionError(f"validate_vote launched {paths['harness_vote']}")

    epoch_s = [float(m.split("EpochTime = ")[1].split()[0]) for m in train_log.messages
               if "EpochTime = " in m]
    step_ms = [s["ms"] for s in steps]
    p50 = statistics.median(step_ms[1:])
    last_save = [s["ms"] for s in saves if s["prefix"] == "ckpt-last"]
    record = {"config": "cfgs/finetune_modelnet.yaml, max_epoch 1", "train_clouds": HARNESS_TRAIN,
              "test_clouds": HARNESS_TEST, "points": TRAIN_POINTS, "batch": TRAIN_BATCH,
              "data_write_s": write_s, "cache_build_s": cache_s,
              "cache_cpu_fps_check_s": fps_check_s, "finetune_run_s": run_s,
              "epoch_s": epoch_s, "step_ms": step_ms, "p50_step_ms": p50,
              "clouds_per_s": TRAIN_BATCH / (p50 / 1e3), "losses": [s["loss"] for s in steps],
              "validation_ms": [v["ms"] for v in train_val], "val_acc": [v["acc"] for v in train_val],
              "test_acc": test_acc, "test_ms": test_val["ms"], "test_logits_max_abs_diff": test_diff,
              "vote_acc": vote_acc, "vote_ms": vote_ms, "vote_passes": HARNESS_VOTES,
              "ckpt_last_bytes": (exp / "ckpt-last.pth").stat().st_size,
              "ckpt_save_ms": [(s["prefix"], s["ms"]) for s in saves],
              "ckpt_last_save_ms": last_save, "phase_s": time.perf_counter() - t_phase,
              "launches": paths, "card": card}
    log(f"harness: data written in {write_s:.1f} s, FPS caches built in {cache_s:.1f} s; "
        f"finetune {run_s:.1f} s, epochs {epoch_s} s, step p50 {p50:.3f} ms "
        f"({TRAIN_BATCH / (p50 / 1e3):.2f} clouds/s), validation "
        f"{[round(v['ms'], 3) for v in train_val]} ms; ckpt-last.pth "
        f"{record['ckpt_last_bytes']} bytes, saved in {[round(v, 3) for v in last_save]} ms; "
        f"test acc {test_acc} (= last validation), vote acc {vote_acc} in {vote_ms:.1f} ms; "
        f"phase {record['phase_s']:.1f} s; {card}")
    return paths, record


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

    records = kernel_phase(device) + backward_kernel_phase(device)
    ssd_records, conv_at_ssd_shape = ssd_kernel_phase(device)
    conv_at_tp_shapes = tp_conv_phase(device)
    for r in records:
        if r["name"] in conv_at_ssd_shape:
            r["at_ssd_shape"] = conv_at_ssd_shape[r["name"]]
            r["at_tp_shapes"] = conv_at_tp_shapes[r["name"]]
    records += ssd_records
    records += split_kernel_phase(device)
    fused_records, fused_routes = fused_mixer_phase(device)
    records += fused_records

    # the six paths, each with every launch count from 0 (set inside each phase)
    paths = {}
    paths["serving"], serving, model, requests = serving_phase(device)
    profile = profile_phase(model, requests)
    del model
    train, paths["train"] = train_phase(device, card)
    grads = gradient_phase(device)
    paths["ssd_serving"], ssd_serving, model, requests = serving_phase(
        device, MODELNET40_SSD, plain_impl="xla", kernels=("causal_conv1d_silu", "ssd_xbc_fwd"))
    ssd_profile = profile_phase(model, requests)
    del model
    ssd_train, paths["ssd_train"] = train_phase(
        device, card, MODELNET40_SSD,
        kernels=("causal_conv1d_silu", "ssd_xbc_fwd_states", "ssd_xbc_bwd",
                 "causal_conv1d_silu_bwd"),
        eval_kernels=("causal_conv1d_silu", "ssd_xbc_fwd"))
    ssd_grads = gradient_phase(device, MODELNET40_SSD, plain_impl="xla")
    paths["fused_serving"], fused_serving, model, requests = serving_phase(
        device, MODELNET40_FUSED, plain_impl="seq", kernels=("fused_mixer_fwd",))
    fused_profile = profile_phase(model, requests)
    del model
    fused_train, paths["fused_train"] = train_phase(
        device, card, MODELNET40_FUSED, kernels=("fused_mixer_fwd_states", "fused_mixer_bwd"),
        eval_kernels=("fused_mixer_fwd",), view_grads=False)
    fused_grads = gradient_phase(device, MODELNET40_FUSED, plain_impl="seq")
    harness_paths, harness = harness_phase(device, card)
    paths.update(harness_paths)
    torch.cuda.empty_cache()  # the ranks share the card
    parallel_paths, parallel = parallel_phases(card)
    paths.update(parallel_paths)

    # each kernel's launches on every path, and on the path it serves
    main_path = {"causal_conv1d_silu": "serving", "selective_scan_fwd": "serving",
                 "selective_scan_fwd_residuals": "train", "selective_scan_bwd": "train",
                 "causal_conv1d_silu_bwd": "train", "ssd_xbc_fwd": "ssd_serving",
                 "ssd_xbc_fwd_states": "ssd_train", "ssd_xbc_bwd": "ssd_train",
                 "fused_mixer_fwd": "fused_serving", "fused_mixer_fwd_states": "fused_train",
                 "fused_mixer_bwd": "fused_train", "ssd_split_fwd": "tp_ssd_serving",
                 "ssd_split_fwd_states": "tp_ssd_train", "ssd_split_bwd": "tp_ssd_train",
                 "ssd_split_fwd_hfin": "sp", "ssd_split_fwd_states_hfin": "sp_train",
                 "ssd_split_bwd_seeded": "sp_train"}
    for r in records:
        r["kernel_ms"] = r["ms"]  # the same time under the field's older name
        r["main_path"] = main_path[r["name"]]
        r["launches_by_path"] = {path: counts[r["name"]] for path, counts in paths.items()}
        r["launches"] = r["launches_by_path"][r["main_path"]]
        if r["launches"] <= 0:
            raise AssertionError(f"{r['name']} was not launched on its path")
    print(json.dumps({"harness": harness}), flush=True)
    print(json.dumps({"serving": serving, "profile": profile, "train": train,
                      "gradients": grads, "ssd": {"serving": ssd_serving, "profile": ssd_profile,
                                                  "train": ssd_train, "gradients": ssd_grads},
                      "fused": {"serving": fused_serving, "profile": fused_profile,
                                "train": fused_train, "gradients": fused_grads,
                                "mixer_interior_ms": fused_routes},
                      "parallel": parallel, "card": card}), flush=True)
    print(json.dumps({"kernels": records}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
