"""The Mamba-1 sequence-parallel scan of two source trees on the same card:
``si_mamba_tpu_torch/parallel/seq_scan.py:selective_scan_seq_parallel`` of
this tree and of another (``--other <dir>``, a commit unpacked with ``git
archive`` into an ignored directory such as ``build/parent``), on two gloo
ranks sharing ``cuda:0`` as ``chip_smoke.py``'s parallel phases run them.

Both ranks load the other tree's ``seq_scan.py`` by its path beside this
tree's package (the rest of the package is this tree's), then time the
forward without a gradient and the forward + backward of each, in turns
this, other, other, this, at layer 0's shape of the ModelNet40 classifier:
B=32, L=512 (256 a rank), d_inner 768, d_state 16, on seeded operands. Each
time is the mean of ``--iters`` calls between two synchronisations, and the
peak allocation of one forward + backward is read alone. The two trees' y
and gradients must agree within 1e-4 of their max.

    python scripts/torch_seq_scan_ab.py --other build/parent [--iters 5] [--rounds 2]

Rank 0 prints one JSON object and writes it to ``build/seq_scan_ab.json`` (or ``--out``).
"""

from __future__ import annotations

import argparse
import datetime
import importlib.util
import json
import os
import socket
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
ORDER = ("this", "other", "other", "this")
SHAPE = dict(B=32, L=512, d=768, n=16)
WORLD = 2


def _operands(device):
    rng = np.random.default_rng(0)
    B, L, d, n = SHAPE["B"], SHAPE["L"], SHAPE["d"], SHAPE["n"]

    def f(*s):
        return torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to(device)

    A = -torch.arange(1, n + 1, dtype=torch.float32, device=device).repeat(d, 1)
    return dict(u=torch.nn.functional.silu(f(B, L, d)), delta=f(B, L, d) - 3.0, A=A,
                B=0.3 * f(B, L, n), C=0.3 * f(B, L, n), D=torch.ones(d, device=device),
                z=f(B, L, d), delta_bias=0.1 * f(d)), f(B, L, d)


def _rank(rank: int, port: int, other: str, iters: int, rounds: int, out: str) -> None:
    import torch.distributed as dist

    from si_mamba_tpu_torch.parallel import make_mesh
    from si_mamba_tpu_torch.parallel.seq_scan import selective_scan_seq_parallel

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=WORLD, timeout=datetime.timedelta(minutes=10))
    try:
        spec = importlib.util.spec_from_file_location(
            "other_seq_scan", Path(other) / "si_mamba_tpu_torch" / "parallel" / "seq_scan.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        fns = {"this": selective_scan_seq_parallel, "other": mod.selective_scan_seq_parallel}
        mesh = make_mesh(("seq",), (WORLD,))
        full, w = _operands(device)
        part = slice(rank * SHAPE["L"] // WORLD, (rank + 1) * SHAPE["L"] // WORLD)
        seq = ("u", "delta", "B", "C", "z")
        local = {k: (v[:, part].contiguous() if k in seq else v) for k, v in full.items()}
        w = w[:, part].contiguous()

        def fwd(tree, t):
            return fns[tree](t["u"], t["delta"], t["A"], t["B"], t["C"], D=t["D"], z=t["z"],
                             delta_bias=t["delta_bias"], mesh=mesh)

        def step(tree):
            leaves = {k: v.clone().requires_grad_() for k, v in local.items()}
            y = fwd(tree, leaves)
            torch.sum(y * w).backward()
            return y.detach(), {k: v.grad for k, v in leaves.items()}

        def timed(fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) / iters * 1e3

        results = {tree: step(tree) for tree in fns}  # warm, and the values held
        y_err = float((results["this"][0] - results["other"][0]).abs().max()
                      / results["other"][0].abs().max())
        g_err = {k: float((v - results["other"][1][k]).abs().max()
                          / results["other"][1][k].abs().max().clamp_min(1e-30))
                 for k, v in results["this"][1].items()}
        if y_err > 1e-4 or max(g_err.values()) > 1e-4:
            raise AssertionError(f"the trees disagree: y {y_err}, gradients {g_err}")
        times = {tree: {"fwd_ms": [], "fwd_bwd_ms": []} for tree in fns}
        for _ in range(rounds):
            for tree in ORDER:
                with torch.no_grad():
                    times[tree]["fwd_ms"].append(timed(lambda: fwd(tree, local)))
                times[tree]["fwd_bwd_ms"].append(timed(lambda: step(tree)))
        peaks = {}
        for tree in fns:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
            base = torch.cuda.memory_allocated(device)
            step(tree)
            torch.cuda.synchronize()
            peaks[tree] = (torch.cuda.max_memory_allocated(device) - base) / 2**30
        if rank == 0:
            record = {"shape": {**SHAPE, "ranks": WORLD}, "iters": iters, "rounds": rounds,
                      "order": ORDER, "times": times,
                      "mean": {tree: {k: sum(v) / len(v) for k, v in t.items()}
                               for tree, t in times.items()},
                      "fwd_bwd_peak_gib": peaks, "y_rel_err": y_err, "grad_rel_err": g_err,
                      "other": other, "card": torch.cuda.get_device_name(0)}
            Path(out).parent.mkdir(parents=True, exist_ok=True)
            Path(out).write_text(json.dumps(record, indent=1))
            print(json.dumps(record), flush=True)
    finally:
        dist.destroy_process_group()


def main() -> None:
    import torch.multiprocessing as mp

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--other", required=True, help="the other tree's root")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out", default=str(ROOT / "build" / "seq_scan_ab.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_seq_scan_ab: no CUDA device")
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")  # the ranks share this host
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    mp.start_processes(_rank, args=(port, args.other, args.iters, args.rounds, args.out),
                       nprocs=WORLD, start_method="spawn", join=True)


if __name__ == "__main__":
    main()
