"""Per-block readings of the wide SSDMixer stacks' per-head gradients at bf16.

For each wide geometry of ``chip_smoke.py`` phase 57 (WIDE_GEOMETRIES) and
each weight seed: the 12-block stack on the kernel route
(``scan_impl='ssd_fused'``), its forward and backward at B=4, L=512; then for
every block and every per-head scalar (A_log, D, dt_bias), on that block's
own inputs (its input on the kernel stack, the gradient at its output), the
kernel route's gradient and the plain bf16 route's, each against its fp32
truth (``chip_smoke._head_truth``), as ``chip_smoke._wide_own_rule`` reads
them. Weight seed 400 is the one phase 57 runs. Writes every figure and each
stack's median and largest to ``--out``. Runs on the card only.

    python scripts/torch_wide_head_grads.py [--seeds 400 900]
        [--out chiprun_out/wide_head_grads.json]
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def stack_figures(device, n: int, p: int, seed: int) -> list[dict]:
    """Every block's per-head figures (``chip_smoke._per_head_figures``) on
    the (``n``, ``p``) stack with weights from ``seed``."""
    from si_mamba_tpu_torch.models.layers import SSDMixer

    kw = dict(d_state=n, head_dim=p, chunk=cs.WIDE_CHUNK)
    blocks = [SSDMixer(384, scan_impl="ssd_fused", **kw) for _ in range(cs.WIDE_DEPTH)]
    for i, blk in enumerate(blocks):
        blk.reset_parameters(torch.Generator().manual_seed(seed + i))
    kernel = torch.nn.ModuleList(blocks).to(device)
    plain = torch.nn.ModuleList(SSDMixer(384, **kw) for _ in range(cs.WIDE_DEPTH)).to(device)
    plain.load_state_dict(kernel.state_dict())
    x = cs._rand(device, 4, 512, 384, seed=n + p, dtype=torch.bfloat16)
    g = cs._rand(device, 4, 512, 384, seed=n + p + 1, dtype=torch.bfloat16)
    inputs = []
    cs._stack_run(kernel, x.detach().requires_grad_(), inputs).backward(g)
    rows = []
    for i, (kb, pb) in enumerate(zip(kernel, plain)):
        u = inputs[i].detach()
        dy = inputs[i + 1].grad if i + 1 < len(inputs) else g
        gp = torch.autograd.grad(pb(u), [getattr(pb, k) for k in cs.WIDE_PER_HEAD], dy)
        tk = cs._head_truth(pb, u, dy, ("in_proj_w", "out_proj_w"))
        tp = cs._head_truth(pb, u, dy, ("in_proj_w", "out_proj_w", "conv_w", "conv_b"))
        for k, a, b, t, t_p in zip(cs.WIDE_PER_HEAD,
                                   (getattr(kb, k).grad for k in cs.WIDE_PER_HEAD), gp, tk, tp):
            rows.append(dict(block=i, leaf=k, **cs._per_head_figures(a, b, t, t_p)))
    return rows


def summary(rows: list[dict]) -> dict:
    out = {}
    for key in ("from_truth", "plain_from_truth", "from_plain"):
        vals = [r[key] for r in rows]
        out[key] = {"median": statistics.median(vals), "max": max(vals)}
    out["passes_rule"] = all(cs._per_head_holds(r) for r in rows)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[400, 900])
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "wide_head_grads.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_wide_head_grads: no CUDA device; this script runs on the GPU")
    from si_mamba_tpu_torch.ops.kernels.build import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    build()
    device = torch.device("cuda", 0)
    result, every = {"card": cs.card_line(), "stacks": {}}, []
    for (n, p) in cs.WIDE_GEOMETRIES:
        for seed in args.seeds:
            rows = stack_figures(device, n, p, seed)
            every += rows
            result["stacks"][f"n{n}_p{p}_seed{seed}"] = {"summary": summary(rows), "rows": rows}
            print(f"n {n} p {p} seed {seed}: {summary(rows)}", flush=True)
    result["all"] = summary(every)
    result["gradients"] = len(every)
    print(f"all {len(every)} gradients: {result['all']}", flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
