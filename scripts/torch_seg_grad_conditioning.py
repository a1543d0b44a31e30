"""How well-conditioned the part-segmentation model's gradients are, and so
what a kernel-against-plain gradient check can hold.

Usage (from the repository root):

    python scripts/torch_seg_grad_conditioning.py [--device cuda] [--batch 16]
                                                  [--method HLT] [--depth 4]

It builds the SSD seg preset's model (cfgs/part_segmentation_ssd_fused.yaml at
full width, ``--depth`` blocks with the taps at 1 .. depth-1, drop_path 0,
seeded weights) and takes one train pass on ``--batch`` seeded clouds of 2048
points, one HLT draw and head keep mask for every pass, and prints, each as
the largest difference over the largest value of a tensor:

1. the kernel route ('ssd_fused') against 'xla': the activations at the
   stack's output and the head's layers, and the parameter gradients' worst
   leaves, the biases of rounding-noise gradient left out (on the CPU both
   routes are plain PyTorch);
2. 'xla' against itself with 1e-6 relative noise on the stack's outputs: how
   far that much rounding moves each gradient of the whole model;
3. the stack alone, fed the inputs and tap cotangent of the 'xla' pass, with
   1e-6 relative noise on every mixer's output: how far it moves the stack's
   own gradients; and the kernel stack on the same inputs and cotangent
   against 'xla' (the check of ``chip_smoke.py:seg_grad_phase``).

Imports no JAX.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from si_mamba_tpu_torch.models.segmentation import (  # noqa: E402
    PartSegConfig,
    PartSegModel,
    nll_loss,
)
from si_mamba_tpu_torch.train.config import get_config  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POINTS = 2048
EPS = 1e-6


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a.double() - b.double()).abs().max() / b.double().abs().max()).item()


def _worst(got: dict, want: dict, n: int = 6) -> str:
    """The ``n`` worst leaves, leaving out the biases of rounding-noise
    gradient: below 1e-4 of their layer's weight's in norm (a bias whose every
    effect a train-mode BatchNorm removes)."""
    noise = {k for k in want if k.endswith(".bias") and k[:-4] + "weight" in want
             and want[k].norm() < 1e-4 * want[k[:-4] + "weight"].norm()}
    rows = sorted(((_rel(got[k], want[k]), k) for k in want if k not in noise),
                  reverse=True)[:n]
    return ", ".join(f"{k} {r:.3e}" for r, k in rows) + f" ({len(noise)} noise biases left out)"


def _noisy(eps: float, seed: int):
    """A forward hook that scales a module's output(s) by 1 + eps N(0, 1)."""
    g = torch.Generator().manual_seed(seed)

    def scale(t):
        return t * (1 + eps * torch.randn(t.shape, generator=g).to(t.device))

    def hook(module, args, out):
        return [scale(t) for t in out] if isinstance(out, list) else scale(out)

    return hook


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--method", default="HLT")
    parser.add_argument("--depth", type=int, default=4)
    args = parser.parse_args()
    device = torch.device(args.device)
    m = dict(get_config(os.path.join(ROOT, "cfgs", "part_segmentation_ssd_fused.yaml")).model)
    m.update(depth=args.depth, fetch_idx=tuple(range(1, args.depth)), drop_path=0.0,
             method=args.method)
    cfg = PartSegConfig.from_dict(m)
    weights = PartSegModel(cfg, generator=torch.Generator().manual_seed(7)).state_dict()
    rng = np.random.default_rng(32)
    B = args.batch
    pts = torch.from_numpy(rng.standard_normal((B, POINTS, 3), dtype=np.float32))
    pts = (pts / pts.abs().amax(dim=(1, 2), keepdim=True)).to(device)
    onehot = torch.eye(16, device=device)[torch.from_numpy(rng.integers(0, 16, B)).to(device)]
    seg = torch.from_numpy(rng.integers(0, cfg.cls_dim, (B, POINTS))).to(device)
    draws = dict(order_noise=torch.from_numpy(rng.random((B, cfg.num_group),
                                                         dtype=np.float32)).to(device),
                 head_mask=torch.from_numpy(rng.random((B, POINTS, 512)) < 0.5).to(device))

    def build(impl):
        net = PartSegModel(PartSegConfig.from_dict({**cfg.__dict__, "scan_impl": impl}))
        net.load_state_dict(weights, strict=True)
        return net.to(device).train()

    def train_pass(net, stack_noise=0.0):
        acts = {}

        def keep(name):
            def hook(module, a, out):
                acts[name] = (torch.cat(out, -1) if isinstance(out, list) else out).detach()
                if name == "blocks":  # the stack's inputs and taps, for part 3
                    for t in (*a[:2], *out):
                        t.retain_grad()
                    acts["stack"] = (a[:2], out)
            return hook

        for name in ("blocks", "prop_bn1", "prop_bn2", "convs1", "bns1", "convs3"):
            getattr(net, name).register_forward_hook(keep(name))
        if stack_noise:
            net.blocks.register_forward_hook(_noisy(stack_noise, 1))
        loss = nll_loss(net(pts, onehot, **draws), seg)
        loss.backward()
        grads = {k: p.grad.detach().clone() for k, p in net.named_parameters()}
        return loss.item(), acts, grads

    plain = build("xla")
    loss, acts, grads = train_pass(plain)
    print(f"{args.method}, depth {args.depth}, batch {B}, {device}: loss {loss:.7f}")
    k_loss, k_acts, k_grads = train_pass(build("ssd_fused"))
    print(f"1. kernel route against 'xla': loss {k_loss:.7f}; activations "
          + ", ".join(f"{k} {_rel(k_acts[k], acts[k]):.3e}" for k in acts if k != "stack"))
    print(f"   gradients, worst leaves: {_worst(k_grads, grads)}")
    _, _, n_grads = train_pass(build("xla"), stack_noise=EPS)
    print(f"2. 'xla' with {EPS:g} noise on the stack's outputs: {_worst(n_grads, grads)}")

    (x0, pos0), taps = acts["stack"]
    cot = [t.grad for t in taps]
    ref = {**{k: p.grad for k, p in plain.blocks.named_parameters()},
           "x": x0.grad, "pos": pos0.grad}

    def stack_grads(net, mixer_noise=0.0):
        if mixer_noise:
            for i, layer in enumerate(net.blocks.layers):
                layer.mixer.register_forward_hook(_noisy(mixer_noise, 10 + i))
        x, pos = (t.detach().requires_grad_() for t in (x0, pos0))
        torch.autograd.backward(net.blocks(x, pos), cot)
        return {**{k: p.grad for k, p in net.blocks.named_parameters()},
                "x": x.grad, "pos": pos.grad}

    print(f"3. the stack on one cotangent, {EPS:g} noise on each mixer's output: "
          f"{_worst(stack_grads(build('xla'), EPS), ref)}")
    print(f"   the kernel stack against 'xla': {_worst(stack_grads(build('ssd_fused')), ref)}")


if __name__ == "__main__":
    main()
