"""Gradient norms of the part-segmentation model at full width, the JAX
package's beside the PyTorch port's on the same weights, on the CPU.

Usage (from the repository root, where JAX is installed):

    python scripts/torch_seg_grad_norms.py [--cases SAST:2 HLT:2 HLT:4 HLT:12]

For each ordering:depth it builds the JAX ``PartSegModel`` with the SSD
mixer (d_model 384, 128 groups of 32, 2 clouds of 2048 points, seeded; the
taps at the last two blocks, three at 12 blocks as the preset's 3, 7, 11),
carries its weights into the port's with ``partseg_state_dict_from_jax``,
and prints the global norm of each framework's train-mode gradient of the
NLL loss, and the norm of the gradient of the first block's norm bias. Both
take the same random draws: the JAX model's HLT tie-break (``jax.random.key(0)``
without an 'order' rng, which the port reproduces bit for bit) and its head
dropout's keep mask (from ``capture_intermediates``), handed to the port's
forward. With HLT the norm grows by about 1e6 every two blocks in both: the
zero slots of the HLT canvas.
"""

from __future__ import annotations

import argparse
import math
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from si_mamba_tpu.models.segmentation import PartSegConfig as JConfig  # noqa: E402
from si_mamba_tpu.models.segmentation import PartSegModel as JModel  # noqa: E402
from si_mamba_tpu.models.segmentation import nll_loss as j_nll  # noqa: E402
from si_mamba_tpu_torch.models.segmentation import (  # noqa: E402
    PartSegConfig,
    PartSegModel,
    nll_loss,
)
from si_mamba_tpu_torch.ops.spectral import prng_key, uniform  # noqa: E402
from si_mamba_tpu_torch.utils.weights import partseg_state_dict_from_jax  # noqa: E402

CASES = ("SAST:2", "HLT:2", "HLT:4", "HLT:12")


def _norm(tensors) -> float:
    return math.sqrt(sum(float(np.sum(np.asarray(t, np.float64) ** 2)) for t in tensors))


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--cases", nargs="+", default=CASES, help="ordering:depth pairs")
    args = parser.parse_args()
    jax.config.update("jax_platforms", "cpu")
    rng = np.random.default_rng(0)
    pts = rng.standard_normal((2, 2048, 3)).astype(np.float32)
    pts /= np.abs(pts).max()
    seg = rng.integers(0, 50, (2, 2048))
    onehot = np.eye(16, dtype=np.float32)[[1, 2]]
    for case in args.cases:
        method, depth = case.split(":")[0], int(case.split(":")[1])
        taps = (3, 7, 11) if depth == 12 else tuple(range(depth - 2, depth))
        kw = dict(depth=depth, fetch_idx=taps, mixer="ssd", drop_path=0.0, method=method)
        jmodel = JModel(JConfig(**kw))
        variables = jax.jit(lambda k: jmodel.init(k, jnp.asarray(pts), jnp.asarray(onehot),
                                                  train=False))(jax.random.key(0))

        def loss(params):
            logp, upd = jmodel.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                     jnp.asarray(pts), jnp.asarray(onehot), train=True,
                                     mutable=["batch_stats", "intermediates"],
                                     capture_intermediates=True,
                                     rngs={"dropout": jax.random.key(1)})
            keep = upd["intermediates"]["Dropout_0"]["__call__"][0] != 0
            return j_nll(logp, jnp.asarray(seg)), keep

        grads, keep = jax.jit(jax.grad(loss, has_aux=True))(variables["params"])
        j_norm = _norm(jax.tree.leaves(grads))
        j_bias = _norm([grads["blocks"]["layers_0"]["norm"]["bias"]])
        model = PartSegModel(PartSegConfig(**kw))
        model.load_state_dict(partseg_state_dict_from_jax(variables["params"],
                                                          variables["batch_stats"]), strict=True)
        noise = torch.from_numpy(uniform(prng_key(0), (2, model.config.num_group)))
        logp = model.train()(torch.from_numpy(pts), torch.from_numpy(onehot),
                             generator=torch.Generator().manual_seed(0), order_noise=noise,
                             head_mask=torch.from_numpy(np.array(keep)))
        nll_loss(logp, torch.from_numpy(seg)).backward()
        t_norm = _norm(p.grad for p in model.parameters() if p.grad is not None)
        t_bias = _norm([model.blocks.layers[0].norm.bias.grad])
        print(f"{method} depth {depth}: gradient norm JAX {j_norm:.6g}, port {t_norm:.6g}; "
              f"first block's norm bias JAX {j_bias:.6g}, port {t_bias:.6g}", flush=True)


if __name__ == "__main__":
    main()
