#!/usr/bin/env python3
"""Time the boundary-fused SSD kernels (K8 lean, K8 with states, K9) of the
PyTorch port built from two source trees, in one process on one card.

    python scripts/torch_ssd_kernel_ab.py --other <dir with ssd_xbc_fwd.cu, ssd_xbc_bwd.cu>

``--other`` is typically the ``si_mamba_tpu_torch/csrc`` of another commit
unpacked with ``git archive``. Both trees are built with the port's nvcc
flags into ``build/ab/`` (``torch_ab_common.build``); the kernels run at the
SSD classifier's shapes (B=32, L=512, chunk 256, 6 heads of 128, d_state
128, the conv output of layer 0's mixer as in ``chip_smoke.py``) in turns
this, other, other, this (ROUNDS times), and the script prints each kernel's
mean time per tree as one JSON line, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

import torch

from torch_ab_common import ROOT, build, means, round_robin

ROUNDS = 5
NAMES = ("ssd_xbc_fwd", "ssd_xbc_bwd")


def _declare(libs: dict[str, ctypes.CDLL]) -> dict[str, ctypes.CDLL]:
    """Declare the C interfaces of a tree's K8/K9 libraries."""
    for name, lib in libs.items():
        fn = getattr(lib, name)
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_longlong] * 2
                       + [ctypes.c_void_p]) if name == "ssd_xbc_fwd" else \
            [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7 + [ctypes.c_longlong] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        err = getattr(lib, f"{name}_error_string")
        err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, type=Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_ssd_kernel_ab: no CUDA device")
    import chip_smoke as cs
    from si_mamba_tpu_torch.ops.kernels import ssd as kssd

    card = cs.card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    trees = {"this": _declare(build(ROOT / "si_mamba_tpu_torch" / "csrc", NAMES, "this")[0]),
             "other": _declare(build(args.other, NAMES, "other")[0])}
    device = torch.device("cuda", 0)
    x6, dth, S, _, _, xbc, D, chunk = cs._split_operands(device, heads=6)
    d = x6.shape[-1]
    dy = torch.randn(x6.shape, device=device, generator=torch.Generator(device).manual_seed(0))
    _, h_in = kssd.ssd_xbc_fwd_ref(xbc, dth, S, D, d, chunk, emit_states=True)
    kernels = {"ssd_xbc_fwd": lambda: kssd.ssd_xbc_fwd(xbc, dth, S, D, d, chunk),
               "ssd_xbc_fwd_states": lambda: kssd.ssd_xbc_fwd_states(xbc, dth, S, D, d, chunk),
               "ssd_xbc_bwd": lambda: kssd.ssd_xbc_bwd(xbc, dth, S, D, h_in, dy, d, chunk)}

    def bind(tree):
        kssd._fwd_library = lambda: trees[tree]["ssd_xbc_fwd"]
        kssd._bwd_library = lambda: trees[tree]["ssd_xbc_bwd"]

    times = round_robin({tree: (lambda tree=tree: bind(tree)) for tree in trees},
                        {k: (lambda tree, fn=fn: fn()) for k, fn in kernels.items()},
                        {"eager": cs.time_ms}, ROUNDS,
                        calls=lambda name: 10 if name == "ssd_xbc_bwd" else 20)["eager"]
    mean = means({"eager": times})["eager"]
    print(json.dumps({"card": card, "rounds": ROUNDS, "mean_ms": mean, "ms": times,
                      "this_over_other": {k: mean["this"][k] / mean["other"][k]
                                          for k in kernels}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
