#!/usr/bin/env python3
"""Time the boundary-fused SSD kernels (K8 lean, K8 with states, K9) of the
PyTorch port built from two source trees, in one process on one card.

    python scripts/torch_ssd_kernel_ab.py --other <dir with ssd_xbc_fwd.cu, ssd_xbc_bwd.cu>

``--other`` is typically the ``si_mamba_tpu_torch/csrc`` of another commit
unpacked with ``git archive``. Both trees are built with the port's nvcc
flags into ``build/ab/``; the kernels run at the SSD classifier's shapes
(B=32, L=512, chunk 256, 6 heads of 128, d_state 128, the conv output of
layer 0's mixer as in ``chip_smoke.py``) in turns this, other, other, this
(ROUNDS times), and the script prints each kernel's mean time per tree as one
JSON line, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
ROUNDS = 5


def _build(src_dir: Path, tag: str) -> dict[str, ctypes.CDLL]:
    from si_mamba_tpu_torch.ops.kernels.build import NVCC_FLAGS, _nvcc

    out_dir = ROOT / "build" / "ab" / tag
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {name: subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", str(out_dir / f"{name}.so"),
                                     str(src_dir / f"{name}.cu")])
             for name in ("ssd_xbc_fwd", "ssd_xbc_bwd")}
    libs = {}
    for name, proc in procs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed for {src_dir / name}.cu")
        lib = ctypes.CDLL(str(out_dir / f"{name}.so"))
        fn = getattr(lib, name)
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_longlong] * 2
                       + [ctypes.c_void_p]) if name == "ssd_xbc_fwd" else \
            [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7 + [ctypes.c_longlong] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        err = getattr(lib, f"{name}_error_string")
        err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
        libs[name] = lib
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
    trees = {"this": _build(ROOT / "si_mamba_tpu_torch" / "csrc", "this"),
             "other": _build(args.other, "other")}
    device = torch.device("cuda", 0)
    x6, dth, S, _, _, xbc, D, chunk = cs._split_operands(device, heads=6)
    d = x6.shape[-1]
    dy = torch.randn(x6.shape, device=device, generator=torch.Generator(device).manual_seed(0))
    _, h_in = kssd.ssd_xbc_fwd_ref(xbc, dth, S, D, d, chunk, emit_states=True)
    kernels = {"ssd_xbc_fwd": lambda: kssd.ssd_xbc_fwd(xbc, dth, S, D, d, chunk),
               "ssd_xbc_fwd_states": lambda: kssd.ssd_xbc_fwd_states(xbc, dth, S, D, d, chunk),
               "ssd_xbc_bwd": lambda: kssd.ssd_xbc_bwd(xbc, dth, S, D, h_in, dy, d, chunk)}
    times = {tree: {k: [] for k in kernels} for tree in trees}
    for _ in range(ROUNDS):
        for tree in ("this", "other", "other", "this"):
            kssd._fwd_library = lambda tree=tree: trees[tree]["ssd_xbc_fwd"]
            kssd._bwd_library = lambda tree=tree: trees[tree]["ssd_xbc_bwd"]
            for name, fn in kernels.items():
                times[tree][name].append(cs.time_ms(fn, 10 if name == "ssd_xbc_bwd" else 20))
    mean = {tree: {k: sum(v) / len(v) for k, v in t.items()} for tree, t in times.items()}
    print(json.dumps({"card": card, "rounds": ROUNDS, "mean_ms": mean, "ms": times,
                      "this_over_other": {k: mean["this"][k] / mean["other"][k]
                                          for k in kernels}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
