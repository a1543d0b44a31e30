#!/usr/bin/env python3
"""Write the small h5 fixtures that the port's h5 reader and its datasets run
on where h5py is missing (the GPU host):

    python scripts/torch_make_h5_fixtures.py [--out tests/data/h5]

The files follow the real datasets' layouts: ModelNet40's
``modelnet40_ply_hdf5_2048/ply_data_{train0,train1,test0}.h5`` (``data``
float32 (n, 2048, 3), ``label`` uint8 (n, 1)) and ScanObjectNN's
``ScanObjectNN/main_split/{training,test}_objectdataset_augmentedrot_scale75.h5``
(``data`` float32 (n, 2048, 3), ``label`` uint8 (n,), ``mask`` int8 (n, 2048)).
Every cloud is a seeded anisotropic Gaussian blob whose axes depend on its
class, scaled into the unit ball. ``ply_data_train1.h5`` is chunked with the
shuffle and deflate filters and the ScanObjectNN test split chunked with
deflate alone; the others are contiguous. All are written with
``libver='earliest'`` (superblock 0, v1 object headers, symbol-table groups).
Needs h5py; the same seed writes the same arrays.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

POINTS = 2048
# (relative path, clouds, classes, storage)
FILES = (
    ("modelnet40_ply_hdf5_2048/ply_data_train0.h5", 24, 8, "contiguous"),
    ("modelnet40_ply_hdf5_2048/ply_data_train1.h5", 16, 8, "shuffle_gzip"),
    ("modelnet40_ply_hdf5_2048/ply_data_test0.h5", 16, 8, "contiguous"),
    ("ScanObjectNN/main_split/training_objectdataset_augmentedrot_scale75.h5", 32, 15,
     "contiguous"),
    ("ScanObjectNN/main_split/test_objectdataset_augmentedrot_scale75.h5", 16, 15, "gzip"),
)


def arrays(index: int, clouds: int, classes: int, seed: int = 0) -> dict[str, np.ndarray]:
    """The arrays of the ``index``-th file of FILES."""
    rng = np.random.default_rng([seed, index])
    labels = rng.integers(0, classes, clouds)
    axes = 0.3 + 0.7 * np.random.default_rng(seed).random((classes, 3))
    pts = rng.standard_normal((clouds, POINTS, 3)) * axes[labels][:, None, :]
    pts /= np.linalg.norm(pts, axis=-1).max(axis=1)[:, None, None]
    out = {"data": pts.astype(np.float32)}
    if index < 3:
        out["label"] = labels.astype(np.uint8)[:, None]
    else:
        out["label"] = labels.astype(np.uint8)
        out["mask"] = (rng.random((clouds, POINTS)) < 0.8).astype(np.int8)
    return out


def write(out: Path, seed: int = 0) -> list[Path]:
    import h5py

    paths = []
    for i, (rel, clouds, classes, storage) in enumerate(FILES):
        path = out / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        with h5py.File(path, "w", libver="earliest") as f:
            for name, a in arrays(i, clouds, classes, seed).items():
                kw = {}
                if name == "data" and storage != "contiguous":
                    kw = dict(chunks=(4, POINTS, 3), compression="gzip",
                              shuffle=storage == "shuffle_gzip")
                f.create_dataset(name, data=a, **kw)
        paths.append(path)
    return paths


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=str(Path(__file__).resolve().parents[1] / "tests" / "data"
                                         / "h5"))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    for p in write(Path(args.out), args.seed):
        print(p, p.stat().st_size)


if __name__ == "__main__":
    main()
