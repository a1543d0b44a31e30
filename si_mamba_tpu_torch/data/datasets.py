"""Dataset classes, the counterparts of ``si_mamba_tpu/data/datasets.py``
(the reference's on-disk formats and per-sample semantics; host numpy, so
that a sample is byte-equal to the JAX package's for the same seed):

- ShapeNet55: npy clouds listed in {train,test}.txt, a random subsample then
  unit-sphere normalisation; ``whole`` prepends the test list (pretraining).
- ModelNet: txt clouds, FPS to N_POINTS cached in a pickle
  ``modelnet40_{split}_{N}pts_fps.dat`` (``[points, labels]``, the
  reference's format, interchangeable with the JAX package's cache),
  normalisation, a train-time point shuffle.
- ModelNetFewShot: the Point-MAE few-shot pickles ``{way}way_{shot}shot/{fold}.pkl``.
- ModelNet40SVM: the ``modelnet40_ply_hdf5_2048/ply_data_{partition}*.h5``
  shards in sorted order (the pretraining SVM probe), the first
  ``num_points`` points of a cloud.
- ScanObjectNN, ScanObjectNN_hardest: one h5 file a split, a train-time
  point shuffle.

The h5 files are read by the port's own reader (``data/h5.py``), without
h5py; labels stored as uint8 come out int64, points float32.
"""

from __future__ import annotations

import glob
import os
import pickle
from collections import defaultdict
from typing import Any

import numpy as np
import torch

from si_mamba_tpu_torch.data.h5 import read_h5
from si_mamba_tpu_torch.data.io import pc_normalize, read_pointcloud

_FPS_POINTS_PER_CALL = 1 << 24  # clouds x points of one batched FPS call


class PointDataset:
    """Minimal map-style dataset: __len__ + __getitem__ -> (points, label)."""

    def __len__(self):  # pragma: no cover - interface
        raise NotImplementedError

    def __getitem__(self, idx):  # pragma: no cover - interface
        raise NotImplementedError


class ShapeNet55(PointDataset):
    def __init__(self, data_path: str, pc_path: str, subset: str = "train",
                 npoints: int = 1024, whole: bool = False, seed: int | None = None):
        self.pc_path = pc_path
        self.npoints = npoints
        self.subset = subset
        lines = open(os.path.join(data_path, f"{subset}.txt")).read().splitlines()
        if whole:
            lines = open(os.path.join(data_path, "test.txt")).read().splitlines() + lines
        self.file_list = [ln.strip() for ln in lines if ln.strip()]
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.file_list)

    def __getitem__(self, idx):
        data = read_pointcloud(os.path.join(self.pc_path, self.file_list[idx]))
        data = data.astype(np.float32)
        sel = self.rng.permutation(data.shape[0])[: self.npoints]
        data = pc_normalize(data[sel])
        return data.astype(np.float32), 0


def fps_indices(points: torch.Tensor, n_samples: int) -> torch.Tensor:
    """Farthest point sampling of the ModelNet cache: points (B, N, 3)
    float32 -> int64 (B, n_samples), from index 0, ties to the first index.
    Each squared distance is (dx^2 + dy^2) + dz^2 with every product and sum
    rounded to float32 on its own, the arithmetic of the JAX package's host
    FPS (its native/pointops.cpp and numpy loop), so both packages pick the
    same points and their caches are interchangeable."""
    B, N, _ = points.shape
    idx = torch.empty((B, n_samples), dtype=torch.long, device=points.device)
    min_d = torch.full((B, N), float("inf"), dtype=points.dtype, device=points.device)
    far = torch.zeros(B, dtype=torch.long, device=points.device)
    rows = torch.arange(B, device=points.device)
    for i in range(n_samples):
        idx[:, i] = far
        diff = points - points[rows, far][:, None, :]
        sq = diff * diff
        d = sq[..., 0] + sq[..., 1]
        min_d = torch.minimum(min_d, d + sq[..., 2])
        far = torch.argmax(min_d, dim=1)
    return idx


def fps_clouds(clouds: list[np.ndarray], npoints: int, device="cpu") -> list[np.ndarray]:
    """Each (N_i, C) cloud's ``npoints`` rows picked by :func:`fps_indices`
    on its first three columns, batched over clouds of one size on
    ``device``."""
    out: list[np.ndarray | None] = [None] * len(clouds)
    by_size = defaultdict(list)
    for i, c in enumerate(clouds):
        by_size[c.shape[0]].append(i)
    for n, ids in by_size.items():
        per_call = max(1, _FPS_POINTS_PER_CALL // n)
        for s in range(0, len(ids), per_call):
            part = ids[s:s + per_call]
            xyz = torch.from_numpy(np.stack([clouds[i][:, :3] for i in part])).to(device)
            sel = fps_indices(xyz, npoints).cpu().numpy()
            for i, rows in zip(part, sel):
                out[i] = clouds[i][rows]
    return out


class ModelNet(PointDataset):
    """``device``: where the FPS of a missing cache runs (the CLI's device)."""

    def __init__(self, data_path: str, subset: str = "train", npoints: int = 8192,
                 num_category: int = 40, use_normals: bool = False,
                 seed: int | None = None, device="cpu"):
        self.root = data_path
        self.subset = subset
        self.use_normals = use_normals
        self.rng = np.random.default_rng(seed)
        prefix = f"modelnet{num_category}"
        cat = [l.rstrip() for l in open(os.path.join(data_path, f"{prefix}_shape_names.txt"))]
        self.classes = {c: i for i, c in enumerate(cat)}
        ids = [l.rstrip() for l in open(os.path.join(data_path, f"{prefix}_{subset}.txt"))]
        names = ["_".join(x.split("_")[:-1]) for x in ids]
        self.datapath = [(names[i], os.path.join(data_path, names[i], ids[i]) + ".txt")
                         for i in range(len(ids))]

        cache = os.path.join(data_path, f"{prefix}_{subset}_{npoints}pts_fps.dat")
        if os.path.exists(cache):
            with open(cache, "rb") as f:
                self.points, self.labels = pickle.load(f)
        else:
            clouds = [np.loadtxt(fn, delimiter=",").astype(np.float32) for _, fn in self.datapath]
            self.points = fps_clouds(clouds, npoints, device)
            self.labels = [np.array([self.classes[name]], dtype=np.int32)
                           for name, _ in self.datapath]
            with open(cache, "wb") as f:
                pickle.dump([self.points, self.labels], f)

    def __len__(self):
        return len(self.datapath)

    def __getitem__(self, idx):
        pts = self.points[idx].copy()
        label = int(np.asarray(self.labels[idx]).reshape(-1)[0])
        pts[:, :3] = pc_normalize(pts[:, :3])
        if not self.use_normals:
            pts = pts[:, :3]
        if self.subset == "train":
            pts = pts[self.rng.permutation(pts.shape[0])]
        return pts.astype(np.float32), label


class ModelNet40SVM(PointDataset):
    """ModelNet40's ``ply_data_*.h5`` shards (the pretraining SVM probe)."""

    def __init__(self, data_path: str, partition: str = "train", num_points: int = 2048):
        files = sorted(glob.glob(os.path.join(
            data_path, "modelnet40_ply_hdf5_2048", f"ply_data_{partition}*.h5")))
        data, labels = [], []
        for fn in files:
            shard = read_h5(fn)
            data.append(shard["data"].astype(np.float32))
            labels.append(shard["label"].astype(np.int64))
        self.data = np.concatenate(data, 0)
        self.labels = np.concatenate(labels, 0).reshape(-1)
        self.num_points = num_points

    def __len__(self):
        return self.data.shape[0]

    def __getitem__(self, idx):
        return self.data[idx][: self.num_points], int(self.labels[idx])


class ScanObjectNN(PointDataset):
    """ScanObjectNN's h5 splits (the object-only and with-background
    variants); ``seed`` drives the train split's point shuffle."""

    FILES = {"train": "training_objectdataset.h5", "test": "test_objectdataset.h5"}

    def __init__(self, root: str, subset: str = "train", seed: int | None = None):
        self.subset = subset
        split = read_h5(os.path.join(root, self.FILES[subset]))
        self.points = np.array(split["data"]).astype(np.float32)
        self.labels = np.array(split["label"]).astype(np.int64)
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return self.points.shape[0]

    def __getitem__(self, idx):
        pts = self.points[idx]
        if self.subset == "train":
            pts = pts[self.rng.permutation(pts.shape[0])]
        return pts.copy(), int(self.labels[idx])


class ScanObjectNNHardest(ScanObjectNN):
    """ScanObjectNN's PB_T50_RS splits (``*_augmentedrot_scale75.h5``)."""

    FILES = {"train": "training_objectdataset_augmentedrot_scale75.h5",
             "test": "test_objectdataset_augmentedrot_scale75.h5"}


class ModelNetFewShot(PointDataset):
    """Point-MAE few-shot protocol: data/ModelNetFewshot/{way}way_{shot}shot/{fold}.pkl
    holding {'train': [(points, label), ...], 'test': [...]}."""

    def __init__(self, data_path: str, subset: str = "train", way: int = 5,
                 shot: int = 10, fold: int = 0, npoints: int = 1024):
        pkl = os.path.join(data_path, f"{way}way_{shot}shot", f"{fold}.pkl")
        with open(pkl, "rb") as f:
            dataset = pickle.load(f)[subset]
        self.samples = dataset
        self.npoints = npoints

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx):
        points, label = self.samples[idx][0], self.samples[idx][1]
        points = np.asarray(points, np.float32)[: self.npoints, :3]
        points = pc_normalize(points)
        return points.astype(np.float32), int(np.asarray(label).reshape(-1)[0])


_DATASETS = {
    "ShapeNet": ShapeNet55,
    "ModelNet": ModelNet,
    "ModelNet40SVM": ModelNet40SVM,
    "ScanObjectNN": ScanObjectNN,
    "ScanObjectNN_hardest": ScanObjectNNHardest,
    "ModelNetFewShot": ModelNetFewShot,
}


def build_dataset(name: str, **kwargs: Any) -> PointDataset:
    """Registry-style dataset construction by the reference's NAME strings."""
    if name not in _DATASETS:
        raise KeyError(f"unknown dataset {name!r}; have {sorted(_DATASETS)}")
    return _DATASETS[name](**kwargs)
