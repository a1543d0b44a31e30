"""Point-cloud file IO, the counterpart of ``si_mamba_tpu/data/io.py`` (the
reference's datasets/io.py:7-43): npy, txt and h5, the last through the
port's own reader (``data/h5.py``), which needs no h5py."""

from __future__ import annotations

import os

import numpy as np

from si_mamba_tpu_torch.data.h5 import read_h5


def read_pointcloud(file_path: str) -> np.ndarray:
    ext = os.path.splitext(file_path)[1]
    if ext == ".npy":
        return np.load(file_path)
    if ext == ".h5":
        return read_h5(file_path)["data"]
    if ext == ".txt":
        return np.loadtxt(file_path)
    raise ValueError(f"Unsupported file extension: {ext}")


def pc_normalize(pc: np.ndarray) -> np.ndarray:
    """Center to centroid, scale to unit max radius (reference pc_norm)."""
    pc = pc - pc.mean(axis=0)
    m = np.max(np.sqrt(np.sum(pc**2, axis=1)))
    return pc / m
