"""Point-cloud file IO, the counterpart of ``si_mamba_tpu/data/io.py`` (the
reference's datasets/io.py:7-43): npy and txt. h5 waits for a reader that
needs no h5py (ROADMAP.md queue 1, M12b)."""

from __future__ import annotations

import os

import numpy as np

H5_NOT_PORTED = ("h5 files need h5py, which the GPU host does not have: an h5 reader "
                 "without h5py, or a conversion to npz, is ROADMAP.md queue 1, M12b")


def read_pointcloud(file_path: str) -> np.ndarray:
    ext = os.path.splitext(file_path)[1]
    if ext == ".npy":
        return np.load(file_path)
    if ext == ".h5":
        raise NotImplementedError(f"{file_path}: {H5_NOT_PORTED}")
    if ext == ".txt":
        return np.loadtxt(file_path)
    raise ValueError(f"Unsupported file extension: {ext}")


def pc_normalize(pc: np.ndarray) -> np.ndarray:
    """Center to centroid, scale to unit max radius (reference pc_norm)."""
    pc = pc - pc.mean(axis=0)
    m = np.max(np.sqrt(np.sum(pc**2, axis=1)))
    return pc / m
