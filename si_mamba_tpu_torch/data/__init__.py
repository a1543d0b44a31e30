"""Data: the datasets (``datasets``), their file IO (``io``), the batch
loader (``loader``) and the batched augmentations (``transforms``)."""

from si_mamba_tpu_torch.data.datasets import (
    ModelNet,
    ModelNet40SVM,
    ModelNetFewShot,
    ScanObjectNN,
    ScanObjectNNHardest,
    ShapeNet55,
    build_dataset,
)
from si_mamba_tpu_torch.data.loader import Loader

__all__ = [
    "ShapeNet55",
    "ModelNet",
    "ModelNet40SVM",
    "ScanObjectNN",
    "ScanObjectNNHardest",
    "ModelNetFewShot",
    "build_dataset",
    "Loader",
]
