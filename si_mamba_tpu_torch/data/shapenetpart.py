"""ShapeNetPart: the dataset and the augmentations of its trainer (its
batches come from ``data/loader.py``'s ``Loader``).

The counterpart of ``si_mamba_tpu/data/shapenetpart.py`` (the reference's
part_segmentation/dataset.py ``PartNormalDataset`` and provider.py
``random_scale_point_cloud`` / ``shift_point_cloud``), with items and batches
equal to the JAX package's for the same seed. The tree is the benchmark's:
``synsetoffset2category.txt``, ``train_test_split/shuffled_{train,val,test}_
file_list.json`` and one ``<synset offset>/<shape id>.txt`` a shape of
``x y z nx ny nz part`` rows.
"""

from __future__ import annotations

import json
import os

import numpy as np

from si_mamba_tpu_torch.data.io import pc_normalize

# category -> its part labels (50 in all), in the reference's order
SEG_CLASSES = {
    "Earphone": [16, 17, 18], "Motorbike": [30, 31, 32, 33, 34, 35],
    "Rocket": [41, 42, 43], "Car": [8, 9, 10, 11], "Laptop": [28, 29],
    "Cap": [6, 7], "Skateboard": [44, 45, 46], "Mug": [36, 37],
    "Guitar": [19, 20, 21], "Bag": [4, 5], "Lamp": [24, 25, 26, 27],
    "Table": [47, 48, 49], "Airplane": [0, 1, 2, 3], "Pistol": [38, 39, 40],
    "Chair": [12, 13, 14, 15], "Knife": [22, 23],
}


class PartNormalDataset:
    """The shapes of one split (``train``, ``val``, ``trainval`` or
    ``test``), each item (points (npoints, 3 or 6), category index, part
    labels (npoints,)): the shape's points normalised to the unit sphere,
    then ``npoints`` drawn with replacement from ``default_rng(seed)``, one
    generator for the dataset (so the draws follow the order of the calls)."""

    def __init__(self, root: str, npoints: int = 2048, split: str = "trainval",
                 normal_channel: bool = False, seed: int | tuple | None = None):
        self.npoints = npoints
        self.normal_channel = normal_channel
        self.split = split
        self.rng = np.random.default_rng(seed)

        cat = {}
        with open(os.path.join(root, "synsetoffset2category.txt")) as f:
            for line in f:
                name, offset = line.strip().split()
                cat[name] = offset
        self.classes = {name: i for i, name in enumerate(cat)}

        def ids(which):
            with open(os.path.join(root, "train_test_split",
                                   f"shuffled_{which}_file_list.json")) as f:
                return {d.split("/")[2] for d in json.load(f)}

        allowed = {
            "train": lambda: ids("train"),
            "val": lambda: ids("val"),
            "trainval": lambda: ids("train") | ids("val"),
            "test": lambda: ids("test"),
        }[split]()

        self.datapath = []
        for name, offset in cat.items():
            d = os.path.join(root, offset)
            for fn in sorted(os.listdir(d)):
                if os.path.splitext(fn)[0] in allowed:
                    self.datapath.append((name, os.path.join(d, fn)))
        self._cache: dict[int, tuple] = {}

    def __len__(self):
        return len(self.datapath)

    def __getitem__(self, idx):
        if idx in self._cache:
            cat_name, data = self._cache[idx]
        else:
            cat_name, fn = self.datapath[idx]
            data = np.loadtxt(fn).astype(np.float32)
            if len(self._cache) < 20000:
                self._cache[idx] = (cat_name, data)
        pts = data[:, :6] if self.normal_channel else data[:, :3]
        seg = data[:, -1].astype(np.int32)
        pts = pts.copy()
        pts[:, :3] = pc_normalize(pts[:, :3])
        choice = self.rng.choice(len(seg), self.npoints, replace=True)
        return pts[choice], self.classes[cat_name], seg[choice]


def random_scale_point_cloud(batch, rng, lo=0.8, hi=1.25):
    """Each cloud of (B, N, C) scaled by a U(lo, hi) draw from ``rng``."""
    scales = rng.uniform(lo, hi, (batch.shape[0], 1, 1)).astype(np.float32)
    return batch * scales


def shift_point_cloud(batch, rng, shift_range=0.1):
    """Each cloud of (B, N, 3) moved by a U(-shift_range, shift_range)^3 draw."""
    shifts = rng.uniform(-shift_range, shift_range,
                         (batch.shape[0], 1, 3)).astype(np.float32)
    return batch + shifts
