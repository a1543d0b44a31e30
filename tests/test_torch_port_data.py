"""The port's data layer against the JAX package on the CPU, on a tree that
``scripts/prepare_data.py --synthetic`` writes: the datasets give byte-equal
samples (the h5 ones read by the port's own h5 reader), the ModelNet FPS
caches of the two packages are interchangeable, and the two ``Loader``s give
byte-equal batches."""

import importlib.util
import pickle
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from si_mamba_tpu.data import datasets as jds
from si_mamba_tpu.data import io as jio
from si_mamba_tpu.data.loader import Loader as JLoader
from si_mamba_tpu.native import fps_cpu
from si_mamba_tpu_torch import data as pdata
from si_mamba_tpu_torch.data import datasets as pds
from si_mamba_tpu_torch.data import io as pio
from si_mamba_tpu_torch.data.loader import Loader as PLoader

ROOT = Path(__file__).resolve().parents[1]
MN = "ModelNet/modelnet40_normal_resampled"


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    spec = importlib.util.spec_from_file_location("prep", ROOT / "scripts" / "prepare_data.py")
    prep = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(prep)
    root = tmp_path_factory.mktemp("data")
    prep.synthetic(str(root), n_train=3, n_test=2, npoints=256, seed=0)
    return root


def _same_samples(a, b):
    assert len(a) == len(b)
    for i in range(len(a)):
        (pa, la), (pb, lb) = a[i], b[i]
        assert pa.dtype == pb.dtype == np.float32 and la == lb
        np.testing.assert_array_equal(pa, pb)


@pytest.mark.parametrize("subset,whole", [("train", False), ("train", True), ("test", False)])
def test_shapenet55_samples_equal_jax(tree, subset, whole):
    kw = dict(data_path=str(tree / "ShapeNet55-34" / "ShapeNet-55"),
              pc_path=str(tree / "ShapeNet55-34" / "shapenet_pc"), subset=subset,
              npoints=128, whole=whole, seed=3)
    _same_samples(pds.ShapeNet55(**kw), jds.ShapeNet55(**kw))


@pytest.mark.parametrize("subset", ["train", "test"])
def test_modelnet_fps_caches_are_interchangeable(tree, tmp_path, subset):
    """Each package builds its cache in its own copy of the tree: the caches
    hold equal points (FPS from index 0 picks the same points) and int32 (1,)
    labels, each package reads the other's, and the samples are equal."""
    jroot, proot = tmp_path / "jax", tmp_path / "port"
    shutil.copytree(tree / MN, jroot)
    shutil.copytree(tree / MN, proot)
    jax_ds = jds.ModelNet(str(jroot), subset=subset, npoints=64, seed=1)
    port_ds = pds.ModelNet(str(proot), subset=subset, npoints=64, seed=1, device="cpu")
    name = f"modelnet40_{subset}_64pts_fps.dat"
    with open(jroot / name, "rb") as f:
        jpts, jlab = pickle.load(f)
    with open(proot / name, "rb") as f:
        ppts, plab = pickle.load(f)
    assert len(jpts) == len(ppts) == len(jax_ds) > 0
    for a, b, la, lb in zip(jpts, ppts, jlab, plab):
        assert a.shape == b.shape == (64, 6) and a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
        assert la.dtype == lb.dtype == np.int32 and la.shape == lb.shape == (1,)
        assert la[0] == lb[0]
    _same_samples(port_ds, jax_ds)
    # each reads the other's cache
    _same_samples(pds.ModelNet(str(jroot), subset=subset, npoints=64, seed=5),
                  jds.ModelNet(str(proot), subset=subset, npoints=64, seed=5))


def test_fps_indices_equal_the_native_fps_on_ties_and_batches():
    rng = np.random.default_rng(0)
    clouds = rng.standard_normal((5, 300, 3)).astype(np.float32)
    clouds[1, 100:] = clouds[1, :200]  # duplicated points: distance ties
    clouds[2] = np.round(clouds[2])  # a lattice: many equal distances
    got = pds.fps_indices(torch.from_numpy(clouds), 120).numpy()
    np.testing.assert_array_equal(got, fps_cpu(clouds, 120, start=0))
    sizes = [clouds[0], clouds[1, :250], clouds[3]]
    picked = pds.fps_clouds(sizes, 40)
    for c, p in zip(sizes, picked):
        np.testing.assert_array_equal(p, c[fps_cpu(c, 40, start=0)])


@pytest.mark.parametrize("subset", ["train", "test"])
def test_fewshot_samples_equal_jax(tree, subset):
    kw = dict(data_path=str(tree / "ModelNetFewshot"), subset=subset, way=5, shot=10, fold=1,
              npoints=200)
    _same_samples(pds.ModelNetFewShot(**kw), jds.ModelNetFewShot(**kw))


@pytest.mark.parametrize("name,kwargs", [
    ("ScanObjectNN", dict(root="ScanObjectNN/main_split", subset="train")),
    ("ScanObjectNN_hardest", dict(root="ScanObjectNN/main_split", subset="test")),
    ("ModelNet40SVM", dict(data_path=".", partition="train", num_points=2048)),
])
def test_h5_datasets_raise_with_their_roadmap_item(tree, name, kwargs):
    """(The name is kept from when these datasets raised M12b.) The h5
    datasets, read without h5py, give the JAX package's items: the same
    points (float32), labels (int64 in the arrays, int items) and, for the
    train split, the same point shuffle from the same seed."""
    kwargs = {k: (str(tree / v) if k in ("root", "data_path") else v) for k, v in kwargs.items()}
    seeded = {"seed": 4} if name.startswith("ScanObjectNN") else {}
    jax_ds = jds.build_dataset(name, **kwargs, **seeded)  # the JAX package reads the tree
    port_ds = pds.build_dataset(name, **kwargs, **seeded)
    assert len(jax_ds) > 0
    if name == "ModelNet40SVM":
        assert port_ds.labels.dtype == jax_ds.labels.dtype == np.int64
        np.testing.assert_array_equal(port_ds.data, jax_ds.data)
    else:
        assert port_ds.labels.dtype == np.int64
        np.testing.assert_array_equal(port_ds.points, jax_ds.points)
    for i in range(len(jax_ds)):
        (pp, pl), (jp, jl) = port_ds[i], jax_ds[i]
        assert pp.dtype == jp.dtype == np.float32 and type(pl) is type(jl) is int and pl == jl
        np.testing.assert_array_equal(pp, jp)


def test_io_matches_jax_and_refuses_h5(tree, tmp_path):
    npy = next((tree / "ShapeNet55-34" / "shapenet_pc").glob("*.npy"))
    txt = tmp_path / "c.txt"
    np.savetxt(txt, np.random.default_rng(0).standard_normal((20, 3)))
    for path in (npy, txt):
        np.testing.assert_array_equal(pio.read_pointcloud(str(path)),
                                      jio.read_pointcloud(str(path)))
    pc = np.random.default_rng(1).standard_normal((50, 3)).astype(np.float32)
    np.testing.assert_array_equal(pio.pc_normalize(pc), jio.pc_normalize(pc))
    h5 = str(tree / "modelnet40_ply_hdf5_2048" / "ply_data_train0.h5")
    got, want = pio.read_pointcloud(h5), jio.read_pointcloud(h5)  # h5py on the JAX side
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="extension"):
        pio.read_pointcloud("x.ply")
    assert set(pdata.__all__) == {"ShapeNet55", "ModelNet", "ModelNet40SVM", "ScanObjectNN",
                                  "ScanObjectNNHardest", "ModelNetFewShot", "build_dataset",
                                  "Loader"}


class _Toy:
    """A dataset whose samples draw no random numbers (so any number of
    loader threads give one stream)."""

    def __init__(self, n=37, npoints=16):
        self.data = np.random.default_rng(0).standard_normal((n, npoints, 3)).astype(np.float32)

    def __len__(self):
        return len(self.data)

    def __getitem__(self, i):
        return self.data[i], i % 5


@pytest.mark.parametrize("num_workers", [1, 3])
@pytest.mark.parametrize("drop_last", [False, True])
@pytest.mark.parametrize("shuffle", [False, True])
def test_loaders_give_byte_equal_batches(shuffle, drop_last, num_workers):
    ds = _Toy()
    kw = dict(batch_size=8, shuffle=shuffle, drop_last=drop_last, seed=4, prefetch=2,
              num_workers=num_workers)
    jl, pl = JLoader(ds, **kw), PLoader(ds, **kw)
    assert len(pl) == len(jl) == (4 if drop_last else 5)
    for epoch in (0, 1):
        jb, pb = list(jl.epoch(epoch)), list(pl.epoch(epoch))
        assert len(pb) == len(jb) == len(pl)
        for (jp, jlab), (pp, plab) in zip(jb, pb):
            assert pp.dtype == np.float32 and plab.dtype == np.int32
            assert pp.tobytes() == jp.tobytes() and plab.tobytes() == jlab.tobytes()


@pytest.mark.parametrize("prefetch", [0, 2])
def test_loader_process_shards_and_ragged_tail_equal_jax(prefetch):
    ds = _Toy(n=23)
    for rank in range(3):
        kw = dict(batch_size=4, shuffle=True, seed=1, process_index=rank, process_count=3,
                  prefetch=prefetch)
        jb, pb = list(JLoader(ds, **kw).epoch(2)), list(PLoader(ds, **kw).epoch(2))
        assert len(pb) == len(jb) == 2  # 8 samples a rank (23 wrapped to 24), one ragged
        for (jp, jl), (pp, pl) in zip(jb, pb):
            assert pp.tobytes() == jp.tobytes() and pl.tobytes() == jl.tobytes()


def test_modelnet_loader_batches_equal_jax(tree):
    """The test split (no per-sample draws) through both loaders, 3 threads."""
    jax_ds = jds.ModelNet(str(tree / MN), subset="test", npoints=64)
    port_ds = pds.ModelNet(str(tree / MN), subset="test", npoints=64)  # reads that cache
    kw = dict(batch_size=3, shuffle=True, seed=2, num_workers=3)
    for (jp, jl), (pp, pl) in zip(JLoader(jax_ds, **kw).epoch(1), PLoader(port_ds, **kw).epoch(1)):
        assert pp.tobytes() == jp.tobytes() and pl.tobytes() == jl.tobytes()


def test_modelnet_train_batches_equal_jax_at_one_worker(tree):
    """The train split draws each cloud's point order from the dataset's
    seeded generator: with one worker both loaders take the draws in the
    index stream's order, so epochs 0 and 1 are byte-equal."""
    jax_ds = jds.ModelNet(str(tree / MN), subset="train", npoints=64, seed=6)
    port_ds = pds.ModelNet(str(tree / MN), subset="train", npoints=64, seed=6)
    kw = dict(batch_size=2, shuffle=True, drop_last=True, seed=2, num_workers=1)
    jl, pl = JLoader(jax_ds, **kw), PLoader(port_ds, **kw)
    for epoch in (0, 1):
        jb, pb = list(jl.epoch(epoch)), list(pl.epoch(epoch))
        assert len(pb) == len(jb) == len(port_ds) // 2 > 0
        for (jp, jlab), (pp, plab) in zip(jb, pb):
            assert pp.tobytes() == jp.tobytes() and plab.tobytes() == jlab.tobytes()


@pytest.mark.parametrize("num_workers", [1, 3])
def test_loader_worker_error_propagates(num_workers):
    class Bad:
        def __len__(self):
            return 8

        def __getitem__(self, i):
            if i == 5:
                raise ValueError("corrupt sample")
            return np.zeros((8, 3), np.float32), 0

    with pytest.raises(ValueError, match="corrupt sample"):
        list(PLoader(Bad(), batch_size=2, prefetch=2, num_workers=num_workers).epoch(0))

