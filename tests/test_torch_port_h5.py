"""The port's h5 reader (``si_mamba_tpu_torch/data/h5.py``) against h5py on
the CPU: files written by h5py under ``libver`` 'earliest' and 'latest' in
every layout the reader takes read back equal to what h5py reads, what it
does not take raises by name, and the committed fixtures
(``scripts/torch_make_h5_fixtures.py``) read equal to h5py's reading."""

import importlib.util
from pathlib import Path

import h5py
import numpy as np
import pytest

from si_mamba_tpu_torch.data.h5 import read_h5

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "data" / "h5"
DTYPES = ("f4", "f8", "u1", "i1", "i8")


def _fixture_script():
    spec = importlib.util.spec_from_file_location(
        "fixtures", ROOT / "scripts" / "torch_make_h5_fixtures.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _write(path, libver, layout, arrays):
    with h5py.File(path, "w", libver=libver) as f:
        for name, a in arrays.items():
            if layout == "compact":
                dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
                dcpl.set_layout(h5py.h5d.COMPACT)
                h5py.h5d.create(f.id, name.encode(), h5py.h5t.py_create(a.dtype),
                                h5py.h5s.create_simple(a.shape), dcpl=dcpl).write(
                    h5py.h5s.ALL, h5py.h5s.ALL, a)
            elif layout == "contiguous":
                f.create_dataset(name, data=a)
            else:
                kw = {"chunked": {}, "gzip": dict(compression="gzip"),
                      "shuffle_gzip": dict(compression="gzip", shuffle=True)}[layout]
                f.create_dataset(name, data=a, chunks=(3, 8, 3), **kw)  # ragged edges
        f.attrs["note"] = "attributes are not datasets"


@pytest.mark.parametrize("order", ["<", ">"])
@pytest.mark.parametrize("libver,layout", [
    ("earliest", "contiguous"), ("earliest", "compact"), ("earliest", "chunked"),
    ("earliest", "gzip"), ("earliest", "shuffle_gzip"), ("latest", "contiguous"),
    ("latest", "compact")])
def test_reads_what_h5py_reads(tmp_path, libver, layout, order):
    """float32, float64, uint8, int8 and int64 of shape (7, 20, 3) in one
    byte order: equal arrays, the file's dtypes (exactness: tolerance 0)."""
    rng = np.random.default_rng(len(layout) + (order == ">"))
    arrays = {f"d_{dt}": (rng.standard_normal((7, 20, 3)) * 60).astype(order + dt)
              for dt in DTYPES}
    path = tmp_path / "x.h5"
    _write(path, libver, layout, arrays)
    got = read_h5(str(path))
    with h5py.File(path, "r") as f:
        want = {k: f[k][()] for k in f}
    assert set(got) == set(want) == set(arrays)
    for k, a in want.items():
        assert got[k].dtype == a.dtype and got[k].shape == a.shape, k
        np.testing.assert_array_equal(got[k], a)


def test_groups_scalars_and_many_links(tmp_path):
    """Nested groups (by path), a scalar, and a root group of 150 entries
    (a v1 group B-tree of several nodes)."""
    path = tmp_path / "g.h5"
    with h5py.File(path, "w", libver="earliest") as f:
        f.create_dataset("a/b", data=np.arange(4, dtype=np.int64))
        f.create_dataset("s", data=np.float32(2.5))
        for i in range(150):
            f.create_dataset(f"m{i:03d}", data=np.full(2, i, np.int16))
    got = read_h5(str(path))
    np.testing.assert_array_equal(got["a/b"], np.arange(4))
    assert got["s"].shape == () and got["s"] == np.float32(2.5)
    assert all(int(got[f"m{i:03d}"][0]) == i for i in range(150))


def test_many_chunks(tmp_path):
    """A chunk B-tree deeper than one node (1000 chunks), shuffle + gzip."""
    a = np.random.default_rng(1).standard_normal((3000, 5)).astype(np.float32)
    path = tmp_path / "c.h5"
    with h5py.File(path, "w", libver="earliest") as f:
        f.create_dataset("data", data=a, chunks=(3, 5), compression="gzip", shuffle=True)
    np.testing.assert_array_equal(read_h5(str(path))["data"], a)


@pytest.mark.parametrize("libver,case", [
    ("earliest", "contiguous"), ("latest", "contiguous"), ("earliest", "chunked"),
    ("earliest", "default"), ("latest", "default")])
@pytest.mark.parametrize("dtype", ["<i8", ">f4"])
def test_unwritten_storage_reads_as_h5py_reads_it(tmp_path, libver, case, dtype):
    """Storage never written reads as the fill value, as h5py reads it: a
    contiguous dataset never allocated with fill value 7, a chunked one of
    which one chunk of six is written, and one never allocated with the
    default fill (exactness: tolerance 0)."""
    path = tmp_path / "f.h5"
    with h5py.File(path, "w", libver=libver) as f:
        if case == "contiguous":
            f.create_dataset("data", shape=(4, 5), dtype=dtype, fillvalue=7)
        elif case == "chunked":
            f.create_dataset("data", shape=(10, 6), chunks=(4, 3), dtype=dtype,
                             fillvalue=7)[0:4, 0:3] = 1
        else:
            f.create_dataset("data", shape=(4, 5), dtype=dtype)
    with h5py.File(path, "r") as f:
        want = f["data"][()]
    got = read_h5(str(path))["data"]
    assert got.dtype == want.dtype
    assert (7 in want) if case != "default" else not want.any()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case,match", [
    ("lzf", "filter id 32000"), ("latest_chunked", "layout message v4"),
    ("dense_links", "dense link storage"), ("string", "datatype class 3"),
    ("not_h5", "not an HDF5 file"), ("external", r"0x7 \(external data files\)"),
    ("fill_never", "never written and no fill value")])
def test_refuses_by_name(tmp_path, case, match):
    path = tmp_path / "r.h5"
    if case == "not_h5":
        path.write_bytes(b"\0" * 64)
    else:
        latest = case in ("latest_chunked", "dense_links")
        with h5py.File(path, "w", libver="latest" if latest else "earliest") as f:
            if case == "lzf":
                f.create_dataset("data", data=np.zeros((8, 3), np.float32), chunks=(4, 3),
                                 compression="lzf")
            elif case == "latest_chunked":
                f.create_dataset("data", data=np.zeros((8, 3), np.float32), chunks=(4, 3))
            elif case == "dense_links":
                for i in range(20):
                    f.create_dataset(f"d{i}", data=np.zeros(2))
            elif case == "external":
                f.create_dataset("data", data=np.arange(6.0),
                                 external=[(str(tmp_path / "raw.bin"), 0, h5py.h5f.UNLIMITED)])
            elif case == "fill_never":
                dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
                dcpl.set_fill_time(h5py.h5d.FILL_TIME_NEVER)
                h5py.h5d.create(f.id, b"data", h5py.h5t.NATIVE_FLOAT,
                                h5py.h5s.create_simple((4, 5)), dcpl=dcpl)
            else:
                f.create_dataset("data", data=np.array([b"ab", b"cd"]))
    with pytest.raises((NotImplementedError, ValueError), match=match):
        read_h5(str(path))


@pytest.mark.parametrize("index", range(5))
def test_fixtures_read_as_h5py_reads_them(index):
    """Each committed fixture: h5py's reading, the port's reading and the
    fixture script's arrays for it are equal."""
    mod = _fixture_script()
    rel, clouds, classes, storage = mod.FILES[index]
    path = FIXTURES / rel
    got = read_h5(str(path))
    with h5py.File(path, "r") as f:
        want = {k: f[k][()] for k in f}
        chunked = f["data"].chunks is not None
    assert chunked == (storage != "contiguous")
    script = mod.arrays(index, clouds, classes)
    assert set(got) == set(want) == set(script)
    for k in want:
        assert got[k].dtype == want[k].dtype == script[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
        np.testing.assert_array_equal(got[k], script[k])
    assert sum(p.stat().st_size for p in FIXTURES.rglob("*.h5")) <= 5 * 2**20
