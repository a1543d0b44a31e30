"""The port's utilities against the JAX package on the CPU: ``utils/misc.py``
(the crops bitwise, the parameter counts and table of a model whose weights
came across), ``utils/profiling.py``, ``utils/visualization.py`` (the text
and ``.npz`` dumps byte for byte, the PNG encoder and renderer, the t-SNE
against sklearn 1.9's exact method), ``--tsne`` through the CLI and
``vis_run`` through the runner on a tiny tree, and ``native/`` against the
JAX package's host ops and the port's device ops."""

import importlib.util
import logging
import struct
import sys
import zipfile
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

from si_mamba_tpu_torch import native
from si_mamba_tpu_torch.ops.pointops import fps, knn
from si_mamba_tpu_torch.utils import misc, profiling
from si_mamba_tpu_torch.utils import visualization as vz

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the t-SNE's thousands of small fp64 ops stall
    when their threads wait on cores that the other test workers hold."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _clouds(b, n, seed):
    rng = np.random.default_rng(seed)
    pts = rng.standard_normal((b, n, 3)).astype(np.float32)
    return pts / np.abs(pts).max(axis=(1, 2), keepdims=True)


# ---------------------------------------------------------------------------
# utils/misc.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("crop,kw", [(64, {}), ([32, 96], {}), (64, {"padding_zeros": True}),
                                     (48, {"fixed_points": [[1.0, 0.0, 0.0], [0.0, 0.0, 1.0]]})])
def test_separate_point_cloud_is_bitwise_jax(crop, kw):
    from si_mamba_tpu.utils.misc import separate_point_cloud as j_separate

    xyz = _clouds(3, 256, 0)
    got = misc.separate_point_cloud(xyz, 256, crop, rng=np.random.default_rng(7), **kw)
    want = j_separate(xyz, 256, crop, rng=np.random.default_rng(7), **kw)
    for g, w in zip(got, want):
        for a, b in zip(g, w):  # arrays, or lists of arrays for a crop range
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_parameter_counts_and_table_equal_jax():
    import jax
    import jax.numpy as jnp

    from si_mamba_tpu.models import PointMamba as JPointMamba
    from si_mamba_tpu.models import PointMambaConfig as JConfig
    from si_mamba_tpu.utils import misc as jmisc
    from si_mamba_tpu_torch.models import PointMamba, PointMambaConfig
    from si_mamba_tpu_torch.utils.weights import state_dict_from_jax

    cfg = dict(trans_dim=32, encoder_dims=32, depth=2, cls_dim=10, num_group=16, group_size=8,
               knn_graph=4)
    jmodel = JPointMamba(JConfig(**cfg))
    variables = jax.jit(lambda k: jmodel.init(k, jnp.zeros((2, 128, 3)), train=False))(
        jax.random.key(0))
    model = PointMamba(PointMambaConfig(**cfg))
    model.load_state_dict(state_dict_from_jax(variables["params"], variables["batch_stats"]),
                          strict=True)
    assert misc.count_parameters(model) == jmisc.count_parameters(variables["params"])
    assert misc.parameter_table(model) == jmisc.parameter_table(variables["params"])
    # a state dict counts every entry, the BatchNorm buffers too
    sd = model.state_dict()
    assert misc.count_parameters(sd) == sum(v.numel() for v in sd.values())


def test_set_global_seed_seeds_every_generator():
    import random

    g = misc.set_global_seed(5)
    a = (random.random(), np.random.rand(), torch.rand(1).item(), torch.rand(1, generator=g).item())
    g = misc.set_global_seed(5)
    assert a == (random.random(), np.random.rand(), torch.rand(1).item(),
                 torch.rand(1, generator=g).item())


# ---------------------------------------------------------------------------
# utils/profiling.py
# ---------------------------------------------------------------------------

def test_time_and_throughput_keys_and_trace(tmp_path):
    x = torch.randn(64, 64)
    t = profiling.time_fn(lambda a: a @ a, x, iters=5, warmup=1)
    assert set(t) == {"p50_ms", "p90_ms", "mean_ms", "iters"} and t["iters"] == 5
    assert 0 < t["p50_ms"] <= t["p90_ms"]
    r = profiling.throughput_fn(lambda a: (a @ a, [a]), x, items_per_call=64, iters=3)
    assert set(r) == {"items_per_sec", "step_ms"} and r["items_per_sec"] > 0
    with profiling.trace(str(tmp_path / "tr")) as prof:
        (x @ x).sum()
    (trace,) = (tmp_path / "tr").glob("trace_*.json")
    assert trace.stat().st_size > 0 and "traceEvents" in trace.read_text()
    assert any("mm" in e.key for e in prof.key_averages())


# ---------------------------------------------------------------------------
# utils/visualization.py: dumps, PNG
# ---------------------------------------------------------------------------

def test_reconstruction_and_traversal_dumps_are_jax_bytes(tmp_path, monkeypatch):
    from si_mamba_tpu.utils import visualization as jvz

    monkeypatch.setattr(jvz, "render_cloud_figure", lambda *a, **k: None)  # JPEG, not compared
    full, vis = _clouds(1, 200, 1)[0], _clouds(1, 80, 2)[0]
    vz.save_reconstruction(str(tmp_path / "port"), "sample_0000", full, vis)
    jvz.save_reconstruction(str(tmp_path / "jax"), "sample_0000", full, vis)
    for name in ("sample_0000_full.txt", "sample_0000_vis.txt"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    for name in ("sample_0000_full.png", "sample_0000_vis.png"):
        assert (tmp_path / "port" / name).read_bytes()[:8] == vz.PNG_SIGNATURE

    rng = np.random.default_rng(3)
    center, nb = rng.standard_normal((2, 4, 16, 3)), rng.standard_normal((2, 16, 8, 3))
    orders = rng.integers(0, 16, (2, 4, 16))
    vz.save_traversal_dump(str(tmp_path / "p" / "t.npz"), center, nb, orders)
    jvz.save_traversal_dump(str(tmp_path / "j" / "t.npz"), center, nb, orders)
    with zipfile.ZipFile(tmp_path / "p" / "t.npz") as p, \
            zipfile.ZipFile(tmp_path / "j" / "t.npz") as j:
        assert p.namelist() == j.namelist() == ["center.npy", "neighborhood.npy", "orders.npy"]
        for name in p.namelist():  # each member byte for byte (the zip stamps its time)
            assert p.read(name) == j.read(name)


def _png_chunks(data: bytes):
    assert data[:8] == vz.PNG_SIGNATURE
    pos, chunks = 8, []
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        assert crc == zlib.crc32(kind + body) & 0xFFFFFFFF, kind
        chunks.append((kind, body))
        pos += 12 + length
    return chunks


def _decode(data: bytes) -> np.ndarray:
    chunks = _png_chunks(data)
    assert [k for k, _ in chunks] == [b"IHDR", b"IDAT", b"IEND"]
    w, h, depth, color, comp, filt, inter = struct.unpack(">IIBBBBB", chunks[0][1])
    assert (depth, color, comp, filt, inter) == (8, 2, 0, 0, 0)
    raw = zlib.decompress(chunks[1][1])
    assert len(raw) == h * (1 + 3 * w)
    rows = np.frombuffer(raw, np.uint8).reshape(h, 1 + 3 * w)
    assert (rows[:, 0] == 0).all()
    return rows[:, 1:].reshape(h, w, 3)


def test_png_encoder_round_trips():
    img = np.random.default_rng(0).integers(0, 256, (7, 11, 3), dtype=np.uint8)
    data = vz.encode_png(img)
    np.testing.assert_array_equal(_decode(data), img)
    assert vz.encode_png(img) == data
    with pytest.raises(ValueError, match="png"):
        vz.write_png("x.jpg", img)


def test_render_cloud_figure_is_deterministic_and_draws_the_cloud(tmp_path):
    pts = _clouds(1, 500, 4)[0]
    a, b = tmp_path / "a.png", tmp_path / "b.png"
    vz.render_cloud_figure(pts, str(a), roll=30, pitch=45, size=200)
    vz.render_cloud_figure(pts, str(b), roll=30, pitch=45, size=200)
    assert a.read_bytes() == b.read_bytes()
    img = _decode(a.read_bytes())
    assert img.shape == (200, 200, 3)
    drawn = (img != 255).any(-1)
    assert 0.02 < drawn.mean() < 0.9  # points on a white ground
    # jet: the lowest x is drawn dark blue, the highest dark red
    assert tuple(vz.jet(np.array([0.0, 1.0]))[0]) == (0, 0, 128)
    assert tuple(vz.jet(np.array([0.0, 1.0]))[1]) == (128, 0, 0)


class _Records(logging.Handler):
    def __init__(self):
        super().__init__()
        self.records = []

    def emit(self, record):
        self.records.append(record)


def test_traversal_viewer_without_plotly_logs_and_returns_false(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "plotly", None)  # as on the GPU host: no plotly
    rng = np.random.default_rng(3)
    vz.save_traversal_dump(str(tmp_path / "t.npz"), rng.standard_normal((1, 2, 8, 3)),
                           rng.standard_normal((1, 8, 4, 3)), rng.integers(0, 8, (1, 2, 8)))
    # on the module's own logger: the package's CLI logger does not propagate to the root
    seen = _Records()
    vz._LOG.addHandler(seen)
    try:
        assert vz.traversal_viewer_html(str(tmp_path / "t.npz"), str(tmp_path / "v.html")) is False
    finally:
        vz._LOG.removeHandler(seen)
    assert len(seen.records) == 1 and "plotly" in seen.records[0].getMessage()
    assert not (tmp_path / "v.html").exists()


# ---------------------------------------------------------------------------
# utils/visualization.py: t-SNE against sklearn
# ---------------------------------------------------------------------------

def _blobs():
    """200 points of 5 seeded Gaussian clusters in 32-d."""
    rng = np.random.default_rng(0)
    centers = rng.standard_normal((5, 32)) * 4
    x = centers[np.repeat(np.arange(5), 40)] + rng.standard_normal((200, 32))
    return x.astype(np.float32), np.repeat(np.arange(5), 40)


def test_joint_probabilities_match_sklearn():
    from scipy.spatial.distance import squareform
    from sklearn.manifold._t_sne import _joint_probabilities

    x, _ = _blobs()
    d = ((x[:, None] - x[None]) ** 2).sum(-1).astype(np.float32)
    want = squareform(_joint_probabilities(d, 30.0, 0))
    got = vz.joint_probabilities(torch.from_numpy(d), 30.0).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def tsne_pair():
    from sklearn.manifold import TSNE

    x, labels = _blobs()
    sk = TSNE(method="exact", init="pca", random_state=0)
    return x, labels, sk.fit_transform(x), sk.kl_divergence_, vz.tsne_embed(x)


def test_tsne_matches_sklearn_exact(tsne_pair):
    from sklearn.manifold import trustworthiness

    x, _, sk_emb, sk_kl, (emb, kl) = tsne_pair
    assert emb.shape == (200, 2) and np.isfinite(emb).all()
    assert kl <= 1.1 * sk_kl, (kl, sk_kl)
    sk_trust = trustworthiness(x, sk_emb, n_neighbors=5)
    assert trustworthiness(x, emb, n_neighbors=5) >= sk_trust - 0.02


def test_tsne_runs_are_bitwise_repeatable(tsne_pair, tmp_path):
    x, labels, _, _, (emb, kl) = tsne_pair
    again, kl2 = vz.tsne_embed(x)
    assert np.array_equal(emb, again) and kl == kl2  # the PCA start draws nothing
    out = tmp_path / "tsne.png"
    emb3 = vz.tsne_features(torch.from_numpy(x), labels, str(out))
    assert np.array_equal(emb3, emb) and _decode(out.read_bytes()).shape == (800, 800, 3)
    with pytest.raises(ValueError, match="perplexity"):
        vz.tsne_embed(x[:30])


# ---------------------------------------------------------------------------
# --tsne through the CLI, vis_run through the runner
# ---------------------------------------------------------------------------

def test_cli_tsne_writes_the_png(tmp_path, monkeypatch):
    """``--tsne --ckpts`` of the classifier on a synthetic ModelNet tree (35
    test clouds, above the perplexity of 30): FPS, the feature forward, the
    t-SNE, ``<experiment_path>/tsne.png``."""
    from si_mamba_tpu_torch.models import PointMamba, PointMambaConfig
    from si_mamba_tpu_torch.train import cli

    spec = importlib.util.spec_from_file_location("prep", ROOT / "scripts" / "prepare_data.py")
    prep = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(prep)
    prep.synthetic(str(tmp_path / "data"), n_train=1, n_test=7, npoints=1024, seed=0)
    (tmp_path / "modelnet.yaml").write_text(
        f"NAME: ModelNet\nDATA_PATH: {tmp_path}/data/ModelNet/modelnet40_normal_resampled\n"
        "N_POINTS: 1024\nNUM_CATEGORY: 40\nUSE_NORMALS: FALSE\n")
    model = dict(trans_dim=32, encoder_dims=32, depth=2, cls_dim=5, group_size=8, num_group=16,
                 knn_graph=4, drop_path=0.0)
    cfg = tmp_path / "tiny.yaml"
    cfg.write_text(f"_base_: {ROOT}/cfgs/finetune_modelnet.yaml\ndataset:\n" + "".join(
        f"  {s}: {{_base_: {tmp_path}/modelnet.yaml, others: {{subset: 'test'}}}}\n"
        for s in ("train", "val", "test")) + "model: {" + ", ".join(
        f"{k}: {v}" for k, v in model.items()) + "}\ntotal_bs: 8\nmax_epoch: 1\n")
    ckpt = tmp_path / "w.pth"
    torch.save({"base_model": PointMamba(PointMambaConfig(**model)).state_dict()}, ckpt)
    monkeypatch.chdir(tmp_path)
    out = cli.main(["--config", str(cfg), "--tsne", "--ckpts", str(ckpt), "--device", "cpu",
                    "--num_workers", "0"])
    assert out == str(Path("experiments") / "tiny" / "default" / "tsne.png")
    assert _decode((tmp_path / out).read_bytes()).shape == (800, 800, 3)


class _Clouds:
    def __init__(self, pts):
        self.pts = pts

    def __len__(self):
        return len(self.pts)

    def __getitem__(self, i):
        return self.pts[i], 0


def test_vis_run_dumps_reconstructions(tmp_path):
    """A tiny MAE from a state dict through ``vis_run``: each sample's text
    clouds (the rebuilt and the ground-truth patches, 16 groups x 16
    points, of which the masked 9) and PNG renders; the same seed gives the
    same dumps."""
    from si_mamba_tpu_torch.data.loader import Loader
    from si_mamba_tpu_torch.models.point_mae import PointMAEConfig, PointMAEMamba
    from si_mamba_tpu_torch.train.runner_vis import vis_run

    cfg = dict(trans_dim=32, encoder_dims=32, depth=2, decoder_depth=1, group_size=16,
               num_group=16, knn_graph=4, k_top_eigenvectors=2, drop_path_rate=0.0)
    sd = PointMAEMamba(PointMAEConfig(**cfg)).state_dict()
    loader = Loader(_Clouds(_clouds(5, 512, 9)), batch_size=2, prefetch=0)
    tags = vis_run(cfg, sd, loader, str(tmp_path / "a"), max_samples=3, seed=4, device="cpu")
    assert tags == ["sample_0000", "sample_0001", "sample_0002"]
    full = np.loadtxt(tmp_path / "a" / "sample_0001_full.txt", delimiter=";")
    gt = np.loadtxt(tmp_path / "a" / "sample_0001_vis.txt", delimiter=";")
    n_mask = int(0.6 * 16)
    total = 2 * 2 * n_mask  # K orders, reversed too
    assert full.shape == gt.shape == (total * 16, 3) and np.isfinite(full).all()
    _decode((tmp_path / "a" / "sample_0001_full.png").read_bytes())
    vis_run(cfg, sd, loader, str(tmp_path / "b"), max_samples=3, seed=4, device="cpu")
    for name in ("sample_0002_full.txt", "sample_0002_vis.txt"):
        assert (tmp_path / "a" / name).read_bytes() == (tmp_path / "b" / name).read_bytes()


# ---------------------------------------------------------------------------
# native/: the host FPS and kNN
# ---------------------------------------------------------------------------

def test_native_ops_equal_jax_and_the_device_ops():
    from si_mamba_tpu import native as jnative

    pts = np.random.default_rng(0).standard_normal((3, 700, 3)).astype(np.float32)
    q = pts[:, ::7]
    assert native.native_available()
    assert native.library_path().parent == ROOT / "build"
    idx = native.fps_cpu(pts, 96)
    np.testing.assert_array_equal(idx, native.fps_cpu(pts, 96, plain=True))
    np.testing.assert_array_equal(idx, jnative.fps_cpu(pts, 96))
    np.testing.assert_array_equal(idx, fps(torch.from_numpy(pts), 96).numpy())
    np.testing.assert_array_equal(native.fps_cpu(pts[0], 96, start=5), jnative.fps_cpu(pts[0], 96,
                                                                                        start=5))
    nn = native.knn_cpu(q, pts, 8)
    np.testing.assert_array_equal(nn, native.knn_cpu(q, pts, 8, plain=True))
    np.testing.assert_array_equal(nn, jnative.knn_cpu(q, pts, 8))
    np.testing.assert_array_equal(nn, knn(torch.from_numpy(q), torch.from_numpy(pts), 8).numpy())


def test_native_build_failure_raises(monkeypatch, tmp_path):
    bad = tmp_path / "pointops.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_LIB", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.fps_cpu(np.zeros((4, 3), np.float32), 2)
    assert not native.native_available()
