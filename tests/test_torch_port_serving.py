"""The port's serving surface (``si_mamba_tpu_torch/serving.py``), mirroring
tests/test_serving.py: the Predictor against the direct forward, its request
checks and chunking, checkpoint loading, and the MicroBatcher."""

import threading

import numpy as np
import pytest
import torch

from si_mamba_tpu_torch.models import PointMamba, PointMambaConfig
from si_mamba_tpu_torch.serving import MicroBatcher, Predictor, _fps_to_npoints

CFG = dict(trans_dim=32, depth=2, cls_dim=4, group_size=8, num_group=16,
           encoder_dims=32, knn_graph=4, drop_path=0.0)


def _small_predictor(max_batch=8, **kw):
    model = PointMamba(PointMambaConfig(**CFG), generator=torch.Generator().manual_seed(0))
    return Predictor(model, npoints=128, max_batch=max_batch, device="cpu", **kw), model


def _direct(model, clouds):
    with torch.no_grad():
        return model.eval()(torch.from_numpy(clouds)).numpy()


def test_predictor_matches_direct_forward_and_chunks():
    p, model = _small_predictor(max_batch=4)
    clouds = np.random.default_rng(0).standard_normal((11, 128, 3)).astype(np.float32)
    logits = p.logits(clouds)  # three chunks: 4 + 4 + 3
    assert logits.shape == (11, 4)
    np.testing.assert_allclose(logits, _direct(model, clouds), rtol=2e-5, atol=2e-5)
    probs = p.predict_proba(clouds)
    np.testing.assert_allclose(probs.sum(-1), 1.0, rtol=1e-5)
    assert (p.predict(clouds) == logits.argmax(-1)).all()
    assert p.logits(np.zeros((0, 128, 3), np.float32)).shape == (0, 4)


def test_predictor_fps_resamples_oversized_clouds():
    p, model = _small_predictor(max_batch=4)
    clouds = np.random.default_rng(1).standard_normal((2, 200, 3)).astype(np.float32)
    with pytest.raises(ValueError, match="accepts"):
        p.logits(clouds)  # N is not among input_points
    p200 = Predictor(model, npoints=128, max_batch=4, input_points=200, device="cpu")
    logits = p200.logits(clouds)
    resampled = _fps_to_npoints(torch.from_numpy(clouds), 128).numpy()
    np.testing.assert_allclose(logits, _direct(model, resampled), rtol=2e-5, atol=2e-5)
    assert Predictor(model, npoints=128, allow_recompile=True,
                     device="cpu").logits(clouds).shape == (2, 4)
    with pytest.raises(ValueError, match="cannot upsample"):
        p.logits(clouds[:, :100])


def test_predictor_multiple_n():
    p, model = _small_predictor(max_batch=4)
    p2 = Predictor(model, npoints=128, max_batch=4, input_points=(128, 200), device="cpu")
    rng = np.random.default_rng(3)
    for n_pts in (128, 200):
        clouds = rng.standard_normal((3, n_pts, 3)).astype(np.float32)
        logits = p2.logits(clouds)
        assert logits.shape == (3, 4) and np.isfinite(logits).all()
        if n_pts == 128:
            np.testing.assert_allclose(logits, p.logits(clouds), rtol=2e-5, atol=2e-5)
    with pytest.raises(ValueError, match="cannot upsample"):
        Predictor(model, npoints=128, input_points=(128, 64), device="cpu")
    p2.warmup()


@pytest.mark.parametrize("source", ["pth", "state_dict"])
def test_predictor_from_checkpoint(tmp_path, source):
    _, model = _small_predictor()
    sd = {f"module.{k}": v for k, v in model.state_dict().items()}  # DDP-style keys
    if source == "pth":
        path = tmp_path / "ckpt.pth"
        torch.save({"base_model": sd, "epoch": 3}, path)
        src = str(path)
    else:
        src = {k: v.numpy() for k, v in sd.items()}
    p = Predictor.from_checkpoint(src, model_cfg=CFG, npoints=128, max_batch=4, device="cpu")
    clouds = np.random.default_rng(2).standard_normal((3, 128, 3)).astype(np.float32)
    np.testing.assert_allclose(p.logits(clouds), _direct(model, clouds), rtol=2e-5, atol=2e-5)


def test_predictor_from_checkpoint_unported_sources(tmp_path):
    with pytest.raises(NotImplementedError, match="orbax"):
        Predictor.from_checkpoint(str(tmp_path / "ckpt-best"), model_cfg=CFG, device="cpu")
    # perf mode serves: bf16 activations and the subspace eigensolver
    # (tests/test_torch_port_perf.py holds its logits against the JAX package)
    sd = {k: v.numpy() for k, v in PointMamba(PointMambaConfig(**CFG)).state_dict().items()}
    p = Predictor.from_checkpoint(sd, model_cfg=CFG, npoints=128, max_batch=4, perf=True,
                                  device="cpu")
    assert (p.model.config.dtype, p.model.config.spectral_method) == ("bfloat16", "subspace")
    clouds = np.random.default_rng(2).standard_normal((3, 128, 3)).astype(np.float32)
    logits = p.logits(clouds)
    assert logits.dtype == np.float32 and logits.shape == (3, CFG["cls_dim"])
    assert np.isfinite(logits).all()


# ---------------------------------------------------------------------------
# MicroBatcher
# ---------------------------------------------------------------------------

def test_microbatcher_coalesces_deterministically():
    entered, release = threading.Event(), threading.Event()
    sizes = []

    def fn(batch):
        sizes.append(len(batch))
        entered.set()
        release.wait(timeout=30)
        return batch.sum(axis=(1, 2))

    rng = np.random.default_rng(0)
    clouds = [rng.standard_normal((16, 3)).astype(np.float32) for _ in range(5)]
    with MicroBatcher(fn, max_batch=4, max_delay_ms=50) as mb:
        futs = [mb.submit(clouds[0])]
        assert entered.wait(timeout=30)
        futs += [mb.submit(c) for c in clouds[1:]]
        release.set()
        results = [f.result(timeout=30) for f in futs]
    assert sizes == [1, 4]
    assert mb.n_batches == 2 and mb.n_requests == 5 and mb.mean_batch_size == 2.5
    for c, r in zip(clouds, results):
        np.testing.assert_allclose(r, c.sum(), rtol=1e-6)


def test_microbatcher_never_mixes_different_n():
    entered, release = threading.Event(), threading.Event()
    shapes = []

    def fn(batch):
        shapes.append(batch.shape)
        entered.set()
        release.wait(timeout=30)
        return batch.sum(axis=(1, 2))

    rng = np.random.default_rng(1)
    a = [rng.standard_normal((16, 3)).astype(np.float32) for _ in range(2)]
    b = [rng.standard_normal((32, 3)).astype(np.float32) for _ in range(2)]
    with MicroBatcher(fn, max_batch=8, max_delay_ms=50) as mb:
        f0 = mb.submit(a[0])
        assert entered.wait(timeout=30)
        futs = [mb.submit(a[1]), mb.submit(b[0]), mb.submit(b[1])]
        release.set()
        res = [f.result(timeout=30) for f in [f0] + futs]
    assert all(s[1] in (16, 32) for s in shapes)
    for c, r in zip([a[0], a[1], b[0], b[1]], res):
        np.testing.assert_allclose(r, c.sum(), rtol=1e-6)
    assert mb.n_batches >= 2


def test_microbatcher_exception_propagates_and_stop_drains():
    def boom(batch):
        raise ValueError("bad batch")

    mb = MicroBatcher(boom, max_batch=2, max_delay_ms=1)
    f = mb.submit(np.zeros((8, 3), np.float32))
    with pytest.raises(ValueError, match="bad batch"):
        f.result(timeout=30)
    mb.stop()
    mb.stop()  # idempotent
    with pytest.raises(RuntimeError, match="stopped"):
        mb.submit(np.zeros((8, 3), np.float32))
    with MicroBatcher(boom) as mb2, pytest.raises(ValueError, match=r"\(N, 3\) cloud"):
        mb2.submit(np.zeros((4, 2), np.float32))


def test_microbatcher_with_real_predictor():
    p, _ = _small_predictor(max_batch=4)
    clouds = np.random.default_rng(3).standard_normal((5, 128, 3)).astype(np.float32)
    with MicroBatcher(p.predict_proba, max_batch=4, max_delay_ms=20) as mb:
        futs = [mb.submit(c) for c in clouds]
        got = np.stack([f.result(timeout=300) for f in futs])
    np.testing.assert_allclose(got, p.predict_proba(clouds), rtol=2e-5, atol=2e-6)
