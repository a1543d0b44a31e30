"""The MAE model remainder against the JAX package on the CPU: the Sinkhorn
EMD and the wavelet-path MAE with ``loss: emd`` and with ``rms_norm``, the
legacy 'MAMBA' MAE path (eval loss, ``vis`` outputs, noaug features, and a
train-mode loss, gradients and BatchNorm statistics with equal masks), and
the legacy path's pretraining through the CLI on the CPU. Small sizes:
depth 2, decoder 1, d_model 32, G = 16 groups of 16, K = 2, N = 256. Each
test states its tolerance."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from si_mamba_tpu.models import point_mae as jmae
from si_mamba_tpu.ops import emd as jemd
from si_mamba_tpu_torch.models import point_mae as pmae
from si_mamba_tpu_torch.ops import emd as pemd
from si_mamba_tpu_torch.train import cli
from si_mamba_tpu_torch.train import runner_pretrain as prp
from si_mamba_tpu_torch.utils.weights import point_mae_state_dict_from_jax

from tests.test_torch_port_mae import _write_shapenet

ROOT = Path(__file__).resolve().parents[1]
MAE_SMALL = dict(trans_dim=32, encoder_dims=32, depth=2, decoder_depth=1, group_size=16,
                 num_group=16, knn_graph=4, k_top_eigenvectors=2, drop_path_rate=0.0)
# the patch encoder's biases whose every path ends in a BatchNorm: their exact
# gradient is 0 and each framework returns its own rounding noise
NOISE_BIASES = {f"MAE_encoder.encoder.{k}.bias" for k in
                ("first_conv.0", "first_conv.3", "second_conv.0")}


def _np(x):
    return np.array(x)  # a writable copy of a JAX array


def _t(x):
    return torch.from_numpy(_np(x))


def _clouds(b, n, seed):
    rng = np.random.default_rng(seed)
    pts = rng.standard_normal((b, n, 3)).astype(np.float32)
    return pts / np.abs(pts).max(axis=(1, 2), keepdims=True)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Tiny tensors, one suite worker a core: one intra-op thread a worker."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_emd_matches_jax():
    """Per cloud and the batch mean within rtol 1e-5, at two epsilons, on
    clouds of unequal sizes."""
    rng = np.random.default_rng(6)
    x, y = (rng.standard_normal((3, n, 3)).astype(np.float32) for n in (12, 9))
    for eps, iters in ((0.01, 50), (0.1, 20)):
        for red in ("mean", None):
            want = _np(jemd.emd_sinkhorn(jnp.asarray(x), jnp.asarray(y), eps, iters, red))
            got = pemd.emd_sinkhorn(torch.from_numpy(x), torch.from_numpy(y), eps, iters, red)
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


def _mae(extra, seed=0):
    """The JAX MAE at MAE_SMALL + ``extra`` and the port's with its weights."""
    jm = jmae.PointMAEMamba(jmae.PointMAEConfig(**MAE_SMALL, **extra))
    variables = jax.jit(lambda k: jm.init({"params": k, "mask": k, "gumbel": k},
                                          jnp.zeros((2, 256, 3)), train=False))(
        jax.random.key(seed))
    model = pmae.PointMAEMamba(pmae.PointMAEConfig(**MAE_SMALL, **extra))
    model.load_state_dict(point_mae_state_dict_from_jax(variables["params"],
                                                        variables["batch_stats"]), strict=True)
    return jm, dict(variables), model


@pytest.mark.parametrize("extra", [dict(rms_norm=True), dict(loss="emd"),
                                   dict(loss="emd", rms_norm=True, reverse=False)],
                         ids=["rms_norm", "emd", "emd-rms_norm-forward"])
def test_mae_options_eval_loss_and_features_match_jax(extra):
    """The wavelet-path MAE with the option, with the same ``mask_override``
    and ``orders_override``: the eval loss within rtol 1e-5 (Chamfer) or
    1e-4 (the EMD's 50 Sinkhorn iterations at epsilon 0.01 through a 2-block
    stack); the noaug features within 1e-4 of their max."""
    jm, variables, model = _mae(extra)
    rng = np.random.default_rng(1)
    pts = _clouds(2, 256, 3)
    mask = np.zeros((2, 16), np.float32)
    for b in range(2):
        mask[b, rng.permutation(16)[:9]] = 1
    orders = np.stack([np.stack([rng.permutation(16) for _ in range(2)]) for _ in range(2)])
    want = float(jax.jit(lambda v, p, m, o: jm.apply(v, p, train=False, mask_override=m,
                                                      orders_override=o))(
        variables, jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(orders)))
    jfeat = _np(jax.jit(lambda v, p, o: jm.apply(v, p, noaug=True, orders_override=o))(
        variables, jnp.asarray(pts), jnp.asarray(orders)))
    model.eval()
    with torch.no_grad():
        got = float(model(_t(pts), mask_override=_t(mask), orders_override=_t(orders)))
        feat = model(_t(pts), noaug=True, orders_override=_t(orders)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4 if extra.get("loss") == "emd" else 1e-5)
    np.testing.assert_allclose(feat, jfeat, atol=1e-4 * np.abs(jfeat).max())


# ---------------------------------------------------------------------------
# the legacy 'MAMBA' MAE path
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def legacy():
    return _mae(dict(method="MAMBA"), seed=3)


def test_legacy_mae_eval_loss_and_features_match_jax(legacy):
    """With JAX's weights carried (``decoder_pos_embed`` and no
    ``diff_sgwt``): the eval loss, whose mask both draw from
    ``jax.random.key(0)`` (the port through its threefry ``uniform``),
    within rtol 1e-5; the rebuilt points and the truth of ``vis`` within
    1e-5 of their max; the noaug features over every group (B, G, C) within
    1e-4 of their max."""
    jm, variables, model = legacy
    assert "diff_sgwt" not in variables["params"] and not hasattr(model, "diff_sgwt")
    pts = _clouds(2, 256, 4)
    want, jvis = jax.jit(lambda v, p: jm.apply(v, p, train=False, vis=True))(
        variables, jnp.asarray(pts))
    jfeat = _np(jax.jit(lambda v, p: jm.apply(v, p, train=False, noaug=True))(
        variables, jnp.asarray(pts)))
    model.eval()
    with torch.no_grad():
        got, vis = model(_t(pts), vis=True)
        feat = model(_t(pts), noaug=True).numpy()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    for k in ("rebuild", "gt"):
        w = _np(jvis[k])
        assert vis[k].shape == w.shape == (2, 9, 16, 3)
        np.testing.assert_allclose(vis[k].numpy(), w, atol=1e-5 * np.abs(w).max())
    assert feat.shape == jfeat.shape == (2, 16, 32)
    np.testing.assert_allclose(feat, jfeat, atol=1e-4 * np.abs(jfeat).max())


def test_legacy_mae_train_loss_and_gradients_match_jax(legacy):
    """A train-mode forward and backward (BatchNorm on batch statistics,
    drop_path 0) with the mask of JAX's 'mask' stream, its uniforms drawn from
    the model's own ``make_rng('mask')`` key and handed to the port as
    ``mask_uniform``: the loss within rtol 1e-5,
    every parameter gradient within 1e-3 of the largest (the patch encoder's
    biases that only feed BatchNorms aside: their exact gradient is 0), the
    BatchNorm statistics within rtol 1e-5 (atol 1e-7)."""
    jm, variables, model = legacy
    pts = _clouds(2, 256, 5)
    rngs = {"mask": jax.random.key(7), "dropout": jax.random.key(8)}

    def loss_fn(params):
        out, upd = jm.apply({"params": params, "batch_stats": variables["batch_stats"]},
                            jnp.asarray(pts), train=True, mutable=["batch_stats"], rngs=rngs)
        return out, upd["batch_stats"]

    (jloss, jstats), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])
    key = jm.apply(variables, method=lambda m: m.make_rng("mask"), rngs=rngs)
    model.train()
    loss = model(_t(pts), mask_uniform=_t(jax.random.uniform(key, (2, 16))))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    want = point_mae_state_dict_from_jax(jgrads, jstats)
    gmax = max(float(np.abs(want[k].numpy()).max()) for k, _ in model.named_parameters())
    for k, p in model.named_parameters():
        if k not in NOISE_BIASES:
            diff = float(np.abs(p.grad.numpy() - want[k].numpy()).max())
            assert diff <= 1e-3 * gmax, (k, diff, gmax)
    for k, v in model.state_dict().items():
        if "running" in k:
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-5, atol=1e-7,
                                       err_msg=k)




def test_legacy_mae_pretrains_through_the_cli_on_the_cpu(tmp_path, monkeypatch):
    """``cli.main --device cpu`` of cfgs/dev/tiny_pretrain_cpu.yaml with
    ``method: MAMBA`` at max_epoch 1 on a written ShapeNet-55 tree (24
    shapes, one step an epoch) and the committed ModelNet40 h5 fixtures: two
    finite steps, the probe's accuracy in (0, 100] from the legacy encoder's
    features (B, G, C), ckpt-last.pth with ``decoder_pos_embed`` and no
    ``diff_sgwt``."""
    monkeypatch.chdir(tmp_path)
    sn = _write_shapenet(tmp_path / "sn", 24)
    (tmp_path / "shapenet.yaml").write_text(
        f"NAME: ShapeNet\nDATA_PATH: {sn / 'ShapeNet-55'}\nN_POINTS: 1024\n"
        f"PC_PATH: {sn / 'shapenet_pc'}\n")
    (tmp_path / "svm.yaml").write_text(f"NAME: ModelNet40SVM\nDATA_PATH: "
                                       f"{ROOT / 'tests' / 'data' / 'h5'}\n")
    base = (ROOT / "cfgs" / "dev" / "tiny_pretrain_cpu.yaml").read_text()
    cfg = tmp_path / "legacy.yaml"
    cfg.write_text(base.replace("cfgs/dataset_configs/ShapeNet-55.yaml",
                                str(tmp_path / "shapenet.yaml"))
                   .replace("cfgs/dataset_configs/ModelNet40SVM.yaml", str(tmp_path / "svm.yaml"))
                   .replace("max_epoch: 12", "max_epoch: 1")
                   .replace("method: smallest_eigenvectors_seperate_learnable_tokens",
                            "method: MAMBA"))
    feats, losses = [], []
    real_feat, real_step = prp.make_feature_step, prp.make_pretrain_step

    def feature_step(model):
        step = real_feat(model)
        return lambda *a: feats.append(step(*a)) or feats[-1]

    def pretrain_step(model, *a):
        step = real_step(model, *a)

        def run(*sa, **sk):
            out = step(*sa, **sk)
            losses.append(float(out[1]["loss"]))
            return out

        return run

    monkeypatch.setattr(prp, "make_feature_step", feature_step)
    monkeypatch.setattr(prp, "make_pretrain_step", pretrain_step)
    state, best = cli.main(["--config", str(cfg), "--device", "cpu", "--num_workers", "0",
                            "--exp_name", "legacy"])
    assert state.model.legacy and state.step == 2 and len(losses) == 2
    assert all(np.isfinite(v) for v in losses)
    assert feats and feats[0].shape[1] == 2 * 48 and 0.0 < best.acc <= 100.0
    last = torch.load(tmp_path / "experiments" / "legacy" / "legacy" / "ckpt-last.pth",
                      weights_only=True)["base_model"]
    assert "decoder_pos_embed.0.weight" in last
    assert not any(k.startswith("diff_sgwt.") for k in last)
