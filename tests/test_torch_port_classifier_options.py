"""The classifier's last options against the JAX package on the CPU: the
RMSNorm (against flax's ``nn.RMSNorm``), ``cross_merge`` and
``resort_sequence``, the ``PointMamba`` classifier with ``rms_norm`` (fp32
and bf16) and with ``add_after_layer`` (its forward and two train steps), the
part-segmentation model with ``rms_norm``, and few-shot through the CLI
(--way/--shot/--fold, then --test) on the CPU. The MAE with these options and
its legacy path are tests/test_torch_port_mae_remainder.py. Small sizes: 2
blocks, d_model 32-64, G = 16. Each test states its tolerance."""

import functools
import pickle
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import flax.linen as fnn

from si_mamba_tpu.models import PointMamba as JPointMamba
from si_mamba_tpu.models import PointMambaConfig as JConfig
from si_mamba_tpu.models import ordering as jorder
from si_mamba_tpu.models import segmentation as jseg
from si_mamba_tpu.models.grouping import group_divider as j_group_divider
from si_mamba_tpu.models.point_mamba import cross_entropy_loss_acc as j_ce
from si_mamba_tpu.models.point_mamba import spectral_eigvecs as j_spectral_eigvecs
from si_mamba_tpu.ops.spectral import sort_orders_by_eigenvectors as j_sort_orders
from si_mamba_tpu.train import optim as joptim
from si_mamba_tpu.train import runner_seg as jrs
from si_mamba_tpu.train.train_state import TrainState as JTrainState
from si_mamba_tpu_torch.models import PointMamba, PointMambaConfig
from si_mamba_tpu_torch.models import ordering as porder
from si_mamba_tpu_torch.models import point_mamba as port_pm
from si_mamba_tpu_torch.models import segmentation as pseg
from si_mamba_tpu_torch.models.layers import RMSNorm
from si_mamba_tpu_torch.ops.spectral import sort_orders_by_eigenvectors
from si_mamba_tpu_torch.train import cli, optim
from si_mamba_tpu_torch.train.train_state import TrainState, make_classifier_train_step
from si_mamba_tpu_torch.utils.weights import state_dict_from_jax

from tests import torch_oracle as oracle
from tests.test_torch_port_perf import ZERO_GRADIENT
from tests.test_torch_port_perf import _aligned_eigvecs as _aligned_bf16_eigvecs
from tests.test_torch_port_seg import SMALL as SEG_SMALL
from tests.test_torch_port_seg import _aligned_eigvecs as _aligned_seg_eigvecs
from tests.test_torch_port_seg import _onehot, _port_model as _seg_port, _randomised_stats

ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(trans_dim=64, encoder_dims=64, depth=2, cls_dim=10, num_group=16,
             group_size=16, knn_graph=8, drop_path=0.0, cls_head_dropout=0.0)
OPTIONS = {"rms_norm": dict(rms_norm=True), "add_after_layer": dict(add_after_layer=True),
           "both": dict(rms_norm=True, add_after_layer=True)}
LOGITS_ATOL, LOGITS_RTOL = 1e-3, 2e-3  # of max|logit|, and relative (test_full_parity.py:83)
BF16_TOL = 3e-2  # the perf tolerance of tests/test_torch_port_perf.py


def _np(x):
    return np.array(x)  # a writable copy of a JAX array


def _t(x):
    return torch.from_numpy(_np(x))


def _clouds(b, n, seed):
    rng = np.random.default_rng(seed)
    pts = rng.standard_normal((b, n, 3)).astype(np.float32)
    return pts / np.abs(pts).max(axis=(1, 2), keepdims=True)


def _rel(got, want) -> float:
    got, want = (np.asarray(x, np.float32) for x in (got.float() if torch.is_tensor(got)
                                                      else got, want))
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Tiny tensors, one suite worker a core: one intra-op thread a worker."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# RMSNorm, cross_merge, resort_sequence
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_flax(dtype):
    """Against flax ``nn.RMSNorm(epsilon=1e-5, dtype=...)`` with a random
    scale: fp32 within rtol 1e-5 (atol 1e-6); bf16 (the statistics in fp32,
    one rounding of the output) within one bf16 ulp; the result in the
    input's dtype and the scale carried as ``weight``."""
    x = np.random.default_rng(1).standard_normal((3, 7, 48)).astype(np.float32) * 3
    scale = np.random.default_rng(2).uniform(0.5, 1.5, 48).astype(np.float32)
    jdt = jnp.dtype(dtype)
    want = fnn.RMSNorm(epsilon=1e-5, dtype=jdt).apply({"params": {"scale": jnp.asarray(scale)}},
                                                      jnp.asarray(x).astype(jdt))
    norm = RMSNorm(48)
    norm.load_state_dict({"weight": torch.from_numpy(scale)}, strict=True)
    got = norm(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype) and str(want.dtype) == dtype
    want = np.asarray(want.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-6)
    else:
        ulp = np.exp2(np.floor(np.log2(np.abs(want) + 1e-30)) - 7)
        assert (np.abs(got.detach().float().numpy() - want) <= ulp).all()


def test_cross_merge_and_resort_sequence_equal_jax():
    """``resort_sequence`` equal to JAX's; ``cross_merge`` (the sum of 2k
    gathers) within rtol 1e-6 (atol 1e-6), and on a per-token feature laid
    out by ``resort_sequence`` it returns 2k times that feature (the inverse
    orders undo the sorts, each flipped segment paired with its traversal);
    a sequence that is not 2kG long is refused, as JAX's."""
    rng = np.random.default_rng(3)
    B, G, k, D = 2, 16, 3, 5
    eig = rng.standard_normal((B, G, k)).astype(np.float32)
    orders = sort_orders_by_eigenvectors(torch.from_numpy(eig))
    x = rng.standard_normal((B, G, D)).astype(np.float32)
    ys = rng.standard_normal((B, 2 * k * G, D)).astype(np.float32)
    for reverse in (True, False):
        np.testing.assert_array_equal(
            porder.resort_sequence(torch.from_numpy(x), orders, reverse).numpy(),
            _np(jorder.resort_sequence(jnp.asarray(x), jnp.asarray(eig), reverse)))
    np.testing.assert_allclose(porder.cross_merge(torch.from_numpy(ys), orders).numpy(),
                               _np(jorder.cross_merge(jnp.asarray(ys), jnp.asarray(eig))),
                               rtol=1e-6, atol=1e-6)
    seq = porder.resort_sequence(torch.from_numpy(x), orders)
    np.testing.assert_allclose(porder.cross_merge(seq, orders).numpy(), 2 * k * x, rtol=1e-6)
    with pytest.raises(AssertionError, match="2kG"):
        porder.cross_merge(torch.from_numpy(ys[:, :k * G]), orders)


# ---------------------------------------------------------------------------
# the classifier
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_variables(rms_norm: bool):
    """The JAX classifier's variables at SMALL (init key 0), with or without
    ``rms_norm``: ``add_after_layer`` and the activation dtype add no
    parameter, so the models of one norm kind share them."""
    jmodel = JPointMamba(JConfig(**SMALL, rms_norm=rms_norm))
    return jax.jit(lambda k: jmodel.init(k, jnp.zeros((2, 256, 3)), train=False))(
        jax.random.key(0))


def _models(extra):
    """The JAX classifier at SMALL + ``extra`` and the port's, both with the
    same JAX-initialised weights."""
    jcfg = JConfig(**SMALL, **extra)
    variables = dict(_jax_variables(jcfg.rms_norm))
    model = PointMamba(PointMambaConfig(**SMALL, **extra))
    model.load_state_dict(state_dict_from_jax(variables["params"], variables["batch_stats"]),
                          strict=True)
    return jcfg, JPointMamba(jcfg), variables, model


def _aligned(jcfg, pts):
    """The port's ``spectral_eigvecs`` with JAX's signs on these clouds, the
    SAST orders asserted equal (a seed clear of eigenvector ties)."""
    grouped = j_group_divider(jnp.asarray(pts), jcfg.num_group, jcfg.group_size)
    jeig = np.asarray(j_spectral_eigvecs(grouped.center, jcfg)[1])
    real = port_pm.spectral_eigvecs

    def aligned(center, cfg):
        vals, vecs = real(center, cfg)
        assert oracle.eig_cosines(vecs, jeig).min() > 1 - 1e-4
        vecs = oracle.align_signs(vecs, jeig)
        np.testing.assert_array_equal(sort_orders_by_eigenvectors(vecs).numpy(),
                                      np.asarray(j_sort_orders(jnp.asarray(jeig))))
        return vals, vecs

    return aligned


@pytest.mark.parametrize("option", list(OPTIONS))
def test_classifier_logits_match_jax(option, monkeypatch):
    """The eval logits and pooled features of the classifier with the option,
    JAX's weights carried (the final ``norm`` a LayerNorm whatever
    ``rms_norm`` says, the stack's norms RMSNorms with it; ``add_after_layer``
    the re-sorting stack under the same ``blocks.*`` keys), within atol 1e-3
    of the max and rtol 2e-3; the stack's kind and norms as JAX builds them."""
    jcfg, jmodel, variables, model = _models(OPTIONS[option])
    names = set(variables["params"]["blocks"]["layers_0"]["norm"])
    assert names == ({"scale"} if jcfg.rms_norm else {"scale", "bias"})
    assert set(variables["params"]["norm"]) == {"scale", "bias"}
    assert type(model.blocks).__name__ == ("MixerModelAdd" if jcfg.add_after_layer
                                           else "MixerModel")
    pts = _clouds(3, 256, seed=2)
    want, want_feat = jmodel.apply(variables, jnp.asarray(pts), train=False,
                                   return_features=True)
    monkeypatch.setattr(port_pm, "spectral_eigvecs", _aligned(jcfg, pts))
    with torch.no_grad():
        got, feat = model.eval()(torch.from_numpy(pts), return_features=True)
    for g, w in ((got, want), (feat, want_feat)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, atol=LOGITS_ATOL * np.abs(w).max(),
                                   rtol=LOGITS_RTOL)


def test_classifier_rms_norm_bf16_matches_jax(monkeypatch):
    """The bf16 classifier with ``rms_norm`` (eval logits in bf16, as JAX's)
    within 3e-2 of the max logit, its features within 3e-2 of their max (the
    perf tolerance), on clouds whose bf16 eigenvectors sort alike."""
    jcfg, jmodel, variables, model = _models(dict(rms_norm=True, dtype="bfloat16"))
    pts = _clouds(4, 256, seed=2)
    want, want_feat = jmodel.apply(variables, jnp.asarray(pts), train=False,
                                   return_features=True)
    _aligned_bf16_eigvecs(monkeypatch, jcfg, pts)
    with torch.no_grad():
        got, feat = model.eval()(torch.from_numpy(pts), return_features=True)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    assert _rel(got, want) <= BF16_TOL, _rel(got, want)
    assert _rel(feat, want_feat) <= BF16_TOL, _rel(feat, want_feat)


def test_add_after_layer_train_steps_match_jax(monkeypatch):
    """Two train steps of the classifier with ``add_after_layer`` and
    ``rms_norm`` (drop rates 0, AdamW at lr 1e-3 with clip 10; the port's
    kernel route, ``scan_impl='pallas'``) from the same weights on the same 8
    clouds: losses within rtol 2e-4; step 0's every parameter gradient within
    1.5e-2 of the largest and the dominant leaves within 1.5 %
    (tests/test_full_parity.py:541-545); after the second step every
    parameter within 2.5 times the summed learning rate of JAX's
    (tests/test_torch_port_train.py's tolerance), but for those whose exact gradient is
    0 (``ZERO_GRADIENT``: biases that only feed a BatchNorm), which AdamW
    moves by each framework's rounding noise."""
    extra = dict(add_after_layer=True, rms_norm=True)
    jcfg, jmodel, variables, _ = _models(extra)
    pts = _clouds(8, 256, seed=3)
    labels = np.random.default_rng(3).integers(0, SMALL["cls_dim"], 8)
    lr = 1e-3
    tx, _ = joptim.build_optimizer(variables["params"], lr=lr, weight_decay=0.05, epochs=4,
                                   warmup_epochs=0, steps_per_epoch=1, grad_clip=10.0)
    state = JTrainState.create(variables["params"], variables["batch_stats"], tx)

    def loss_fn(p, bs):
        logits, upd = jmodel.apply({"params": p, "batch_stats": bs}, jnp.asarray(pts),
                                   train=True, mutable=["batch_stats"],
                                   rngs={"dropout": jax.random.key(0)})
        return jnp.mean(j_ce(logits, jnp.asarray(labels, jnp.int32))[0]), upd["batch_stats"]

    @jax.jit
    def jstep(state):
        (loss, bs), grads = jax.value_and_grad(loss_fn, has_aux=True)(state.params,
                                                                      state.batch_stats)
        return state.apply_gradients(grads, new_batch_stats=bs), loss, grads

    j_losses, j_grads0 = [], None
    for _ in range(2):
        state, loss, grads = jstep(state)
        j_losses.append(float(loss))
        j_grads0 = grads if j_grads0 is None else j_grads0

    monkeypatch.setattr(port_pm, "spectral_eigvecs", _aligned(jcfg, pts))
    model = PointMamba(PointMambaConfig(**SMALL, **extra, scan_impl="pallas"))
    model.load_state_dict(state_dict_from_jax(variables["params"], variables["batch_stats"]),
                          strict=True)
    optimizer, _ = optim.build_optimizer(model, lr=lr, weight_decay=0.05, epochs=4,
                                         warmup_epochs=0, steps_per_epoch=1, grad_clip=10.0)
    pstate = TrainState.create(model, optimizer)
    step = make_classifier_train_step(model)
    tpts, tlab = torch.from_numpy(pts), torch.from_numpy(labels)
    per, _ = port_pm.cross_entropy_loss_acc(model.train()(tpts), tlab)
    grads0 = torch.autograd.grad(per.mean(), list(model.parameters()))
    losses = []
    for _ in range(2):
        pstate, metrics = step(pstate, tpts, tlab, None)
        losses.append(float(metrics["loss"]))
    np.testing.assert_allclose(losses, j_losses, rtol=2e-4)
    want = state_dict_from_jax(j_grads0, variables["batch_stats"])
    gmax = max(float(np.abs(v.numpy()).max()) for k, v in want.items() if "running" not in k)
    for (k, _), g in zip(model.named_parameters(), grads0):
        w = want[k].numpy()
        diff = float(np.abs(g.numpy() - w).max())
        assert diff <= 1.5e-2 * gmax, (k, diff, gmax)
        if np.abs(w).max() > 0.1 * gmax:
            assert diff <= 1.5e-2 * np.abs(w).max(), k
    final = state_dict_from_jax(state.params, state.batch_stats)
    for k, p in model.named_parameters():
        if k in ZERO_GRADIENT:
            continue
        np.testing.assert_allclose(p.detach().numpy(), final[k].numpy(), rtol=0,
                                   atol=2.5 * 2 * lr, err_msg=k)


# ---------------------------------------------------------------------------
# the segmentation model with rms_norm
# ---------------------------------------------------------------------------

def test_seg_rms_norm_logp_match_jax():
    """The part-segmentation model with ``rms_norm`` (SAST, Mamba-1), JAX's
    weights and randomised BatchNorm statistics carried: eval log-probs
    within 2e-3 (atol and rtol) of JAX's evaluation step; the stack's norms
    RMSNorms, the final ``norm`` a LayerNorm."""
    kw = dict(SEG_SMALL, method="SAST", mixer="mamba", rms_norm=True)
    jcfg = jseg.PartSegConfig(**kw)
    jmodel = jseg.PartSegModel(jcfg)
    variables = dict(jax.jit(lambda k: jmodel.init(k, jnp.zeros((2, 256, 3)), jnp.zeros((2, 16)),
                                                   train=False))(jax.random.key(1)))
    variables["batch_stats"] = _randomised_stats(variables["batch_stats"],
                                                 np.random.default_rng(4))
    pts, cls = _clouds(2, 256, seed=5), np.array([3, 12], np.int32)
    jstate = JTrainState.create(variables["params"], variables["batch_stats"], optax.sgd(0.0))
    want = np.asarray(jax.jit(jrs.make_seg_eval_step(jmodel))(jstate, jnp.asarray(pts),
                                                              jnp.asarray(cls)))
    model = _seg_port(kw, variables).eval()
    assert isinstance(model.blocks.norm_f, RMSNorm) and not isinstance(model.norm, RMSNorm)
    with torch.no_grad(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(pseg, "spectral_eigvecs", _aligned_seg_eigvecs(jcfg))
        got = model(torch.from_numpy(pts), torch.from_numpy(_onehot(cls))).numpy()
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=2e-3)


# ---------------------------------------------------------------------------
# few-shot through the CLI on the CPU
# ---------------------------------------------------------------------------

def _write_fewshot(root: Path, way: int, shot: int, fold: int, n_test: int) -> Path:
    """``ModelNetFewshot/{way}way_{shot}shot/{fold}.pkl``: ``shot`` train and
    ``n_test`` test clouds of 1024 points a class, each class a seeded blob."""
    rng = np.random.default_rng(fold)
    centres = rng.standard_normal((way, 3)) * 2

    def sample(c):
        pts = centres[c] + rng.standard_normal((1024, 3)) * (0.3 + 0.1 * c)
        return pts.astype(np.float32), np.array([c], np.int64)

    d = root / "ModelNetFewshot" / f"{way}way_{shot}shot"
    d.mkdir(parents=True)
    with open(d / f"{fold}.pkl", "wb") as f:
        pickle.dump({"train": [sample(c) for c in range(way) for _ in range(shot)],
                     "test": [sample(c) for c in range(way) for _ in range(n_test)]}, f)
    return root / "ModelNetFewshot"


@pytest.mark.parametrize("model", ["", "model: {add_after_layer: true, rms_norm: true}\n"],
                         ids=["preset", "add_after_layer-rms_norm"])
def test_fewshot_cli_on_the_cpu(tmp_path, monkeypatch, model):
    """``cli.main --device cpu`` of cfgs/dev/tiny_fewshot_cpu.yaml at
    max_epoch 0 with --way 5 --shot 10 --fold 0 on a written pickle, as it
    stands and with the classifier's two options: the head is 5 wide (the
    config's cls_dim 15 overridden), the epoch's validation accuracy finite
    and in [0, 100]; then --test of its ckpt-last.pth gives a finite
    accuracy."""
    data = _write_fewshot(tmp_path, 5, 10, 0, 4)
    monkeypatch.chdir(tmp_path)
    (tmp_path / "cfgs").symlink_to(ROOT / "cfgs")  # the dev presets' refs are CWD-relative
    (tmp_path / "fs_ds.yaml").write_text(f"NAME: ModelNetFewShot\nDATA_PATH: {data}\n")
    cfg = tmp_path / "fs.yaml"
    cfg.write_text("_base_: cfgs/dev/tiny_fewshot_cpu.yaml\ndataset:\n" + "".join(
        f"  {s}: {{_base_: {tmp_path / 'fs_ds.yaml'}, others: {{subset: '{sub}'}}}}\n"
        for s, sub in (("train", "train"), ("val", "test"), ("test", "test"))) +
        "max_epoch: 0\n" + model)
    fs = ["--way", "5", "--shot", "10", "--fold", "0", "--device", "cpu", "--num_workers", "0"]
    state, best = cli.main(["--config", str(cfg), "--exp_name", "fs"] + fs)
    exp = tmp_path / "experiments" / "fs" / "fs"
    payload = torch.load(exp / "ckpt-last.pth", weights_only=True)
    assert payload["base_model"]["cls_head_finetune.8.bias"].shape == (5,)
    cfg_used = state.model.config
    assert cfg_used.cls_dim == 5 and state.step == 50 // 8  # total_bs 8
    assert cfg_used.add_after_layer == cfg_used.rms_norm == bool(model)
    accs = [r["value"] for r in map(__import__("json").loads,
                                    (exp / "scalars.jsonl").read_text().splitlines())
            if r.get("tag") == "Metric/ACC"]
    assert accs and all(np.isfinite(a) and 0.0 <= a <= 100.0 for a in accs)
    acc = cli.main(["--config", str(cfg), "--exp_name", "fs_test", "--test", "--ckpts",
                    str(exp / "ckpt-last.pth")] + fs)
    assert np.isfinite(acc) and 0.0 <= acc <= 100.0
