"""Part segmentation: the port's ``models/segmentation.py``,
``data/shapenetpart.py``, ``train/runner_seg.py``, the PointNet++ helpers of
``ops/pointops.py`` and the seg CLI, against the JAX package on the CPU at
small sizes, the JAX-initialised weights carried over by
``partseg_state_dict_from_jax``.

In eval the port draws the JAX evaluation's HLT tie-break itself (threefry,
bit for bit). In training the random draws are replayed, not matched by
stream: the JAX model's HLT tie-break (its ``jax.random.uniform`` draw) and
its head dropout's keep mask (from ``capture_intermediates``) are handed to
the port's forward. The
eigenvector signs are aligned to JAX's; the seeds here put no eigenvector
entry within an ulp of its mean, so the HLT codes agree (asserted)."""

import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from si_mamba_tpu.data import shapenetpart as jsp
from si_mamba_tpu.models import segmentation as jseg
from si_mamba_tpu.models.point_mamba import spectral_eigvecs as j_spectral_eigvecs
from si_mamba_tpu.ops import pointops as jpo
from si_mamba_tpu.ops.spectral import multilevel_codes as j_multilevel_codes
from si_mamba_tpu.train import optim as joptim
from si_mamba_tpu.train import runner_seg as jrs
from si_mamba_tpu.train.train_state import TrainState as JTrainState
from si_mamba_tpu_torch.data import shapenetpart as psp
from si_mamba_tpu_torch.data.loader import Loader
from si_mamba_tpu_torch.models import segmentation as pseg
from si_mamba_tpu_torch.models.point_mamba import order_noise
from si_mamba_tpu_torch.ops import pointops as ppo
from si_mamba_tpu_torch.ops.spectral import multilevel_codes
from si_mamba_tpu_torch.train import cli
from si_mamba_tpu_torch.train import optim
from si_mamba_tpu_torch.train import runner_seg as prs
from si_mamba_tpu_torch.train.registry import build_model_from_cfg
from si_mamba_tpu_torch.train.train_state import TrainState
from si_mamba_tpu_torch.utils.weights import partseg_state_dict_from_jax

from tests import torch_oracle as oracle

ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(trans_dim=32, encoder_dims=32, depth=3, group_size=8, num_group=32, knn_graph=6,
             fetch_idx=(0, 1, 2), k_top_eigenvectors=3, drop_path=0.0, ssd_chunk=64)
LOGP_TOL = 2e-3  # atol and rtol of composed log-probs (tests/test_full_parity.py:333)


def _clouds(b, n, seed):
    rng = np.random.default_rng(seed)
    pts = rng.standard_normal((b, n, 3)).astype(np.float32)
    return pts / np.abs(pts).max(axis=(1, 2), keepdims=True)


def _onehot(cls):
    return np.eye(16, dtype=np.float32)[cls]


def _np(x):
    return np.array(x)  # a writable copy of a JAX array


def _randomised_stats(batch_stats, rng):
    """BatchNorm statistics that keep the activations alive through the
    per-point layers: means near 0, variances in [0.02, 0.06]."""
    def draw(path, x):
        if path[-1].key == "mean":
            return jnp.asarray((rng.standard_normal(x.shape) * 0.01).astype(np.float32))
        return jnp.asarray(rng.uniform(0.02, 0.06, x.shape).astype(np.float32))

    return jax.tree_util.tree_map_with_path(draw, batch_stats)


def _jax_model(cfg, seed=1):
    model = jseg.PartSegModel(cfg)
    variables = jax.jit(lambda k, p, o: model.init(k, p, o, train=False))(
        jax.random.key(seed), jnp.zeros((2, 256, 3)), jnp.zeros((2, 16)))
    return model, dict(variables)


def _port_model(kw, variables, **extra):
    model = pseg.PartSegModel(pseg.PartSegConfig(**kw, **extra))
    model.load_state_dict(partseg_state_dict_from_jax(variables["params"],
                                                      variables["batch_stats"]), strict=True)
    return model


def _aligned_eigvecs(jcfg):
    """The port's ``spectral_eigvecs`` with its signs aligned to JAX's for the
    same centres, and the HLT codes asserted equal."""
    real = pseg.spectral_eigvecs

    def aligned(center, cfg):
        vals, vecs = real(center, cfg)
        _, jv = j_spectral_eigvecs(jnp.asarray(center.detach().numpy()), jcfg)
        jv = np.asarray(jv)
        assert oracle.eig_cosines(vecs, jv).min() > 1 - 1e-4
        vecs = oracle.align_signs(vecs, jv)
        k = cfg.k_top_eigenvectors
        np.testing.assert_array_equal(multilevel_codes(vecs, k).numpy(),
                                      np.asarray(j_multilevel_codes(jnp.asarray(jv), k)))
        return vals, vecs

    return aligned


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_config_mirrors_jax():
    import dataclasses

    assert ([(f.name, f.default) for f in dataclasses.fields(pseg.PartSegConfig)]
            == [(f.name, f.default) for f in dataclasses.fields(jseg.PartSegConfig)])
    cfg = pseg.PartSegConfig.from_dict({"NAME": "PartSegModel", "fetch_idx": [1, 2], "depth": 3})
    assert cfg.fetch_idx == (1, 2) and cfg.depth == 3


def test_three_nn_breaks_ties_to_the_lower_index_as_jax():
    """Centres as the HLT canvas lays them: chunks repeated and zero slots,
    points on the centres and at the origin, so most picks tie. The picked
    indices equal ``lax.top_k``'s, the interpolation JAX's within 1e-6."""
    rng = np.random.default_rng(0)
    base = rng.standard_normal((2, 8, 3)).astype(np.float32)
    centres = np.concatenate([base, base[:, ::-1], base[:, :4], np.zeros((2, 6, 3), np.float32)],
                             axis=1)  # (2, 26, 3): every point twice or thrice, six zeros
    pts = np.concatenate([base, np.zeros((2, 3, 3), np.float32),
                          rng.standard_normal((2, 20, 3)).astype(np.float32)], axis=1)
    feats = rng.standard_normal((2, 26, 5)).astype(np.float32)
    d = jpo.pairwise_sqdist(jnp.asarray(pts), jnp.asarray(centres))
    _, want_idx = jax.lax.top_k(-d, 3)
    dists, idx = pseg.three_nn(torch.from_numpy(pts), torch.from_numpy(centres))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    sd = np.sort(np.asarray(d), axis=-1)
    assert (sd[..., 0] == sd[..., 1]).sum() >= 2 * 11  # the ties are there
    want = jseg.feature_propagation_interp(jnp.asarray(pts), jnp.asarray(centres),
                                           jnp.asarray(feats))
    got = pseg.feature_propagation_interp(torch.from_numpy(pts), torch.from_numpy(centres),
                                          torch.from_numpy(feats))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


@pytest.mark.parametrize("method,mixer", [("HLT", "mamba"), ("HLT", "ssd"), ("SAST", "mamba"),
                                          ("SAST", "ssd"), ("Point_MAMBA", "mamba")])
def test_partseg_eval_logp_match_jax(method, mixer):
    """Eval log-probs with carried weights and randomised BatchNorm
    statistics against the JAX trainer's ``make_seg_eval_step``, within 2e-3
    (atol and rtol); the port's eval forward draws HLT's tie-break itself,
    as JAX's evaluation does (``EVAL_ORDER_KEY``), and another draw would
    miss."""
    kw = dict(SMALL, method=method, mixer=mixer)
    jcfg = jseg.PartSegConfig(**kw)
    jmodel, variables = _jax_model(jcfg)
    variables["batch_stats"] = _randomised_stats(variables["batch_stats"],
                                                 np.random.default_rng(4))
    pts, cls = _clouds(2, 256, seed=5), np.array([3, 12], np.int32)
    onehot = _onehot(cls)
    jstate = JTrainState.create(variables["params"], variables["batch_stats"],
                                optax.sgd(0.0))
    want = np.asarray(jax.jit(jrs.make_seg_eval_step(jmodel))(jstate, jnp.asarray(pts),
                                                              jnp.asarray(cls)))
    assert want.std() > 0.1  # the statistics leave the log-probs spread
    model = _port_model(kw, variables).eval()
    with torch.no_grad(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(pseg, "spectral_eigvecs", _aligned_eigvecs(jcfg))
        got = model(torch.from_numpy(pts), torch.from_numpy(onehot)).numpy()
        if method == "HLT":  # another draw orders the buckets otherwise
            other = model(torch.from_numpy(pts), torch.from_numpy(onehot),
                          order_noise=order_noise(2, jcfg.num_group, "cpu", False)).numpy()
            assert np.abs(other - want).max() > 1e-3
    np.testing.assert_allclose(got, want, atol=LOGP_TOL, rtol=LOGP_TOL)


def test_nll_loss_matches_jax():
    rng = np.random.default_rng(2)
    logp = np.log(rng.dirichlet(np.ones(50), (2, 7)).astype(np.float32))
    target = rng.integers(0, 50, (2, 7))
    np.testing.assert_allclose(
        float(pseg.nll_loss(torch.from_numpy(logp), torch.from_numpy(target))),
        float(jseg.nll_loss(jnp.asarray(logp), jnp.asarray(target))), rtol=1e-6)


def test_registry_builds_the_seg_presets():
    for preset, mixer, impl in (("part_segmentation.yaml", "mamba", "auto"),
                                ("part_segmentation_ssd_fused.yaml", "ssd", "ssd_fused")):
        from si_mamba_tpu_torch.train.config import get_config

        m = get_config(str(ROOT / "cfgs" / preset)).model
        cfg = pseg.PartSegConfig.from_dict(m)
        assert (cfg.method, cfg.mixer, cfg.scan_impl, cfg.fetch_idx, cfg.num_group) == (
            "HLT", mixer, impl, (3, 7, 11), 128)
    model, cfg = build_model_from_cfg({"NAME": "PartSegModel", **SMALL,
                                       "fetch_idx": [0, 2]}, "cpu")
    assert isinstance(model, pseg.PartSegModel) and cfg.fetch_idx == (0, 2)
    assert model.convs1.in_features == 1024 + 2 * 2 * 32 + 64


# ---------------------------------------------------------------------------
# two train steps
# ---------------------------------------------------------------------------

LR, WD, CLIP, EPOCHS = 1e-3, 0.05, 10.0, 4
LOSS_RTOL = 2e-4
# the relative error of each leaf's update, in its L2 norm. The first step
# starts from the initial weights, where the canvas's zero slots make the
# forward ill-conditioned: the two gradients agree within 2e-3 (the global
# norm is about 260), and Adam's first, sign-like step carries that into
# every element whose gradient is near zero (worst leaf 0.052). The second
# step starts from JAX's state after the first, Adam's moments carried, where
# the gradients agree within 2e-6 (worst leaf's update 7.4e-4).
UPDATE_RTOL = (0.1, 2e-3)
GRAD_NORM_RTOL = 1e-3  # the global gradient norm before the clip
# the biases whose every effect a train-mode BatchNorm removes (directly, or
# through max-pooling, a LayerNorm and a Linear): their gradient is zero but
# for rounding, which the rule of ``_noise_biases`` finds
NOISE_BIASES = {"encoder.first_conv.0.bias", "encoder.first_conv.3.bias",
                "encoder.second_conv.0.bias", "norm.bias", "prop_fc1.bias", "prop_fc2.bias",
                "convs1.bias", "convs2.bias"}


def _noise_biases(grads):
    """The biases whose gradient norm is below 1e-4 of their layer's weight's."""
    return {k for k in grads if k.endswith(".bias") and k[:-4] + "weight" in grads
            and float(grads[k].norm()) < 1e-4 * float(grads[k[:-4] + "weight"].norm())}


def _check_update(got, want, noise, lr, rtol):
    """Each leaf's update (after minus before) against JAX's: within ``rtol``
    of JAX's in L2 norm; a bias of ``noise`` elementwise within 2 lr (Adam
    moves an element by at most about lr a step, whatever the sign of its
    rounding-noise gradient)."""
    for k, dj in want.items():
        dp = got[k]
        if k in noise:
            err = float((dp - dj).abs().max())
            assert err <= 2.02 * lr, f"{k}: |update - JAX's| {err:.3g} > 2 lr"
        else:
            err, ref = float((dp - dj).norm()), float(dj.norm())
            assert err <= rtol * ref, f"{k}: |update - JAX's| {err:.3g} > {rtol} x {ref:.3g}"


def _port_in_state(kw, jstate):
    """The port's model, optimizer and train state in JAX's train state:
    weights, BatchNorm statistics, the update count and Adam's moments."""
    model = _port_model(kw, {"params": jstate.params, "batch_stats": jstate.batch_stats})
    optimizer, _ = optim.build_optimizer(model, lr=LR, weight_decay=WD, epochs=EPOCHS,
                                         warmup_epochs=0, steps_per_epoch=1, grad_clip=CLIP)
    count = int(jstate.step)
    if count:
        (adam,) = [s for s in jax.tree_util.tree_leaves(
            jstate.opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
            if isinstance(s, optax.ScaleByAdamState)]
        mu = partseg_state_dict_from_jax(adam.mu, jstate.batch_stats)
        nu = partseg_state_dict_from_jax(adam.nu, jstate.batch_stats)
        for name, p in model.named_parameters():
            optimizer.torch_optimizer.state[p] = {"step": torch.tensor(float(count)),
                                                  "exp_avg": mu[name], "exp_avg_sq": nu[name]}
        optimizer.count = count
    return model, TrainState(step=count, model=model, optimizer=optimizer)


def _params_and_buffers(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()
            if "num_batches_tracked" not in k}


def test_seg_train_steps_match_jax(monkeypatch):
    """Two steps of ``make_seg_train_step`` against JAX's (HLT, drop_path 0),
    JAX's own HLT draw and head-dropout mask of each step replayed into the
    port's. Run on from the same initial weights, the losses agree within
    2e-4. Each step, started from JAX's state before it, moves every
    parameter as JAX's does (``UPDATE_RTOL``, the biases of rounding-noise
    gradient within 2 lr), from a global gradient norm within 1e-3 of
    JAX's, and moves the BatchNorm statistics to JAX's within 1e-3 (rtol;
    atol 1e-6). A zero update and the update's opposite fail that check."""
    kw = dict(SMALL, method="HLT")
    jcfg = jseg.PartSegConfig(**kw)
    jmodel, variables = _jax_model(jcfg, seed=3)
    pts = _clouds(4, 256, seed=6)
    cls = np.array([3, 12, 0, 7], np.int32)
    seg = np.stack([np.random.default_rng(b).choice(jsp.SEG_CLASSES[list(jsp.SEG_CLASSES)[c]],
                                                    256) for b, c in enumerate(cls)])
    seg = seg.astype(np.int32)
    tx, schedule = joptim.build_optimizer(variables["params"], lr=LR, weight_decay=WD,
                                          epochs=EPOCHS, warmup_epochs=0, steps_per_epoch=1,
                                          grad_clip=CLIP)
    state = JTrainState.create(variables["params"], variables["batch_stats"], tx)
    rng = jax.random.key(9)
    jstep = jax.jit(jrs.make_seg_train_step(jmodel))

    real_uniform, drawn = jax.random.uniform, []

    def recording_uniform(key, shape=(), *a, **k):
        drawn.append(real_uniform(key, shape, *a, **k))
        return drawn[-1]

    def replayed(state, s):
        """The step's HLT draw, head keep mask and gradient, as its forward
        and backward make them."""
        drawn.clear()
        k_drop, k_order = jax.random.split(jax.random.fold_in(rng, s))

        def loss(params):
            logp, upd = jmodel.apply({"params": params, "batch_stats": state.batch_stats},
                                     jnp.asarray(pts), jax.nn.one_hot(cls, 16), train=True,
                                     mutable=["batch_stats", "intermediates"],
                                     capture_intermediates=True,
                                     rngs={"dropout": k_drop, "order": k_order})
            return jseg.nll_loss(logp, jnp.asarray(seg)), upd["intermediates"]

        (_, inter), grads = jax.value_and_grad(loss, has_aux=True)(state.params)
        return (drawn[0], inter["Dropout_0"]["__call__"][0] != 0, grads,
                optax.global_norm(grads))

    with monkeypatch.context() as mp:
        mp.setattr(jax.random, "uniform", recording_uniform)
        replay = jax.jit(replayed, static_argnums=1)
        steps = []  # (JAX state before, noise, mask, gradient, its norm, loss)
        for s in range(2):
            noise, mask, grads, norm = replay(state, s)
            before = state
            state, m = jstep(state, jnp.asarray(pts), jnp.asarray(cls), jnp.asarray(seg), rng)
            steps.append((before, torch.from_numpy(_np(noise)), torch.from_numpy(_np(mask)),
                          partseg_state_dict_from_jax(grads, before.batch_stats),
                          float(norm), float(m["loss"])))
    states = [s[0] for s in steps] + [state]
    monkeypatch.setattr(pseg, "spectral_eigvecs", _aligned_eigvecs(jcfg))
    inputs = (torch.from_numpy(pts), torch.from_numpy(cls), torch.from_numpy(seg), None)

    model, pstate = _port_in_state(kw, states[0])
    step = prs.make_seg_train_step(model)
    for _, noise, mask, _, _, jloss in steps:
        pstate, m = step(pstate, *inputs, order_noise=noise, head_mask=mask)
        np.testing.assert_allclose(float(m["loss"]), jloss, rtol=LOSS_RTOL)
    assert pstate.step == 2 and pstate.optimizer.count == 2

    for s, (before, noise, mask, grads, norm, jloss) in enumerate(steps):
        noise_biases = _noise_biases(grads)
        assert noise_biases == NOISE_BIASES
        model, pstate = _port_in_state(kw, before)
        start = _params_and_buffers(model)
        want = partseg_state_dict_from_jax(states[s + 1].params, states[s + 1].batch_stats)
        pstate, m = prs.make_seg_train_step(model)(pstate, *inputs, order_noise=noise,
                                                   head_mask=mask)
        np.testing.assert_allclose(float(m["loss"]), jloss, rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(pstate.optimizer.last_grad_norm), norm,
                                   rtol=GRAD_NORM_RTOL)
        after = _params_and_buffers(model)
        names = [n for n, _ in model.named_parameters()]
        got = {k: after[k] - start[k] for k in names}
        jupd = {k: want[k] - start[k] for k in names}
        lr = float(schedule(s))
        _check_update(got, jupd, noise_biases, lr, UPDATE_RTOL[s])
        for wrong in ({k: torch.zeros_like(v) for k, v in got.items()},
                      {k: -v for k, v in got.items()}):
            with pytest.raises(AssertionError):
                _check_update(wrong, jupd, noise_biases, lr, UPDATE_RTOL[s])
        for k in after:
            if "running_" in k:
                assert not torch.equal(after[k], start[k]), k
                np.testing.assert_allclose(after[k].numpy(), want[k].numpy(), rtol=1e-3,
                                           atol=1e-6, err_msg=k)


# ---------------------------------------------------------------------------
# the data, the augmentations and the evaluation
# ---------------------------------------------------------------------------

def write_shapenetpart_tree(root: Path, n_trainval: int, n_test: int, n_points: int = 300,
                            seed: int = 0) -> Path:
    """A ShapeNetPart-layout tree: the 16 categories, the split lists and one
    ``x y z nx ny nz part`` text file a shape, the parts drawn from its
    category's."""
    rng = np.random.default_rng(seed)
    names = list(psp.SEG_CLASSES)
    offsets = {name: f"{i + 2690000:08d}" for i, name in enumerate(names)}
    (root / "train_test_split").mkdir(parents=True)
    (root / "synsetoffset2category.txt").write_text(
        "".join(f"{n}\t{o}\n" for n, o in offsets.items()))
    lists = {"train": [], "val": [], "test": []}
    for i in range(n_trainval + n_test):
        name = names[i % len(names)]
        split = "test" if i >= n_trainval else ("val" if i % 5 == 4 else "train")
        sid = f"shape{i:04d}"
        (root / offsets[name]).mkdir(exist_ok=True)
        rows = np.concatenate([rng.standard_normal((n_points, 6)),
                               rng.choice(psp.SEG_CLASSES[name], (n_points, 1))], axis=1)
        np.savetxt(root / offsets[name] / f"{sid}.txt", rows, fmt="%.6f")
        lists[split].append(f"shape_data/{offsets[name]}/{sid}")
    for split, ids in lists.items():
        (root / "train_test_split" / f"shuffled_{split}_file_list.json").write_text(json.dumps(ids))
    return root


@pytest.fixture(scope="module")
def seg_tree(tmp_path_factory):
    return write_shapenetpart_tree(tmp_path_factory.mktemp("shapenetpart"), 10, 6)


def test_dataset_items_and_loader_batches_equal_jax(seg_tree):
    assert psp.SEG_CLASSES == jsp.SEG_CLASSES
    for split in ("trainval", "test", "train", "val"):
        a = psp.PartNormalDataset(str(seg_tree), npoints=64, split=split, seed=3)
        b = jsp.PartNormalDataset(str(seg_tree), npoints=64, split=split, seed=3)
        assert a.datapath == b.datapath and a.classes == b.classes and len(a) > 0
        for i in list(range(len(a))) + [0]:  # a second read comes from the cache
            for x, y in zip(a[i], b[i]):
                np.testing.assert_array_equal(x, y)
    for shuffle, drop_last in ((True, True), (False, False)):
        la = Loader(psp.PartNormalDataset(str(seg_tree), 64, "trainval", seed=1), 4,
                    shuffle=shuffle, drop_last=drop_last, seed=2)
        lb = jsp.PartSegLoader(jsp.PartNormalDataset(str(seg_tree), 64, "trainval", seed=1), 4,
                               shuffle=shuffle, drop_last=drop_last, seed=2)
        assert len(la) == len(lb) == (2 if drop_last else 3)
        for ba, bb in zip(la.epoch(1), lb.epoch(1), strict=True):
            for x, y in zip(ba, bb):
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)


def test_augmentations_equal_jax():
    pts = _clouds(3, 16, seed=0)
    a, b = np.random.default_rng(5), np.random.default_rng(5)
    np.testing.assert_array_equal(
        psp.shift_point_cloud(psp.random_scale_point_cloud(pts, a), a),
        jsp.shift_point_cloud(jsp.random_scale_point_cloud(pts, b), b))


def test_evaluate_miou_equals_jax(seg_tree):
    """The same log-probs (drawn once a batch) through both evaluations,
    the last batch short: every metric equal."""
    ds = psp.PartNormalDataset(str(seg_tree), npoints=64, split="test", seed=0)
    loader = Loader(ds, 4)
    rng = np.random.default_rng(8)
    logps = [np.log(rng.dirichlet(np.ones(50), (len(c), 64))).astype(np.float32)
             for _, c, _ in loader.epoch(0)]
    assert [len(x) for x in logps] == [4, 2]

    def replay(convert):
        it = iter(logps)
        return lambda state, pts, cls: convert(next(it))

    ds.rng = np.random.default_rng(0)  # the same draws again for each evaluation
    got = prs.evaluate_miou(replay(torch.from_numpy), None, loader, device="cpu")
    ds.rng = np.random.default_rng(0)
    want = jrs.evaluate_miou(replay(jnp.asarray), None, loader)
    assert got == want and 0 < got["instance_miou"] < 1
    _, _, seg0 = next(loader.epoch(0))
    cats = [prs.SEG_LABEL_TO_CAT[int(row[0])] for row in seg0]
    np.testing.assert_array_equal(prs.masked_category_argmax(logps[0], cats),
                                  jrs.masked_category_argmax(logps[0], cats))


# ---------------------------------------------------------------------------
# the PointNet++ helpers
# ---------------------------------------------------------------------------

def test_ball_query_and_set_abstractions_equal_jax():
    pts = _clouds(2, 64, seed=1)
    pts[:, 40:44] = pts[:, 0:4]  # duplicates tie
    feats = np.random.default_rng(0).standard_normal((2, 64, 5)).astype(np.float32)
    q = pts[:, :6]
    for radius, k in ((0.8, 8), (0.05, 4), (0.3, 16)):
        np.testing.assert_array_equal(
            ppo.ball_query(torch.from_numpy(q), torch.from_numpy(pts), radius, k).numpy(),
            np.asarray(jpo.ball_query(jnp.asarray(q), jnp.asarray(pts), radius, k)))
    w = np.random.default_rng(2).standard_normal((8, 7)).astype(np.float32)
    xyz, f = ppo.set_abstraction(torch.from_numpy(pts), torch.from_numpy(feats), 16, 0.8, 8,
                                 lambda g: g @ torch.from_numpy(w))
    jxyz, jf = jpo.set_abstraction(jnp.asarray(pts), jnp.asarray(feats), 16, 0.8, 8,
                                   lambda g: g @ jnp.asarray(w))
    np.testing.assert_array_equal(xyz.numpy(), np.asarray(jxyz))
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), atol=1e-5, rtol=1e-5)
    xyz, f = ppo.set_abstraction_msg(torch.from_numpy(pts), torch.from_numpy(feats), 16,
                                     [0.4, 0.9], [4, 8],
                                     [lambda g: g * 1.5, lambda g: g[..., :2] * 2.0])
    jxyz, jf = jpo.set_abstraction_msg(jnp.asarray(pts), jnp.asarray(feats), 16, [0.4, 0.9],
                                       [4, 8], [lambda g: g * 1.5, lambda g: g[..., :2] * 2.0])
    np.testing.assert_array_equal(xyz.numpy(), np.asarray(jxyz))
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), atol=1e-6, rtol=1e-6)
    assert f.shape == (2, 16, 8 + 2)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_cli_trains_and_evaluates_a_tiny_seg_config_on_the_cpu(seg_tree, tmp_path, monkeypatch):
    """``cli.main --device cpu`` on cfgs/dev/tiny_partseg_cpu.yaml (HLT, 3 x 48)
    at 256 points, batch 4, one epoch: two steps, the evaluation, both
    checkpoints; then --resume of the finished run trains nothing."""
    monkeypatch.chdir(tmp_path)
    cfg = tmp_path / "seg.yaml"
    cfg.write_text(f"_base_: {ROOT}/cfgs/dev/tiny_partseg_cpu.yaml\ndata_root: {seg_tree}\n"
                   f"npoints: 256\ntotal_bs: 4\nmax_epoch: 1\n"
                   f"scheduler: {{type: CosLR, kwargs: {{epochs: 1, initial_epochs: 0}}}}\n")
    state, best = cli.main(["--config", str(cfg), "--device", "cpu", "--num_workers", "0"])
    exp = tmp_path / "experiments" / "seg" / "default"
    assert state.step == 2 and isinstance(state.model, pseg.PartSegModel)
    assert {"ckpt-last.pth", "ckpt-best.pth", "config.yaml", "scalars.jsonl"} <= set(
        os.listdir(exp))
    payload = torch.load(exp / "ckpt-last.pth", map_location="cpu", weights_only=True)
    m = payload["metrics"]
    assert payload["epoch"] == 0 and payload["step"] == 2
    assert all(0 <= m[k] <= 1 for k in ("instance_miou", "class_miou", "accuracy"))
    assert best["instance_miou"] == m["instance_miou"] > 0
    tags = [json.loads(line)["tag"] for line in (exp / "scalars.jsonl").read_text().splitlines()]
    assert tags == ["Seg/instance_miou"]
    resumed, _ = cli.main(["--config", str(cfg), "--device", "cpu", "--num_workers", "0",
                           "--resume"])
    assert resumed.step == 2
    with pytest.raises(NotImplementedError, match="--test"):
        cli.main(["--config", str(cfg), "--device", "cpu", "--test"])
