"""The train-step slice of the port against the JAX package on the CPU: three
steps of ``make_classifier_train_step`` against JAX's ``TrainState`` and
``build_optimizer``, the optimizer chain and schedules, the weight-decay
mask, gradient accumulation, and the random operations (held by their
statistics, since the two frameworks draw from different streams)."""

import copy
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from si_mamba_tpu.models import PointMamba as JPointMamba
from si_mamba_tpu.models import PointMambaConfig as JConfig
from si_mamba_tpu.models.grouping import group_divider as j_group_divider
from si_mamba_tpu.models.point_mamba import cross_entropy_loss_acc as j_ce
from si_mamba_tpu.models.point_mamba import spectral_eigvecs as j_spectral_eigvecs
from si_mamba_tpu.train import optim as joptim
from si_mamba_tpu.train.train_state import TrainState as JTrainState
from si_mamba_tpu_torch.data import transforms
from si_mamba_tpu_torch.models import PointMamba, PointMambaConfig
from si_mamba_tpu_torch.models import point_mamba as port_pm
from si_mamba_tpu_torch.models.embed import Dropout
from si_mamba_tpu_torch.models.layers import DropPath
from si_mamba_tpu_torch.train import optim
from si_mamba_tpu_torch.train.runner_finetune import (
    _point_all,
    finetune_update,
    make_input_pipeline,
    make_train_step,
)
from si_mamba_tpu_torch.train.train_state import (
    TrainState,
    make_classifier_eval_step,
    make_classifier_train_step,
)
from si_mamba_tpu_torch.utils.weights import state_dict_from_jax

from tests import torch_oracle as oracle

SMALL = dict(trans_dim=96, encoder_dims=96, depth=2, cls_dim=10, num_group=32,
             group_size=16, drop_path=0.0, cls_head_dropout=0.0)
LR, WD, CLIP, EPOCHS, WARMUP, STEPS = 1e-3, 0.05, 0.05, 4, 1, 3


def _clouds(b, n, seed):
    rng = np.random.default_rng(seed)
    pts = rng.standard_normal((b, n, 3)).astype(np.float32)
    return pts / np.abs(pts).max(axis=(1, 2), keepdims=True)


# ---------------------------------------------------------------------------
# the whole slice: three train steps of each package
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def three_steps():
    """Three steps of both packages from the same JAX-initialised weights on
    the same 8 clouds (a seed with no eigenvector ties at G=32, N=256), drop
    rates 0. The port runs the kernels' CPU path (scan_impl='pallas': the
    autograd Functions over the plain forward and backward), with its
    eigenvector signs aligned to JAX's (the solvers' signs are arbitrary)."""
    jcfg = JConfig(**SMALL)
    jmodel = JPointMamba(jcfg)
    variables = jmodel.init(jax.random.key(0), jnp.zeros((2, 256, 3)), train=False)
    pts = _clouds(8, 256, seed=3)
    labels = np.random.default_rng(3).integers(0, SMALL["cls_dim"], 8)

    # JAX: value_and_grad + TrainState.apply_gradients through build_optimizer
    tx, _ = joptim.build_optimizer(variables["params"], lr=LR, weight_decay=WD,
                                        epochs=EPOCHS, warmup_epochs=WARMUP,
                                        steps_per_epoch=1, grad_clip=CLIP)
    state = JTrainState.create(variables["params"], variables["batch_stats"], tx)
    jpts, jlab = jnp.asarray(pts), jnp.asarray(labels, jnp.int32)

    def loss_fn(p, bs):
        logits, upd = jmodel.apply({"params": p, "batch_stats": bs}, jpts, train=True,
                                   mutable=["batch_stats"], rngs={"dropout": jax.random.key(0)})
        per, _ = j_ce(logits, jlab)
        return jnp.mean(per), upd["batch_stats"]

    vgrad = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    j_losses, j_norms, j_grads0 = [], [], None
    for _ in range(STEPS):
        (loss, bs), grads = vgrad(state.params, state.batch_stats)
        j_losses.append(float(loss))
        j_norms.append(float(optax.global_norm(grads)))
        j_grads0 = grads if j_grads0 is None else j_grads0
        state = state.apply_gradients(grads, new_batch_stats=bs)

    grouped = j_group_divider(jpts, jcfg.num_group, jcfg.group_size)
    jeig = np.asarray(j_spectral_eigvecs(grouped.center, jcfg)[1])
    real = port_pm.spectral_eigvecs

    def aligned(center, cfg):
        vals, vecs = real(center, cfg)
        assert oracle.eig_cosines(vecs, jeig).min() > 1 - 1e-4
        return vals, oracle.align_signs(vecs, jeig)

    model = PointMamba(PointMambaConfig(**SMALL, scan_impl="pallas"))
    model.load_state_dict(state_dict_from_jax(variables["params"], variables["batch_stats"]),
                          strict=True)
    start = copy.deepcopy(model)
    optimizer, _ = optim.build_optimizer(model, lr=LR, weight_decay=WD, epochs=EPOCHS,
                                         warmup_epochs=WARMUP, steps_per_epoch=1,
                                         grad_clip=CLIP)
    pstate = TrainState.create(model, optimizer)
    step = make_classifier_train_step(model)
    tpts, tlab = torch.from_numpy(pts), torch.from_numpy(labels)
    losses, norms = [], []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_pm, "spectral_eigvecs", aligned)
        per, _ = port_pm.cross_entropy_loss_acc(start.train()(tpts), tlab)
        per.mean().backward()  # step 0's gradients, on a copy of the start
        for _ in range(STEPS):
            pstate, metrics = step(pstate, tpts, tlab, None)
            losses.append(float(metrics["loss"]))
            norms.append(float(optimizer.last_grad_norm))
    return dict(j_losses=j_losses, j_norms=j_norms, j_grads0=j_grads0, j_state=state,
                losses=losses, norms=norms, start=start, model=model, pstate=pstate,
                variables=variables)


def test_train_steps_losses_and_grad_norms_match_jax(three_steps):
    r = three_steps
    np.testing.assert_allclose(r["losses"], r["j_losses"], rtol=2e-4)
    np.testing.assert_allclose(r["norms"], r["j_norms"], rtol=3e-3)
    assert r["pstate"].step == STEPS and r["pstate"].optimizer.count == STEPS


def test_train_step_zero_gradients_match_jax(three_steps):
    """Every parameter's step-0 gradient, mapped to the port's names by
    ``state_dict_from_jax``: within 1.5e-2 of the largest gradient, and the
    dominant leaves within 1.5 % (tests/test_full_parity.py:541-545)."""
    r = three_steps
    want = state_dict_from_jax(r["j_grads0"], r["variables"]["batch_stats"])
    got = {k: p.grad for k, p in r["start"].named_parameters()}
    assert set(got) <= set(want)
    gmax = max(float(want[k].abs().max()) for k in got)
    for k, g in got.items():
        diff = float((g - want[k]).abs().max())
        assert diff < 1.5e-2 * gmax, (k, diff, gmax)
        bmax = float(want[k].abs().max())
        if bmax > 0.1 * gmax:
            assert diff / bmax < 1.5e-2, (k, diff / bmax)


def test_train_steps_parameters_and_bn_statistics_match_jax(three_steps):
    r = three_steps
    js = r["j_state"]
    want = state_dict_from_jax(js.params, js.batch_stats)
    lr_sum = sum(joptim.cosine_warmup_epoch_schedule(LR, EPOCHS, WARMUP, 1)(i)
                 for i in range(STEPS))
    got = r["model"].state_dict()
    for k, v in got.items():
        if "num_batches_tracked" in k:
            continue
        if "running_" in k:
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-3, atol=1e-4,
                                       err_msg=k)
        else:
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-4,
                                       atol=2.5 * float(lr_sum), err_msg=k)


def test_eval_step_after_training_uses_running_statistics(three_steps):
    model = three_steps["model"]
    step = make_classifier_eval_step(model)
    pts = torch.from_numpy(_clouds(3, 256, seed=4))
    logits = step(three_steps["pstate"], pts)
    assert not model.training and logits.shape == (3, SMALL["cls_dim"])
    assert torch.isfinite(logits).all() and logits.grad_fn is None
    with pytest.raises(ValueError, match="another model"):
        make_classifier_eval_step(copy.deepcopy(model))(three_steps["pstate"], pts)


# ---------------------------------------------------------------------------
# optimizer, schedules, weight-decay mask, accumulation
# ---------------------------------------------------------------------------

def _chain_case(seed=5, steps=4):
    rng = np.random.default_rng(seed)
    shapes = {"w": (16, 8), "bias": (8,), "tok_token": (1, 4), "A_log": (8, 4)}
    params0 = {k: rng.standard_normal(s).astype(np.float32) * 0.1 for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(steps)]
    return params0, grads


def _jax_chain(params0, grads, **kw):
    jp = {k: jnp.asarray(v) for k, v in params0.items()}
    tx, _ = joptim.build_optimizer(jp, **kw)
    ost = tx.init(jp)
    for g in grads:
        upd, ost = tx.update({k: jnp.asarray(v) for k, v in g.items()}, ost, jp)
        jp = optax.apply_updates(jp, upd)
    return {k: np.asarray(v) for k, v in jp.items()}


def _port_chain(params0, grads, **kw):
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params0.items()}
    opt, _ = optim.build_optimizer(tp, **kw)
    updates = []
    for g in grads:
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy()) if p.grad is None else \
                p.grad + torch.from_numpy(g[k])  # backward passes accumulate
        updates.append(opt.step())
    return {k: p.detach().numpy() for k, p in tp.items()}, updates


@pytest.mark.parametrize("opt_type", ["AdamW", "Adam", "SGD"])
def test_optimizer_chain_matches_jax(opt_type):
    """Clip -> optimizer at the stepped-cosine lr, four updates spanning the
    warm-up and the cosine, with shared gradients (the chain of
    tests/test_full_parity.py:570)."""
    params0, grads = _chain_case()
    kw = dict(opt_type=opt_type, lr=1e-2, weight_decay=0.05, epochs=8, warmup_epochs=2,
              steps_per_epoch=1, grad_clip=0.5)
    got, updates = _port_chain(params0, grads, **kw)
    want = _jax_chain(params0, grads, **kw)
    assert updates == [True] * 4
    for k in params0:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=2e-7, err_msg=k)


def test_gradient_accumulation_matches_jax_multisteps():
    params0, grads = _chain_case(seed=6, steps=4)
    kw = dict(lr=1e-2, weight_decay=0.05, epochs=8, warmup_epochs=0, steps_per_epoch=1,
              grad_clip=0.5, step_per_update=2)
    got, updates = _port_chain(params0, grads, **kw)
    want = _jax_chain(params0, grads, **kw)
    assert updates == [False, True, False, True]
    for k in params0:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=2e-7, err_msg=k)


@pytest.mark.parametrize("steps_per_epoch", [1, 3])
def test_lr_schedules_match_jax(steps_per_epoch):
    steps = range(0, 41 * steps_per_epoch)
    pairs = [
        (optim.cosine_warmup_epoch_schedule(3e-4, 300, 10, steps_per_epoch),
         joptim.cosine_warmup_epoch_schedule(3e-4, 300, 10, steps_per_epoch)),
        (optim.cosine_warmup_epoch_schedule(1e-3, 30, 3, steps_per_epoch, lr_min=1e-5,
                                            warmup_lr_init=1e-4),
         joptim.cosine_warmup_epoch_schedule(1e-3, 30, 3, steps_per_epoch, lr_min=1e-5,
                                             warmup_lr_init=1e-4)),
        (optim.lambda_lr_schedule(1e-3, steps_per_epoch, decay_step=7, lr_decay=0.7,
                                  lowest_decay=0.02),
         joptim.lambda_lr_schedule(1e-3, steps_per_epoch, decay_step=7, lr_decay=0.7,
                                   lowest_decay=0.02)),
        (optim.build_optimizer([("w", torch.nn.Parameter(torch.zeros(1)))], opt_type="SGD", lr=0.1, epochs=9, sched_type="StepLR",
                               steps_per_epoch=steps_per_epoch)[1],
         joptim.build_optimizer({}, opt_type="SGD", lr=0.1, epochs=9, sched_type="StepLR",
                                steps_per_epoch=steps_per_epoch)[1]),
    ]
    for port, ref in pairs:  # JAX evaluates the schedules in float32
        np.testing.assert_allclose([port(s) for s in steps], [float(ref(s)) for s in steps],
                                   rtol=1e-5)


def test_bn_momentum_schedule_matches_jax():
    kw = dict(bn_momentum=0.1, bn_decay=0.5, decay_step=8, lowest_decay=0.01)
    port, ref = optim.bn_momentum_schedule(**kw), joptim.bn_momentum_schedule(**kw)
    for epoch in range(41):
        assert port(epoch) == pytest.approx(ref(epoch), rel=1e-12)
    assert port(0) == pytest.approx(0.9) and port(40) == pytest.approx(0.99)


def test_wd_mask_on_port_names_matches_jax():
    """The JAX mask, mapped to the port's names by ``state_dict_from_jax``,
    equals the port's mask over the port's parameter names."""
    cfg = JConfig(**SMALL)
    variables = JPointMamba(cfg).init(jax.random.key(1), jnp.zeros((2, 256, 3)), train=False)
    jmask = jax.tree_util.tree_map(lambda m, v: np.full(np.shape(v), m),
                                   joptim.wd_mask(variables["params"]), variables["params"])
    mapped = state_dict_from_jax(jmask, variables["batch_stats"])
    model = PointMamba(PointMambaConfig(**SMALL))
    mask = optim.wd_mask(model)
    assert set(mask) == {k for k, _ in model.named_parameters()}
    for name, decays in mask.items():
        assert decays == bool(mapped[name].all()), name
    assert mask["blocks.layers.0.mixer.A_log"] and not mask["blocks.layers.0.mixer.D"]
    assert not mask["cls_head_finetune.0.bias"] and mask["cls_head_finetune.0.weight"]
    assert not optim.wd_mask({"cls_token": torch.zeros(1, 1, 8)})["cls_token"]


def test_build_optimizer_groups_and_rejects_unknown_types():
    model = PointMamba(PointMambaConfig(**SMALL))
    opt, _ = optim.build_optimizer(model)
    decay, no_decay = (g for g in opt.torch_optimizer.param_groups
                       if g["weight_decay"] > 0), \
        (g for g in opt.torch_optimizer.param_groups if g["weight_decay"] == 0)
    mask = optim.wd_mask(model)
    assert len(next(decay)["params"]) == sum(mask.values())
    assert len(next(no_decay)["params"]) == sum(not v for v in mask.values())
    with pytest.raises(NotImplementedError):
        optim.build_optimizer(model, opt_type="LAMB")
    with pytest.raises(NotImplementedError):
        optim.build_optimizer(model, sched_type="cyclic")


# ---------------------------------------------------------------------------
# random operations: held by their statistics
# ---------------------------------------------------------------------------

def _binomial_ok(k: int, n: int, p: float, sigmas: float = 5.0) -> bool:
    return abs(k - n * p) <= sigmas * math.sqrt(n * p * (1 - p))


def test_drop_path_and_dropout_keep_rates_and_scale():
    gen = torch.Generator().manual_seed(0)
    x = torch.ones(4000, 3, 2)
    y = DropPath(0.3).train()(x, gen)
    kept = y[:, 0, 0] != 0
    assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / 0.7))
    assert torch.all(y[~kept] == 0)
    assert torch.all(y.reshape(4000, -1).eq(y[:, :1, :1].reshape(4000, 1)))  # per sample
    assert _binomial_ok(int(kept.sum()), 4000, 0.7)
    d = Dropout(0.5).train()
    z = d(torch.ones(200, 100), gen)
    assert set(torch.unique(z).tolist()) <= {0.0, 2.0}
    assert _binomial_ok(int((z != 0).sum()), 20000, 0.5)
    assert d.eval()(x) is x and Dropout(0.0).train()(x) is x
    with pytest.raises(ValueError, match="Generator"):
        Dropout(0.5).train()(x)
    with pytest.raises(ValueError, match="Generator"):
        DropPath(0.5).train()(x)


def test_transforms_ranges_and_shapes():
    gen = torch.Generator().manual_seed(1)
    pts = torch.from_numpy(_clouds(64, 128, seed=5))
    r = transforms.rotate_y(pts, gen)
    torch.testing.assert_close(r.norm(dim=-1), pts.norm(dim=-1), rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(r[..., 1], pts[..., 1])
    st = transforms.scale_and_translate(pts, gen)
    t = transforms.translate(pts, gen) - pts
    s = transforms.scale(pts + 2.0, gen) / (pts + 2.0)
    assert torch.all(t.abs() <= 0.2) and torch.allclose(t, t[:, :1, :].expand_as(t), atol=1e-6)
    assert torch.all(s >= 2 / 3 - 1e-5) and torch.all(s <= 1.5 + 1e-5)
    assert torch.all(torch.isfinite(st)) and st.shape == pts.shape
    j = transforms.jitter(pts, gen) - pts
    assert torch.all(j.abs() <= 0.05 + 1e-6) and 0.005 < float(j.std()) < 0.015
    dropped = transforms.random_input_dropout(pts, gen)
    same = torch.all(dropped == pts, dim=-1) | torch.all(dropped == pts[:, :1], dim=-1)
    assert torch.all(same)
    frac = (~torch.all(dropped == pts, dim=-1)).float().mean()
    assert 0.3 < float(frac) < 0.58  # the mean ratio is 0.875 / 2; 64 clouds


def test_fps_resample_draws_distinct_input_points():
    gen = torch.Generator().manual_seed(2)
    pts = torch.from_numpy(_clouds(3, 2048, seed=6))
    out = transforms.fps_resample(pts, gen, 1024, point_all=_point_all(1024))
    assert out.shape == (3, 1024, 3)
    for b in range(3):
        rows = {tuple(p) for p in out[b].tolist()}
        assert len(rows) == 1024 and rows <= {tuple(p) for p in pts[b].tolist()}
    again = transforms.fps_resample(pts, gen, 1024, point_all=1200)
    assert not torch.equal(out, again)  # a fresh subset each call
    with pytest.raises(NotImplementedError):
        _point_all(1000)


def test_finetune_step_runs_pipeline_and_sets_bn_momentum():
    cfg = dict(SMALL, drop_path=0.2, cls_head_dropout=0.5, drop_out_in_block=0.1)
    model = PointMamba(PointMambaConfig(**cfg))
    opt, _ = optim.build_optimizer(model, steps_per_epoch=2)
    state = TrainState.create(model, opt)
    step = make_train_step(model, 1024, rotation=True)
    pts = torch.from_numpy(_clouds(4, 1280, seed=7))
    labels = torch.tensor([0, 1, 2, 3])
    before = {k: v.clone() for k, v in model.state_dict().items()}
    state, metrics = step(state, pts, labels, torch.Generator().manual_seed(3),
                          bn_momentum=0.8)
    assert state.step == 1 and torch.isfinite(metrics["loss"])
    assert state.schedule is opt.schedule and opt.count == 1
    assert 0.0 <= float(metrics["acc"]) <= 100.0
    bns = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm1d)]
    assert bns and all(m.momentum == pytest.approx(0.2) for m in bns)
    moved = [k for k, v in model.state_dict().items() if not torch.equal(v, before[k])]
    assert any("running_mean" in k for k in moved) and any("mixer.A_log" in k for k in moved)
    with pytest.raises(ValueError, match="Generator"):
        step(state, pts, labels, None)


def test_finetune_step_is_its_input_pipeline_then_its_update():
    """The step's two halves, run one after the other from the same generator
    state, do what the step does: same loss, parameters and statistics."""
    pts = torch.from_numpy(_clouds(4, 1280, seed=8))
    labels = torch.tensor([0, 1, 2, 3])
    cfg = dict(SMALL, drop_path=0.2, cls_head_dropout=0.5)
    runs = []
    for halves in (False, True):
        model = PointMamba(PointMambaConfig(**cfg), generator=torch.Generator().manual_seed(2))
        opt, _ = optim.build_optimizer(model, steps_per_epoch=2)
        state, gen = TrainState.create(model, opt), torch.Generator().manual_seed(5)
        if halves:
            prepared = make_input_pipeline(1024, rotation=False)(pts, gen)
            state, metrics = finetune_update(state, prepared, labels, gen, bn_momentum=0.8)
        else:
            step = make_train_step(model, 1024, rotation=False)
            state, metrics = step(state, pts, labels, gen, bn_momentum=0.8)
        assert state.step == 1
        runs.append((metrics["loss"], model.state_dict()))
    (loss_a, sd_a), (loss_b, sd_b) = runs
    assert torch.equal(loss_a, loss_b)
    assert all(torch.equal(sd_a[k], sd_b[k]) for k in sd_a)
