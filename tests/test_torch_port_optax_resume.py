"""Resuming a JAX run in the port with Adam's moments (M11b): optax's
``ScaleByAdamState`` mapped by ``utils/weights.adamw_state_from_jax`` and
written by ``scripts/torch_export_optax_state.py`` from an orbax checkpoint.

A small classifier (the xyz ordering, drops 0) takes two AdamW steps in JAX
(``build_optimizer`` with its clip, cosine schedule and weight-decay mask);
the port resumes from that state and takes step 3. Given JAX's step-3
gradient, its parameters equal JAX's step 3 within rtol 1e-4, atol 1e-6,
where a fresh optimizer (the moments restarted, as a weights-only export
leaves them) does not; with its own forward and backward, its loss equals
JAX's within 2e-4 and each leaf's update JAX's within 1e-2 in L2 norm (1.7e-3
measured; restarted moments miss by more than 1e-1), the biases whose effect
a BatchNorm removes, their gradients rounding noise, elementwise within 2
lr."""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from si_mamba_tpu.models import PointMamba as JPointMamba
from si_mamba_tpu.models import PointMambaConfig as JConfig
from si_mamba_tpu.models.point_mamba import cross_entropy_loss_acc as j_ce
from si_mamba_tpu.train import checkpoint as jckpt
from si_mamba_tpu.train import optim as joptim
from si_mamba_tpu.train.train_state import TrainState as JTrainState
from si_mamba_tpu_torch.models import PointMamba, PointMambaConfig
from si_mamba_tpu_torch.train import checkpoint as pckpt
from si_mamba_tpu_torch.train import optim
from si_mamba_tpu_torch.train.train_state import TrainState, make_classifier_train_step
from si_mamba_tpu_torch.utils.weights import adamw_state_from_jax, state_dict_from_jax

ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(trans_dim=32, encoder_dims=32, depth=2, cls_dim=4, num_group=16, group_size=8,
             knn_graph=4, drop_path=0.0, cls_head_dropout=0.0, method="MAMBA")
OPT = dict(lr=1e-3, weight_decay=0.05, epochs=4, warmup_epochs=0, steps_per_epoch=1,
           grad_clip=10.0)


# The biases whose every effect a BatchNorm removes (a per-channel shift in
# front of it: the first conv pair's second bias reaches bn2 through both halves
# of the concat, the final norm's bias the head's bn1 through the pooled
# feature): their gradients are rounding noise in both frameworks, so Adam's
# step on them is noise too (elementwise within 2 lr).
BN_FED_BIASES = ("encoder.first_conv.0.bias", "encoder.first_conv.3.bias",
                 "encoder.second_conv.0.bias", "norm.bias", "cls_head_finetune.0.bias",
                 "cls_head_finetune.4.bias")


def _batch(step):
    rng = np.random.default_rng(40 + step)
    pts = rng.standard_normal((8, 128, 3)).astype(np.float32)
    return pts / np.abs(pts).max(axis=(1, 2), keepdims=True), rng.integers(0, 4, 8)


def _script():
    spec = importlib.util.spec_from_file_location(
        "torch_export_optax_state", ROOT / "scripts" / "torch_export_optax_state.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """Three JAX steps; the state after two saved as the orbax ``ckpt-last``
    of an experiment directory with its config, as the JAX CLI leaves it."""
    jmodel = JPointMamba(JConfig(**SMALL))
    variables = jax.jit(lambda k: jmodel.init(k, jnp.zeros((2, 128, 3)), train=False))(
        jax.random.key(0))
    tx, _ = joptim.build_optimizer(variables["params"], **OPT)
    state = JTrainState.create(variables["params"], variables["batch_stats"], tx)

    def loss_fn(p, bs, pts, lab):
        logits, upd = jmodel.apply({"params": p, "batch_stats": bs}, pts, train=True,
                                   mutable=["batch_stats"], rngs={"dropout": jax.random.key(0)})
        return jnp.mean(j_ce(logits, lab)[0]), upd["batch_stats"]

    @jax.jit
    def train_step(state, pts, lab):
        (loss, bs), g = jax.value_and_grad(loss_fn, has_aux=True)(state.params,
                                                                  state.batch_stats, pts, lab)
        return state.apply_gradients(g, new_batch_stats=bs), loss, g

    states, grads, losses = [state], [], []
    for step in range(3):
        pts, lab = _batch(step)
        state, loss, g = train_step(state, jnp.asarray(pts), jnp.asarray(lab, jnp.int32))
        states.append(state)
        grads.append(g)
        losses.append(float(loss))
    exp = tmp_path_factory.mktemp("jax_exp")
    jckpt.save_checkpoint(str(exp), "ckpt-last", states[2], 1, {"acc": 25.0}, {"acc": 50.0})
    (exp / "config.yaml").write_text(
        "model: {NAME: PointMamba, " + ", ".join(f"{k}: {v}" for k, v in SMALL.items()) + "}\n")
    return dict(states=states, grads=grads, losses=losses, exp=exp)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _adam(state):
    (adam,) = [s for s in jax.tree_util.tree_leaves(
        state.opt_state, is_leaf=lambda s: type(s).__name__ == "ScaleByAdamState")
        if type(s).__name__ == "ScaleByAdamState"]
    return adam


def _port_at(state):
    """The port's model and optimizer at a JAX state's weights and statistics
    (the optimizer fresh)."""
    model = PointMamba(PointMambaConfig(**SMALL, scan_impl="pallas"))
    model.load_state_dict(state_dict_from_jax(_np_tree(state.params),
                                              _np_tree(state.batch_stats)), strict=True)
    optimizer, _ = optim.build_optimizer(model, **OPT)
    return model, optimizer


def _step_with_jax_grads(model, optimizer, grads):
    g = state_dict_from_jax(_np_tree(grads), None)
    for name, p in model.named_parameters():
        p.grad = g[name].reshape(p.shape).clone()
    optimizer.step()


def _worst(model, state):
    """max over the parameters of |port - JAX| / (atol 1e-6 + rtol 1e-4 |JAX|)."""
    want = state_dict_from_jax(_np_tree(state.params), None)
    worst = 0.0
    for name, p in model.named_parameters():
        w = want[name].reshape(p.shape)
        worst = max(worst, float(((p.detach() - w).abs() / (1e-6 + 1e-4 * w.abs())).max()))
    return worst


def test_adamw_state_from_jax_maps_moments_and_count(jax_run):
    state2 = jax_run["states"][2]
    adam = _adam(state2)
    model, optimizer = _port_at(state2)
    payload = adamw_state_from_jax(_np_tree(adam.mu), _np_tree(adam.nu), int(adam.count), model)
    assert payload["count"] == 2 and payload["micro"] == 0 and "param_groups" not in payload
    pckpt._load_optimizer(optimizer, payload)
    mu = state_dict_from_jax(_np_tree(adam.mu), None)
    names = {id(p): n for n, p in model.named_parameters()}
    assert len(optimizer.torch_optimizer.state) == len(names)
    for p, st in optimizer.torch_optimizer.state.items():
        assert float(st["step"]) == 2.0
        assert torch.equal(st["exp_avg"], mu[names[id(p)]].reshape(p.shape))
    assert optimizer.count == 2
    # the optimizer keeps its own hyperparameters: lr, betas, the decay groups
    wd = {g["weight_decay"] for g in optimizer.torch_optimizer.param_groups}
    assert wd == {0.0, OPT["weight_decay"]}


def test_resumed_step_3_matches_jax_given_its_gradient(jax_run):
    """Step 3 from the resumed moments with JAX's step-3 gradient lands on
    JAX's step-3 parameters; restarted moments miss them."""
    state2, state3, g3 = jax_run["states"][2], jax_run["states"][3], jax_run["grads"][2]
    adam = _adam(state2)
    model, optimizer = _port_at(state2)
    pckpt._load_optimizer(optimizer, adamw_state_from_jax(
        _np_tree(adam.mu), _np_tree(adam.nu), int(adam.count), model))
    _step_with_jax_grads(model, optimizer, g3)
    assert optimizer.count == 3
    assert _worst(model, state3) <= 1.0
    fresh, fresh_opt = _port_at(state2)
    fresh_opt.count = 2  # the schedule's place kept, the moments restarted
    _step_with_jax_grads(fresh, fresh_opt, g3)
    assert _worst(fresh, state3) > 1.0


def test_export_script_then_resume_and_step_in_the_port(jax_run, tmp_path):
    """The orbax checkpoint through the script to a ``.pth``, read by the
    port's ``resume_state``: the count, step and epoch carried; step 3 with
    the port's own forward and backward gives JAX's loss (rtol 2e-4) and each
    leaf's update within 1e-2 of JAX's in L2 norm (the step's gradient is the
    port's, so Adam's per-element steps part where a gradient is near its
    rounding); from restarted moments the same step misses by more than 1e-1."""
    state2, state3 = jax_run["states"][2], jax_run["states"][3]
    port_exp = tmp_path / "port_exp"
    port_exp.mkdir()
    out = _script().export(str(jax_run["exp"]), "ckpt-last", out=str(port_exp / "ckpt-last.pth"))
    model = PointMamba(PointMambaConfig(**SMALL, scan_impl="pallas"))
    optimizer, _ = optim.build_optimizer(model, **OPT)
    pstate, start_epoch, best = pckpt.resume_state(str(port_exp), TrainState.create(model,
                                                                                   optimizer))
    assert Path(out).exists() and start_epoch == 2 and best == {"acc": 50.0}
    assert pstate.step == 2 and optimizer.count == 2
    pts, lab = _batch(2)
    pstate, metrics = make_classifier_train_step(model)(pstate, torch.from_numpy(pts),
                                                        torch.from_numpy(lab), None)
    np.testing.assert_allclose(float(metrics["loss"]), jax_run["losses"][2], rtol=2e-4)
    assert _update_errors(model, state2, state3) <= 1e-2
    # the control: the same step from restarted moments misses JAX's
    fresh, fresh_opt = _port_at(state2)
    fresh_opt.count = 2
    make_classifier_train_step(fresh)(TrainState(step=2, model=fresh, optimizer=fresh_opt),
                                      torch.from_numpy(pts), torch.from_numpy(lab), None)
    assert _update_errors(fresh, state2, state3) > 1e-1


def _update_errors(model, state2, state3) -> float:
    """The largest, over the leaves, of |port update - JAX update| / |JAX
    update| in L2 norm; ``BN_FED_BIASES`` are held elementwise within 2 lr."""
    want3 = state_dict_from_jax(_np_tree(state3.params), None)
    want2 = state_dict_from_jax(_np_tree(state2.params), None)
    worst = 0.0
    for name, p in model.named_parameters():
        diff = p.detach() - want3[name].reshape(p.shape)
        if name in BN_FED_BIASES:
            assert float(diff.abs().max()) <= 2 * OPT["lr"], name
            continue
        step = (want3[name] - want2[name]).reshape(p.shape)
        worst = max(worst, float(diff.norm() / step.norm()))
    return worst
