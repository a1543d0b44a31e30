"""The tensor- and sequence-parallel paths of the port against the JAX
package on the CPU.

The port runs on 2 (tensor parallelism) or 4 (sequence parallelism) ``gloo``
ranks, spawned processes with a file rendezvous under the test's temporary
directory; JAX runs the same numpy inputs on the 8-device CPU mesh of
``tests/conftest.py``. Each group of ranks is spawned once per module and
runs every case of its kind; the tests compare what the ranks saved. The
rank bodies import no JAX: JAX is imported inside the JAX-side helpers only.

Tolerances: values rtol/atol 2e-5 for the mixers and scans (the JAX package's
own TP and SP tests hold 2e-5 to 2e-4); logits atol 1e-3 max|logit|, rtol
2e-3; gradients within 1e-3 of the largest (sums over the ranks and over
chunks run in other orders than JAX's).
"""

from __future__ import annotations

import types
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from si_mamba_tpu_torch.models import PointMamba, PointMambaConfig
from si_mamba_tpu_torch.utils import weights

VAL_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_REL = 1e-3

SSD_MIX = dict(d_model=32, n_heads=4, d_state=16, chunk=32, b=2, l=100)  # l padded to 128
MAMBA_MIX = dict(d_model=32, d_state=16, d_conv=4, dt_rank=2, b=2, l=24)
STACK = dict(d_model=32, n_layer=2, b=2, l=16)
# two heads of 128 at trans_dim 128, one a rank; L = 2 * 4 * 16 = 128, two chunks of 64
TP_MODEL = dict(trans_dim=128, encoder_dims=128, depth=2, cls_dim=10, num_group=16,
                group_size=8, drop_path=0.0, cls_head_dropout=0.0, mixer="ssd", ssd_chunk=64,
                knn_graph=8, scan_impl="ssd_fused")
SP_SSD = dict(b=2, l=256, h=2, p=8, n=8, chunk=32)  # 64 a rank on 4 ranks: two chunks each
SP_SCAN = dict(b=2, l=32, d=8, n=4)


def _rng_arrays(seed, **shapes):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}


def _ssd_mixer_params(seed):
    c = SSD_MIX
    d_inner = 2 * c["d_model"]
    conv = d_inner + 2 * c["d_state"]
    a = _rng_arrays(seed, in_proj_w=(c["d_model"], 2 * d_inner + 2 * c["d_state"] + c["n_heads"]),
                    conv_w=(conv, 4), conv_b=(conv,), dt_bias=(c["n_heads"],),
                    A_log=(c["n_heads"],), D=(c["n_heads"],), norm_scale=(d_inner,),
                    out_proj_w=(d_inner, c["d_model"]), u=(c["b"], c["l"], c["d_model"]))
    a["in_proj_w"] *= 0.1
    a["conv_w"] *= 0.2
    a["conv_b"] *= 0.1
    a["norm_scale"] = 1.0 + 0.1 * a["norm_scale"]
    a["out_proj_w"] *= 0.1
    return a


def _mamba_mixer_params(seed):
    c = MAMBA_MIX
    d_inner = 2 * c["d_model"]
    a = _rng_arrays(seed, in_proj_w=(c["d_model"], 2 * d_inner), conv_w=(d_inner, c["d_conv"]),
                    conv_b=(d_inner,), x_proj_w=(d_inner, c["dt_rank"] + 2 * c["d_state"]),
                    dt_proj_w=(c["dt_rank"], d_inner), dt_proj_b=(d_inner,),
                    out_proj_w=(d_inner, c["d_model"]), x=(c["b"], c["l"], c["d_model"]))
    for k in a:
        a[k] *= 0.1
    a["x"] *= 100.0
    a["A_log"] = np.log(np.tile(np.arange(1, c["d_state"] + 1, dtype=np.float32), (d_inner, 1)))
    a["D"] = np.ones(d_inner, np.float32)
    return a


def _sp_ssd_inputs(seed):
    c = SP_SSD
    a = _rng_arrays(seed, x=(c["b"], c["l"], c["h"], c["p"]), dt=(c["b"], c["l"], c["h"]),
                    A=(c["h"],), Bm=(c["b"], c["l"], c["n"]), Cm=(c["b"], c["l"], c["n"]),
                    D=(c["h"],))
    a["dt"] = np.log1p(np.exp(a["dt"])).astype(np.float32)
    a["A"] = -np.exp(a["A"]).astype(np.float32)
    return a


def _sp_scan_inputs(seed):
    c = SP_SCAN
    a = _rng_arrays(seed, u=(c["b"], c["l"], c["d"]), delta=(c["b"], c["l"], c["d"]),
                    z=(c["b"], c["l"], c["d"]), A=(c["d"], c["n"]), B=(c["b"], c["l"], c["n"]),
                    C=(c["b"], c["l"], c["n"]), D=(c["d"],), dt_bias=(c["d"],))
    a["delta"] *= 0.5
    a["A"] = -np.exp(a["A"]).astype(np.float32)
    a["dt_bias"] *= 0.1
    return a


def _loss(y):
    """A loss whose gradient differs from element to element."""
    return torch.sum(torch.sin(y) * torch.cos(0.3 * y))


# ---------------------------------------------------------------------------
# the ranks (no JAX here)
# ---------------------------------------------------------------------------

def _rank_main(rank, fn, world, rdzv, out, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rdzv}", rank=rank, world_size=world)
    try:
        torch.save(fn(rank, world, *args), f"{out}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _run_ranks(fn, world: int, tmp: Path, *args) -> list[dict]:
    mp.start_processes(_rank_main, args=(fn, world, str(tmp / "rdzv"), str(tmp), args),
                       nprocs=world, start_method="spawn", join=True)
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(world)]


def _tp_rank(rank, world, data_path):
    from si_mamba_tpu_torch.data.transforms import fps_resample
    from si_mamba_tpu_torch.models import point_mamba as port_pm
    from si_mamba_tpu_torch.models.layers import MixerModel
    from si_mamba_tpu_torch.parallel import global_host_concat, global_host_sum, make_mesh
    from si_mamba_tpu_torch.parallel.tensor_parallel import (
        mamba_mixer_tp,
        shard_mixer_params,
        shard_ssd_mixer_params,
        ssd_mixer_tp,
    )
    from si_mamba_tpu_torch.train.optim import average_replicated_grads, build_optimizer
    from si_mamba_tpu_torch.train.runner_finetune import check_same_generator
    from si_mamba_tpu_torch.train.train_state import TrainState, make_classifier_train_step

    data = torch.load(data_path, weights_only=False)
    mesh = make_mesh(("model",), (world,))
    out = {}

    # the SSD mixer, both routes: value, gradients of u and of the local params
    a = data["ssd_mixer"]
    c = SSD_MIX
    for impl in ("ssd_fused", "xla"):
        full = {k: torch.from_numpy(v) for k, v in a.items() if k != "u"}
        p = {k: v.clone().requires_grad_() for k, v in shard_ssd_mixer_params(
            full, rank, world, n_heads=c["n_heads"], d_state=c["d_state"]).items()}
        u = torch.from_numpy(a["u"].copy()).requires_grad_()
        y = ssd_mixer_tp(p, u, mesh=mesh, n_heads=c["n_heads"], d_state=c["d_state"],
                         chunk=c["chunk"], impl=impl)
        _loss(y).backward()
        out[f"ssd_mixer_{impl}"] = dict(y=y.detach(), du=u.grad,
                                        grads={k: v.grad for k, v in p.items()})

    # the Mamba-1 mixer ('auto': the chunked scan on the CPU, as JAX's TP)
    a = data["mamba_mixer"]
    c = MAMBA_MIX
    full = {k: torch.from_numpy(v) for k, v in a.items() if k != "x"}
    p = {k: v.clone().requires_grad_() for k, v in shard_mixer_params(full, rank, world).items()}
    x = torch.from_numpy(a["x"].copy()).requires_grad_()
    y = mamba_mixer_tp(p, x, mesh=mesh, d_state=c["d_state"], dt_rank=c["dt_rank"])
    _loss(y).backward()
    out["mamba_mixer"] = dict(y=y.detach(), dx=x.grad, grads={k: v.grad for k, v in p.items()})

    # the Mamba-1 stack
    stack = MixerModel(STACK["d_model"], STACK["n_layer"], mesh=mesh, tp_axis="model")
    cfg = types.SimpleNamespace(mixer="mamba")
    stack.load_state_dict(weights.shard_state_dict(data["stack_sd"], cfg, rank, world))
    with torch.no_grad():
        out["stack"] = stack(torch.from_numpy(data["stack_x"]), torch.zeros(STACK["b"],
                                                                           STACK["l"],
                                                                           STACK["d_model"]))

    # the SSD PointMamba: eval logits, then one train step (loss, gradients,
    # the clip's global norm, BatchNorm statistics)
    jeig = torch.from_numpy(data["eigvecs"])
    real = port_pm.spectral_eigvecs

    def aligned(center, cfg):
        vals, vecs = real(center, cfg)
        s = torch.sign((vecs * jeig).sum(dim=1, keepdim=True))
        return vals, vecs * torch.where(s == 0, torch.ones_like(s), s)

    port_pm.spectral_eigvecs = aligned
    cfg = PointMambaConfig(**TP_MODEL, tp_axis="model")
    model = PointMamba(cfg, mesh=mesh)
    model.load_state_dict(weights.shard_state_dict(data["model_sd"], cfg, rank, world),
                          strict=True)
    pts = torch.from_numpy(data["pts"])
    with torch.no_grad():
        out["logits"] = model.eval()(pts)
    optimizer, _ = build_optimizer(model, lr=1e-3, weight_decay=0.05, epochs=4, warmup_epochs=0,
                                   steps_per_epoch=1, grad_clip=1e-3, tp=model.tp_sharding())
    state = TrainState.create(model, optimizer)
    grads = {}
    for name, prm in model.named_parameters():
        prm.register_hook(lambda g, name=name: grads.__setitem__(name, g.clone()))
    state, metrics = make_classifier_train_step(model)(state, pts,
                                                       torch.from_numpy(data["labels"]), None)
    port_pm.spectral_eigvecs = real
    out["train"] = dict(loss=float(metrics["loss"]), grads=grads,
                        grad_norm=float(optimizer.last_grad_norm),
                        stats={k: v.clone() for k, v in model.named_buffers() if "running" in k})

    # the helpers around the mesh
    dm = make_mesh(("data", "model"), (world, 1))
    out["data_axis"] = (dm.shape, dm["data"].index, dm["data"].size, dm["model"].size)
    shard, whole = torch.zeros(2, requires_grad=True), torch.zeros(3, requires_grad=True)
    shard.grad, whole.grad = torch.full((2,), rank + 1.0), torch.full((3,), rank + 1.0)
    average_replicated_grads([shard, whole], {id(shard): None}, mesh["model"])
    out["averaged"] = (shard.grad, whole.grad)
    out["host_sum"] = global_host_sum(np.array([rank + 1.0, 2.0]))
    out["host_concat"] = global_host_concat(np.full((rank + 1, 2), rank, np.float32))
    same = torch.Generator().manual_seed(3)
    fps_resample(torch.zeros(1, 64, 3), same, 8, point_all=16)
    check_same_generator(same, mesh["model"], torch.device("cpu"))
    try:
        check_same_generator(torch.Generator().manual_seed(rank), mesh["model"],
                             torch.device("cpu"))
        out["generator_mismatch_raises"] = False
    except RuntimeError:
        out["generator_mismatch_raises"] = True
    return out


def _sp_rank(rank, world, data_path):
    from si_mamba_tpu_torch.parallel import make_mesh
    from si_mamba_tpu_torch.parallel.seq_scan import selective_scan_seq_parallel, ssd_seq_parallel

    data = torch.load(data_path, weights_only=False)
    mesh = make_mesh(("seq",), (world,))
    out = {}
    a = data["ssd"]
    l_loc = SP_SSD["l"] // world
    part = slice(rank * l_loc, (rank + 1) * l_loc)
    for impl in ("ssd_fused", "xla"):
        t = {k: torch.from_numpy(v[:, part].copy() if v.ndim > 1 else v.copy()).requires_grad_()
             for k, v in a.items()}
        y = ssd_seq_parallel(t["x"], t["dt"], t["A"], t["Bm"], t["Cm"], t["D"], mesh=mesh,
                             chunk=SP_SSD["chunk"], impl=impl)
        _loss(y).backward()
        out[f"ssd_{impl}"] = dict(y=y.detach(), grads={k: v.grad for k, v in t.items()})

    a = data["scan"]
    l_loc = SP_SCAN["l"] // world
    part = slice(rank * l_loc, (rank + 1) * l_loc)
    t = {k: torch.from_numpy(v[:, part].copy() if k in ("u", "delta", "z", "B", "C")
                             else v.copy()).requires_grad_() for k, v in a.items()}
    y = selective_scan_seq_parallel(t["u"], t["delta"], t["A"], t["B"], t["C"], D=t["D"],
                                    z=t["z"], delta_bias=t["dt_bias"], mesh=mesh)
    _loss(y).backward()
    out["scan"] = dict(y=y.detach(), grads={k: v.grad for k, v in t.items()})
    return out


# ---------------------------------------------------------------------------
# the JAX side and the module fixtures
# ---------------------------------------------------------------------------

def _clouds(b, n, seed):
    rng = np.random.default_rng(seed)
    pts = rng.standard_normal((b, n, 3)).astype(np.float32)
    return pts / np.abs(pts).max(axis=(1, 2), keepdims=True)


def _jax_mesh(names, n):
    import jax

    from si_mamba_tpu.parallel import make_mesh as j_make_mesh

    return j_make_mesh(jax.devices()[:n], axis_names=names, shape=(1,) * (len(names) - 1) + (n,))


@pytest.fixture(scope="module")
def jax_model():
    import jax
    import jax.numpy as jnp

    from si_mamba_tpu.models import PointMamba as JPointMamba
    from si_mamba_tpu.models import PointMambaConfig as JConfig

    jcfg = JConfig(**TP_MODEL)
    jmodel = JPointMamba(jcfg)
    variables = jax.jit(lambda key: jmodel.init(key, jnp.zeros((2, 128, 3)), train=False))(
        jax.random.key(0))
    return jcfg, variables


@pytest.fixture(scope="module")
def stack_variables():
    import jax
    import jax.numpy as jnp

    from si_mamba_tpu.models.layers import MixerModel as JMixerModel

    x = np.random.default_rng(4).standard_normal((STACK["b"], STACK["l"], STACK["d_model"]))
    x = x.astype(np.float32)
    mm = JMixerModel(d_model=STACK["d_model"], n_layer=STACK["n_layer"], scan_impl="chunked")
    return x, mm.init(jax.random.key(1), jnp.asarray(x), jnp.zeros_like(jnp.asarray(x)))


def _stack_state_dict(variables):
    p = variables["params"]
    sd = {}
    for i in range(STACK["n_layer"]):
        weights._ln(sd, f"layers.{i}.norm", p[f"layers_{i}"]["norm"])
        weights._mixer(sd, f"layers.{i}.mixer", p[f"layers_{i}"]["mixer"])
    weights._ln(sd, "norm_f", p["norm_f"])
    return sd


@pytest.fixture(scope="module")
def tp_ranks(tmp_path_factory, jax_model, stack_variables):
    import jax
    import jax.numpy as jnp

    from si_mamba_tpu.models.grouping import group_divider as j_group_divider
    from si_mamba_tpu.models.point_mamba import spectral_eigvecs as j_spectral_eigvecs

    jcfg, variables = jax_model
    pts = _clouds(4, 128, seed=2)
    eig = jax.jit(lambda x: j_spectral_eigvecs(
        j_group_divider(x, jcfg.num_group, jcfg.group_size).center, jcfg)[1])(jnp.asarray(pts))
    stack_x, stack_vars = stack_variables
    data = dict(ssd_mixer=_ssd_mixer_params(1), mamba_mixer=_mamba_mixer_params(2),
                stack_x=stack_x, stack_sd=_stack_state_dict(stack_vars),
                model_sd=weights.state_dict_from_jax(variables["params"],
                                                     variables["batch_stats"]),
                pts=pts, labels=np.array([0, 3, 5, 9]), eigvecs=np.asarray(eig))
    tmp = tmp_path_factory.mktemp("tp")
    torch.save(data, tmp / "data.pt")
    return data, _run_ranks(_tp_rank, 2, tmp, str(tmp / "data.pt"))


@pytest.fixture(scope="module")
def sp_ranks(tmp_path_factory):
    data = dict(ssd=_sp_ssd_inputs(5), scan=_sp_scan_inputs(6))
    tmp = tmp_path_factory.mktemp("sp")
    torch.save(data, tmp / "data.pt")
    return data, _run_ranks(_sp_rank, 4, tmp, str(tmp / "data.pt"))


def _close_to_max(got, want, rel=GRAD_REL, name=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= rel * float(np.abs(want).max()), (name, err, float(np.abs(want).max()))


def _jax_loss(y):
    import jax.numpy as jnp

    return jnp.sum(jnp.sin(y) * jnp.cos(0.3 * y))


# ---------------------------------------------------------------------------
# tensor parallelism
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["ssd_fused", "xla"])
def test_ssd_mixer_tp_matches_jax(tp_ranks, impl):
    """``ssd_mixer_tp`` on 2 ranks (the fused route: the plain K6/K7 on the
    CPU) against JAX's ``ssd_mixer_tp`` on a 2-device model mesh (its fused
    route in interpret mode, as tests/test_ssd_pallas.py:132-163): the value,
    the gradient of the replicated input and the gathered parameter
    gradients, L = 100 padded to a multiple of 32."""
    import jax
    import jax.numpy as jnp

    from si_mamba_tpu.parallel.tensor_parallel import shard_ssd_mixer_params, ssd_mixer_tp

    data, ranks = tp_ranks
    a, c = data["ssd_mixer"], SSD_MIX
    mesh = _jax_mesh(("model",), 2)
    full = {k: jnp.asarray(v) for k, v in a.items() if k != "u"}
    kw = dict(mesh=mesh, n_heads=c["n_heads"], d_state=c["d_state"], chunk=c["chunk"],
              impl="ssd_fused", _interpret=True)

    def loss(p, u):
        return _jax_loss(ssd_mixer_tp(p, u, **kw))

    p = shard_ssd_mixer_params(full, mesh, n_heads=c["n_heads"], d_state=c["d_state"])
    y = jax.jit(lambda p, u: ssd_mixer_tp(p, u, **kw))(p, jnp.asarray(a["u"]))
    gp, gu = jax.jit(jax.grad(loss, argnums=(0, 1)))(p, jnp.asarray(a["u"]))
    got = [r[f"ssd_mixer_{impl}"] for r in ranks]
    for r in got:  # the output and the input gradient are replicated
        np.testing.assert_allclose(r["y"].numpy(), np.asarray(y), **VAL_TOL)
        _close_to_max(r["du"].numpy(), np.asarray(gu), name="du")
    gmax = max(float(np.abs(np.asarray(v)).max()) for v in gp.values())
    for k, want in gp.items():
        axis = 1 if k.startswith("in_proj") and k != "in_proj_bc" else 0
        if k in ("in_proj_bc", "conv_bc_w", "conv_bc_b"):  # replicated: whole on each rank
            for r in got:
                np.testing.assert_allclose(r["grads"][k].numpy(), np.asarray(want),
                                           atol=GRAD_REL * gmax, rtol=0, err_msg=k)
            continue
        gathered = np.concatenate([r["grads"][k].numpy() for r in got], axis=axis)
        np.testing.assert_allclose(gathered, np.asarray(want), atol=GRAD_REL * gmax, rtol=0,
                                   err_msg=k)


def test_mamba_mixer_tp_matches_jax(tp_ranks):
    """``mamba_mixer_tp`` on 2 ranks against JAX's on a 2-device model mesh
    (tests/test_harness.py:221-257): value, input gradient and the gathered
    parameter gradients."""
    import jax
    import jax.numpy as jnp

    from si_mamba_tpu.parallel.tensor_parallel import mamba_mixer_tp, shard_mixer_params

    data, ranks = tp_ranks
    a, c = data["mamba_mixer"], MAMBA_MIX
    mesh = _jax_mesh(("model",), 2)
    full = {k: jnp.asarray(v) for k, v in a.items() if k != "x"}
    kw = dict(mesh=mesh, d_state=c["d_state"], dt_rank=c["dt_rank"])
    p = shard_mixer_params(full, mesh)
    y = jax.jit(lambda p, x: mamba_mixer_tp(p, x, **kw))(p, jnp.asarray(a["x"]))
    gp, gx = jax.jit(jax.grad(lambda p, x: _jax_loss(mamba_mixer_tp(p, x, **kw)),
                              argnums=(0, 1)))(p, jnp.asarray(a["x"]))
    got = [r["mamba_mixer"] for r in ranks]
    for r in got:
        np.testing.assert_allclose(r["y"].numpy(), np.asarray(y), rtol=2e-4, atol=2e-5)
        _close_to_max(r["dx"].numpy(), np.asarray(gx), name="dx")
    gmax = max(float(np.abs(np.asarray(v)).max()) for v in gp.values())
    d_inner = 2 * c["d_model"]
    for k, want in gp.items():
        want = np.asarray(want)
        if k == "in_proj_w":  # (d, 2, d_inner) in JAX; [x | z] of the rank's channels here
            want = want.reshape(c["d_model"], 2 * d_inner)
            loc = [r["grads"][k].numpy() for r in got]
            half = d_inner // 2
            gathered = np.concatenate([x[:, :half] for x in loc] + [x[:, half:] for x in loc], 1)
        else:
            axis = 1 if k == "dt_proj_w" else 0
            gathered = np.concatenate([r["grads"][k].numpy() for r in got], axis=axis)
        np.testing.assert_allclose(gathered, want, atol=GRAD_REL * gmax, rtol=0, err_msg=k)


def test_tp_mixer_model_matches_jax(tp_ranks, stack_variables):
    """The port's ``MixerModel`` with a 2-rank model axis, loaded with
    ``shard_state_dict``, against JAX's ``MixerModel(tp_axis='model')`` under
    its context mesh (tests/test_harness.py:259-278)."""
    import jax
    import jax.numpy as jnp

    from si_mamba_tpu.models.layers import MixerModel as JMixerModel

    _, ranks = tp_ranks
    x, variables = stack_variables
    mm = JMixerModel(d_model=STACK["d_model"], n_layer=STACK["n_layer"], scan_impl="chunked",
                     tp_axis="model")
    xj = jnp.asarray(x)
    with jax.set_mesh(_jax_mesh(("model",), 2)):
        want = np.asarray(jax.jit(lambda v, x, p: mm.apply(v, x, p))(variables, xj,
                                                                      jnp.zeros_like(xj)))
    for r in ranks:
        np.testing.assert_allclose(r["stack"].numpy(), want, rtol=2e-4, atol=2e-5)


def test_tp_point_mamba_logits_match_jax(tp_ranks, jax_model):
    """The SSD classifier with its mixers over a 2-rank model axis (K6 on the
    card, its plain version here), its weights cut from JAX's by
    ``shard_state_dict``: the eval logits of both ranks against JAX's TP
    model on a ('data', 'model') mesh of 1 x 2, SAST with sign-aligned
    eigenvectors."""
    import jax
    import jax.numpy as jnp

    from si_mamba_tpu.models import PointMamba as JPointMamba

    data, ranks = tp_ranks
    jcfg, variables = jax_model
    jmodel = JPointMamba(jcfg.__class__(**{**TP_MODEL, "tp_axis": "model"}))
    with jax.set_mesh(_jax_mesh(("data", "model"), 2)):
        want = np.asarray(jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(
            variables, jnp.asarray(data["pts"])))
    scale = float(np.abs(want).max())
    for r in ranks:
        np.testing.assert_allclose(r["logits"].numpy(), want, atol=1e-3 * scale, rtol=2e-3)


def test_tp_point_mamba_train_step_matches_jax(tp_ranks, jax_model):
    """One train step (drop rates 0) of the 2-rank TP classifier through the
    K6/K7 route against JAX's value_and_grad on its DP x TP mesh (1 x 2,
    tests/test_harness.py:281-345): the loss on both ranks, the gradients
    gathered over the ranks within 1e-3 of the largest, the clip's global
    norm over the logical parameters against optax's, and the BatchNorm
    statistics."""
    import jax
    import jax.numpy as jnp
    import optax

    from si_mamba_tpu.models import PointMamba as JPointMamba
    from si_mamba_tpu.models.point_mamba import cross_entropy_loss_acc as j_ce

    data, ranks = tp_ranks
    jcfg, variables = jax_model
    jmodel = JPointMamba(jcfg.__class__(**{**TP_MODEL, "tp_axis": "model"}))

    def loss_fn(p, bs):
        logits, upd = jmodel.apply({"params": p, "batch_stats": bs}, jnp.asarray(data["pts"]),
                                   train=True, mutable=["batch_stats"],
                                   rngs={"dropout": jax.random.key(0)})
        return jnp.mean(j_ce(logits, jnp.asarray(data["labels"]))[0]), upd["batch_stats"]

    with jax.set_mesh(_jax_mesh(("data", "model"), 2)):
        (j_loss, bs), j_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            variables["params"], variables["batch_stats"])
    cfg = PointMambaConfig(**TP_MODEL, tp_axis="model")
    got = weights.gather_state_dict([r["train"]["grads"] for r in ranks], cfg)
    want = weights.state_dict_from_jax(j_grads, variables["batch_stats"])
    assert set(got) == {k for k in want if "running" not in k and "num_batches" not in k}
    gmax = max(float(want[k].abs().max()) for k in got)
    for k, g in got.items():
        diff = float((g - want[k]).abs().max())
        assert diff < GRAD_REL * gmax, (k, diff, gmax)
    for r in ranks:
        np.testing.assert_allclose(r["train"]["loss"], float(j_loss), rtol=2e-4)
        np.testing.assert_allclose(r["train"]["grad_norm"], float(optax.global_norm(j_grads)),
                                   rtol=1e-4)
    stats = weights.state_dict_from_jax(variables["params"], bs)
    for r in ranks:
        for k, v in r["train"]["stats"].items():
            np.testing.assert_allclose(v.numpy(), stats[k].numpy(), rtol=1e-4, atol=1e-5,
                                       err_msg=k)


def test_mesh_helpers_on_two_ranks(tp_ranks):
    """A data axis larger than 1 builds (each rank its index on it); the host
    sum and the ragged host concat; the train step's generator check passes
    for one seed and raises for two; the replicated parameters' gradients
    are averaged over the ranks, the sharded ones left alone."""
    _, ranks = tp_ranks
    for rank, r in enumerate(ranks):
        assert r["data_axis"] == ((len(ranks), 1), rank, len(ranks), 1)
        shard, whole = r["averaged"]
        assert torch.equal(shard, torch.full((2,), rank + 1.0))
        assert torch.equal(whole, torch.full((3,), 1.5))
        np.testing.assert_array_equal(r["host_sum"], [3.0, 4.0])
        np.testing.assert_array_equal(r["host_concat"], [[0, 0], [1, 1], [1, 1]])
        assert r["generator_mismatch_raises"]


def test_tp_needs_a_mesh_with_its_axis():
    """tp_axis without a mesh is refused; with add_after_layer it is not
    ported, as JAX refuses it; tensor-parallel shards round-trip."""
    with pytest.raises(ValueError, match="mesh"):
        PointMamba(PointMambaConfig(**TP_MODEL, tp_axis="model"))
    with pytest.raises(NotImplementedError, match="add_after_layer"):
        PointMamba(PointMambaConfig(**{**TP_MODEL, "mixer": "mamba", "scan_impl": "auto"},
                                    tp_axis="model", add_after_layer=True))


def test_mesh_helpers_without_a_group(monkeypatch):
    """Single-process: no bring-up without SI_MAMBA_MULTIHOST, the batch split
    and its divisibility check, a mesh needs the default group, the host
    reductions are the identity."""
    from si_mamba_tpu_torch import parallel

    monkeypatch.delenv("SI_MAMBA_MULTIHOST", raising=False)
    assert not parallel.maybe_initialize_distributed()
    assert parallel.per_process_batch(32, 2) == 16
    with pytest.raises(ValueError, match="divide evenly"):
        parallel.per_process_batch(32, 3)
    with pytest.raises(RuntimeError, match="init_process_group"):
        parallel.make_mesh(("model",))
    x = np.arange(6.0).reshape(3, 2)
    np.testing.assert_array_equal(parallel.global_host_sum(x), x)
    np.testing.assert_array_equal(parallel.global_host_concat(x), x)


@pytest.mark.parametrize("mixer", ["ssd", "mamba"])
def test_shard_and_gather_state_dict_round_trip(mixer):
    cfg = PointMambaConfig(**{**TP_MODEL, "mixer": mixer, "scan_impl": "auto"})
    full = PointMamba(cfg).state_dict()
    parts = [weights.shard_state_dict(full, cfg, r, 2) for r in range(2)]
    key = "blocks.layers.1.mixer.in_proj.weight"
    assert parts[0][key].shape[0] == {"ssd": (2 * 256 + 2 * 128 + 2) // 2 + 128,
                                      "mamba": 256}[mixer]
    back = weights.gather_state_dict(parts, cfg)
    assert set(back) == set(full)
    for k, v in full.items():
        assert torch.equal(back[k], v), k


# ---------------------------------------------------------------------------
# sequence parallelism
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["ssd_fused", "xla"])
def test_ssd_seq_parallel_matches_jax(sp_ranks, impl):
    """``ssd_seq_parallel`` on 4 ranks, two chunks a rank (the fused route: K6
    with h_fin and the seeded K7, plain here), against JAX's on a 4-device
    seq mesh (tests/test_ssd.py:161-217): y and the gradients of x, dt, A,
    B, C and D."""
    import jax
    import jax.numpy as jnp

    from si_mamba_tpu.parallel.seq_scan import ssd_seq_parallel

    data, ranks = sp_ranks
    a = {k: jnp.asarray(v) for k, v in data["ssd"].items()}
    mesh = _jax_mesh(("seq",), 4)
    names = ("x", "dt", "A", "Bm", "Cm", "D")

    def f(*args):
        return ssd_seq_parallel(*args, mesh=mesh, chunk=SP_SSD["chunk"])

    y = jax.jit(f)(*(a[k] for k in names))
    grads = jax.jit(jax.grad(lambda *args: _jax_loss(f(*args)), argnums=tuple(range(6))))(
        *(a[k] for k in names))
    got = [r[f"ssd_{impl}"] for r in ranks]
    np.testing.assert_allclose(np.concatenate([r["y"].numpy() for r in got], axis=1),
                               np.asarray(y), **VAL_TOL)
    for k, want in zip(names, grads):
        if k in ("A", "D"):  # replicated: summed over the ranks, whole on each
            for r in got:
                _close_to_max(r["grads"][k].numpy(), want, name=k)
        else:
            _close_to_max(np.concatenate([r["grads"][k].numpy() for r in got], axis=1), want,
                          name=k)


def test_selective_scan_seq_parallel_matches_jax(sp_ranks):
    """``selective_scan_seq_parallel`` on 4 ranks against JAX's on a 4-device
    seq mesh (tests/test_harness.py:166-219): y and the gradients of every
    input, the replicated A, D and dt bias summed over the ranks."""
    import jax
    import jax.numpy as jnp

    from si_mamba_tpu.parallel.seq_scan import selective_scan_seq_parallel

    data, ranks = sp_ranks
    a = {k: jnp.asarray(v) for k, v in data["scan"].items()}
    mesh = _jax_mesh(("seq",), 4)
    names = ("u", "delta", "A", "B", "C", "D", "z", "dt_bias")

    def f(u, delta, A, B, C, D, z, db):
        return selective_scan_seq_parallel(u, delta, A, B, C, D=D, z=z, delta_bias=db, mesh=mesh)

    y = jax.jit(f)(*(a[k] for k in names))
    grads = jax.jit(jax.grad(lambda *args: _jax_loss(f(*args)), argnums=tuple(range(8))))(
        *(a[k] for k in names))
    got = [r["scan"] for r in ranks]
    np.testing.assert_allclose(np.concatenate([r["y"].numpy() for r in got], axis=1),
                               np.asarray(y), rtol=1e-4, atol=1e-5)
    for k, want in zip(names, grads):
        if k in ("A", "D", "dt_bias"):
            for r in got:
                _close_to_max(r["grads"][k].numpy(), want, name=k)
        else:
            _close_to_max(np.concatenate([r["grads"][k].numpy() for r in got], axis=1), want,
                          name=k)
