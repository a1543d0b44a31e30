"""The pipeline-parallel mixer stack of the port (``parallel/pipeline.py``)
on 2 and 4 ``gloo`` ranks of a ``pipe`` axis, against the JAX package's
``pipeline_mixer_apply`` on the 8-device CPU mesh of ``tests/conftest.py``
and against its ``PointMamba`` (the counterparts of ``tests/test_pipeline.py``).

Each group of ranks is spawned once per module with a file rendezvous; the
rank bodies import no JAX (spawned children re-import this module).
Tolerances are those of ``tests/test_pipeline.py``: values rtol/atol 2e-5,
the input's gradient 1e-4, each parameter's gradient within 1e-5 + 1e-3 of
its largest; logits atol 1e-3 max|logit|, rtol 2e-3.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

D_MODEL, N_LAYER, B, L = 32, 4, 8, 16
MICRO = {2: 2, 4: 4}  # n_micro by stage count: 2 and 4 microbatches of the 8 rows
CLS = dict(trans_dim=32, encoder_dims=32, depth=4, cls_dim=4, num_group=16, group_size=8,
           knn_graph=4, method="MAMBA", drop_path=0.0)
CLOUDS, CLS_MICRO = 4, 2


def _stack_state(seed=0) -> dict:
    """A seeded port ``MixerModel``'s state dict, as numpy."""
    from si_mamba_tpu_torch.models.layers import MixerModel

    model = MixerModel(D_MODEL, N_LAYER)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}


def _rank_main(rank, fn, world, rdzv, out, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rdzv}", rank=rank, world_size=world)
    try:
        torch.save(fn(rank, world, *args), f"{out}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _run_ranks(fn, world: int, tmp: Path, *args) -> list[dict]:
    tmp.mkdir()
    mp.start_processes(_rank_main, args=(fn, world, str(tmp / "rdzv"), str(tmp), args),
                       nprocs=world, start_method="spawn", join=True)
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(world)]


def _pipe_rank(rank, world, data):
    """The stack forward and one backward of sum(y^2); both classifiers'
    logits; every rank's stage from its own slice of the whole state dict."""
    from si_mamba_tpu_torch.models import PointMamba, PointMambaConfig
    from si_mamba_tpu_torch.parallel import make_mesh
    from si_mamba_tpu_torch.parallel.pipeline import (
        pipeline_mixer_apply,
        pipeline_pointmamba_logits,
        stack_mixer_params,
        take_stage,
    )
    from si_mamba_tpu_torch.utils.weights import stage_state_dict

    mesh = make_mesh(("pipe",), (world,))
    sd = {k: torch.from_numpy(v) for k, v in data["stack"].items()}
    stacked, norm_f = stack_mixer_params(sd, N_LAYER, world)
    stage = take_stage(stacked, rank)
    whole = {f"blocks.{k}": v for k, v in sd.items()}
    mine, _ = stack_mixer_params(stage_state_dict(whole, rank, world, N_LAYER),
                                 N_LAYER // world, 1)
    out = {"stage_state_dict": all(torch.equal(a, b) for a, b in zip(
        _leaves(take_stage(mine, 0)), _leaves(stage)))}
    for leaf in _leaves(stage) + list(norm_f.values()):
        leaf.requires_grad_(True)
    x = torch.from_numpy(data["x"] + data["pos"]).requires_grad_(True)
    y = pipeline_mixer_apply(stage, norm_f, x, mesh=mesh, n_micro=MICRO[world],
                             scan_impl="chunked")
    torch.sum(y ** 2).backward()
    out["stack"] = dict(y=y.detach(), dx=x.grad,
                        grads={k: v.grad for k, v in stage["mixer"].items()},
                        norm_grads=(stage["norm_scale"].grad, stage["norm_bias"].grad))
    out["logits"] = {}
    for mixer, sd_cls in data["classifiers"].items():
        model = PointMamba(PointMambaConfig(**{**CLS, "mixer": mixer}))
        model.load_state_dict({k: torch.from_numpy(v) for k, v in sd_cls.items()}, strict=True)
        with torch.no_grad():
            out["logits"][mixer] = pipeline_pointmamba_logits(
                model, torch.from_numpy(data["clouds"]), mesh=mesh, n_micro=CLS_MICRO)
    return out


def _leaves(stage):
    return [stage["norm_scale"], stage["norm_bias"], *stage["mixer"].values()]


@pytest.fixture(scope="module")
def pipe_ranks(tmp_path_factory):
    import jax

    from si_mamba_tpu.models import PointMamba as JPointMamba
    from si_mamba_tpu.models import PointMambaConfig as JConfig
    from si_mamba_tpu_torch.models import PointMamba, PointMambaConfig
    from si_mamba_tpu_torch.utils.weights import state_dict_from_jax

    tmp = tmp_path_factory.mktemp("pipe")
    rng = np.random.default_rng(0)
    clouds = rng.standard_normal((CLOUDS, 64, 3)).astype(np.float32)
    mamba = PointMamba(PointMambaConfig(**CLS))
    jssd = JPointMamba(JConfig(**{**CLS, "mixer": "ssd"}))
    jvars = jssd.init(jax.random.key(0), clouds[:2], train=False)
    classifiers = {
        "mamba": {k: v.numpy() for k, v in mamba.state_dict().items()},
        "ssd": {k: v.numpy() for k, v in state_dict_from_jax(jvars["params"],
                                                              jvars["batch_stats"]).items()}}
    data = dict(stack=_stack_state(), x=rng.standard_normal((B, L, D_MODEL)).astype(np.float32),
                pos=rng.standard_normal((B, L, D_MODEL)).astype(np.float32), clouds=clouds,
                classifiers=classifiers)
    groups = {n: _run_ranks(_pipe_rank, n, tmp / f"p{n}", data) for n in (2, 4)}
    return data, groups, jvars


def _jax_stack(sd: dict) -> dict:
    """The port stack's state dict -> the JAX MixerModel's params."""
    from si_mamba_tpu.utils.torch_import import _mixer_stack

    return _mixer_stack({f"blocks.{k}": v for k, v in sd.items()}, "blocks", N_LAYER)


JAX_NAMES = {"in_proj_w": "in_proj", "conv_w": "conv1d_weight", "conv_b": "conv1d_bias",
             "x_proj_w": "x_proj", "dt_proj_w": "dt_proj", "dt_proj_b": "dt_proj_bias",
             "A_log": "A_log", "D": "D", "out_proj_w": "out_proj"}


@pytest.mark.parametrize("n_stages", [2, 4])
def test_pipeline_stack_forward_and_gradient_match_jax(pipe_ranks, n_stages):
    """pipeline_mixer_apply over 2 stages x 2 blocks (2 microbatches) and 4
    stages x 1 block (4 microbatches) against JAX's on a ('pipe',) mesh of as
    many devices: the output on every rank, the input's gradient (summed
    over the ranks) and each stage's block gradients; each rank's stage taken
    from the whole state dict by ``stage_state_dict`` equals its slice of the
    stack."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from si_mamba_tpu.parallel.pipeline import pipeline_mixer_apply, stack_mixer_params

    data, groups, _ = pipe_ranks
    ranks = groups[n_stages]
    params = jax.tree.map(jnp.asarray, _jax_stack(data["stack"]))
    mesh = Mesh(np.array(jax.devices()[:n_stages]), ("pipe",))

    def f(p, x):
        stacked, norm_f = stack_mixer_params(p, N_LAYER, n_stages)
        y = pipeline_mixer_apply(stacked, norm_f, x, mesh=mesh, n_micro=MICRO[n_stages],
                                 scan_impl="chunked")
        return jnp.sum(y ** 2), y

    (_, y), (gp, gx) = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(
        params, jnp.asarray(data["x"] + data["pos"]))
    y, gx = np.asarray(y), np.asarray(gx)
    per = N_LAYER // n_stages
    for rank, r in enumerate(ranks):
        assert r["stage_state_dict"]
        np.testing.assert_allclose(r["stack"]["y"].numpy(), y, rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(r["stack"]["dx"].numpy(), gx, rtol=1e-4, atol=1e-4)
        for j in range(per):
            layer = gp[f"layers_{rank * per + j}"]
            pairs = [(r["stack"]["norm_grads"][0][j], layer["norm"]["scale"]),
                     (r["stack"]["norm_grads"][1][j], layer["norm"]["bias"])]
            pairs += [(g[j], layer["mixer"][JAX_NAMES[k]]) for k, g in r["stack"]["grads"].items()]
            for got, want in pairs:
                want = np.asarray(want)
                err = np.abs(got.numpy() - want).max()
                assert err < 1e-5 + 1e-3 * np.abs(want).max(), (rank, j, err)


@pytest.mark.parametrize("mixer", ["mamba", "ssd"])
def test_pipelined_classifier_logits_match_jax(pipe_ranks, mixer):
    """pipeline_pointmamba_logits (grouping, ordering, the pipelined blocks,
    norm, pool, head) over 2 and 4 stages, 2 microbatches, against JAX's
    PointMamba eval forward on the same weights, for the Mamba-1 and the SSD
    mixer."""
    import jax

    from si_mamba_tpu.models import PointMamba as JPointMamba
    from si_mamba_tpu.models import PointMambaConfig as JConfig
    from si_mamba_tpu.utils.torch_import import import_pointmamba

    data, groups, jvars = pipe_ranks
    if mixer == "mamba":
        params, stats, _ = import_pointmamba(data["classifiers"]["mamba"], depth=CLS["depth"])
        jvars = {"params": params, "batch_stats": stats}
    jmodel = JPointMamba(JConfig(**{**CLS, "mixer": mixer}))
    want = np.asarray(jax.jit(lambda v, p: jmodel.apply(v, p, train=False))(
        jvars, data["clouds"]))
    scale = np.abs(want).max()
    for ranks in groups.values():
        for r in ranks:
            np.testing.assert_allclose(r["logits"][mixer].numpy(), want, rtol=2e-3,
                                       atol=1e-3 * scale)


def test_pipeline_depth_the_stages_do_not_divide_raises():
    """Six blocks over four stages raise, in the stack and in the stage's
    weights helper, as JAX's stack_mixer_params does."""
    from si_mamba_tpu_torch.models.layers import MixerModel
    from si_mamba_tpu_torch.parallel.pipeline import stack_mixer_params
    from si_mamba_tpu_torch.utils.weights import stage_state_dict

    sd = MixerModel(8, 6).state_dict()
    with pytest.raises(ValueError, match="divide the stack depth"):
        stack_mixer_params(sd, 6, 4)
    with pytest.raises(ValueError, match="divide the stack depth"):
        stage_state_dict({f"blocks.{k}": v for k, v in sd.items()}, 0, 4, 6)
