"""Data parallelism of the port (a ``data`` mesh axis, alone and with a
tensor-parallel ``model`` axis) on the CPU, against the JAX package and
against the port's own one-process step.

The port runs on 2 ``gloo`` ranks (and on 4 for the (data 2, model 2) mesh),
spawned once per module with a file rendezvous under pytest's temporary
directory; the rank bodies import no JAX (spawned children re-import this
module, so JAX is imported inside the JAX-side helpers only). JAX runs the
same numpy inputs on the 8-device CPU mesh of ``tests/conftest.py``.

Rank r holds rows [r B/2, (r + 1) B/2) of the global batch. Tolerances: the
BatchNorm's outputs and statistics rtol/atol 2e-5, its input gradients 1e-5
of their largest; the train steps those of ``tests/test_torch_port_train.py``
(losses rtol 2e-4, grad norms 3e-3, parameters rtol 1e-4 / atol 2.5 x the
summed learning rate, BatchNorm statistics rtol 1e-3 / atol 1e-4); the
port's own data-parallel step against its one-process step: the draws
bitwise, losses rtol 2e-4.
"""

from __future__ import annotations

import types
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

SMALL = dict(trans_dim=64, encoder_dims=64, depth=2, cls_dim=4, num_group=8, group_size=16,
             method="MAMBA", knn_graph=4, drop_path=0.0, cls_head_dropout=0.0)
DROPS = dict(SMALL, drop_path=0.3, cls_head_dropout=0.5)
B, N_UPD, N_RAW, NPOINTS = 8, 128, 1100, 1024
LR, WD, CLIP, EPOCHS, WARMUP, STEPS = 1e-3, 0.05, 0.05, 4, 1, 3
BN_ROWS, BN_C = 12, 6
N_VAL, VAL_BS = 9, 3  # 5 a rank (one padded), batches of 3 and a ragged 2


def _clouds(b, n, seed):
    rng = np.random.default_rng(seed)
    pts = rng.standard_normal((b, n, 3)).astype(np.float32)
    return pts / np.abs(pts).max(axis=(1, 2), keepdims=True)


class _Clouds:
    """A dataset of seeded clouds and labels (the Loader's item protocol)."""

    def __init__(self, n, points, seed, classes=SMALL["cls_dim"]):
        self.pts = _clouds(n, points, seed)
        self.labels = np.random.default_rng(seed).integers(0, classes, n).astype(np.int32)

    def __len__(self):
        return len(self.labels)

    def __getitem__(self, i):
        return self.pts[i], self.labels[i]


class _SegSamples:
    """ShapeNetPart-like items (points, category, per-point parts)."""

    def __init__(self, n, points=32, seed=0):
        from si_mamba_tpu_torch.data.shapenetpart import SEG_CLASSES

        rng = np.random.default_rng(seed)
        cats = list(SEG_CLASSES)
        self.items = []
        for i in range(n):
            c = i % len(cats)
            parts = np.asarray(SEG_CLASSES[cats[c]])
            self.items.append((rng.standard_normal((points, 3)).astype(np.float32), c,
                               rng.choice(parts, points).astype(np.int32)))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def _fake_seg_step(state, pts, cls):
    """Log-probs that depend on the points only: a fixed function of them."""
    w = torch.linspace(-1.0, 1.0, 50 * 3).reshape(3, 50)
    return torch.log_softmax(torch.sin(pts @ w * 3.0), dim=-1)


def _fake_feature_step(state, pts):
    return torch.cat([pts.amax(dim=1), pts.mean(dim=1)], dim=-1)


def _write_modelnet(root: Path, n=6, points=80) -> Path:
    rng = np.random.default_rng(4)
    names = ["class00", "class01"]
    root.mkdir(parents=True)
    (root / "modelnet40_shape_names.txt").write_text("\n".join(names) + "\n")
    ids = []
    for k in range(n):
        name = names[k % 2]
        (root / name).mkdir(exist_ok=True)
        ids.append(f"{name}_train{k:04d}")
        np.savetxt(root / name / f"{ids[-1]}.txt", rng.standard_normal((points, 6)),
                   fmt="%.6f", delimiter=",")
    (root / "modelnet40_train.txt").write_text("\n".join(ids) + "\n")
    return root


def _port_model(cfg: dict, sd: dict | None = None):
    from si_mamba_tpu_torch.models import PointMamba, PointMambaConfig

    model = PointMamba(PointMambaConfig(**cfg))
    if sd is not None:
        model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    return model


def _optimizer(model, data_axis=None):
    from si_mamba_tpu_torch.train import optim

    return optim.build_optimizer(model, lr=LR, weight_decay=WD, epochs=EPOCHS,
                                 warmup_epochs=WARMUP, steps_per_epoch=1, grad_clip=CLIP,
                                 data_axis=data_axis)[0]


def _state_np(model) -> dict:
    return {k: v.detach().clone().numpy() for k, v in model.state_dict().items()}


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


def _update_steps(model, optimizer, pts, labels, dp):
    """STEPS updates on prepared points (no draws): losses, pre-clip norms."""
    from si_mamba_tpu_torch.train.runner_finetune import axis_mean, finetune_update
    from si_mamba_tpu_torch.train.train_state import TrainState

    state = TrainState.create(model, optimizer)
    losses, norms = [], []
    for _ in range(STEPS):
        state, m = finetune_update(state, pts, labels, None)
        losses.append(float(axis_mean(m, dp)["loss"]))
        norms.append(float(optimizer.last_grad_norm))
    return losses, norms


def _invariant_steps(model, optimizer, points, labels, dp):
    """STEPS steps of the shipped train step (FPS resample, scale and
    translate, drop_path 0.3, the head's dropout) at seed 0: the prepared
    points of each step, the generator's state after it, the losses."""
    from si_mamba_tpu_torch.train import runner_finetune as rf
    from si_mamba_tpu_torch.train.train_state import TrainState

    state = TrainState.create(model, optimizer)
    step = rf.make_train_step(model, NPOINTS, rotation=False, data_axis=dp)
    generator = torch.Generator().manual_seed(0)
    prepared, gen_states, losses = [], [], []
    real = rf.finetune_update

    def recording(state, pts, *a, **k):
        prepared.append(pts.clone())
        return real(state, pts, *a, **k)

    rf.finetune_update = recording
    try:
        for _ in range(STEPS):
            state, m = step(state, points, labels, generator)
            gen_states.append(generator.get_state().clone())
            losses.append(float(m["loss"]))
    finally:
        rf.finetune_update = real
    return prepared, gen_states, losses


def _dp_rank(rank, world, data, tmp):
    from si_mamba_tpu_torch.data.loader import Loader
    from si_mamba_tpu_torch.models.embed import ChannelLastBatchNorm
    from si_mamba_tpu_torch.parallel import make_mesh, set_data_axis
    from si_mamba_tpu_torch.train import cli, runner_finetune as rf
    from si_mamba_tpu_torch.train.config import ConfigDict, _to_config
    from si_mamba_tpu_torch.train.runner_pretrain import collect_features
    from si_mamba_tpu_torch.train.runner_seg import evaluate_miou

    mesh = make_mesh(("data",), (world,))
    dp = mesh["data"]
    out = {"mesh": (mesh.axis_names, mesh.shape, dp.index, dp.size)}
    b, nb = B // world, BN_ROWS // world
    rows, bn_rows = slice(rank * b, (rank + 1) * b), slice(rank * nb, (rank + 1) * nb)

    # BatchNorm over the global batch: outputs, statistics, input gradients
    bn = ChannelLastBatchNorm(BN_C)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(data["bn_scale"]))
        bn.bias.copy_(torch.from_numpy(data["bn_bias"]))
    set_data_axis(bn, dp)
    x = torch.from_numpy(data["bn_x"][bn_rows]).requires_grad_()
    y = bn.train()(x)
    torch.sum(y * torch.from_numpy(data["bn_w"][bn_rows])).backward()
    out["bn"] = dict(y=y.detach(), grad=x.grad, mean=bn.running_mean.clone(),
                     var=bn.running_var.clone())
    try:  # a BatchNorm given no axis over a world of 2 ranks raises in training
        ChannelLastBatchNorm(BN_C).train()(x.detach())
        out["unset_axis_raises"] = False
    except RuntimeError as e:
        out["unset_axis_raises"] = "no data axis" in str(e)

    # the update half on prepared points, against JAX's dp_train_jit step
    model = _port_model(SMALL, data["weights"])
    set_data_axis(model, dp)
    out["update"] = _update_steps(model, _optimizer(model, dp),
                                  torch.from_numpy(data["upd_pts"][rows]),
                                  torch.from_numpy(data["upd_labels"][rows]), dp)
    out["update_state"] = _state_np(model)

    # the shipped step with draws, against the port's one-process step
    model = _port_model(DROPS, data["weights"])
    set_data_axis(model, dp)
    prepared, gens, losses = _invariant_steps(
        model, _optimizer(model, dp), torch.from_numpy(data["raw_pts"][rows]),
        torch.from_numpy(data["raw_labels"][rows]), dp)
    out["invariant"] = dict(prepared=prepared, generator=gens, losses=losses,
                            state=_state_np(model))
    rf.check_replicas(model, mesh)
    with torch.no_grad():  # a replica that parts is named
        dict(model.named_parameters())["norm.weight"][0] += rank
    try:
        rf.check_replicas(model, mesh)
        out["parted_raises"] = False
    except RuntimeError as e:
        out["parted_raises"] = "norm.weight" in str(e)

    # validate / validate_vote over the ranks' loader shards, a ragged last batch
    model = _port_model(SMALL, data["weights"])
    set_data_axis(model, dp)  # the counts are summed over the model's data axis
    val = Loader(_Clouds(N_VAL, N_RAW, seed=5), VAL_BS, process_index=rank, process_count=world)
    state = rf.TrainState(step=0, model=model, optimizer=None)
    out["validate"] = rf.validate(rf.make_eval_step(model, NPOINTS), state, val)
    out["validate_vote"] = rf.validate_vote(
        rf.make_vote_step(model, NPOINTS, rotation=False, times=2), state, val)
    out["val_batches"] = [len(lab) for _, lab in val.epoch(0)]

    # the seg IoU sums and the pretraining features over the ranks
    seg = Loader(_SegSamples(6), 2, process_index=rank, process_count=world)
    out["miou"] = evaluate_miou(_fake_seg_step, state, seg, torch.device("cpu"), dp)
    feats = Loader(_Clouds(7, 20, seed=6), 2, process_index=rank, process_count=world)
    out["features"] = collect_features(_fake_feature_step, state, feats, torch.device("cpu"),
                                       dp)

    # the ModelNet cache: built once, by rank 0, and read by every rank
    from si_mamba_tpu_torch.data import datasets

    writes = []
    real = datasets._write_atomic
    datasets._write_atomic = lambda *a: writes.append(1) or real(*a)
    dcfg = _to_config(ConfigDict({"_base_": {"NAME": "ModelNet", "DATA_PATH": data["modelnet"],
                                             "N_POINTS": 64, "NUM_CATEGORY": 40},
                                  "others": {"subset": "train"}}))
    args = types.SimpleNamespace(seed=0, device="cpu", num_workers=0, shard=(rank, world))
    loader = cli.build_loader(dcfg, args, "train", 2, shuffle=False, drop_last=False)
    datasets._write_atomic = real
    cache = Path(data["modelnet"]) / "modelnet40_train_64pts_fps.dat"
    out["cache"] = dict(writes=len(writes), bytes=cache.read_bytes(),
                        points=np.stack(loader.dataset.points), shard=loader.process_index)

    out["run"] = _finetune(rank, data, tmp, tp=False)
    out["pretrain"] = _pretrain(rank, tmp)
    return out


def _run_config(tp: bool):
    from si_mamba_tpu_torch.train.config import ConfigDict, _to_config

    model = dict(SMALL, NAME="PointMamba")
    cfg = dict(optimizer={"type": "AdamW", "kwargs": {"lr": LR, "weight_decay": WD}},
               scheduler={"type": "CosLR", "kwargs": {"epochs": 2, "initial_epochs": 1}},
               model=model, npoints=NPOINTS, total_bs=4, max_epoch=0, grad_norm_clip=10)
    if tp:
        model["tp_axis"], cfg["tp_size"] = "model", 2
    return _to_config(ConfigDict(cfg))


def _finetune(rank, data, tmp, tp: bool) -> dict:
    """``finetune_run`` for one epoch of 2 steps (total_bs 4) on the ranks'
    loader shards, through ``make_run_mesh``: ('data',) of 2 ranks, or with
    ``tp`` ('data', 'model') of (2, 2) and the Mamba-1 tensor-parallel mixer.
    Each step's loss as the rank saw it; rank 0's checkpoint and scalars."""
    from si_mamba_tpu_torch.data.loader import Loader
    from si_mamba_tpu_torch.parallel.mesh import data_axis
    from si_mamba_tpu_torch.train import runner_finetune as rf

    cfg = _run_config(tp)
    mesh = rf.make_run_mesh(cfg)
    dp = data_axis(mesh)
    ds = _Clouds(8, N_RAW, seed=7)
    train = Loader(ds, 2, shuffle=True, drop_last=True, process_index=dp.index,
                   process_count=dp.size, prefetch=0)
    val = Loader(ds, 4, process_index=dp.index, process_count=dp.size, prefetch=0)
    losses = []
    real = rf.make_train_step

    def recording(*a, **k):
        step = real(*a, **k)

        def wrapped(*sa, **sk):
            state, m = step(*sa, **sk)
            losses.append(float(m["loss"]))
            return state, m

        return wrapped

    rf.make_train_step = recording
    exp = tmp / ("tp" if tp else "dp")
    try:
        state, best = rf.finetune_run(cfg, train, val, str(exp), device="cpu", seed=0,
                                      mesh=mesh)
    finally:
        rf.make_train_step = real
    # --resume of the finished run: every rank takes its shard of rank 0's file
    resumed, _ = rf.finetune_run(cfg, train, val, str(exp), resume=True, device="cpu", seed=0,
                                 mesh=mesh)
    before = state.model.state_dict() | _moments(state.optimizer)
    after = resumed.model.state_dict() | _moments(resumed.optimizer)
    out = {"mesh": (mesh.axis_names, mesh.shape), "losses": losses, "acc": best.acc,
           "resumed_equal": before.keys() == after.keys() and all(
               torch.equal(v, after[k]) for k, v in before.items())}
    if rank == 0:
        out["ckpt"] = torch.load(exp / "ckpt-last.pth", weights_only=True)
        out["scalars"] = (exp / "scalars.jsonl").read_text()
    return out


def _moments(optimizer) -> dict:
    state = optimizer.torch_optimizer.state_dict()["state"]
    return {f"{kind}.{i}": s[kind] for i, s in state.items() for kind in ("exp_avg", "exp_avg_sq")}


def _dp_tp_rank(rank, world, data, tmp):
    from si_mamba_tpu_torch.parallel import make_mesh

    mesh = make_mesh(("data", "model"), (2, 2))
    out = {"mesh": (mesh.shape, mesh["data"].index, mesh["model"].index)}
    out["run"] = _finetune(rank, data, tmp, tp=True)
    return out


def _pretrain_config():
    from si_mamba_tpu_torch.train.config import ConfigDict, _to_config

    return _to_config(ConfigDict(dict(
        optimizer={"type": "AdamW", "kwargs": {"lr": LR, "weight_decay": WD}},
        scheduler={"type": "CosLR", "kwargs": {"epochs": 2, "initial_epochs": 1}},
        model={"NAME": "Point_MAE_Mamba", "group_size": 16, "num_group": 16, "loss": "cdl2",
               "transformer_config": {"mask_ratio": 0.6, "mask_type": "rand", "trans_dim": 32,
                                      "encoder_dims": 32, "depth": 2, "drop_path_rate": 0.1,
                                      "decoder_depth": 1, "knn_graph": 4,
                                      "k_top_eigenvectors": 2, "reverse": True}},
        npoints=256, total_bs=4, max_epoch=1, grad_norm_clip=10)))


def _pretrain(rank, tmp) -> dict:
    """``pretrain_run`` over the ranks: epochs 0 and 1 of one step each at a
    global batch of 4, the probe after epoch 1 on every rank's features."""
    from si_mamba_tpu_torch.data.loader import Loader
    from si_mamba_tpu_torch.train import runner_pretrain as rp

    shard = dict(process_index=rank, process_count=2, prefetch=0)
    train = Loader(_Clouds(4, 256, seed=8), 2, shuffle=True, drop_last=True, **shard)
    probe = (Loader(_Clouds(10, 256, seed=9, classes=2), 4, **shard),
             Loader(_Clouds(6, 256, seed=10, classes=2), 4, **shard))
    losses, accs = [], []
    real_step, real_probe = rp.make_pretrain_step, rp.svm_probe

    def recording_step(*a, **k):
        step = real_step(*a, **k)

        def wrapped(*sa, **sk):
            state, m = step(*sa, **sk)
            losses.append(float(m["loss"]))
            return state, m

        return wrapped

    rp.make_pretrain_step = recording_step
    rp.svm_probe = lambda *a, **k: accs.append(real_probe(*a, **k)) or accs[-1]
    try:
        state, _ = rp.pretrain_run(_pretrain_config(), train, probe, str(tmp / "pre"),
                                   device="cpu", seed=0)
    finally:
        rp.make_pretrain_step, rp.svm_probe = real_step, real_probe
    return {"losses": losses, "accs": accs, "step": state.step}


# ---------------------------------------------------------------------------
# the module's rank groups
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The 2-rank group's and the 4-rank group's records, and the inputs."""
    tmp = tmp_path_factory.mktemp("dp")
    rng = np.random.default_rng(11)
    model = _port_model(SMALL)
    with torch.no_grad():  # statistics away from their initial values
        for name, buf in model.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(0.1 * torch.from_numpy(rng.standard_normal(buf.shape)))
    data = dict(
        weights=_state_np(model),
        bn_x=(2.0 * rng.standard_normal((BN_ROWS, BN_C)) + 0.5).astype(np.float32),
        bn_w=rng.standard_normal((BN_ROWS, BN_C)).astype(np.float32),
        bn_scale=(1.0 + 0.1 * rng.standard_normal(BN_C)).astype(np.float32),
        bn_bias=(0.1 * rng.standard_normal(BN_C)).astype(np.float32),
        upd_pts=_clouds(B, N_UPD, seed=3),
        upd_labels=rng.integers(0, SMALL["cls_dim"], B).astype(np.int64),
        raw_pts=_clouds(B, N_RAW, seed=12),
        raw_labels=rng.integers(0, SMALL["cls_dim"], B).astype(np.int64),
        modelnet=str(_write_modelnet(tmp / "modelnet")))
    (tmp / "two").mkdir()
    (tmp / "four").mkdir()
    two = _run_ranks(_dp_rank, 2, tmp / "two", data, tmp / "two")
    four = _run_ranks(_dp_tp_rank, 4, tmp / "four", data, tmp / "four")
    return data, two, four


# ---------------------------------------------------------------------------
# the tests (JAX imported here only)
# ---------------------------------------------------------------------------

def _lr_sum():
    from si_mamba_tpu_torch.train.optim import cosine_warmup_epoch_schedule

    return sum(cosine_warmup_epoch_schedule(LR, EPOCHS, WARMUP, 1)(i) for i in range(STEPS))


def _assert_state_close(got: dict, want: dict, lr_sum: float):
    """The tolerances of tests/test_torch_port_train.py:152-167."""
    for k, v in got.items():
        if "num_batches_tracked" in k:
            continue
        w = want[k].numpy() if isinstance(want[k], torch.Tensor) else want[k]
        if "running_" in k:
            np.testing.assert_allclose(v, w, rtol=1e-3, atol=1e-4, err_msg=k)
        else:
            np.testing.assert_allclose(v, w, rtol=1e-4, atol=2.5 * lr_sum, err_msg=k)


def _jax_state(data):
    import jax

    from si_mamba_tpu.models import PointMamba as JPointMamba
    from si_mamba_tpu.models import PointMambaConfig as JConfig
    from si_mamba_tpu.train import optim as joptim
    from si_mamba_tpu.train.train_state import TrainState as JTrainState
    from si_mamba_tpu.utils.torch_import import import_pointmamba

    params, stats, unexpected = import_pointmamba(data["weights"], depth=SMALL["depth"])
    assert unexpected == []
    params, stats = jax.tree.map(np.asarray, (params, stats))
    tx, _ = joptim.build_optimizer(params, lr=LR, weight_decay=WD, epochs=EPOCHS,
                                   warmup_epochs=WARMUP, steps_per_epoch=1, grad_clip=CLIP)
    return JPointMamba(JConfig(**SMALL)), JTrainState.create(params, stats, tx)


def test_data_meshes_build_on_two_and_four_ranks(ranks):
    """make_mesh(('data',), (2,)) and (('data', 'model'), (2, 2)) build,
    row-major; make_run_mesh gives ('data',) and ('data', 'model')."""
    _, two, four = ranks
    for rank, r in enumerate(two):
        assert r["mesh"] == (("data",), (2,), rank, 2)
        assert r["run"]["mesh"] == (("data",), (2,))
    for rank, r in enumerate(four):
        assert r["mesh"] == ((2, 2), rank // 2, rank % 2)
        assert r["run"]["mesh"] == (("data", "model"), (2, 2))


def test_global_batchnorm_matches_jax_on_the_concatenated_batch(ranks):
    """The BatchNorm over 2 ranks (rows 0-5 and 6-11) against JAX's
    TorchBatchNorm on all 12 rows: outputs, the running statistics (the
    unbiased variance of the global count) and the input gradients."""
    import jax
    import jax.numpy as jnp

    from si_mamba_tpu.models.embed import TorchBatchNorm

    data, two, _ = ranks
    bn = TorchBatchNorm(use_running_average=False, momentum=0.9)
    x, w = jnp.asarray(data["bn_x"]), jnp.asarray(data["bn_w"])
    stats = {"mean": jnp.zeros(BN_C), "var": jnp.ones(BN_C)}
    params = {"scale": jnp.asarray(data["bn_scale"]), "bias": jnp.asarray(data["bn_bias"])}

    def loss(x):
        y, upd = bn.apply({"params": params, "batch_stats": stats}, x,
                          mutable=["batch_stats"])
        return jnp.sum(y * w), (y, upd["batch_stats"])

    (_, (y, new)), dx = jax.value_and_grad(loss, has_aux=True)(x)
    y, dx = np.asarray(y), np.asarray(dx)
    nb = BN_ROWS // 2
    for rank, r in enumerate(two):
        rows = slice(rank * nb, (rank + 1) * nb)
        np.testing.assert_allclose(r["bn"]["y"].numpy(), y[rows], rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(r["bn"]["mean"].numpy(), np.asarray(new["mean"]),
                                   rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(r["bn"]["var"].numpy(), np.asarray(new["var"]),
                                   rtol=2e-5, atol=2e-5)
        assert np.abs(r["bn"]["grad"].numpy() - dx[rows]).max() < 1e-5 * np.abs(dx).max()
        assert r["unset_axis_raises"]


def test_dp_update_matches_jax_dp_train_jit(ranks):
    """Three updates on 2 ranks x 4 prepared clouds against JAX's step over a
    ('data',) mesh of 2 devices on the 8 clouds (dp_train_jit): losses,
    pre-clip gradient norms, then every parameter and BatchNorm statistic;
    the ranks' states bitwise equal."""
    import jax
    import jax.numpy as jnp
    import optax

    from si_mamba_tpu.models.point_mamba import cross_entropy_loss_acc as j_ce
    from si_mamba_tpu.parallel import dp_train_jit, make_mesh, replicate
    from si_mamba_tpu_torch.utils.weights import state_dict_from_jax

    data, two, _ = ranks
    jmodel, jstate = _jax_state(data)

    def step(state, points, labels, rng):  # JAX's classifier step, with the norm
        def loss_fn(params):
            logits, upd = jmodel.apply({"params": params, "batch_stats": state.batch_stats},
                                       points, train=True, mutable=["batch_stats"],
                                       rngs={"dropout": rng})
            per, acc = j_ce(logits, labels)
            return jnp.mean(per), upd["batch_stats"]

        (loss, bs), grads = jax.value_and_grad(loss_fn, has_aux=True)(state.params)
        return (state.apply_gradients(grads, new_batch_stats=bs),
                {"loss": loss, "norm": optax.global_norm(grads)})

    mesh = make_mesh(jax.devices()[:2], axis_names=("data",))
    jstate = replicate(jstate, mesh)
    train = dp_train_jit(step, mesh, n_batch=2, n_extra=1)
    pts, labels = jnp.asarray(data["upd_pts"]), jnp.asarray(data["upd_labels"], jnp.int32)
    losses, norms = [], []
    for _ in range(STEPS):
        jstate, m = train(jstate, pts, labels, jax.random.key(0))
        losses.append(float(m["loss"]))
        norms.append(float(m["norm"]))
    want = state_dict_from_jax(jax.tree.map(np.asarray, jstate.params),
                               jax.tree.map(np.asarray, jstate.batch_stats))
    for r in two:
        got_losses, got_norms = r["update"]
        np.testing.assert_allclose(got_losses, losses, rtol=2e-4)
        np.testing.assert_allclose(got_norms, norms, rtol=3e-3)
        _assert_state_close(r["update_state"], want, _lr_sum())
    for k, v in two[0]["update_state"].items():
        assert np.array_equal(v, two[1]["update_state"][k]), k


def test_dp_step_draws_what_the_one_process_step_draws(ranks):
    """The shipped step (FPS resample keys, scale and translate, drop_path
    0.3, the head's dropout 0.5) on 2 ranks against the port's one-process
    step on the 8 clouds at the same seed: each rank's prepared clouds are
    its rows of the one-process batch bitwise, the generators stay in step
    bitwise, the losses agree within rtol 2e-4 and the states within the
    train test's tolerances; the ranks' states bitwise equal."""
    data, two, _ = ranks
    model = _port_model(DROPS, data["weights"])
    prepared, gens, losses = _invariant_steps(model, _optimizer(model),
                                              torch.from_numpy(data["raw_pts"]),
                                              torch.from_numpy(data["raw_labels"]), None)
    b = B // 2
    for rank, r in enumerate(two):
        inv = r["invariant"]
        for s in range(STEPS):
            assert torch.equal(inv["prepared"][s], prepared[s][rank * b:(rank + 1) * b])
            assert torch.equal(inv["generator"][s], gens[s])
        np.testing.assert_allclose(inv["losses"], losses, rtol=2e-4)
        _assert_state_close(inv["state"], _state_np(model), _lr_sum())
    for k, v in two[0]["invariant"]["state"].items():
        assert np.array_equal(v, two[1]["invariant"]["state"][k]), k


def test_replica_check_names_a_parted_tensor(ranks):
    """The epoch-end check passes on the trained replicas and names the
    tensor once one rank's copy is changed."""
    _, two, _ = ranks
    assert all(r["parted_raises"] for r in two)


def test_validate_and_vote_over_ranks_with_a_ragged_batch(ranks):
    """validate over 2 ranks' loader shards (9 clouds: 5 a rank, one of them
    padded as DistributedSampler pads; batches of 3 and a ragged 2) equals
    JAX's validate over the same two shards, the counts summed; the vote's
    accuracy equals the port's one-process vote over each shard, summed."""
    import jax

    from si_mamba_tpu.data.loader import Loader as JLoader
    from si_mamba_tpu.train import runner_finetune as jrf
    from si_mamba_tpu_torch.data.loader import Loader
    from si_mamba_tpu_torch.train import runner_finetune as rf

    data, two, _ = ranks
    jmodel, jstate = _jax_state(data)
    eval_step = jax.jit(jrf.make_eval_step(jmodel, NPOINTS))
    ds = _Clouds(N_VAL, N_RAW, seed=5)
    shards = [JLoader(ds, VAL_BS, process_index=r, process_count=2) for r in range(2)]
    want = np.mean([jrf.validate(eval_step, jstate, s) for s in shards])
    model = _port_model(SMALL, data["weights"])
    state = rf.TrainState(step=0, model=model, optimizer=None)
    vote = rf.make_vote_step(model, NPOINTS, rotation=False, times=2)
    want_vote = np.mean([rf.validate_vote(vote, state, Loader(ds, VAL_BS, process_index=r,
                                                               process_count=2))
                         for r in range(2)])
    for r in two:
        assert r["val_batches"] == [3, 2]
        assert r["validate"] == pytest.approx(want, abs=1e-9)
        assert r["validate_vote"] == pytest.approx(want_vote, abs=1e-9)


def test_seg_iou_sums_and_probe_features_over_ranks(ranks):
    """evaluate_miou over 2 ranks' shards (6 samples, batches of 2 and a
    ragged 1) equals the one-process evaluation; the probe's features and
    labels are every rank's, concatenated in rank order."""
    from si_mamba_tpu_torch.data.loader import Loader
    from si_mamba_tpu_torch.train.runner_pretrain import collect_features
    from si_mamba_tpu_torch.train.runner_seg import evaluate_miou

    _, two, _ = ranks
    cpu = torch.device("cpu")
    want = evaluate_miou(_fake_seg_step, None, Loader(_SegSamples(6), 2), cpu)
    feats, labels = collect_features(_fake_feature_step, None, Loader(_Clouds(7, 20, seed=6), 2),
                                     cpu)
    order = [0, 2, 4, 6, 1, 3, 5, 0]  # each rank's shard of the padded index space
    for r in two:
        got = r["miou"]
        for k in ("accuracy", "instance_miou", "class_miou"):
            assert got[k] == pytest.approx(want[k], rel=1e-12), k
        assert got["per_category"] == pytest.approx(want["per_category"], rel=1e-12)
        assert torch.equal(r["features"][0], feats[order])
        assert torch.equal(r["features"][1], labels[order])


def test_modelnet_cache_built_once_and_read_by_both_ranks(ranks):
    """With no cache, rank 0 builds it (one write) while rank 1 waits, then
    both read the same bytes; each loader is its rank's shard."""
    _, two, _ = ranks
    assert [r["cache"]["writes"] for r in two] == [1, 0]
    assert two[0]["cache"]["bytes"] == two[1]["cache"]["bytes"]
    assert np.array_equal(two[0]["cache"]["points"], two[1]["cache"]["points"])
    assert [r["cache"]["shard"] for r in two] == [0, 1]


def test_dp_tp_finetune_matches_dp_only(ranks):
    """finetune_run with tp_size 2 on the (data 2, model 2) mesh against the
    same run over ('data',) of 2: the losses agree on every rank within rtol
    2e-4; rank 0's ckpt-last.pth is whole (the model axis gathered, the
    optimizer's moments too), loads strict into a one-process model and
    agrees with the data-only run's; --resume gives every rank back its
    parameters, statistics and moments bitwise."""
    _, two, four = ranks
    dp_losses = two[0]["run"]["losses"]
    assert len(dp_losses) == 2 and two[1]["run"]["losses"] == dp_losses
    for r in four:
        np.testing.assert_allclose(r["run"]["losses"], dp_losses, rtol=2e-4)
        assert r["run"]["losses"] == four[0]["run"]["losses"]
    tp, dp = four[0]["run"]["ckpt"], two[0]["run"]["ckpt"]
    _port_model(SMALL).load_state_dict(tp["base_model"], strict=True)
    from si_mamba_tpu_torch.train.optim import cosine_warmup_epoch_schedule

    lr_sum = sum(cosine_warmup_epoch_schedule(LR, 2, 1, 2)(i) for i in range(2))
    _assert_state_close({k: v.numpy() for k, v in tp["base_model"].items()},
                        dp["base_model"], lr_sum)
    for kind in ("exp_avg", "exp_avg_sq"):  # within 1e-3 of the largest moment
        want = {i: s[kind] for i, s in dp["optimizer"]["state"].items()}
        top = max(float(v.abs().max()) for v in want.values())
        for i, v in want.items():
            got = tp["optimizer"]["state"][i][kind]
            assert got.shape == v.shape and float((got - v).abs().max()) < 1e-3 * top, (kind, i)
    assert tp["step"] == dp["step"] == 2 and torch.equal(tp["rng"], dp["rng"])
    assert all(r["run"]["resumed_equal"] for r in two + four)


def test_pretrain_run_over_two_ranks(ranks):
    """pretrain_run over 2 ranks: both steps' losses and the probe's accuracy
    equal on both ranks (the probe solved on rank 0 from every rank's
    features)."""
    _, two, _ = ranks
    a, b = two[0]["pretrain"], two[1]["pretrain"]
    assert a["step"] == b["step"] == 2 and len(a["losses"]) == 2
    assert a["losses"] == b["losses"] and np.isfinite(a["losses"]).all()
    assert len(a["accs"]) == 1 and a["accs"] == b["accs"] and 0.0 <= a["accs"][0] <= 100.0


def test_backend_rule_and_rank_devices(monkeypatch):
    """nccl only when every rank of the host has a card of its own, gloo
    otherwise and on the CPU; a rank's card is LOCAL_RANK modulo the card
    count; without SI_MAMBA_MULTIHOST nothing is initialised."""
    from si_mamba_tpu_torch.parallel import mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    assert mesh.backend_for("cuda") == "nccl"
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    assert mesh.backend_for("cuda") == "gloo"
    assert mesh.backend_for("cpu") == "gloo"
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert mesh.rank_device("cuda") == torch.device("cuda", 1)
    assert mesh.rank_device("cpu") == torch.device("cpu")
    monkeypatch.delenv("SI_MAMBA_MULTIHOST", raising=False)
    assert not mesh.maybe_initialize_distributed(device="cpu")
