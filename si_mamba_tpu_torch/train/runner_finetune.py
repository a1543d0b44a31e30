"""The classification finetune and test runner, the counterpart of
``si_mamba_tpu/train/runner_finetune.py`` (the reference's
tools/runner_finetune.py).

The train step folds in the reference's input pipeline (its batch body,
:168-232): FPS-oversample, random subsample, rotate or scale + translate,
forward, loss, backward, update. It is two halves, ``make_input_pipeline``'s
``prepare`` and ``finetune_update``, so each can be timed on its own as the
step runs it. ``finetune_run`` runs the epochs with validation, the vote
protocol and checkpoints; ``test_run`` the plain or the voted test.

Over several ranks (``make_run_mesh``) the step is the JAX package's step
over its ``('data',)`` or ``('data', tp_axis)`` mesh, which is the
one-process step over the global batch: each rank of the ``data`` axis holds
its rows of the batch, the BatchNorms take the global statistics, the
optimizer averages the gradients over the axis, and every draw (the FPS
resampling's keys, the augmentation, DropPath, the head's dropout) is made
for the global batch from the one generator all ranks hold, each rank keeping
its rows (``parallel/draws.py``). A tensor-parallel model (``PointMamba``
with ``tp_axis``) runs the same step on every rank of its model axis: the
same points and labels and the same draws, or the replicated activations
would part silently. The step checks that the ranks' generators agree
before it draws, and every epoch ends with a check that the replicas'
parameters and BatchNorm statistics are bitwise equal.
"""

from __future__ import annotations

import time
from collections.abc import Callable

import numpy as np
import torch
import torch.distributed as dist

from si_mamba_tpu_torch.data import transforms
from si_mamba_tpu_torch.models.embed import set_bn_momentum
from si_mamba_tpu_torch.models.point_mamba import PointMamba
from si_mamba_tpu_torch.ops.pointops import fps, gather_points
from si_mamba_tpu_torch.parallel.collectives import all_gather
from si_mamba_tpu_torch.parallel.draws import shard_rows
from si_mamba_tpu_torch.parallel.mesh import (
    barrier,
    check_replicas_equal,
    data_axis,
    data_mesh,
    global_host_sum,
    make_mesh,
    module_data_axis,
    rank_and_world,
    set_data_axis,
)
from si_mamba_tpu_torch.serving import _fps_to_npoints
from si_mamba_tpu_torch.train import checkpoint as ckpt
from si_mamba_tpu_torch.train.logging_utils import (
    AccMetric,
    AverageMeter,
    DeferredMeters,
    ScalarWriter,
    print_log,
)
from si_mamba_tpu_torch.train.optim import bn_momentum_schedule, build_optimizer
from si_mamba_tpu_torch.train.registry import build_model_from_cfg
from si_mamba_tpu_torch.train.train_state import (
    TrainState,
    classifier_update,
    make_classifier_eval_step,
)
from si_mamba_tpu_torch.utils.device import resolve_device
from si_mamba_tpu_torch.utils.weights import _strip_prefixes, shard_state_dict


def _point_all(npoints: int) -> int:
    """The reference's FPS oversampling table (npoints -> points kept by FPS)."""
    table = {1024: 1200, 2048: 2400, 4096: 4800, 8192: 8192}
    if npoints not in table:
        raise NotImplementedError(f"npoints={npoints}")
    return table[npoints]


def make_input_pipeline(npoints: int, rotation: bool) -> Callable:
    """Returns prepare(points, generator) -> (B, npoints, 3): FPS to the
    oversampled count, a random subset of ``npoints``, then a rotation about
    y or a scale + translate, all drawn from ``generator``."""
    point_all = _point_all(npoints)

    def prepare(points, generator):
        pts = transforms.fps_resample(points, generator, npoints, point_all=point_all)
        if rotation:
            return transforms.rotate_y(pts, generator)
        return transforms.scale_and_translate(pts, generator)

    return prepare


def finetune_update(state: TrainState, points, labels, generator, bn_momentum: float = 0.9):
    """Sets every BatchNorm's momentum for this epoch, then one
    ``classifier_update`` on prepared points."""
    set_bn_momentum(state.model, bn_momentum)
    return classifier_update(state, points, labels, generator)


def check_same_generator(generator: torch.Generator, axis, device) -> None:
    """Raise unless every rank of the mesh axis ``axis`` holds ``generator``
    in the same state (same seed, same draws so far). One all-reduce of the
    generator's state bytes, on ``device``."""
    state = generator.get_state().to(device=device, dtype=torch.float64)
    rows = all_gather(state, axis)
    if not torch.equal(rows.amin(dim=0), rows.amax(dim=0)):
        raise RuntimeError(f"the ranks of the '{axis.name}' axis hold generators in different "
                           f"states: a tensor-parallel step needs one seed on every rank")


def axis_mean(metrics: dict, axis) -> dict:
    """Each scalar metric averaged over the mesh axis ``axis`` (the logged
    loss and accuracy of the global batch, every rank's rows the same
    count); the metrics themselves without an axis. One all-reduce."""
    if axis is None or axis.size == 1:
        return metrics
    flat = torch.stack([v.float() for v in metrics.values()])
    dist.all_reduce(flat, group=axis.group)
    flat.div_(axis.size)
    return dict(zip(metrics, flat.unbind()))


def make_train_step(model: PointMamba, npoints: int, rotation: bool,
                    data_axis=None) -> Callable:
    """Returns step(state, points, labels, generator, bn_momentum=0.9) ->
    (state, {"loss", "acc"}). ``points`` (B, N, 3) on the model's device;
    ``generator`` on that device drives the resample, the augmentation and
    the drops. ``bn_momentum`` is the flax-convention BatchNorm momentum of
    this epoch (``optim.bn_momentum_schedule``; 0.9 without a scheduler).
    ``data_axis``: the mesh's ``data`` axis under data parallelism, ``points``
    then this rank's rows of the global batch; the draws are the global
    batch's and the metrics its means. Every step first checks that the ranks
    of the data axis and of a tensor-parallel model's axis hold the generator
    in the same state."""
    prepare = make_input_pipeline(npoints, rotation)
    tp = model.tp_sharding()
    dp = data_axis if data_axis is not None and data_axis.size > 1 else None

    def step(state: TrainState, points, labels, generator, bn_momentum: float = 0.9):
        if state.model is not model:
            raise ValueError("the train state holds another model than this step's")
        for axis in (dp, None if tp is None else tp[0]):
            if axis is not None:
                check_same_generator(generator, axis, points.device)
        rows = shard_rows(generator, dp)
        state, metrics = finetune_update(state, prepare(points, rows), labels, rows,
                                         bn_momentum)
        return state, axis_mean(metrics, dp)

    return step


def _model_device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def make_eval_step(model: PointMamba, npoints: int) -> Callable:
    """Returns step(state, points) -> logits: FPS from index 0 down to
    ``npoints`` (the reference's validate, :313-321), then an eval-mode
    forward."""
    classify = make_classifier_eval_step(model)

    def step(state: TrainState, points):
        return classify(state, _fps_to_npoints(points, npoints))

    return step


def vote_pass(pool, generator: torch.Generator, npoints: int, rotation: bool):
    """One vote pass's clouds: a random ``npoints`` subset of the FPS pool,
    then a rotation about y or a scale + translate, drawn from ``generator``."""
    pts = transforms.fps_resample(pool, generator, npoints, point_all=pool.shape[1])
    if rotation:
        return transforms.rotate_y(pts, generator)
    return transforms.scale_and_translate(pts, generator)


def make_vote_step(model: PointMamba, npoints: int, rotation: bool,
                   times: int = 10) -> Callable:
    """Returns step(state, points, generator) -> (B, cls_dim) float32: the
    logits of ``times`` eval forwards summed (the reference's vote, :345-406).
    The FPS pool of ``_point_all(npoints)`` points is taken once a batch (the
    reference's shared ``fps_idx_raw``, :368) and every pass draws its subset
    and augmentation from it (:func:`vote_pass`)."""
    classify = make_classifier_eval_step(model)

    def step(state: TrainState, points, generator: torch.Generator):
        B, N = points.shape[0], points.shape[1]
        pa = _point_all(npoints)
        pool = gather_points(points, fps(points, pa)) if N > pa else points
        acc = torch.zeros((B, model.config.cls_dim), dtype=torch.float32, device=points.device)
        for _ in range(times):
            acc = acc + classify(state, vote_pass(pool, generator, npoints, rotation)).float()
        return acc

    return step


def _accuracy(loader, device, logits_of, axis=None) -> float:
    """Percent of the loader's labels (epoch 0: its unshuffled order) that the
    argmax of ``logits_of(points on device)`` hits, counted on the host, the
    counts summed over the mesh axis ``axis`` (every process's shard of the
    index space, padded as DistributedSampler pads it, ``data/loader.py``)."""
    correct = total = 0
    for pts, labels in loader.epoch(0):
        logits = logits_of(torch.from_numpy(pts).to(device))
        correct += int((logits.argmax(-1).cpu().numpy() == labels).sum())
        total += len(labels)
    counts = global_host_sum(np.asarray([correct, total], np.int64), axis)
    return 100.0 * int(counts[0]) / max(int(counts[1]), 1)


def validate(eval_step, state, loader, epoch: int = 0) -> float:
    """Accuracy in percent of ``eval_step``'s logits over the loader; under
    data parallelism over the ranks of the model's data axis
    (``parallel.set_data_axis``), each evaluating its loader shard."""
    return _accuracy(loader, _model_device(state.model), lambda pts: eval_step(state, pts),
                     module_data_axis(state.model))


def validate_vote(vote_step, state, loader, seed: int = 0) -> float:
    """Vote accuracy in percent (``make_vote_step``'s summed logits), over
    the ranks of the model's data axis as :func:`validate`. As in the JAX
    package, whose every batch takes the key of ``seed``, every batch draws
    from a generator on the model's device seeded anew with ``seed``."""
    device = _model_device(state.model)
    generator = torch.Generator(device)

    def logits_of(pts):
        generator.manual_seed(seed)
        return vote_step(state, pts, generator)

    return _accuracy(loader, device, logits_of, module_data_axis(state.model))


def check_tensor_parallel(config) -> tuple[str | None, int]:
    """(tp_axis, tp_size) of the config; raises for a one-sided request
    (only ``model.tp_axis`` or only ``tp_size`` > 1), as the JAX package
    does."""
    tp_axis = config.model.get("tp_axis", None)
    tp_size = int(config.get("tp_size", 1) or 1)
    if (tp_axis is not None) != (tp_size > 1):
        raise ValueError(
            f"tensor parallelism needs BOTH model.tp_axis and top-level "
            f"tp_size > 1 (got tp_axis={tp_axis!r}, tp_size={tp_size})")
    return tp_axis, tp_size


def make_run_mesh(config):
    """The mesh of a run over the ranks of the default group: ``('data',)``
    over all of them, or with ``model.tp_axis`` and ``tp_size`` > 1
    ``('data', tp_axis)`` of shape (world // tp_size, tp_size), as the JAX
    runner lays out its devices; None for a single process. Every rank must
    call it (its groups are created collectively). Raises for a one-sided
    tensor parallelism and for a ``tp_size`` that does not divide the world
    size."""
    tp_axis, tp_size = check_tensor_parallel(config)
    _, world_size = rank_and_world()
    if world_size % tp_size:
        raise ValueError(f"tp_size={tp_size} must divide the world size {world_size} "
                         f"(launch tp_size ranks or a multiple of it)")
    if tp_size > 1 and world_size > 1:
        return make_mesh(("data", tp_axis), (world_size // tp_size, tp_size))
    return data_mesh()


def check_replicas(model: torch.nn.Module, mesh) -> None:
    """Raise, naming the tensor, unless the copies of every parameter and
    BatchNorm buffer that ranks hold alike are bitwise equal: all of them
    over the ``data`` axis, and over a tensor-parallel model axis those not
    sharded over it. Nothing without a mesh."""
    if mesh is None:
        return
    named = dict(model.named_parameters()) | dict(model.named_buffers())
    check_replicas_equal(named, data_axis(mesh))
    tp = model.tp_sharding() if hasattr(model, "tp_sharding") else None
    if tp is not None:
        axis, segments = tp
        check_replicas_equal({k: v for k, v in named.items() if k not in segments}, axis)


def finetune_run(config, train_loader, val_loader, exp_dir: str,
                 pretrained: dict | None = None, resume: bool = False, vote: bool = False,
                 logger=None, seed: int = 0, device="cuda", model: PointMamba | None = None,
                 mesh=None):
    """The finetune loop: epochs ``start_epoch..max_epoch`` (inclusive) of
    train steps, each epoch's validation, the vote protocol above the
    reference's thresholds (:278-288), and the best, best-vote and last
    checkpoints. ``model``: the classifier to train, on ``device``; without
    one, ``config.model`` is built there through the registry from a
    generator seeded with ``seed``. The steps draw from a second generator of
    that seed, whose state the checkpoints keep. ``pretrained``: a state dict
    to start from (``checkpoint.transfer_pretrained``). Returns (state, best
    AccMetric).

    Over several ranks ``mesh`` (``make_run_mesh(config)`` unless given; the
    model's own for a tensor-parallel model) and the loaders must be every
    rank's: each loader this rank's shard (``Loader(process_index=data
    index, process_count=data size)``). The validations sum their counts
    over the ranks, rank 0 writes the checkpoints, and every epoch ends with
    :func:`check_replicas`."""
    device = resolve_device(device)
    if mesh is None:
        mesh = make_run_mesh(config)
    dp = data_axis(mesh)
    npoints = int(config.npoints)
    rotation = bool(config.model.get("rotation", False))
    if model is None:
        model, _ = build_model_from_cfg(config.model, device, seed, mesh=mesh)
    if mesh is not None:
        set_data_axis(model, dp)
    if pretrained is not None:
        tp = model.tp_sharding()
        if tp is not None:  # this rank's shard of the whole state dict
            pretrained = shard_state_dict(_strip_prefixes(pretrained), model.config,
                                          tp[0].index, tp[0].size)
        ckpt.transfer_pretrained(model, pretrained, logger)

    steps_per_epoch = max(len(train_loader), 1)
    optimizer, sched = build_optimizer(
        model, opt_type=config.optimizer.type,
        lr=float(config.optimizer.kwargs.lr),
        weight_decay=float(config.optimizer.kwargs.get("weight_decay", 0.0)),
        # LambdaLR/StepLR configs carry no epochs/initial_epochs keys:
        # max_epoch and 0 stand in
        epochs=int(config.scheduler.kwargs.get("epochs", config.max_epoch)),
        warmup_epochs=int(config.scheduler.kwargs.get("initial_epochs", 0)),
        steps_per_epoch=steps_per_epoch,
        grad_clip=float(config.get("grad_norm_clip", 0) or 0) or None,
        sched_type=config.scheduler.type,
        step_per_update=int(config.get("step_per_update", 1) or 1),
        sched_kwargs=dict(config.scheduler.kwargs), tp=model.tp_sharding(), data_axis=dp)
    state = TrainState.create(model, optimizer)

    # the reference's optional BatchNorm-momentum scheduler (config key
    # ``bnmscheduler``), one value an epoch
    bnm_cfg = config.get("bnmscheduler", None)
    if bnm_cfg is not None and bnm_cfg.get("type", "Lambda") == "Lambda":
        kw = dict(bnm_cfg.get("kwargs", {}) or {})
        bn_sched = bn_momentum_schedule(
            bn_momentum=float(kw.get("bn_momentum", 0.1)),
            bn_decay=float(kw.get("bn_decay", 0.5)),
            decay_step=float(kw.get("decay_step", 40)),
            lowest_decay=float(kw.get("lowest_decay", 0.01)))
    else:
        bn_sched = lambda epoch: 0.9  # noqa: E731  (torch's momentum 0.1)

    generator = torch.Generator(device).manual_seed(seed)
    start_epoch, best = 0, {}
    if resume:
        state, start_epoch, best = ckpt.resume_state(exp_dir, state, generator)
        print_log(f"[RESUME] restored ckpt-last: start_epoch={start_epoch} best={best}", logger)
        if start_epoch > int(config.max_epoch):
            print_log(f"[RESUME] training already complete (max_epoch={config.max_epoch})",
                      logger)
    best_metrics = AccMetric(best.get("acc", 0.0))
    best_vote = AccMetric(0.0)

    train_step = make_train_step(model, npoints, rotation, dp)
    eval_step = make_eval_step(model, npoints)
    vote_step = make_vote_step(model, npoints, rotation)
    async_ckpt = bool(config.get("async_ckpt", False))
    writer = ScalarWriter(f"{exp_dir}/scalars.jsonl")
    try:
        for epoch in range(start_epoch, int(config.max_epoch) + 1):
            t0 = time.time()
            meters = AverageMeter(["loss", "acc"])
            # epoch e trains at bnm(e - 1): the reference steps its scheduler
            # at the end of an epoch after applying bnm(0) at the start
            bn_m = bn_sched(max(epoch - 1, 0))
            lag = DeferredMeters(meters, ("loss", "acc"))
            for pts, labels in train_loader.epoch(epoch):
                state, m = train_step(state, torch.from_numpy(pts).to(device),
                                      torch.from_numpy(labels).to(device), generator, bn_m)
                lag.push(m)
            lag.flush()
            check_replicas(model, mesh)
            lr_now = float(sched(int(state.step)))
            print_log(f"[Training] EPOCH: {epoch} EpochTime = {time.time() - t0:.3f} (s) "
                      f"Losses = {['%.4f' % v for v in meters.avg()]} lr = {lr_now:.6f} "
                      f"bn_momentum = {bn_m:.6f}", logger)
            writer.add_scalar("Loss/Epoch/Loss", meters.avg(0), epoch)
            writer.add_scalar("LR", lr_now, epoch)

            acc = validate(eval_step, state, val_loader, epoch)
            writer.add_scalar("Metric/ACC", acc, epoch)
            print_log(f"[Validation] EPOCH: {epoch}  acc = {acc:.4f}", logger)
            metrics = AccMetric(acc)
            better = metrics.better_than(best_metrics)
            if better:
                best_metrics = metrics
                ckpt.save_checkpoint(exp_dir, "ckpt-best", state, epoch, metrics.state_dict(),
                                     best_metrics.state_dict(), async_ckpt, generator)
            if vote and (acc > 92.1 or (better and acc > 91)):
                vacc = validate_vote(vote_step, state, val_loader)
                writer.add_scalar("Metric/ACC_vote", vacc, epoch)
                if AccMetric(vacc).better_than(best_vote):
                    best_vote = AccMetric(vacc)
                    ckpt.save_checkpoint(exp_dir, "ckpt-best_vote", state, epoch,
                                         {"acc": vacc}, best_vote.state_dict(), async_ckpt,
                                         generator)
            ckpt.save_checkpoint(exp_dir, "ckpt-last", state, epoch, metrics.state_dict(),
                                 best_metrics.state_dict(), async_ckpt, generator)
    finally:
        try:
            ckpt.wait_for_saves()
        finally:
            writer.close()
    barrier()  # rank 0's checkpoints are on disk before any rank returns
    return state, best_metrics


def tsne_run(config, test_loader, state, out_path: str, logger=None):
    """The t-SNE scatter of the test features (reference test_tsne,
    :573-631) needs sklearn, which the GPU host does not have."""
    raise NotImplementedError("--tsne needs sklearn's t-SNE and the visualisation utilities: "
                              "ROADMAP.md queue 1, M21")


def test_run(config, test_loader, state: TrainState, vote: bool = False, logger=None) -> float:
    """The test (reference test_net, :409-467): the plain eval accuracy, or
    with ``vote`` the best of 300 rounds of ``validate_vote`` (seeds
    0..299); over several ranks each takes its loader shard and the model's
    data axis sums the counts."""
    npoints = int(config.npoints)
    acc = validate(make_eval_step(state.model, npoints), state, test_loader)
    print_log(f"[TEST] acc = {acc:.4f}", logger)
    if not vote:
        return acc
    rotation = bool(config.model.get("rotation", False))
    vote_step = make_vote_step(state.model, npoints, rotation, times=10)
    best = 0.0
    for t in range(300):
        vacc = validate_vote(vote_step, state, test_loader, seed=t)
        best = max(best, vacc)
        if t % 10 == 0:
            print_log(f"[TEST_VOTE] iter {t}: acc {vacc:.4f} best {best:.4f}", logger)
    print_log(f"[TEST_VOTE] final best acc = {best:.4f}", logger)
    return best

