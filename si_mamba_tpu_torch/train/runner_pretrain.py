"""The MAE pretraining runner, the counterpart of
``si_mamba_tpu/train/runner_pretrain.py`` (the reference's
tools/runner_pretrain.py): the tau schedule of the Gumbel noise, the train
step (scale + translate, the Chamfer loss, backward, clip, AdamW), the
feature step of the SVM probe (max and mean of the noaug features) and the
probe itself, solved on the device (``train/svm.py``), and the epoch loop
with its checkpoints.

One process: the loaders yield every sample (data parallelism is ROADMAP.md
queue 1, M18b). The step's draws (the augmentation, the mask, the Gumbel
noise, DropPath) come from a ``torch.Generator`` on the device seeded with
``seed``, whose state the checkpoints keep.
"""

from __future__ import annotations

import math
import time
from collections.abc import Callable

import torch
import torch.distributed as dist

from si_mamba_tpu_torch.data import transforms
from si_mamba_tpu_torch.models.point_mae import PointMAEMamba
from si_mamba_tpu_torch.train import checkpoint as ckpt
from si_mamba_tpu_torch.train import svm
from si_mamba_tpu_torch.train.logging_utils import (
    AccMetric,
    AverageMeter,
    DeferredMeters,
    ScalarWriter,
    print_log,
)
from si_mamba_tpu_torch.train.optim import build_optimizer
from si_mamba_tpu_torch.train.registry import build_model_from_cfg
from si_mamba_tpu_torch.train.train_state import TrainState
from si_mamba_tpu_torch.utils.device import resolve_device


def tau_schedule(epoch: int, start_tau: float = 0.01, max_tau: float = 1.0,
                 warmup_epochs: int = 20, total_epochs: int = 300) -> float:
    """Linear warm-up to max_tau, then a cosine back to start_tau (the
    reference's runner_pretrain.py:34-44)."""
    if epoch < 0:
        return start_tau
    if epoch < warmup_epochs:
        return start_tau + (max_tau - start_tau) * epoch / max(warmup_epochs, 1)
    t = (epoch - warmup_epochs) / max(total_epochs - warmup_epochs, 1)
    return start_tau + 0.5 * (max_tau - start_tau) * (1 + math.cos(math.pi * t))


def make_pretrain_step(model: PointMAEMamba) -> Callable:
    """Returns step(state, points, generator, tau, **draws) -> (state,
    {"loss"}): scale + translate, a train-mode forward (the mask, the Gumbel
    noise at ``tau`` and DropPath drawn from ``generator``), backward and an
    optimizer step (clip and AdamW as built). ``points`` (B, N, 3) on the
    model's device. ``draws``: ``aug_uniform`` (the scale's and the shift's
    (B, 1, 3) uniforms), ``mask_uniform`` and ``gumbel_uniform`` in place of
    the generator's (for tests that replay another framework's)."""

    def step(state: TrainState, points, generator, tau, **draws):
        if state.model is not model:
            raise ValueError("the train state holds another model than this step's")
        pts = transforms.scale_and_translate(points, generator,
                                             uniforms=draws.get("aug_uniform"))
        loss = model.train()(pts, tau=tau, generator=generator,
                             mask_uniform=draws.get("mask_uniform"),
                             gumbel_uniform=draws.get("gumbel_uniform"))
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return state, {"loss": loss.detach()}

    return step


def make_feature_step(model: PointMAEMamba) -> Callable:
    """Returns step(state, points) -> (B, 2 C): the max and the mean over the
    tokens of the eval-mode noaug features (the reference's SVM features)."""

    def step(state: TrainState, points):
        if state.model is not model:
            raise ValueError("the train state holds another model than this step's")
        with torch.no_grad():
            feats = model.eval()(points, noaug=True)
        return torch.cat([feats.amax(dim=1), feats.mean(dim=1)], dim=-1)

    return step


def collect_features(feature_step, state, loader, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The loader's features (on ``device``, fp32) and labels, epoch 0."""
    feats, labels = [], []
    for pts, lab in loader.epoch(0):
        feats.append(feature_step(state, torch.from_numpy(pts).to(device)).float())
        labels.append(torch.from_numpy(lab).reshape(-1).to(device))
    return torch.cat(feats), torch.cat(labels)


def svm_probe(feature_step, state, svm_train_loader, svm_test_loader) -> float:
    """The linear SVM probe's test accuracy in percent: the features of both
    splits, then ``svm.svm_accuracy`` on the model's device."""
    device = next(state.model.parameters()).device
    trf, trl = collect_features(feature_step, state, svm_train_loader, device)
    tef, tel = collect_features(feature_step, state, svm_test_loader, device)
    return svm.svm_accuracy(trf, trl, tef, tel)


def pretrain_run(config, train_loader, svm_loaders, exp_dir: str, resume: bool = False,
                 logger=None, seed: int = 0, val_freq: int = 1, device="cuda",
                 model: PointMAEMamba | None = None):
    """The pretraining loop: epochs ``start_epoch..max_epoch`` (inclusive) of
    train steps at tau = ``tau_schedule(epoch, total_epochs=max_epoch)``; the
    SVM probe on ``svm_loaders`` (train, test) every ``val_freq`` epochs
    after epoch 0, ``ckpt-best`` when its accuracy rose; ``ckpt-last`` every
    epoch and ``ckpt-epoch-NNN`` every 25 from epoch 250. ``model``: the
    model to train, on ``device``; without one ``config.model`` is built
    there through the registry from a generator seeded with ``seed``.
    ``resume``: continue from the experiment's ``ckpt-last.pth``. Returns
    (state, best AccMetric)."""
    device = resolve_device(device)
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        raise NotImplementedError("data-parallel pretraining over several processes is "
                                  "ROADMAP.md queue 1, M18b")
    if model is None:
        model, _ = build_model_from_cfg(config.model, device, seed)
    optimizer, sched = build_optimizer(
        model, opt_type=config.optimizer.type,
        lr=float(config.optimizer.kwargs.lr),
        weight_decay=float(config.optimizer.kwargs.get("weight_decay", 0.0)),
        epochs=int(config.scheduler.kwargs.get("epochs", config.max_epoch)),
        warmup_epochs=int(config.scheduler.kwargs.get("initial_epochs", 0)),
        steps_per_epoch=max(len(train_loader), 1),
        grad_clip=float(config.get("grad_norm_clip", 0) or 0) or None,
        sched_type=config.scheduler.type,
        step_per_update=int(config.get("step_per_update", 1) or 1),
        sched_kwargs=dict(config.scheduler.kwargs))
    state = TrainState.create(model, optimizer)
    generator = torch.Generator(device).manual_seed(seed)
    start_epoch, best = 0, {}
    if resume:
        state, start_epoch, best = ckpt.resume_state(exp_dir, state, generator)
        print_log(f"[RESUME] restored ckpt-last: start_epoch={start_epoch} best={best}", logger)
    best_metrics = AccMetric(best.get("acc", 0.0))
    train_step = make_pretrain_step(model)
    feature_step = make_feature_step(model)
    async_ckpt = bool(config.get("async_ckpt", False))
    writer = ScalarWriter(f"{exp_dir}/scalars.jsonl")
    max_epoch = int(config.max_epoch)
    try:
        for epoch in range(start_epoch, max_epoch + 1):
            t0 = time.time()
            tau = tau_schedule(epoch, total_epochs=max_epoch)
            meters = AverageMeter(["loss"])
            lag = DeferredMeters(meters, ("loss",))
            for pts, _ in train_loader.epoch(epoch):
                state, m = train_step(state, torch.from_numpy(pts).to(device), generator, tau)
                lag.push(m)
            lag.flush()
            print_log(f"[Training] EPOCH: {epoch} EpochTime = {time.time() - t0:.3f} (s) "
                      f"Losses = {meters.avg(0):.6f} tau = {tau:.4f} "
                      f"lr = {float(sched(int(state.step))):.6f}", logger)
            writer.add_scalar("Loss/Epoch/Loss", meters.avg(0), epoch)
            if svm_loaders is not None and epoch % val_freq == 0 and epoch != 0:
                acc = svm_probe(feature_step, state, *svm_loaders)
                writer.add_scalar("Metric/SVM_ACC", acc, epoch)
                print_log(f"[Validation] EPOCH: {epoch}  svm_acc = {acc:.4f}", logger)
                if AccMetric(acc).better_than(best_metrics):
                    best_metrics = AccMetric(acc)
                    ckpt.save_checkpoint(exp_dir, "ckpt-best", state, epoch, {"acc": acc},
                                         best_metrics.state_dict(), async_ckpt, generator)
            ckpt.save_checkpoint(exp_dir, "ckpt-last", state, epoch, {},
                                 best_metrics.state_dict(), async_ckpt, generator)
            if epoch >= 250 and epoch % 25 == 0:
                ckpt.save_checkpoint(exp_dir, f"ckpt-epoch-{epoch:03d}", state, epoch, {},
                                     best_metrics.state_dict(), async_ckpt, generator)
    finally:
        try:
            ckpt.wait_for_saves()
        finally:
            writer.close()
    return state, best_metrics
