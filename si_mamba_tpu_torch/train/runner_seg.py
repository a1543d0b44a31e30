"""The part-segmentation trainer and its per-category mIoU evaluation, the
counterpart of ``si_mamba_tpu/train/runner_seg.py`` (the reference's
part_segmentation/main.py).

The augmentations (a random scale, then a shift) draw from
``np.random.default_rng(seed)`` on the host, as the JAX trainer's do, so a
batch equals the JAX package's for the same seed; the model's own draws
(DropPath, the head's dropout, HLT's tie-break) come from a
``torch.Generator`` on the device seeded with ``seed``, whose state the
checkpoints keep. Over several ranks (a ``data`` axis, as
``runner_finetune``) each rank trains on its loader shard with the global
batch's draws, host and device, keeping its rows; the BatchNorms take the
global statistics, the gradients are averaged, and the evaluation's IoU sums
and counts are summed over the ranks.
"""

from __future__ import annotations

import time
from collections.abc import Callable

import numpy as np
import torch
import torch.nn.functional as F

from si_mamba_tpu_torch.parallel.draws import shard_rows
from si_mamba_tpu_torch.parallel.mesh import (
    barrier,
    data_axis,
    data_mesh,
    global_host_sum,
    set_data_axis,
)

from si_mamba_tpu_torch.data.shapenetpart import (
    SEG_CLASSES,
    random_scale_point_cloud,
    shift_point_cloud,
)
from si_mamba_tpu_torch.models.segmentation import PartSegConfig, PartSegModel, nll_loss
from si_mamba_tpu_torch.train import checkpoint as ckpt
from si_mamba_tpu_torch.train.logging_utils import (
    AverageMeter,
    DeferredMeters,
    ScalarWriter,
    print_log,
)
from si_mamba_tpu_torch.train.optim import build_optimizer
from si_mamba_tpu_torch.train.runner_finetune import axis_mean, check_replicas
from si_mamba_tpu_torch.train.train_state import TrainState
from si_mamba_tpu_torch.utils.device import resolve_device


def _onehot(cls: torch.Tensor, num_categories: int) -> torch.Tensor:
    return F.one_hot(cls.long(), num_categories).float()


def augment(pts: np.ndarray, rng: np.random.Generator, index: int = 0,
            count: int = 1) -> np.ndarray:
    """The trainer's augmentation, a random scale then a shift of every
    cloud, drawn from ``rng`` for a global batch of ``count`` shards like
    ``pts`` and applied to this shard's rows, the ``index``-th block (with
    one shard: ``shift_point_cloud(random_scale_point_cloud(pts, rng), rng)``)."""
    b = pts.shape[0]
    rows = slice(index * b, (index + 1) * b)
    scales = random_scale_point_cloud(np.ones((b * count, 1, 1), np.float32), rng)[rows]
    shifts = shift_point_cloud(np.zeros((b * count, 1, 3), np.float32), rng)[rows]
    return pts * scales + shifts


def make_seg_train_step(model: PartSegModel, num_categories: int = 16,
                        data_axis=None) -> Callable:
    """Returns step(state, pts, cls, seg, generator, **draws) -> (state,
    {"loss", "acc"}): a train-mode forward (BatchNorm on batch statistics,
    the draws from ``generator``), the mean NLL over every point, backward
    and an optimizer step. ``pts`` (B, N, 3), ``cls`` (B,) and ``seg`` (B, N)
    on the model's device; under data parallelism (``data_axis``) this rank's
    rows, the draws the global batch's and the metrics its means. ``draws``:
    ``order_noise`` and ``head_mask`` for the forward in place of its draws
    (for tests that replay another framework's)."""

    def step(state: TrainState, pts, cls, seg, generator, **draws):
        if state.model is not model:
            raise ValueError("the train state holds another model than this step's")
        rows = shard_rows(generator, data_axis)
        logp = model.train()(pts, _onehot(cls, num_categories), generator=rows, **draws)
        loss = nll_loss(logp, seg)
        acc = torch.mean((torch.argmax(logp, -1) == seg).float())
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return state, axis_mean({"loss": loss.detach(), "acc": acc.detach()}, data_axis)

    return step


def make_seg_eval_step(model: PartSegModel, num_categories: int = 16) -> Callable:
    """Returns step(state, pts, cls) -> log-probs (B, N, cls_dim): an
    eval-mode forward without gradient (HLT's draw seeded 0)."""

    def step(state: TrainState, pts, cls):
        if state.model is not model:
            raise ValueError("the train state holds another model than this step's")
        with torch.no_grad():
            return model.eval()(pts, _onehot(cls, num_categories))

    return step


SEG_LABEL_TO_CAT = {label: name for name, labels in SEG_CLASSES.items() for label in labels}


def masked_category_argmax(logp: np.ndarray, cat_names: list[str]) -> np.ndarray:
    """Each point's argmax over the parts of its sample's category only
    (the reference's evaluation)."""
    preds = np.zeros(logp.shape[:2], np.int32)
    for b in range(logp.shape[0]):
        parts = SEG_CLASSES[cat_names[b]]
        preds[b] = np.asarray(parts)[logp[b][:, parts].argmax(-1)]
    return preds


def evaluate_miou(eval_step, state, loader, device=None, axis=None) -> dict:
    """Instance and class mIoU and point accuracy of ``eval_step``'s
    log-probs over the loader (epoch 0: its unshuffled order; the last batch
    may be short). A sample's category is the one its ground-truth parts
    belong to; a part absent from both truth and prediction counts IoU 1.
    Batches go to ``device`` (the state's model's when None). The IoU sums
    and the counts are summed over the ranks of the mesh axis ``axis``, each
    evaluating its loader shard."""
    if device is None:
        device = next(state.model.parameters()).device
    cat_order = list(SEG_CLASSES)
    cat_pos = {name: i for i, name in enumerate(cat_order)}
    iou_sum = np.zeros(len(cat_order))
    iou_cnt = np.zeros(len(cat_order))
    correct = total = 0
    for pts, cls_idx, seg in loader.epoch(0):
        logp = eval_step(state, torch.from_numpy(pts).to(device),
                         torch.from_numpy(cls_idx).to(device))
        logp = logp.float().cpu().numpy() if isinstance(logp, torch.Tensor) else np.asarray(logp)
        cat_names = [SEG_LABEL_TO_CAT[int(seg[b, 0])] for b in range(seg.shape[0])]
        preds = masked_category_argmax(logp, cat_names)
        correct += int((preds == seg).sum())
        total += seg.size
        for b in range(len(cls_idx)):
            name = cat_names[b]
            ious = []
            for p in SEG_CLASSES[name]:
                gt_p, pr_p = seg[b] == p, preds[b] == p
                union = np.logical_or(gt_p, pr_p).sum()
                ious.append(1.0 if union == 0 else np.logical_and(gt_p, pr_p).sum() / union)
            iou_sum[cat_pos[name]] += float(np.mean(ious))
            iou_cnt[cat_pos[name]] += 1
    iou_sum, iou_cnt = global_host_sum(iou_sum, axis), global_host_sum(iou_cnt, axis)
    correct, total = (int(v) for v in global_host_sum(np.asarray([correct, total], np.int64),
                                                      axis))
    cat_ious = {name: float(iou_sum[i] / iou_cnt[i])
                for i, name in enumerate(cat_order) if iou_cnt[i] > 0}
    n_samples = float(iou_cnt.sum())
    return {
        "accuracy": correct / max(total, 1),
        "instance_miou": float(iou_sum.sum() / n_samples) if n_samples else 0.0,
        "class_miou": float(np.mean(list(cat_ious.values()))) if cat_ious else 0.0,
        "per_category": cat_ious,
    }


def seg_run(cfg: PartSegConfig, train_loader, test_loader, exp_dir: str, epochs: int = 300,
            lr: float = 0.0002, weight_decay: float = 0.05, warmup_epochs: int = 10,
            pretrained: dict | None = None, logger=None, seed: int = 0, resume: bool = False,
            async_ckpt: bool = False, device="cuda", model: PartSegModel | None = None,
            mesh=None):
    """The training loop: epochs ``start_epoch..epochs - 1`` of train steps
    (AdamW at the timm stepped cosine with warm-up, global-norm clip 10),
    each followed by the mIoU evaluation on ``test_loader``, ``ckpt-best``
    when the instance mIoU rose and ``ckpt-last`` every epoch. ``model``:
    the model to train, on ``device``; without one it is built there from a
    generator seeded with ``seed``. ``pretrained``: a state dict to start
    from (``checkpoint.transfer_pretrained``). ``resume``: continue from the
    experiment's ``ckpt-last.pth``. ``mesh``: over several ranks the run's
    (a ``('data',)`` mesh of them all unless given), the loaders each rank's
    shard. Returns (state, best metrics)."""
    device = resolve_device(device)
    if mesh is None:
        mesh = data_mesh()
    dp = data_axis(mesh)
    if model is None:
        with torch.device(device):
            model = PartSegModel(cfg, generator=torch.Generator(device).manual_seed(seed))
    if mesh is not None:
        set_data_axis(model, dp)
    shard = (0, 1) if dp is None else (dp.index, dp.size)
    if pretrained is not None:
        ckpt.transfer_pretrained(model, pretrained, logger)
    rng_np = np.random.default_rng(seed)
    optimizer, _ = build_optimizer(model, lr=lr, weight_decay=weight_decay, epochs=epochs,
                                   warmup_epochs=warmup_epochs,
                                   steps_per_epoch=max(len(train_loader), 1), grad_clip=10.0,
                                   data_axis=dp)
    state = TrainState.create(model, optimizer)
    generator = torch.Generator(device).manual_seed(seed)
    start_epoch, best0 = 0, {}
    if resume:
        state, start_epoch, best0 = ckpt.resume_state(exp_dir, state, generator)
        print_log(f"[RESUME] restored ckpt-last: start_epoch={start_epoch} best={best0}", logger)
    train_step = make_seg_train_step(model, cfg.num_categories, dp)
    eval_step = make_seg_eval_step(model, cfg.num_categories)
    writer = ScalarWriter(f"{exp_dir}/scalars.jsonl")
    best = best0 if best0.get("instance_miou") else {"instance_miou": 0.0}
    try:
        for epoch in range(start_epoch, epochs):
            t0 = time.time()
            meters = AverageMeter(["loss", "acc"])
            lag = DeferredMeters(meters, ("loss", "acc"))
            for pts, cls_idx, seg in train_loader.epoch(epoch):
                pts = augment(pts, rng_np, *shard)
                state, m = train_step(state, torch.from_numpy(pts).to(device),
                                      torch.from_numpy(cls_idx).to(device),
                                      torch.from_numpy(seg).to(device), generator)
                lag.push(m)
            lag.flush()
            check_replicas(model, mesh)
            print_log(f"[Seg] EPOCH {epoch} time={time.time() - t0:.1f}s "
                      f"loss={meters.avg(0):.4f} acc={meters.avg(1):.4f}", logger)
            metrics = evaluate_miou(eval_step, state, test_loader, device, dp)
            writer.add_scalar("Seg/instance_miou", metrics["instance_miou"], epoch)
            print_log(f"[Seg] EPOCH {epoch} inst mIoU={metrics['instance_miou']:.4f} "
                      f"class mIoU={metrics['class_miou']:.4f} "
                      f"acc={metrics['accuracy']:.4f}", logger)
            if metrics["instance_miou"] > best["instance_miou"]:
                best = metrics
                ckpt.save_checkpoint(exp_dir, "ckpt-best", state, epoch, metrics, best,
                                     async_ckpt, generator)
            ckpt.save_checkpoint(exp_dir, "ckpt-last", state, epoch, metrics, best, async_ckpt,
                                 generator)
    finally:
        try:
            ckpt.wait_for_saves()
        finally:
            writer.close()
    barrier()  # rank 0's checkpoints are on disk before any rank returns
    return state, best
