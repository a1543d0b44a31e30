"""The classification finetune step with the reference's input pipeline
folded in, the counterpart of ``make_train_step`` in
``si_mamba_tpu/train/runner_finetune.py`` (the reference's batch body,
tools/runner_finetune.py:168-232): FPS-oversample, random subsample, rotate
or scale + translate, forward, loss, backward, update.

The step is two halves, ``make_input_pipeline``'s ``prepare`` and
``finetune_update``, so each can be timed on its own as the step runs it.
"""

from __future__ import annotations

from collections.abc import Callable

from si_mamba_tpu_torch.data import transforms
from si_mamba_tpu_torch.models.embed import set_bn_momentum
from si_mamba_tpu_torch.models.point_mamba import PointMamba
from si_mamba_tpu_torch.train.train_state import TrainState, classifier_update


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


def make_train_step(model: PointMamba, npoints: int, rotation: bool) -> Callable:
    """Returns step(state, points, labels, generator, bn_momentum=0.9) ->
    (state, {"loss", "acc"}). ``points`` (B, N, 3) on the model's device;
    ``generator`` on that device drives the resample, the augmentation and
    the drops. ``bn_momentum`` is the flax-convention BatchNorm momentum of
    this epoch (``optim.bn_momentum_schedule``; 0.9 without a scheduler)."""
    prepare = make_input_pipeline(npoints, rotation)

    def step(state: TrainState, points, labels, generator, bn_momentum: float = 0.9):
        if state.model is not model:
            raise ValueError("the train state holds another model than this step's")
        return finetune_update(state, prepare(points, generator), labels, generator,
                               bn_momentum)

    return step
