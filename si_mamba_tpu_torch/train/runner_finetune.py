"""The classification finetune step with the reference's input pipeline
folded in, the counterpart of ``make_train_step`` in
``si_mamba_tpu/train/runner_finetune.py`` (the reference's batch body,
tools/runner_finetune.py:168-232): FPS-oversample, random subsample, rotate
or scale + translate, forward, loss, backward, update.

The step is two halves, ``make_input_pipeline``'s ``prepare`` and
``finetune_update``, so each can be timed on its own as the step runs it.

A tensor-parallel model (``PointMamba`` with a mesh and ``tp_axis``) runs
the same step on every rank of its model axis: the same points and labels,
and a generator of the same seed for the FPS resampling, the augmentation,
DropPath and the head's dropout, or the replicated activations would part
silently. The step checks that the ranks' generators agree before it draws.
"""

from __future__ import annotations

from collections.abc import Callable

import torch

from si_mamba_tpu_torch.data import transforms
from si_mamba_tpu_torch.models.embed import set_bn_momentum
from si_mamba_tpu_torch.models.point_mamba import PointMamba
from si_mamba_tpu_torch.parallel.collectives import all_gather
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


def check_same_generator(generator: torch.Generator, axis, device) -> None:
    """Raise unless every rank of the mesh axis ``axis`` holds ``generator``
    in the same state (same seed, same draws so far). One all-reduce of the
    generator's state bytes, on ``device``."""
    state = generator.get_state().to(device=device, dtype=torch.float64)
    rows = all_gather(state, axis)
    if not torch.equal(rows.amin(dim=0), rows.amax(dim=0)):
        raise RuntimeError(f"the ranks of the '{axis.name}' axis hold generators in different "
                           f"states: a tensor-parallel step needs one seed on every rank")


def make_train_step(model: PointMamba, npoints: int, rotation: bool) -> Callable:
    """Returns step(state, points, labels, generator, bn_momentum=0.9) ->
    (state, {"loss", "acc"}). ``points`` (B, N, 3) on the model's device;
    ``generator`` on that device drives the resample, the augmentation and
    the drops. ``bn_momentum`` is the flax-convention BatchNorm momentum of
    this epoch (``optim.bn_momentum_schedule``; 0.9 without a scheduler).
    For a tensor-parallel model every step first checks that the ranks of
    its model axis hold the generator in the same state."""
    prepare = make_input_pipeline(npoints, rotation)
    tp = model.tp_sharding()

    def step(state: TrainState, points, labels, generator, bn_momentum: float = 0.9):
        if state.model is not model:
            raise ValueError("the train state holds another model than this step's")
        if tp is not None:
            check_same_generator(generator, tp[0], points.device)
        return finetune_update(state, prepare(points, generator), labels, generator,
                               bn_momentum)

    return step
