"""Train state and the classifier's train and eval steps, the counterparts of
``si_mamba_tpu/train/train_state.py``.

The JAX state carries parameters, BatchNorm statistics and optimizer state
as arrays; here the model holds the first two and the optimizer the third,
and a step updates them in place.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Callable

import torch
import torch.nn as nn

from si_mamba_tpu_torch.models.point_mamba import cross_entropy_loss_acc
from si_mamba_tpu_torch.train.optim import Optimizer


@dataclasses.dataclass
class TrainState:
    """The update count ``step``, the model (parameters and BatchNorm
    statistics) and the optimizer (its state and the learning-rate schedule)."""

    step: int
    model: nn.Module
    optimizer: Optimizer

    @classmethod
    def create(cls, model: nn.Module, optimizer: Optimizer) -> "TrainState":
        return cls(step=0, model=model, optimizer=optimizer)

    @property
    def schedule(self) -> Callable[[int], float]:
        return self.optimizer.schedule


def classifier_update(state: TrainState, points: torch.Tensor, labels: torch.Tensor,
                      generator: torch.Generator | None):
    """One train-mode forward (BatchNorm on batch statistics, drop draws from
    ``generator``), mean cross-entropy, backward and optimizer step. Returns
    (state, {"loss", "acc"}) with the metrics as device tensors."""
    model = state.model.train()
    per, acc = cross_entropy_loss_acc(model(points, generator=generator), labels)
    loss = torch.mean(per)
    loss.backward()
    state.optimizer.step()
    state.step += 1
    return state, {"loss": loss.detach(), "acc": acc.detach()}


def make_classifier_train_step(model: nn.Module) -> Callable:
    """Returns train_step(state, points, labels, generator) -> (state, metrics)
    for a state that holds ``model``."""

    def train_step(state: TrainState, points, labels, generator=None):
        if state.model is not model:
            raise ValueError("the train state holds another model than this step's")
        return classifier_update(state, points, labels, generator)

    return train_step


def make_classifier_eval_step(model: nn.Module) -> Callable:
    """Returns eval_step(state, points) -> logits: an eval-mode forward
    (running BatchNorm statistics, no drops, no gradient)."""

    def eval_step(state: TrainState, points):
        if state.model is not model:
            raise ValueError("the train state holds another model than this step's")
        with torch.no_grad():
            return model.eval()(points)

    return eval_step
