"""Patch encoder, positional-embedding MLP and classification head.

PyTorch counterparts of ``si_mamba_tpu/models/embed.py``, with the
reference's module names, so that reference state-dict keys load as they
are (``encoder.first_conv.0``, ``pos_embed.2``, ``cls_head_finetune.8``).
The reference's k=1 ``Conv1d`` layers keep their (out, in, 1) weights but
compute as ``F.linear`` over channel-last activations: a float32 convolution
would go through cuDNN in TF32 by default.

BatchNorm is torch's own ``BatchNorm1d`` (eps 1e-5): in training mode it
normalises with the biased batch variance and folds the unbiased one into
the running statistics, the semantics of the JAX package's
``TorchBatchNorm``; torch's momentum is 1 - the flax retention factor
(:func:`set_bn_momentum`). Under data parallelism (``data_axis``, set by
``parallel.set_data_axis``) the training statistics are those of the global
batch, as the JAX step over a data mesh takes them
(:class:`ChannelLastBatchNorm`). Dropout draws from a generator that the
caller passes (:class:`Dropout`).

Every layer runs in its input's dtype (float32, or bfloat16 in perf mode),
with the JAX modules' rounding points at ``dtype=bfloat16``: a linear layer
casts its fp32 weight and bias to the input's dtype (flax ``Dense``); a
BatchNorm takes its statistics, normalises and applies its affine in fp32
and rounds once (``TorchBatchNorm``), its running statistics fp32.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from si_mamba_tpu_torch.parallel import draws
from si_mamba_tpu_torch.parallel.collectives import psum
from si_mamba_tpu_torch.parallel.mesh import batch_axis


def trunc_normal_(t: torch.Tensor, std: float, generator: torch.Generator) -> torch.Tensor:
    """Normal(0, std) truncated at +-2 std, the form of the JAX package's Dense
    init. The two frameworks draw from different streams, so initialisers
    agree in form and statistics; parity tests carry weights across."""
    return nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std, generator=generator)


class PointwiseConv(nn.Module):
    """A k=1 ``Conv1d``'s parameters, (out, in, 1) weight and (out,) bias,
    applied to channel-last input as ``F.linear``."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, 1))
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def reset_parameters(self, generator: torch.Generator) -> None:
        trunc_normal_(self.weight.data, 0.02, generator)
        self.bias.data.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight[..., 0].to(x.dtype), self.bias.to(x.dtype))


class Linear(nn.Linear):
    """``nn.Linear`` in its input's dtype: weight and bias are cast to it, as
    flax's ``Dense(dtype=...)`` casts its fp32 parameters."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


class Dropout(nn.Module):
    """Inverted dropout whose mask draws from a ``torch.Generator`` passed to
    ``forward`` (``nn.Dropout`` reads the global generator); identity in eval
    or at rate 0."""

    def __init__(self, p: float):
        super().__init__()
        self.p = p

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        if self.p == 0.0 or not self.training:
            return x
        if generator is None:
            raise ValueError("dropout in training mode needs a torch.Generator")
        keep = 1.0 - self.p
        mask = draws.bernoulli(x.shape, keep, generator, device=x.device, dtype=x.dtype)
        return x * mask / keep


def set_bn_momentum(module: nn.Module, momentum: float) -> None:
    """Set every BatchNorm's running-average momentum from the flax-convention
    retention factor ``momentum`` (torch momentum = 1 - momentum): the
    counterpart of the JAX model's ``bn_momentum=`` argument, fed once per
    epoch from ``train.optim.bn_momentum_schedule``."""
    for m in module.modules():
        if isinstance(m, nn.modules.batchnorm._BatchNorm):
            m.momentum = 1.0 - float(momentum)


class ChannelLastBatchNorm(nn.BatchNorm1d):
    """``BatchNorm1d`` over the last axis of (..., C) input, computed in fp32
    (statistics, normalisation, affine) and returned in the input's dtype.

    ``data_axis``: the mesh axis the batch is sharded over. In training with
    an axis of more than one rank the mean and the biased variance are those
    of the rows of every rank, in two passes (the sum of x, then of (x -
    mean)^2, each summed over the axis by ``collectives.psum``, whose
    backward sums the cotangents too), and the running variance takes the
    unbiased estimate over the global row count, as torch's BatchNorm and the
    JAX ``TorchBatchNorm`` do. Otherwise it is torch's ``BatchNorm1d``. Over
    a world of several ranks an unset axis raises in training
    (``parallel.mesh.batch_axis``)."""

    data_axis = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x2 = x.reshape(-1, x.shape[-1]).float()
        axis = batch_axis(self) if self.training else None
        y = super().forward(x2) if axis is None else self._global(x2, axis)
        return y.reshape(x.shape).to(x.dtype)

    def _global(self, x: torch.Tensor, axis) -> torch.Tensor:
        count = x.new_full((1,), x.shape[0])
        sums = psum(torch.cat([x.sum(dim=0), count]), axis)
        n = sums[-1]
        mean = sums[:-1] / n
        var = psum(torch.sum((x - mean) ** 2, dim=0), axis) / n
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1 - m).add_(mean.detach(), alpha=m)
            unbiased = var.detach() * (n / torch.clamp(n - 1, min=1))
            self.running_var.mul_(1 - m).add_(unbiased, alpha=m)
            self.num_batches_tracked.add_(1)
        return (x - mean) * torch.rsqrt(var + self.eps) * self.weight + self.bias


def _init_linear(m: nn.Linear, generator: torch.Generator) -> None:
    trunc_normal_(m.weight.data, 0.02, generator)
    m.bias.data.zero_()


class PatchEncoder(nn.Module):
    """PointNet-style per-group encoder: (B, G, n, 3) -> (B, G, C)."""

    def __init__(self, encoder_channel: int):
        super().__init__()
        self.encoder_channel = encoder_channel
        self.first_conv = nn.Sequential(PointwiseConv(3, 128), ChannelLastBatchNorm(128),
                                        nn.ReLU(), PointwiseConv(128, 256))
        self.second_conv = nn.Sequential(PointwiseConv(512, 512), ChannelLastBatchNorm(512),
                                         nn.ReLU(), PointwiseConv(512, encoder_channel))

    def reset_parameters(self, generator: torch.Generator) -> None:
        for m in self.modules():
            if isinstance(m, PointwiseConv):
                m.reset_parameters(generator)

    def forward(self, point_groups: torch.Tensor) -> torch.Tensor:
        B, G, n, _ = point_groups.shape
        x = self.first_conv(point_groups.reshape(B * G, n, 3))  # (BG, n, 256)
        g = torch.amax(x, dim=1, keepdim=True)  # per-group global feature
        x = torch.cat([g.expand_as(x), x], dim=-1)  # (BG, n, 512)
        x = self.second_conv(x)
        return torch.amax(x, dim=1).reshape(B, G, self.encoder_channel)


class PosEmbedMLP(nn.Sequential):
    """3 -> 128 -> GELU (exact erf) -> d MLP over centres."""

    def __init__(self, out_dim: int, hidden: int = 128):
        super().__init__(Linear(3, hidden), nn.GELU(), Linear(hidden, out_dim))

    def reset_parameters(self, generator: torch.Generator) -> None:
        _init_linear(self[0], generator)
        _init_linear(self[2], generator)


class ClsHead(nn.Sequential):
    """(Linear, BN, ReLU, Dropout) x 2, then the Linear classifier."""

    def __init__(self, in_dim: int, cls_dim: int, hidden: int = 256, drop: float = 0.5):
        super().__init__(
            Linear(in_dim, hidden), ChannelLastBatchNorm(hidden), nn.ReLU(), Dropout(drop),
            Linear(hidden, hidden), ChannelLastBatchNorm(hidden), nn.ReLU(), Dropout(drop),
            Linear(hidden, cls_dim))

    def reset_parameters(self, generator: torch.Generator) -> None:
        for i in (0, 4, 8):
            _init_linear(self[i], generator)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        for m in self:
            x = m(x, generator) if isinstance(m, Dropout) else m(x)
        return x
