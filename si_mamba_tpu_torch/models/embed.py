"""Patch encoder, positional-embedding MLP and classification head.

PyTorch counterparts of ``si_mamba_tpu/models/embed.py``, with the
reference's module names, so that reference state-dict keys load as they
are (``encoder.first_conv.0``, ``pos_embed.2``, ``cls_head_finetune.8``).
The reference's k=1 ``Conv1d`` layers keep their (out, in, 1) weights but
compute as ``F.linear`` over channel-last activations: a float32 convolution
would go through cuDNN in TF32 by default.

BatchNorm here is evaluated with the running statistics (eps 1e-5); the
training-mode statistics wait for the training slice.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


def trunc_normal_(t: torch.Tensor, std: float, generator: torch.Generator) -> torch.Tensor:
    """Normal(0, std) truncated at +-2 std, the form of the JAX package's Dense
    init (its draws differ; exact init parity waits for the training slice)."""
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
        return F.linear(x, self.weight[..., 0], self.bias)


class ChannelLastBatchNorm(nn.BatchNorm1d):
    """``BatchNorm1d`` over the last axis of (..., C) input."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.reshape(-1, x.shape[-1])).reshape(x.shape)


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
        super().__init__(nn.Linear(3, hidden), nn.GELU(), nn.Linear(hidden, out_dim))

    def reset_parameters(self, generator: torch.Generator) -> None:
        _init_linear(self[0], generator)
        _init_linear(self[2], generator)


class ClsHead(nn.Sequential):
    """(Linear, BN, ReLU, Dropout) x 2, then the Linear classifier."""

    def __init__(self, in_dim: int, cls_dim: int, hidden: int = 256, drop: float = 0.5):
        super().__init__(
            nn.Linear(in_dim, hidden), nn.BatchNorm1d(hidden), nn.ReLU(), nn.Dropout(drop),
            nn.Linear(hidden, hidden), nn.BatchNorm1d(hidden), nn.ReLU(), nn.Dropout(drop),
            nn.Linear(hidden, cls_dim))

    def reset_parameters(self, generator: torch.Generator) -> None:
        for i in (0, 4, 8):
            _init_linear(self[i], generator)
