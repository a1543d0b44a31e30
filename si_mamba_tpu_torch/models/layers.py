"""Mamba mixer, block and stack as ``nn.Module``s.

PyTorch counterparts of ``MambaMixer``, ``DropPath``, ``Block`` and
``MixerModel`` in ``si_mamba_tpu/models/layers.py``, with the reference's
parameter names (``in_proj``, ``conv1d``, ``x_proj``, ``dt_proj``, ``A_log``,
``D``, ``out_proj``). The initialisers take the JAX package's forms, so a
freshly built model has realistic scan dynamics:

- Linear and conv weights U(-1/sqrt(fan_in), 1/sqrt(fan_in));
- dt_proj weight U(+-dt_rank^-1/2), bias the inverse softplus of a
  log-uniform dt in [1e-3, 0.1];
- A_log = log(1..d_state) per channel, D = 1;
- out_proj further divided by sqrt(n_layer).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from si_mamba_tpu_torch.models.embed import Dropout
from si_mamba_tpu_torch.ops.selective_scan import mamba_mixer_apply


def _uniform_(t: torch.Tensor, bound: float, generator: torch.Generator) -> torch.Tensor:
    return t.uniform_(-bound, bound, generator=generator)


def _dt_bias(d_inner: int, generator: torch.Generator, dt_min: float = 1e-3,
             dt_max: float = 0.1, floor: float = 1e-4) -> torch.Tensor:
    """Inverse softplus of a log-uniform dt sample (mamba-ssm's dt_proj init)."""
    u = torch.rand(d_inner, generator=generator)
    dt = torch.exp(u * (math.log(dt_max) - math.log(dt_min)) + math.log(dt_min))
    dt = torch.clamp_min(dt, floor)
    return dt + torch.log(-torch.expm1(-dt))


class DepthwiseConvWeights(nn.Module):
    """The parameters of the mixer's depthwise ``Conv1d``: weight (d, 1, W)
    and bias (d,). The causal conv itself is in ``mamba_mixer_apply``."""

    def __init__(self, channels: int, width: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(channels, 1, width))
        self.bias = nn.Parameter(torch.empty(channels))


class MambaMixer(nn.Module):
    """Mamba-1 selective-SSM token mixer."""

    def __init__(self, d_model: int, d_state: int = 16, d_conv: int = 4, expand: int = 2,
                 dt_rank: int | None = None, out_proj_div: float = 1.0,
                 scan_impl: str = "auto"):
        super().__init__()
        self.d_state = d_state
        self.d_inner = expand * d_model
        self.dt_rank = dt_rank if dt_rank is not None else math.ceil(d_model / 16)
        self.out_proj_div = out_proj_div
        self.scan_impl = scan_impl
        d_inner = self.d_inner
        self.in_proj = nn.Linear(d_model, 2 * d_inner, bias=False)
        self.conv1d = DepthwiseConvWeights(d_inner, d_conv)
        self.x_proj = nn.Linear(d_inner, self.dt_rank + 2 * d_state, bias=False)
        self.dt_proj = nn.Linear(self.dt_rank, d_inner, bias=True)
        self.A_log = nn.Parameter(torch.empty(d_inner, d_state))
        self.D = nn.Parameter(torch.empty(d_inner))
        self.out_proj = nn.Linear(d_inner, d_model, bias=False)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        d_model, d_inner = self.in_proj.in_features, self.d_inner
        d_conv = self.conv1d.weight.shape[-1]
        _uniform_(self.in_proj.weight, 1 / math.sqrt(d_model), generator)
        _uniform_(self.conv1d.weight, 1 / math.sqrt(d_conv), generator)
        _uniform_(self.conv1d.bias, 1 / math.sqrt(d_conv), generator)
        _uniform_(self.x_proj.weight, 1 / math.sqrt(d_inner), generator)
        _uniform_(self.dt_proj.weight, self.dt_rank ** -0.5, generator)
        self.dt_proj.bias.copy_(_dt_bias(d_inner, generator))
        self.A_log.copy_(torch.log(torch.arange(1, self.d_state + 1, dtype=torch.float32))
                         .repeat(d_inner, 1))
        self.D.fill_(1.0)
        _uniform_(self.out_proj.weight, 1 / math.sqrt(d_inner), generator)
        self.out_proj.weight.div_(self.out_proj_div)

    def params(self) -> dict:
        """The parameters in ``mamba_mixer_apply``'s layout (views, no copies)."""
        return {
            "in_proj_w": self.in_proj.weight.t(),
            "conv_w": self.conv1d.weight[:, 0, :],
            "conv_b": self.conv1d.bias,
            "x_proj_w": self.x_proj.weight.t(),
            "dt_proj_w": self.dt_proj.weight.t(),
            "dt_proj_b": self.dt_proj.bias,
            "A_log": self.A_log,
            "D": self.D,
            "out_proj_w": self.out_proj.weight.t(),
        }

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mamba_mixer_apply(self.params(), x, d_state=self.d_state,
                                 dt_rank=self.dt_rank, impl=self.scan_impl)


class DropPath(nn.Module):
    """Per-sample stochastic depth (timm semantics); identity in eval. The
    mask draws from the generator passed to ``forward``; training at a rate
    above 0 needs one."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        if self.rate == 0.0 or not self.training:
            return x
        if generator is None:
            raise ValueError("DropPath in training mode needs a torch.Generator")
        keep = 1.0 - self.rate
        shape = (x.shape[0],) + (1,) * (x.ndim - 1)
        mask = torch.empty(shape, device=x.device).bernoulli_(keep, generator=generator)
        return torch.where(mask.bool(), x / keep, torch.zeros_like(x))


class Block(nn.Module):
    """Add -> LayerNorm -> mixer. Returns (mixer output, residual), where the
    residual is the pre-norm sum; the first block takes residual None."""

    def __init__(self, d_model: int, norm_eps: float = 1e-5, drop_path: float = 0.0,
                 out_proj_div: float = 1.0, scan_impl: str = "auto"):
        super().__init__()
        self.norm = nn.LayerNorm(d_model, eps=norm_eps)
        self.mixer = MambaMixer(d_model, out_proj_div=out_proj_div, scan_impl=scan_impl)
        self.drop_path = DropPath(drop_path)

    def forward(self, hidden: torch.Tensor, residual: torch.Tensor | None = None,
                generator: torch.Generator | None = None):
        residual = hidden if residual is None else self.drop_path(hidden, generator) + residual
        return self.mixer(self.norm(residual)), residual


class MixerModel(nn.Module):
    """Stack of Mamba blocks + final LayerNorm; in training, dropout at
    ``drop_out_in_block`` after every block's mixer output."""

    def __init__(self, d_model: int, n_layer: int, norm_eps: float = 1e-5,
                 drop_path: float = 0.0, drop_out_in_block: float = 0.0,
                 scan_impl: str = "auto"):
        super().__init__()
        div = math.sqrt(n_layer)  # one residual per layer
        self.layers = nn.ModuleList(
            Block(d_model, norm_eps=norm_eps, drop_path=drop_path, out_proj_div=div,
                  scan_impl=scan_impl)
            for _ in range(n_layer))
        self.block_dropout = Dropout(drop_out_in_block)
        self.norm_f = nn.LayerNorm(d_model, eps=norm_eps)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for layer in self.layers:
            layer.norm.reset_parameters()
            layer.mixer.reset_parameters(generator)
        self.norm_f.reset_parameters()

    def forward(self, x: torch.Tensor, pos: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        hidden, residual = x + pos, None
        for layer in self.layers:
            hidden, residual = layer(hidden, residual, generator)
            hidden = self.block_dropout(hidden, generator)
        residual = hidden + residual if residual is not None else hidden
        return self.norm_f(residual)
