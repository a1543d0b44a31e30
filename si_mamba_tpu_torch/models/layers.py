"""Mamba mixers, block and stack as ``nn.Module``s.

PyTorch counterparts of ``MambaMixer``, ``SSDMixer``, ``DropPath``, ``Block``
and ``MixerModel`` in ``si_mamba_tpu/models/layers.py``. The Mamba-1 mixer
has the reference's parameter names (``in_proj``, ``conv1d``, ``x_proj``,
``dt_proj``, ``A_log``, ``D``, ``out_proj``), the SSD mixer mamba-ssm's
Mamba2 names (``in_proj``, ``conv1d``, ``dt_bias``, ``A_log``, ``D``,
``norm.weight``, ``out_proj``). The initialisers take the JAX package's
forms, so a freshly built model has realistic scan dynamics:

- Linear and conv weights U(-1/sqrt(fan_in), 1/sqrt(fan_in));
- dt_proj weight U(+-dt_rank^-1/2); the dt bias (dt_proj's, or the SSD
  mixer's per-head dt_bias) the inverse softplus of a log-uniform dt in
  [1e-3, 0.1];
- Mamba-1: A_log = log(1..d_state) per channel, D = 1; SSD: A_log = log of
  U(1, 16) per head, D = 1 per head, the gated-RMSNorm scale 1;
- out_proj further divided by sqrt(n_layer).

The stack runs in its input's dtype, the activation dtype (float32, or
bfloat16 in perf mode): every LayerNorm computes in fp32 and hands on that
dtype, rounded once, as flax's ``LayerNorm(dtype=...)`` does, and the residual
stream stays in the dtype of what is added to it (``residual_in_fp32`` is
False in the JAX package). The two part only under tensor parallelism at
bf16: the JAX package's tensor-parallel Mamba-1 mixer returns fp32, so from
the first block on the residual stream is fp32 while every norm still hands
on bf16.

With a ``mesh`` and a ``tp_axis`` the mixers are tensor-parallel
(``parallel/tensor_parallel.py``): each rank holds its shard of the mixer's
parameters under the same names (``utils/weights.shard_state_dict``'s
layout), drawn as the single-process mixer's from the same generator and then
cut, so a tensor-parallel model and a single-process one built from one seed
hold the same weights.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from si_mamba_tpu_torch.models.embed import Dropout
from si_mamba_tpu_torch.ops.selective_scan import mamba_mixer_apply
from si_mamba_tpu_torch.ops.ssd import ssd_mixer_apply
from si_mamba_tpu_torch.parallel import draws
from si_mamba_tpu_torch.parallel.mesh import Mesh
from si_mamba_tpu_torch.parallel.tensor_parallel import mamba_mixer_tp, ssd_mixer_tp
from si_mamba_tpu_torch.utils.weights import shard_mixer_state


def _uniform_(t: torch.Tensor, bound: float, generator: torch.Generator) -> torch.Tensor:
    return t.uniform_(-bound, bound, generator=generator)


def _dt_bias(d_inner: int, generator: torch.Generator, dt_min: float = 1e-3,
             dt_max: float = 0.1, floor: float = 1e-4) -> torch.Tensor:
    """Inverse softplus of a log-uniform dt sample (mamba-ssm's dt_proj init)."""
    u = torch.rand(d_inner, generator=generator)
    dt = torch.exp(u * (math.log(dt_max) - math.log(dt_min)) + math.log(dt_min))
    dt = torch.clamp_min(dt, floor)
    return dt + torch.log(-torch.expm1(-dt))


def _tp_size(mesh: Mesh | None, tp_axis: str | None) -> int:
    """The size of the tensor-parallel axis (1 without one); a ``tp_axis``
    needs a mesh that has it."""
    if tp_axis is None:
        return 1
    if mesh is None or tp_axis not in mesh:
        raise ValueError(f"tp_axis={tp_axis!r} needs a mesh with that axis")
    return mesh[tp_axis].size


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` computed in fp32 and returned in the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias,
                            self.eps).to(x.dtype)


class RMSNorm(nn.Module):
    """RMS norm over the last axis, y = x rsqrt(mean(x^2) + eps) weight,
    computed in fp32 and returned in the input's dtype, as flax's
    ``nn.RMSNorm(dtype=...)``; its one parameter ``weight`` is flax's
    ``scale`` (no bias)."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def reset_parameters(self) -> None:
        nn.init.ones_(self.weight)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mul = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + self.eps) * self.weight
        return (xf * mul).to(x.dtype)


def norm_layer(dim: int, eps: float = 1e-5, rms_norm: bool = False) -> nn.Module:
    """The stack's norm: :class:`RMSNorm` with ``rms_norm``, else
    :class:`LayerNorm` (the JAX package's ``norm_cls``)."""
    return RMSNorm(dim, eps) if rms_norm else LayerNorm(dim, eps=eps)


def _load_shard(module: nn.Module, full: nn.Module, kind: str, generator) -> None:
    """Draw ``full``'s (single-process) parameters from ``generator`` and load
    this rank's shard of them into the tensor-parallel ``module``."""
    full.reset_parameters(generator)
    ax = module.mesh[module.tp_axis]
    module.load_state_dict(shard_mixer_state(full.state_dict(), kind, ax.index, ax.size))


class DepthwiseConvWeights(nn.Module):
    """The parameters of the mixer's depthwise ``Conv1d``: weight (d, 1, W)
    and bias (d,). The causal conv itself is in ``mamba_mixer_apply``."""

    def __init__(self, channels: int, width: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(channels, 1, width))
        self.bias = nn.Parameter(torch.empty(channels))


class MambaMixer(nn.Module):
    """Mamba-1 selective-SSM token mixer. ``scan_impl`` picks the route of
    ``mamba_mixer_apply``: 'auto' (the conv and scan kernels K1/K2, K3/K4/K5
    in training, on a CUDA tensor; the plain chunked scan on the CPU),
    'pallas', 'seq' or 'chunked', or 'fused', which runs the whole interior
    between in_proj and out_proj as one kernel (K10; K10 with states and K11
    in training; their plain versions on the CPU), or 'fused_interpret', the
    plain versions of that on any device. With ``mesh`` and ``tp_axis`` it
    is ``mamba_mixer_tp`` on this rank's d_inner / M channels."""

    def __init__(self, d_model: int, d_state: int = 16, d_conv: int = 4, expand: int = 2,
                 dt_rank: int | None = None, out_proj_div: float = 1.0,
                 scan_impl: str = "auto", mesh: Mesh | None = None, tp_axis: str | None = None):
        super().__init__()
        self.d_state = d_state
        self.d_inner = expand * d_model
        self.dt_rank = dt_rank if dt_rank is not None else math.ceil(d_model / 16)
        self.out_proj_div = out_proj_div
        self.scan_impl = scan_impl
        self.mesh, self.tp_axis = mesh, tp_axis
        size = _tp_size(mesh, tp_axis)
        if self.d_inner % size:
            raise ValueError(f"d_inner={self.d_inner} does not split over {size} ranks")
        self._full = dict(d_model=d_model, d_state=d_state, d_conv=d_conv, expand=expand,
                          dt_rank=dt_rank, out_proj_div=out_proj_div)
        d_inner = self.d_inner // size  # this rank's channels
        self.in_proj = nn.Linear(d_model, 2 * d_inner, bias=False)
        self.conv1d = DepthwiseConvWeights(d_inner, d_conv)
        self.x_proj = nn.Linear(d_inner, self.dt_rank + 2 * d_state, bias=False)
        self.dt_proj = nn.Linear(self.dt_rank, d_inner, bias=True)
        self.A_log = nn.Parameter(torch.empty(d_inner, d_state))
        self.D = nn.Parameter(torch.empty(d_inner))
        self.out_proj = nn.Linear(d_inner, d_model, bias=False)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        if self.tp_axis is not None:
            return _load_shard(self, MambaMixer(**self._full), "mamba", generator)
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
        """The parameters in ``mamba_mixer_apply``'s layout (views, no copies);
        under tensor parallelism this rank's shard, the layout of
        ``shard_mixer_params``."""
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
        if self.tp_axis is not None:
            return mamba_mixer_tp(self.params(), x, mesh=self.mesh, d_state=self.d_state,
                                  dt_rank=self.dt_rank, axis=self.tp_axis,
                                  scan_impl=self.scan_impl)
        return mamba_mixer_apply(self.params(), x, d_state=self.d_state,
                                 dt_rank=self.dt_rank, impl=self.scan_impl)


class GatedRMSNormWeight(nn.Module):
    """The scale of the SSD mixer's gated RMSNorm, ``norm.weight`` (d,). The
    norm itself is in ``ssd_mixer_apply``."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim))


class SSDMixer(nn.Module):
    """Scalar-decay SSD token mixer (``ops/ssd.py``), the JAX package's opt-in
    alternative to the Mamba-1 mixer (``PointMambaConfig.mixer='ssd'``):
    d_inner = expand * d_model in heads of head_dim, one B/C group, A one
    scalar per head. ``scan_impl='ssd_fused'`` runs the boundary-fused core
    (K8/K9, with the conv's K1/K5); any other value, the default ``'auto'``
    included, the plain conv and the plain chunked core, as the JAX mixer
    maps it. So on CUDA only ``'ssd_fused'`` launches a kernel; the JAX
    package's ``'xla'`` route on the TPU still runs its Pallas conv. With
    ``mesh`` and ``tp_axis`` it is ``ssd_mixer_tp`` on this rank's block of
    n_heads / M heads ('ssd_fused': K1/K5 and the split core K6/K7). bf16
    activations (the SSD presets) run with its fp32 parameters, cast at each
    matmul as the JAX mixer does, through the kernels' bf16 variants."""

    def __init__(self, d_model: int, d_state: int = 128, d_conv: int = 4, expand: int = 2,
                 head_dim: int = 128, chunk: int = 128, out_proj_div: float = 1.0,
                 scan_impl: str = "auto", mesh: Mesh | None = None, tp_axis: str | None = None):
        super().__init__()
        d_inner = expand * d_model
        self._full = dict(d_model=d_model, d_state=d_state, d_conv=d_conv, expand=expand,
                          head_dim=head_dim, chunk=chunk, out_proj_div=out_proj_div,
                          scan_impl=scan_impl)
        # head_dim must divide d_inner; otherwise the largest divisor below it
        if d_inner % head_dim:
            head_dim = next(d for d in range(min(head_dim, d_inner), 0, -1) if d_inner % d == 0)
        self.d_state, self.d_inner, self.head_dim = d_state, d_inner, head_dim
        self.n_heads = d_inner // head_dim
        self.chunk, self.out_proj_div = chunk, out_proj_div
        self.impl = "ssd_fused" if scan_impl == "ssd_fused" else "xla"
        self.mesh, self.tp_axis = mesh, tp_axis
        size = _tp_size(mesh, tp_axis)
        if self.n_heads % size:
            raise ValueError(f"the tensor-parallel SSD mixer shards whole heads: n_heads="
                             f"{self.n_heads} must be divisible by the '{tp_axis}' axis size "
                             f"{size}")
        h, d_loc = self.n_heads // size, d_inner // size  # this rank's heads and channels
        self.in_proj = nn.Linear(d_model, 2 * d_loc + 2 * d_state + h, bias=False)
        self.conv1d = DepthwiseConvWeights(d_loc + 2 * d_state, d_conv)
        self.dt_bias = nn.Parameter(torch.empty(h))
        self.A_log = nn.Parameter(torch.empty(h))
        self.D = nn.Parameter(torch.empty(h))
        self.norm = GatedRMSNormWeight(d_loc)
        self.out_proj = nn.Linear(d_loc, d_model, bias=False)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        if self.tp_axis is not None:
            return _load_shard(self, SSDMixer(**self._full), "ssd", generator)
        d_model = self.in_proj.in_features
        d_conv = self.conv1d.weight.shape[-1]
        _uniform_(self.in_proj.weight, 1 / math.sqrt(d_model), generator)
        _uniform_(self.conv1d.weight, 1 / math.sqrt(d_conv), generator)
        _uniform_(self.conv1d.bias, 1 / math.sqrt(d_conv), generator)
        self.dt_bias.copy_(_dt_bias(self.n_heads, generator))
        self.A_log.copy_(torch.log(torch.rand(self.n_heads, generator=generator) * 15.0 + 1.0))
        self.D.fill_(1.0)
        self.norm.weight.fill_(1.0)
        _uniform_(self.out_proj.weight, 1 / math.sqrt(self.d_inner), generator)
        self.out_proj.weight.div_(self.out_proj_div)

    def params(self) -> dict:
        """The parameters in ``ssd_mixer_apply``'s layout (views, no copies);
        under tensor parallelism this rank's shard in ``ssd_mixer_tp``'s
        layout (``shard_ssd_mixer_params``)."""
        if self.tp_axis is not None:
            d, n = self.norm.weight.shape[0], self.d_state
            w, cw, cb = self.in_proj.weight, self.conv1d.weight[:, 0, :], self.conv1d.bias
            return {
                "in_proj_z": w[:d].t(), "in_proj_x": w[d:2 * d].t(),
                "in_proj_bc": w[2 * d:2 * d + 2 * n].t(), "in_proj_dt": w[2 * d + 2 * n:].t(),
                "conv_x_w": cw[:d], "conv_x_b": cb[:d], "conv_bc_w": cw[d:], "conv_bc_b": cb[d:],
                "dt_bias": self.dt_bias, "A_log": self.A_log, "D": self.D,
                "norm_scale": self.norm.weight, "out_proj_w": self.out_proj.weight.t(),
            }
        return {
            "in_proj_w": self.in_proj.weight.t(),
            "conv_w": self.conv1d.weight[:, 0, :],
            "conv_b": self.conv1d.bias,
            "dt_bias": self.dt_bias,
            "A_log": self.A_log,
            "D": self.D,
            "norm_scale": self.norm.weight,
            "out_proj_w": self.out_proj.weight.t(),
        }

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp_axis is not None:
            return ssd_mixer_tp(self.params(), x, mesh=self.mesh, n_heads=self.n_heads,
                                d_state=self.d_state, chunk=self.chunk, axis=self.tp_axis,
                                impl=self.impl)
        return ssd_mixer_apply(self.params(), x, n_heads=self.n_heads, d_state=self.d_state,
                               chunk=self.chunk, impl=self.impl)


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
        mask = draws.bernoulli(shape, keep, generator, device=x.device)
        return torch.where(mask.bool(), x / keep, torch.zeros_like(x))


class Block(nn.Module):
    """Add -> norm (LayerNorm, or RMSNorm with ``rms_norm``) -> mixer. Returns
    (mixer output, residual), where the residual is the pre-norm sum; the
    first block takes residual None."""

    def __init__(self, d_model: int, norm_eps: float = 1e-5, drop_path: float = 0.0,
                 out_proj_div: float = 1.0, scan_impl: str = "auto", mixer: str = "mamba",
                 ssd_chunk: int = 128, mesh: Mesh | None = None, tp_axis: str | None = None,
                 rms_norm: bool = False):
        super().__init__()
        self.norm = norm_layer(d_model, norm_eps, rms_norm)
        tp = dict(mesh=mesh, tp_axis=tp_axis)
        if mixer == "ssd":
            self.mixer = SSDMixer(d_model, out_proj_div=out_proj_div, scan_impl=scan_impl,
                                  chunk=ssd_chunk, **tp)
        elif mixer == "mamba":
            self.mixer = MambaMixer(d_model, out_proj_div=out_proj_div, scan_impl=scan_impl, **tp)
        else:
            raise ValueError(f"unknown mixer {mixer!r}")
        self.drop_path = DropPath(drop_path)

    def forward(self, hidden: torch.Tensor, residual: torch.Tensor | None = None,
                generator: torch.Generator | None = None, *, dtype: torch.dtype):
        """``dtype``: the activation dtype, which the norm hands the mixer."""
        residual = hidden if residual is None else self.drop_path(hidden, generator) + residual
        return self.mixer(self.norm(residual).to(dtype)), residual


class MixerModel(nn.Module):
    """Stack of Mamba (or SSD) blocks + final norm (LayerNorm, or RMSNorm
    with ``rms_norm``, as every block's); in training, dropout at
    ``drop_out_in_block`` after every block's mixer output. With ``mesh`` and
    ``tp_axis`` every mixer is tensor-parallel; the rest is replicated."""

    def __init__(self, d_model: int, n_layer: int, norm_eps: float = 1e-5,
                 drop_path: float = 0.0, drop_out_in_block: float = 0.0,
                 scan_impl: str = "auto", mixer: str = "mamba", ssd_chunk: int = 128,
                 mesh: Mesh | None = None, tp_axis: str | None = None,
                 rms_norm: bool = False):
        super().__init__()
        div = math.sqrt(n_layer)  # one residual per layer
        self.layers = nn.ModuleList(
            Block(d_model, norm_eps=norm_eps, drop_path=drop_path, out_proj_div=div,
                  scan_impl=scan_impl, mixer=mixer, ssd_chunk=ssd_chunk, mesh=mesh,
                  tp_axis=tp_axis, rms_norm=rms_norm)
            for _ in range(n_layer))
        self.block_dropout = Dropout(drop_out_in_block)
        self.norm_f = norm_layer(d_model, norm_eps, rms_norm)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for layer in self.layers:
            layer.norm.reset_parameters()
            layer.mixer.reset_parameters(generator)
        self.norm_f.reset_parameters()

    def forward(self, x: torch.Tensor, pos: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        hidden, residual = x + pos, None
        act = hidden.dtype  # the activation dtype; the residual may turn fp32 (see above)
        for layer in self.layers:
            hidden, residual = layer(hidden, residual, generator, dtype=act)
            hidden = self.block_dropout(hidden, generator)
        residual = hidden + residual if residual is not None else hidden
        return self.norm_f(residual).to(act)


class MixerModelAdd(MixerModel):
    """The Mamba-1 stack that re-sorts its tokens after every block (the
    JAX package's ``MixerModelAdd``, the reference's ``MixerModel_add``, the
    classifier's ``add_after_layer``): the block's 2kG-token output is merged
    back to token order (``ordering.cross_merge``: each traversal through its
    inverse order, the k forward and k flipped ones summed), then laid out
    again in the k eigenvector sorts and their flip (``resort_sequence``).
    The residual is carried as it is. Module names are ``MixerModel``'s
    (``layers.{i}``, ``norm_f``), so the same state dict loads."""

    def __init__(self, d_model: int, n_layer: int, norm_eps: float = 1e-5,
                 drop_path: float = 0.0, drop_out_in_block: float = 0.0,
                 scan_impl: str = "auto", rms_norm: bool = False):
        super().__init__(d_model, n_layer, norm_eps=norm_eps, drop_path=drop_path,
                         drop_out_in_block=drop_out_in_block, scan_impl=scan_impl,
                         rms_norm=rms_norm)

    def forward(self, x: torch.Tensor, pos: torch.Tensor, eigvecs: torch.Tensor,
                reverse: bool = True, generator: torch.Generator | None = None) -> torch.Tensor:
        """x, pos (B, 2kG, C) in the SAST layout of ``eigvecs`` (B, G, k)."""
        from si_mamba_tpu_torch.models.ordering import cross_merge, resort_sequence
        from si_mamba_tpu_torch.ops.spectral import sort_orders_by_eigenvectors

        orders = sort_orders_by_eigenvectors(eigvecs)  # the same for every block
        hidden, residual = x + pos, None
        act = hidden.dtype
        for layer in self.layers:
            hidden, residual = layer(hidden, residual, generator, dtype=act)
            hidden = self.block_dropout(hidden, generator)
            hidden = resort_sequence(cross_merge(hidden, orders), orders, reverse=reverse)
        residual = hidden + residual if residual is not None else hidden
        return self.norm_f(residual).to(act)
