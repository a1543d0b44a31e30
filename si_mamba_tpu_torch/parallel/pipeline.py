"""The pipeline-parallel mixer stack over a ``pipe`` mesh axis, the
counterpart of the JAX package's ``parallel/pipeline.py``.

The depth of the mixer stack is cut over the ranks of the axis: stage p
holds blocks [p L/P, (p + 1) L/P). The batch streams through the stages in
microbatches, GPipe's schedule: at each of n_micro + P - 1 ticks every stage
applies its blocks to the (hidden, residual) pair it holds, then hands the
pair to the next stage (``collectives.shift``); stage 0 takes microbatch t in
at tick t and the last stage gives microbatch t - (P - 1) out. The block
recurrence is the stack's own: h = x + pos, res = 0; each block res <- h +
res, h <- mixer(norm(res)); the output norm_f(h + res), equal to
``MixerModel`` in eval mode.

Every rank runs the same operations at every tick, the stages that hold no
microbatch on what they hold; the choices (take the input in, give the
output out) are ``torch.where`` on the stage index, so every rank's autograd
graph has the same collectives in the same order and the backward runs on
all of them alike. The gradient flows through autograd: the shifts send the
cotangents back, the output reaches the other ranks through a sum whose
backward is the identity, the input's gradient is summed over the axis.
"""

from __future__ import annotations

import math
from collections.abc import Mapping

import torch
import torch.nn.functional as F

from si_mamba_tpu_torch.ops.selective_scan import mamba_mixer_apply
from si_mamba_tpu_torch.ops.ssd import ssd_mixer_apply
from si_mamba_tpu_torch.parallel.collectives import enter, psum_replicated, shift
from si_mamba_tpu_torch.parallel.mesh import Mesh

# the mixers' state-dict names (the reference's) -> their apply functions'
# keys, with how each tensor is laid out there
_MIXER_KEYMAP = {
    "in_proj.weight": ("in_proj_w", "t"), "conv1d.weight": ("conv_w", "conv"),
    "conv1d.bias": ("conv_b", None), "x_proj.weight": ("x_proj_w", "t"),
    "dt_proj.weight": ("dt_proj_w", "t"), "dt_proj.bias": ("dt_proj_b", None),
    "A_log": ("A_log", None), "D": ("D", None), "out_proj.weight": ("out_proj_w", "t"),
}
_SSD_KEYMAP = {
    "in_proj.weight": ("in_proj_w", "t"), "conv1d.weight": ("conv_w", "conv"),
    "conv1d.bias": ("conv_b", None), "dt_bias": ("dt_bias", None), "A_log": ("A_log", None),
    "D": ("D", None), "norm.weight": ("norm_scale", None),
    "out_proj.weight": ("out_proj_w", "t"),
}


def _layout(t: torch.Tensor, how: str | None) -> torch.Tensor:
    if how == "t":
        return t.t()
    if how == "conv":
        return t[:, 0, :]
    return t


def stack_mixer_params(sd: Mapping[str, torch.Tensor], n_layer: int, n_stages: int,
                       mixer: str = "mamba") -> tuple[dict, dict]:
    """A mixer stack's state dict (``MixerModel.state_dict()``: keys
    ``layers.{i}.norm.*``, ``layers.{i}.mixer.*``, ``norm_f.*``) -> (stacked,
    norm_f): every stacked leaf (``norm_scale``, ``norm_bias`` and the
    ``mixer`` dict in the apply functions' layout) has leading dims
    (n_stages, n_layer // n_stages). Raises unless the stage count divides
    the depth."""
    if n_layer % n_stages != 0:
        raise ValueError(
            f"pipeline stages must divide the stack depth evenly: n_layer={n_layer}, "
            f"n_stages={n_stages} (uneven stage loads would idle the short stages every "
            f"tick)")
    per = n_layer // n_stages
    keymap = _SSD_KEYMAP if mixer == "ssd" else _MIXER_KEYMAP

    def leaf(key, how=None):
        x = torch.stack([_layout(sd[f"layers.{i}.{key}"], how) for i in range(n_layer)])
        return x.reshape((n_stages, per) + x.shape[1:]).clone()

    stacked = {
        "norm_scale": leaf("norm.weight"),
        "norm_bias": leaf("norm.bias"),
        "mixer": {name: leaf(f"mixer.{k}", how) for k, (name, how) in keymap.items()},
    }
    return stacked, {"scale": sd["norm_f.weight"], "bias": sd["norm_f.bias"]}


def take_stage(stacked: dict, stage: int) -> dict:
    """Stage ``stage``'s slice of :func:`stack_mixer_params`'s stack: leaves
    with leading dim layers-per-stage."""
    return {"norm_scale": stacked["norm_scale"][stage],
            "norm_bias": stacked["norm_bias"][stage],
            "mixer": {k: v[stage] for k, v in stacked["mixer"].items()}}


def _layer_norm(x, scale, bias, eps):
    return F.layer_norm(x.float(), (x.shape[-1],), scale, bias, eps).to(x.dtype)


def _stage_apply(stage: dict, h, res, *, d_state, dt_rank, scan_impl, norm_eps, mixer,
                 ssd_chunk):
    """This stage's blocks on the (h, res) pair."""
    for i in range(stage["norm_scale"].shape[0]):
        res = h + res
        hn = _layer_norm(res, stage["norm_scale"][i], stage["norm_bias"][i], norm_eps)
        lp = {k: v[i] for k, v in stage["mixer"].items()}
        if mixer == "ssd":
            d_inner = lp["out_proj_w"].shape[0]
            h = ssd_mixer_apply(lp, hn, n_heads=lp["A_log"].shape[0],
                                d_state=(lp["conv_w"].shape[0] - d_inner) // 2,
                                chunk=ssd_chunk,
                                impl="ssd_fused" if scan_impl == "ssd_fused" else "xla")
        else:
            h = mamba_mixer_apply(lp, hn, d_state=d_state, dt_rank=dt_rank, impl=scan_impl)
    return h, res


def pipeline_mixer_apply(stage: dict, norm_f: dict, x: torch.Tensor, *, mesh: Mesh,
                         axis: str = "pipe", n_micro: int, d_state: int = 16,
                         dt_rank: int | None = None, scan_impl: str = "auto",
                         norm_eps: float = 1e-5, mixer: str = "mamba",
                         ssd_chunk: int = 128) -> torch.Tensor:
    """The whole mixer stack on x = tokens + pos, (B, L, D) with B % n_micro
    == 0, the same on every rank of ``axis``; ``stage``: this rank's stage
    (``take_stage(stacked, mesh[axis].index)``, or the stack of a state dict
    from ``utils/weights.stage_state_dict``). Returns norm_f(h + res) (B, L,
    D) on every rank, ``MixerModel``'s output in eval mode. Every rank of the
    axis must call it with the same shapes; the gradient flows to each rank's
    stage and, summed over the ranks, to ``x``."""
    ax = mesh[axis]
    B, L, D = x.shape
    if B % n_micro:
        raise ValueError(f"the batch {B} must split into n_micro={n_micro} microbatches")
    mb, nst = B // n_micro, ax.size
    if dt_rank is None:
        dt_rank = math.ceil(D / 16)
    xs = enter(x, ax).reshape(n_micro, mb, L, D)
    first = torch.tensor(ax.index == 0, device=x.device)
    last = torch.tensor(ax.index == nst - 1, device=x.device)
    pair = x.new_zeros((2, mb, L, D))
    outs = []
    for t in range(n_micro + nst - 1):
        if t < n_micro:
            inject = torch.stack([xs[t], torch.zeros_like(xs[t])])
            pair = torch.where(first, inject, pair)
        h, res = _stage_apply(stage, pair[0], pair[1], d_state=d_state, dt_rank=dt_rank,
                              scan_impl=scan_impl, norm_eps=norm_eps, mixer=mixer,
                              ssd_chunk=ssd_chunk)
        if t >= nst - 1:
            outs.append(torch.where(last, h + res, torch.zeros_like(h)))
        if t < n_micro + nst - 2:
            pair = shift(torch.stack([h, res]), ax, 1)
    y = psum_replicated(torch.cat(outs).float(), ax).to(x.dtype)
    return _layer_norm(y, norm_f["scale"], norm_f["bias"], norm_eps)


def pipeline_pointmamba_logits(model, pts: torch.Tensor, *, mesh: Mesh, axis: str = "pipe",
                               n_micro: int, stage: dict | None = None) -> torch.Tensor:
    """The ``PointMamba`` classifier's eval forward with its mixer stack
    pipelined over ``axis``: grouping, the patch encoder, the position
    embedding and the ordering run on every rank (a few per cent of the
    work), the blocks stream through the stages, then the final norm, the
    mean over the tokens and the head. Equal to ``model.eval()(pts)``.
    ``stage``: this rank's stage of the blocks (taken from ``model.blocks``
    when None). pts (B, N, 3), B % n_micro == 0."""
    cfg = model.config
    if cfg.add_after_layer or cfg.rms_norm or cfg.tp_axis is not None:
        raise NotImplementedError(
            f"pipeline_pointmamba_logits covers the plain MixerModel stack only "
            f"(add_after_layer={cfg.add_after_layer}, rms_norm={cfg.rms_norm}, "
            f"tp_axis={cfg.tp_axis!r})")
    if model.dtype != torch.float32:
        raise NotImplementedError(f"pipeline_pointmamba_logits runs fp32 only (dtype="
                                  f"{cfg.dtype})")
    model = model.eval()
    ax = mesh[axis]
    if stage is None:
        stacked, _ = stack_mixer_params(model.blocks.state_dict(), cfg.depth, ax.size,
                                        cfg.mixer)
        stage = take_stage(stacked, ax.index)
    blocks = model.blocks
    norm_f = {"scale": blocks.norm_f.weight, "bias": blocks.norm_f.bias}
    tokens, pos, center = model.embed(pts)
    x, pos_seq = model.sequence(tokens, pos, center)
    mixer0 = blocks.layers[0].mixer
    h = pipeline_mixer_apply(stage, norm_f, x + pos_seq, mesh=mesh, axis=axis, n_micro=n_micro,
                             d_state=getattr(mixer0, "d_state", 16),
                             dt_rank=getattr(mixer0, "dt_rank", None), scan_impl=cfg.scan_impl,
                             norm_eps=blocks.norm_f.eps, mixer=cfg.mixer,
                             ssd_chunk=cfg.ssd_chunk)
    feat = torch.mean(model.norm(h), dim=1)
    return model.cls_head_finetune(feat)
