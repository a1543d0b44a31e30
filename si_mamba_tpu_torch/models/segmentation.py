"""ShapeNetPart part-segmentation model.

PyTorch counterpart of ``si_mamba_tpu/models/segmentation.py`` (the
reference's part_segmentation/models/pt_mamba.py ``get_model``): Group
(num_group x group_size) -> PatchEncoder -> pos-embed -> ordering (HLT, SAST
or xyz 'Point_MAMBA') -> Mamba stack with feature taps at ``fetch_idx`` ->
LayerNorm of each tap, concatenated -> global max + mean and the one-hot
label path -> 3-NN inverse-distance propagation of the sequence features
back to every point -> MLP head -> per-point log-probs.

Module names are the reference's state-dict keys (``label_conv``,
``prop_fc1``, ``convs1``, ``bns1``, ... and the classifier's ``encoder``,
``pos_embed``, ``blocks``, ``norm``). ``.train()`` is the JAX model's
``train=True``: BatchNorm on batch statistics (over every point for the
per-point layers), DropPath, the head's fixed Dropout(0.5) and HLT's
tie-break drawing from the ``generator`` passed to ``forward``. In eval the
HLT draw is the JAX trainer's evaluation draw (from ``EVAL_ORDER_KEY``,
reproduced bit for bit), so evaluation repeats and equals the JAX package's
on every device. One HLT draw orders the tokens, their positions and the
centres alike.

``config.dtype`` is the activation dtype, 'float32' or 'bfloat16', with the
JAX model's casts: the encoder and the pos-embed run in it, the eigenvectors
are rounded to it before the ordering, the stack and its norms hand it on.
The head's linear layers take no dtype in the JAX model, so flax promotes
their input to their fp32 parameters: each runs in fp32 on its input as
given (a bf16 one widened), and each BatchNorm after one rounds its output
to the activation dtype. The propagated features stay fp32 (the
interpolation weights are), the points are rounded to the activation dtype
and widened beside them, and the log-probs come back fp32. Parameters,
BatchNorm statistics and the scan state stay fp32.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from si_mamba_tpu_torch.models.embed import (
    ChannelLastBatchNorm,
    Dropout,
    Linear,
    PatchEncoder,
    PosEmbedMLP,
    trunc_normal_,
)
from si_mamba_tpu_torch.models.grouping import group_divider
from si_mamba_tpu_torch.models.layers import Block, LayerNorm, norm_layer
from si_mamba_tpu_torch.models.ordering import hlt_sequence, sast_sequence, xyz_sequence
from si_mamba_tpu_torch.models.point_mamba import DTYPES, order_noise, spectral_eigvecs
from si_mamba_tpu_torch.ops.pointops import pairwise_sqdist
from si_mamba_tpu_torch.ops.spectral import fold_in, prng_key

HEAD_DROPOUT = 0.5  # fixed in the reference's head (pt_mamba.py), no config key
# The raw threefry key of the JAX model's eval HLT draw. The JAX trainer
# evaluates with rngs={'order': jax.random.key(0)}, and the model's one
# make_rng('order') folds into that key the first 4 bytes (big-endian) of the
# SHA-1 of its call count, 1, as flax does.
EVAL_ORDER_KEY = fold_in(prng_key(0), int.from_bytes(hashlib.sha1(b"\x01").digest()[:4], "big"))


@dataclasses.dataclass(frozen=True)
class PartSegConfig:
    """The reference's part-segmentation model keys (cfgs/part_segmentation*.yaml),
    the same fields and defaults as the JAX package's ``PartSegConfig``."""

    trans_dim: int = 384
    depth: int = 12
    cls_dim: int = 50  # part classes
    num_categories: int = 16
    group_size: int = 32
    num_group: int = 128
    encoder_dims: int = 384
    rms_norm: bool = False
    drop_path: float = 0.1
    drop_path_rate: float = 0.1
    drop_out: float = 0.0
    fetch_idx: tuple = (3, 7, 11)
    method: str = "HLT"  # HLT | SAST | Point_MAMBA
    reverse: bool = True
    knn_graph: int = 20
    k_top_eigenvectors: int = 4
    smallest: bool = True
    alpha: float = 10.0
    symmetric: bool = True
    self_loop: bool = False
    binary: bool = True
    matrix: str = "laplacian"
    scan_impl: str = "auto"
    mixer: str = "mamba"  # 'mamba' | 'ssd'
    ssd_chunk: int = 128
    dtype: str = "float32"

    @classmethod
    def from_dict(cls, d) -> "PartSegConfig":
        """Build from a config-model mapping, ignoring non-field keys;
        ``fetch_idx`` may come as a list."""
        d = {k: v for k, v in dict(d).items() if k in cls.__dataclass_fields__}
        if "fetch_idx" in d:
            d["fetch_idx"] = tuple(int(i) for i in d["fetch_idx"])
        return cls(**d)


def _check_supported(cfg: PartSegConfig) -> None:
    if cfg.dtype not in DTYPES:
        raise NotImplementedError(f"dtype={cfg.dtype!r}: the port runs {sorted(DTYPES)}")
    if cfg.method not in ("HLT", "SAST", "Point_MAMBA"):
        raise ValueError(f"unknown method {cfg.method!r}")
    if cfg.mixer not in ("mamba", "ssd"):
        raise ValueError(f"unknown mixer {cfg.mixer!r}")
    if any(not 0 <= i < cfg.depth for i in cfg.fetch_idx):
        raise ValueError(f"fetch_idx {cfg.fetch_idx} is outside the {cfg.depth} blocks")


class MixerModelForSegmentation(nn.Module):
    """The Mamba (or SSD) block stack that returns ``norm_f`` of the
    residual stream (hidden + residual) after each block of ``fetch_idx``;
    every norm an RMSNorm with ``rms_norm``."""

    def __init__(self, d_model: int, n_layer: int, fetch_idx=(3, 7, 11), norm_eps: float = 1e-5,
                 drop_path: float = 0.0, scan_impl: str = "auto", mixer: str = "mamba",
                 ssd_chunk: int = 128, rms_norm: bool = False):
        super().__init__()
        self.fetch_idx = tuple(fetch_idx)
        div = math.sqrt(n_layer)
        self.layers = nn.ModuleList(
            Block(d_model, norm_eps=norm_eps, drop_path=drop_path, out_proj_div=div,
                  scan_impl=scan_impl, mixer=mixer, ssd_chunk=ssd_chunk, rms_norm=rms_norm)
            for _ in range(n_layer))
        self.norm_f = norm_layer(d_model, norm_eps, rms_norm)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for layer in self.layers:
            layer.norm.reset_parameters()
            layer.mixer.reset_parameters(generator)
        self.norm_f.reset_parameters()

    def forward(self, x: torch.Tensor, pos: torch.Tensor,
                generator: torch.Generator | None = None) -> list[torch.Tensor]:
        hidden, residual = x + pos, None
        act = hidden.dtype
        feats = []
        for i, layer in enumerate(self.layers):
            hidden, residual = layer(hidden, residual, generator, dtype=act)
            if i in self.fetch_idx:
                feats.append(self.norm_f(hidden + residual).to(act))
        return feats


def three_nn(xyz1: torch.Tensor, xyz2: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The three nearest of ``xyz2`` (B, S, 3) to each of ``xyz1`` (B, N, 3):
    (squared distances, indices), each (B, N, 3), nearest first. Distances
    by the matmul expansion, so that duplicated points tie bitwise, and ties
    go to the lower index (a stable sort), as ``jax.lax.top_k`` breaks them."""
    d = pairwise_sqdist(xyz1, xyz2)
    dists, idx = torch.sort(d, dim=-1, stable=True)
    return dists[..., :3], idx[..., :3]


def feature_propagation_interp(xyz1: torch.Tensor, xyz2: torch.Tensor,
                               feats2: torch.Tensor) -> torch.Tensor:
    """3-NN inverse-distance interpolation of feats2 (B, S, D) at xyz2
    (B, S, 3) onto xyz1 (B, N, 3) -> (B, N, D)."""
    dists, idx = three_nn(xyz1, xyz2)
    w = 1.0 / (torch.clamp_min(dists, 0.0) + 1e-8)
    w = w / torch.sum(w, dim=-1, keepdim=True)
    B, N, _ = idx.shape
    gathered = torch.gather(feats2, 1, idx.reshape(B, N * 3, 1).expand(-1, -1, feats2.shape[-1]))
    return torch.sum(gathered.reshape(B, N, 3, -1) * w[..., None], dim=2)


class PartSegModel(nn.Module):
    """The part-segmentation model. Built on the CPU from a seeded
    ``torch.Generator`` (seed 0 when none is given); move it with
    ``.to(device)``. In training mode a forward needs a ``generator`` on the
    input's device for its random draws (the head's dropout, DropPath and
    the HLT tie-break)."""

    def __init__(self, config: PartSegConfig, generator: torch.Generator | None = None):
        super().__init__()
        _check_supported(config)
        self.config = cfg = config
        self.dtype = DTYPES[cfg.dtype]
        D = cfg.trans_dim
        self.encoder = PatchEncoder(cfg.encoder_dims)
        self.pos_embed = PosEmbedMLP(D)
        self.blocks = MixerModelForSegmentation(D, cfg.depth, fetch_idx=cfg.fetch_idx,
                                                drop_path=cfg.drop_path,
                                                scan_impl=cfg.scan_impl, mixer=cfg.mixer,
                                                ssd_chunk=cfg.ssd_chunk, rms_norm=cfg.rms_norm)
        self.norm = LayerNorm(D, eps=1e-5)
        n_tap = len(set(cfg.fetch_idx)) * D  # one tap a block, as the stack fetches them
        self.label_conv = Linear(cfg.num_categories, 64, bias=False)
        self.label_bn = ChannelLastBatchNorm(64)
        self.prop_fc1 = Linear(3 + n_tap, 4 * D)
        self.prop_bn1 = ChannelLastBatchNorm(4 * D)
        self.prop_fc2 = Linear(4 * D, 1024)
        self.prop_bn2 = ChannelLastBatchNorm(1024)
        self.convs1 = Linear(1024 + 2 * n_tap + 64, 512)
        self.bns1 = ChannelLastBatchNorm(512)
        self.head_dropout = Dropout(HEAD_DROPOUT)
        self.convs2 = Linear(512, 256)
        self.bns2 = ChannelLastBatchNorm(256)
        self.convs3 = Linear(256, cfg.cls_dim)
        self.reset_parameters(generator or torch.Generator().manual_seed(0))

    def reset_parameters(self, generator: torch.Generator) -> None:
        for m in (self.encoder, self.pos_embed, self.blocks):
            m.reset_parameters(generator)
        for m in (self.label_conv, self.prop_fc1, self.prop_fc2, self.convs1, self.convs2,
                  self.convs3):
            trunc_normal_(m.weight.data, 0.02, generator)
            if m.bias is not None:
                m.bias.data.zero_()
        for m in self.modules():
            if isinstance(m, nn.BatchNorm1d):
                m.reset_parameters()
        self.norm.reset_parameters()

    # -- the pieces of the forward, public so that tests can compose them --
    def embed(self, pts: torch.Tensor):
        """pts (B, N, 3) -> (tokens (B, G, C), pos (B, G, C) in the activation
        dtype, centres (B, G, 3) in the points' dtype)."""
        cfg = self.config
        grouped = group_divider(pts, cfg.num_group, cfg.group_size)
        return (self.encoder(grouped.neighborhood.to(self.dtype)),
                self.pos_embed(grouped.center.to(self.dtype)), grouped.center)

    def sequence(self, tokens, pos, center, eigvecs=None, noise=None,
                 generator: torch.Generator | None = None):
        """Order tokens, positions and centres alike: (x, pos_seq, center_seq).
        The eigenvectors are computed from ``center`` unless given and are
        used as rounded to the activation dtype; HLT's tie-break ``noise``
        (B, G) is drawn by ``order_noise`` unless given."""
        cfg = self.config
        xs = (tokens, pos, center)
        if cfg.method == "Point_MAMBA":
            return xyz_sequence(center, *xs)
        if eigvecs is None:
            _, eigvecs = spectral_eigvecs(center, cfg)
        if cfg.method == "SAST":
            eigvecs = eigvecs.to(self.dtype).to(eigvecs.dtype)
            return sast_sequence(eigvecs, *xs, reverse=cfg.reverse)
        if noise is None:
            noise = order_noise(center.shape[0], center.shape[1], center.device,
                                self.training, generator, EVAL_ORDER_KEY, self.dtype)
        return hlt_sequence(eigvecs.to(self.dtype), cfg.k_top_eigenvectors, noise, *xs)

    def segment(self, x, pos_seq, center_seq, pts, cls_label_onehot,
                generator: torch.Generator | None = None, head_mask=None) -> torch.Tensor:
        """The stack, the global and label features, the propagation to every
        point and the head: log-probs (B, N, cls_dim). ``head_mask`` (B, N,
        512) bool, in training: the head dropout's keep mask instead of a
        draw (for tests that replay another framework's mask)."""
        B, N, _ = pts.shape
        feats = self.blocks(x, pos_seq, generator)
        seq_feat = torch.cat([self.norm(f) for f in feats], dim=-1)  # (B, S, 3D)
        act = seq_feat.dtype
        # the head's layers run in fp32 (JAX: Dense without a dtype), each
        # BatchNorm's output rounded to the activation dtype
        lbl = F.leaky_relu(
            self.label_bn(self.label_conv(cls_label_onehot.to(act).float())).to(act), 0.2)
        global_feat = torch.cat([torch.amax(seq_feat, dim=1), torch.mean(seq_feat, dim=1), lbl],
                                dim=-1)
        f = torch.cat([pts.to(act).float(),
                       feature_propagation_interp(pts, center_seq, seq_feat).float()], dim=-1)
        f = F.relu(self.prop_bn1(self.prop_fc1(f)).to(act))
        f = F.relu(self.prop_bn2(self.prop_fc2(f.float())).to(act))
        h = torch.cat([f, global_feat[:, None, :].expand(B, N, -1)], dim=-1)
        h = F.relu(self.bns1(self.convs1(h.float())).to(act))
        if head_mask is not None and self.training:
            h = torch.where(head_mask, h / (1.0 - HEAD_DROPOUT), torch.zeros_like(h))
        else:
            h = self.head_dropout(h, generator)
        h = F.relu(self.bns2(self.convs2(h.float())).to(act))
        return F.log_softmax(self.convs3(h.float()), dim=-1)

    def forward(self, pts: torch.Tensor, cls_label_onehot: torch.Tensor,
                generator: torch.Generator | None = None, order_noise=None,
                head_mask=None) -> torch.Tensor:
        """pts (B, N, 3), cls_label_onehot (B, num_categories) -> per-point
        log-probs (B, N, cls_dim). ``order_noise`` (B, G): HLT's tie-break
        instead of a draw; ``head_mask``: see :meth:`segment`."""
        tokens, pos, center = self.embed(pts)
        x, pos_seq, center_seq = self.sequence(tokens, pos, center, noise=order_noise,
                                               generator=generator)
        return self.segment(x, pos_seq, center_seq, pts, cls_label_onehot, generator, head_mask)


def nll_loss(log_probs: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean negative log-likelihood over every point (reference ``get_loss``)."""
    return -torch.mean(torch.gather(log_probs, -1, target[..., None].long())[..., 0])
