"""Point-MAE-Mamba, the pretraining model.

PyTorch counterpart of ``si_mamba_tpu/models/point_mae.py``'s wavelet-Sinkhorn
path (the reference's ``Point_MAE_Mamba`` with ``method:
smallest_eigenvectors_seperate_learnable_tokens``): FPS + kNN groups; K
traversal orders from the diffusion-wavelet scores of the centres' kNN graph,
sorted by Sinkhorn and rounded to hard permutations; a fixed-count random
mask; the encoder stack over each traversal's visible tokens (and their
reverse); the learnable mask tokens restored into the traversal slots; the
decoder stack; the masked groups' points rebuilt from their tokens and held to
the truth by the Chamfer loss.

The permutations act by index gather with the Sinkhorn matrix supplying the
gradient (the reference's ``P_hard + P_hat - P_hat.detach()`` product): a
token's gradient flows through the gather alone, the scores' through the soft
product over the detached tokens.

Module names are the reference's state-dict keys: ``MAE_encoder.{encoder,
pos_embed, blocks, norm}``, ``MAE_decoder.{blocks, norm}``, ``mask_token``,
``increase_dim.0`` and ``diff_sgwt``. ``.train()`` is the JAX model's
``train=True``: BatchNorm on batch statistics, DropPath, the Gumbel noise and
the straight-through permutations. The random draws (the mask's and the
Gumbel noise's uniforms, DropPath's) come from the ``generator`` passed to
``forward``, or the mask's and the noise's as explicit tensors; an eval
forward without either draws the mask as the JAX model does without a 'mask'
stream, ``jax.random.uniform`` of ``jax.random.key(0)``, bit for bit.

``config.dtype`` 'bfloat16' is perf mode's activation dtype, with the JAX
model's rounding points: the patch encoder, pos-embed, both stacks and their
norms at bf16; the orders, the wavelet module's layers, the rebuild layer
and the loss at fp32.

``method: MAMBA`` is the legacy path (the reference's MaskMamba, MambaDecoder
and Point_MAE_Mamba's MAMBA branch, the JAX package's ``_legacy_mae``): the
plain random or block mask, the visible tokens in their original order
through the encoder stack, the decoder over [visible, mask tokens] with its
own position embedding (``decoder_pos_embed.{0,2}``), the last n_mask tokens
rebuilt. That model has no ``diff_sgwt``. ``rms_norm`` makes every norm of
both stacks an RMSNorm (their final norms ``norm`` stay LayerNorms, as in
JAX); ``loss: emd`` is the Sinkhorn EMD of ``ops/emd.py`` on the wavelet path
(the legacy path, as JAX's, takes Chamfer-L1 for any loss but cdl2).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn as nn

from si_mamba_tpu_torch.models.embed import PatchEncoder, PointwiseConv, PosEmbedMLP
from si_mamba_tpu_torch.models.grouping import Grouped, group_divider
from si_mamba_tpu_torch.models.layers import LayerNorm, MixerModel
from si_mamba_tpu_torch.models.point_mamba import DTYPES
from si_mamba_tpu_torch.ops.chamfer import chamfer_l1, chamfer_l2
from si_mamba_tpu_torch.ops.emd import emd_sinkhorn
from si_mamba_tpu_torch.parallel import draws
from si_mamba_tpu_torch.ops.graph import knn_adjacency, rw_laplacian
from si_mamba_tpu_torch.ops.sinkhorn import greedy_round, hungarian_round, sinkhorn_soft_perm
from si_mamba_tpu_torch.ops.spectral import prng_key, uniform
from si_mamba_tpu_torch.ops.wavelets import (
    SOLVERS,
    DiffusionWaveletSGWT,
    scale_scores,
    wavelet_projections,
)

LEGACY = "MAMBA"
SST = "smallest_eigenvectors_seperate_learnable_tokens"


@dataclasses.dataclass(frozen=True)
class PointMAEConfig:
    """The pretraining model's keys (cfgs/pretrain.yaml's model block), the
    fields and defaults of the JAX package's ``PointMAEConfig``."""

    trans_dim: int = 384
    encoder_dims: int = 384
    depth: int = 12
    decoder_depth: int = 4
    group_size: int = 32
    num_group: int = 64
    mask_ratio: float = 0.6
    mask_type: str = "rand"
    drop_path_rate: float = 0.1
    rms_norm: bool = False
    loss: str = "cdl2"
    method: str = "smallest_eigenvectors_seperate_learnable_tokens"
    reverse: bool = True
    knn_graph: int = 20
    k_top_eigenvectors: int = 4
    smallest: bool = True
    alpha: float = 10.0
    symmetric: bool = True
    self_loop: bool = False
    binary: bool = True
    wavelet_J: int = 3
    sinkhorn_epsilon: float = 0.05
    sinkhorn_iters: int = 40
    sinkhorn_rounding: str = "greedy"  # 'hungarian': scipy on the host
    # 'sorted': differentiable sorting; 'self': the reference's cost against
    # the unsorted scores, whose plan is the identity (parity_preset)
    sinkhorn_target: str = "sorted"
    scan_impl: str = "auto"
    mixer: str = "mamba"
    ssd_chunk: int = 128
    wavelet_solver: str = "eigh"  # 'eigh' | 'jacobi' | 'subspace'
    dtype: str = "float32"

    @property
    def num_mask(self) -> int:
        return int(self.mask_ratio * self.num_group)

    @property
    def num_vis(self) -> int:
        return self.num_group - self.num_mask

    def parity_preset(self) -> "PointMAEConfig":
        """The published behaviour: Sinkhorn against the scores themselves
        (the identity plan) rounded by Hungarian assignment."""
        return dataclasses.replace(self, sinkhorn_target="self", sinkhorn_rounding="hungarian")

    @classmethod
    def from_dict(cls, d) -> "PointMAEConfig":
        """From a config's model mapping: the ``transformer_config`` entries,
        then the model's own keys over them (the JAX runner's merge), every
        non-field key ignored."""
        d = dict(d)
        fields = cls.__dataclass_fields__
        kw = {k: v for k, v in dict(d.get("transformer_config") or {}).items() if k in fields}
        kw.update({k: v for k, v in d.items() if k in fields})
        return cls(**kw)


def _check_supported(cfg: PointMAEConfig) -> None:
    if cfg.method not in (SST, LEGACY):
        raise ValueError(f"unknown method {cfg.method!r}")
    if cfg.loss not in ("cdl2", "cdl1", "emd"):
        raise NotImplementedError(cfg.loss)
    if cfg.dtype not in DTYPES:
        raise NotImplementedError(f"dtype={cfg.dtype!r}: the port runs {sorted(DTYPES)}")
    if cfg.mask_type not in ("rand", "block"):
        raise ValueError(f"unknown mask_type {cfg.mask_type!r}")
    if cfg.sinkhorn_rounding not in ("greedy", "hungarian"):
        raise ValueError(f"unknown rounding {cfg.sinkhorn_rounding!r}")
    if cfg.wavelet_solver not in SOLVERS:
        raise ValueError(f"wavelet solver {cfg.wavelet_solver!r} not in {SOLVERS}")
    if cfg.method == SST and cfg.k_top_eigenvectors > cfg.wavelet_J + 1:
        raise ValueError("k_top_eigenvectors traversals need as many of the wavelet_J + 1 scales")


def random_mask(B: int, G: int, num_mask: int, device=None,
                generator: torch.Generator | None = None,
                uniform_draw: torch.Tensor | None = None) -> torch.Tensor:
    """(B, G) float mask with exactly num_mask ones a row: the num_mask
    smallest of U(0, 1) scores (``uniform_draw``, or drawn from
    ``generator``), ties to the first index."""
    scores = uniform_draw
    if scores is None:
        scores = draws.rand((B, G), generator, device=device)
    ranks = torch.argsort(torch.argsort(scores, dim=-1, stable=True), dim=-1, stable=True)
    return (ranks < num_mask).float()


def block_mask(center: torch.Tensor, num_mask: int, generator: torch.Generator | None = None,
               seed: torch.Tensor | None = None) -> torch.Tensor:
    """(B, G) mask of the num_mask groups nearest a random seed group
    (``seed`` (B,) indices, or drawn from ``generator``)."""
    B, G, _ = center.shape
    if seed is None:
        seed = draws.randint(0, G, (B,), generator, device=center.device)
    seed_pt = torch.gather(center, 1, seed.long()[:, None, None].expand(B, 1, 3))
    d = torch.linalg.norm(center - seed_pt, dim=-1)
    ranks = torch.argsort(torch.argsort(d, dim=-1, stable=True), dim=-1, stable=True)
    return (ranks < num_mask).float()


def _take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, S, ...) rows at idx (B, T) -> (B, T, ...)."""
    shape = idx.shape + x.shape[2:]
    idx = idx.reshape(idx.shape + (1,) * (x.ndim - 2)).expand(shape)
    return torch.gather(x, 1, idx)


def restore_tokens(mask_sorted: torch.Tensor, vis_tokens: torch.Tensor,
                   mask_tokens: torch.Tensor) -> torch.Tensor:
    """Fill a traversal-ordered canvas: masked slots (mask_sorted (B, S) 0/1)
    take the next of ``mask_tokens`` (B, n_mask, C), visible slots the next of
    ``vis_tokens`` (B, n_vis, C). Returns (B, S, C)."""
    m = mask_sorted
    # a slot's rank among the masked / visible slots before it; past the last
    # masked (visible) slot it names no token, and the other branch is taken
    mask_rank = (torch.cumsum(m, dim=-1) - m).long()
    vis_rank = (torch.cumsum(1.0 - m, dim=-1) - (1.0 - m)).long()
    from_vis = _take_rows(vis_tokens, vis_rank.clamp_max(vis_tokens.shape[1] - 1))
    if mask_tokens.shape[1] == 0:
        return from_vis
    from_mask = _take_rows(mask_tokens, mask_rank.clamp_max(mask_tokens.shape[1] - 1))
    return torch.where(m[..., None] > 0.5, from_mask, from_vis)


def select_by_rank(x: torch.Tensor, mask: torch.Tensor, count: int,
                   masked: bool) -> torch.Tensor:
    """The ``count`` masked (or visible) rows of x (B, S, C) in order: a
    stable argsort of the 0/1 mask puts visible positions first, masked
    after."""
    order = torch.argsort(mask, dim=-1, stable=True)
    idx = order[:, -count:] if masked else order[:, :count]
    return _take_rows(x, idx)


class MAEEncoder(nn.Module):
    """Patch encoder, pos-embed, the encoder stack and its norm (the
    reference's MaskMamba_2 keys)."""

    def __init__(self, cfg: PointMAEConfig):
        super().__init__()
        self.encoder = PatchEncoder(cfg.encoder_dims)
        self.pos_embed = PosEmbedMLP(cfg.trans_dim)
        self.blocks = MixerModel(cfg.trans_dim, cfg.depth, drop_path=cfg.drop_path_rate,
                                 scan_impl=cfg.scan_impl, mixer=cfg.mixer,
                                 ssd_chunk=cfg.ssd_chunk, rms_norm=cfg.rms_norm)
        self.norm = LayerNorm(cfg.trans_dim, eps=1e-5)


class MAEDecoder(nn.Module):
    """The decoder stack and its norm (the reference's MambaDecoder_SST, or
    MambaDecoder on the legacy path)."""

    def __init__(self, cfg: PointMAEConfig):
        super().__init__()
        self.blocks = MixerModel(cfg.trans_dim, cfg.decoder_depth, drop_path=cfg.drop_path_rate,
                                 scan_impl=cfg.scan_impl, mixer=cfg.mixer,
                                 ssd_chunk=cfg.ssd_chunk, rms_norm=cfg.rms_norm)
        self.norm = LayerNorm(cfg.trans_dim, eps=1e-5)


@dataclasses.dataclass
class Encoded:
    """What the decoder takes from the encoder: ``x_vis`` (B, T_vis, C) the
    encoded visible tokens (and their reverse), ``pos_full`` (B, T, C) every
    traversal slot's position embedding (and the reverse), ``mask_flat``
    (B, K G) 0/1 and ``flat_idx`` (B, K G) each slot's group, in traversal
    order."""

    x_vis: torch.Tensor
    pos_full: torch.Tensor
    mask_flat: torch.Tensor
    flat_idx: torch.Tensor


class PointMAEMamba(nn.Module):
    """The pretraining model. Built on the CPU from a seeded
    ``torch.Generator`` (seed 0 when none is given), or on the device of a
    ``torch.device`` context with a generator there."""

    def __init__(self, config: PointMAEConfig, generator: torch.Generator | None = None):
        super().__init__()
        _check_supported(config)
        self.config = cfg = config
        self.dtype = DTYPES[cfg.dtype]
        self.MAE_encoder = MAEEncoder(cfg)
        self.MAE_decoder = MAEDecoder(cfg)
        self.mask_token = nn.Parameter(torch.zeros(1, 1, cfg.trans_dim))
        self.increase_dim = nn.Sequential(PointwiseConv(cfg.trans_dim, 3 * cfg.group_size))
        self.legacy = cfg.method == LEGACY
        if self.legacy:
            self.decoder_pos_embed = PosEmbedMLP(cfg.trans_dim)
        else:
            self.diff_sgwt = DiffusionWaveletSGWT(J=cfg.wavelet_J, in_features=3,
                                                  dtype=self.dtype)
        self.reset_parameters(generator or torch.Generator().manual_seed(0))

    def reset_parameters(self, generator: torch.Generator) -> None:
        enc = self.MAE_encoder
        last = self.decoder_pos_embed if self.legacy else self.diff_sgwt
        for m in (enc.encoder, enc.pos_embed, enc.blocks, self.MAE_decoder.blocks,
                  self.increase_dim[0], last):
            m.reset_parameters(generator)
        for m in self.modules():
            if isinstance(m, nn.BatchNorm1d):
                m.reset_parameters()
        enc.norm.reset_parameters()
        self.MAE_decoder.norm.reset_parameters()
        nn.init.trunc_normal_(self.mask_token.data, std=0.02, a=-0.04, b=0.04,
                              generator=generator)

    # -- the pieces of the forward, public so that tests and timings can
    # compose them --
    def group(self, pts: torch.Tensor) -> Grouped:
        return group_divider(pts, self.config.num_group, self.config.group_size)

    def laplacian(self, center: torch.Tensor) -> torch.Tensor:
        """The random-walk Laplacian (B, G, G) of the centres' kNN graph."""
        cfg = self.config
        A = knn_adjacency(center.float(), k=cfg.knn_graph, alpha=cfg.alpha,
                          symmetric=cfg.symmetric, self_loop=cfg.self_loop, binary=cfg.binary,
                          gaussian_sigma=(cfg.alpha == 0))
        return rw_laplacian(A, eps=1e-6, eps_mode="clamp")

    def scores(self, center: torch.Tensor, PJ: torch.Tensor, tau: float | None = None,
               generator: torch.Generator | None = None,
               gumbel_uniform: torch.Tensor | None = None) -> torch.Tensor:
        """The K traversals' scores (B, G, K) of the centres from the wavelet
        projections PJ; in training with tau-scaled Gumbel noise."""
        coeffs = self.diff_sgwt(center.float(), PJ, tau=tau, deterministic=not self.training,
                                generator=generator, gumbel_uniform=gumbel_uniform)
        return scale_scores(coeffs, k=self.config.k_top_eigenvectors)

    def soft_perm(self, scores: torch.Tensor) -> torch.Tensor:
        """The Sinkhorn matrices P_hat (B, K, G, G) of the scores (B, G, K)."""
        cfg = self.config
        return sinkhorn_soft_perm(scores.transpose(1, 2), cfg.sinkhorn_epsilon,
                                  cfg.sinkhorn_iters, target=cfg.sinkhorn_target)

    def round_perm(self, P_hat: torch.Tensor) -> torch.Tensor:
        """The hard orders (B, K, G) int64 rounded from P_hat."""
        rnd = greedy_round if self.config.sinkhorn_rounding == "greedy" else hungarian_round
        return torch.argmax(rnd(P_hat), dim=-1)

    def orders(self, center: torch.Tensor, tau: float | None = None,
               generator: torch.Generator | None = None,
               gumbel_uniform: torch.Tensor | None = None):
        """Traversal orders of the centres (B, G, 3): (order_idx (B, K, G)
        int64, P_hat (B, K, G, G) the Sinkhorn matrices). In training the
        scores take tau-scaled Gumbel noise and P_hat keeps its gradient into
        ``diff_sgwt``."""
        cfg = self.config
        PJ = wavelet_projections(self.laplacian(center), cfg.wavelet_J, cfg.wavelet_solver)
        P_hat = self.soft_perm(self.scores(center, PJ, tau, generator, gumbel_uniform))
        return self.round_perm(P_hat), P_hat

    def mask(self, center: torch.Tensor, noaug: bool = False,
             generator: torch.Generator | None = None,
             mask_uniform: torch.Tensor | None = None) -> torch.Tensor:
        """(B, G) 0/1: none with ``noaug`` or a zero ratio; else the
        config's random or block mask (the block mask of ``center``), drawn
        from ``generator`` (or the uniforms ``mask_uniform``); without
        either, the rand mask of ``jax.random.uniform(jax.random.key(0))``."""
        cfg = self.config
        B, G = center.shape[:2]
        if noaug or cfg.mask_ratio == 0:
            return torch.zeros((B, G), device=center.device)
        if cfg.mask_type == "rand":
            if mask_uniform is None and generator is None:
                mask_uniform = torch.from_numpy(uniform(prng_key(0), (B, G))).to(center.device)
            return random_mask(B, G, cfg.num_mask, center.device, generator, mask_uniform)
        if generator is None:
            raise ValueError("the block mask needs a torch.Generator")
        return block_mask(center, cfg.num_mask, generator)

    def forward(self, pts: torch.Tensor, noaug: bool = False, tau: Optional[float] = None,
                vis: bool = False, mask_override: torch.Tensor | None = None,
                orders_override: torch.Tensor | None = None,
                generator: torch.Generator | None = None,
                mask_uniform: torch.Tensor | None = None,
                gumbel_uniform: torch.Tensor | None = None):
        """pts (B, N, 3) -> the mean Chamfer loss (with ``vis`` also
        {"rebuild", "gt"}, each (B, T, M, 3)), or with ``noaug`` the encoder's
        features over every token, (B, 2 K G, C). ``mask_override`` (B, G) 0/1
        and ``orders_override`` (B, K, G) replace the drawn mask and the
        computed orders (the latter in eval only: an injected order has no
        soft gradient)."""
        grouped = self.group(pts)
        if self.legacy:
            return self.legacy_forward(grouped, noaug, vis, mask_override, generator,
                                       mask_uniform)
        if orders_override is not None:
            if self.training:
                raise ValueError("orders_override is an eval-mode hook")
            order_idx, P_hat = orders_override.long(), None
        else:
            with torch.set_grad_enabled(self.training and torch.is_grad_enabled()):
                order_idx, P_hat = self.orders(grouped.center, tau, generator, gumbel_uniform)
        if mask_override is not None:
            mask = mask_override.float()
        else:
            mask = self.mask(grouped.center, noaug, generator, mask_uniform)
        enc = self.encode(grouped, order_idx, P_hat, mask, noaug, generator)
        if noaug:
            return enc.x_vis
        return self.decode_loss(grouped, enc, generator, vis)

    def encode(self, grouped: Grouped, order_idx: torch.Tensor, P_hat: torch.Tensor | None,
               mask: torch.Tensor, noaug: bool = False,
               generator: torch.Generator | None = None) -> Encoded:
        """The patch encoder and pos-embed, the traversals (straight through
        P_hat in training), the visible tokens (every token with ``noaug``)
        and their reverse through the encoder stack and its norm."""
        cfg = self.config
        dtype, K, C = self.dtype, cfg.k_top_eigenvectors, cfg.trans_dim
        B, G = mask.shape
        n_vis = G if noaug else cfg.num_vis
        train = self.training
        enc = self.MAE_encoder
        tokens = enc.encoder(grouped.neighborhood.to(dtype))
        pos = enc.pos_embed(grouped.center.to(dtype))
        flat_idx = order_idx.reshape(B, K * G)

        def permute(x):
            hard = _take_rows(x, flat_idx).reshape(B, K, G, -1)
            if not train:
                return hard
            xf = x.detach().float().reshape(B, 1, G, -1)
            soft = torch.einsum("bkij,bcjf->bkif", P_hat.float(), xf).to(x.dtype)
            return hard + (soft - soft.detach())  # the value of hard, soft's gradient

        tok_k, pos_k = permute(tokens), permute(pos)
        mask_k = torch.gather(mask, 1, flat_idx).reshape(B, K, G)
        pos_flat = pos_k.reshape(B, K * G, C)
        tok_vis = select_by_rank(tok_k.reshape(B * K, G, C), mask_k.reshape(B * K, G), n_vis,
                                 masked=False).reshape(B, K * n_vis, C)
        pos_vis = select_by_rank(pos_k.reshape(B * K, G, C), mask_k.reshape(B * K, G), n_vis,
                                 masked=False).reshape(B, K * n_vis, C)
        if cfg.reverse:
            tok_vis = torch.cat([tok_vis, tok_vis.flip(1)], dim=1)
            pos_vis = torch.cat([pos_vis, pos_vis.flip(1)], dim=1)
            pos_flat = torch.cat([pos_flat, pos_flat.flip(1)], dim=1)
        x_vis = enc.norm(enc.blocks(tok_vis, pos_vis, generator))
        return Encoded(x_vis, pos_flat, mask_k.reshape(B, K * G), flat_idx)

    def decode_loss(self, grouped: Grouped, enc: Encoded,
                    generator: torch.Generator | None = None, vis: bool = False):
        """The mask tokens restored into the traversal slots beside the
        encoded visible ones, the decoder stack and its norm, the masked
        groups' points rebuilt and held to the truth: the mean Chamfer loss
        (with ``vis`` also {"rebuild", "gt"})."""
        cfg = self.config
        K, C, B = cfg.k_top_eigenvectors, cfg.trans_dim, enc.x_vis.shape[0]
        n_mask, n_vis = cfg.num_mask, cfg.num_vis
        mask_flat, x_vis, flat_idx = enc.mask_flat, enc.x_vis, enc.flat_idx
        mask_full = torch.cat([mask_flat, mask_flat.flip(1)], dim=1) if cfg.reverse else mask_flat
        mask_tokens = self.mask_token.expand(B, mask_full.shape[1] - x_vis.shape[1], C).to(
            self.dtype)
        x_full = restore_tokens(mask_flat, x_vis[:, :K * n_vis], mask_tokens[:, :K * n_mask])
        if cfg.reverse:
            rev = restore_tokens(mask_flat.flip(1), x_vis[:, K * n_vis:],
                                 mask_tokens[:, K * n_mask:])
            x_full = torch.cat([x_full, rev], dim=1)
        dec = self.MAE_decoder
        x_rec = dec.norm(dec.blocks(x_full, enc.pos_full, generator))

        total = (2 if cfg.reverse else 1) * K * n_mask
        x_masked = select_by_rank(x_rec, mask_full, total, masked=True)
        # the truth by index composition: masked slot -> group id -> points
        slot = torch.argsort(mask_full, dim=-1, stable=True)[:, -total:]
        oidx_full = torch.cat([flat_idx, flat_idx.flip(1)], dim=1) if cfg.reverse else flat_idx
        gidx = torch.gather(oidx_full, 1, slot)
        gt = _take_rows(grouped.neighborhood.float(), gidx)  # (B, T, M, 3)
        rebuild = self.increase_dim(x_masked.float()).reshape(B, total, cfg.group_size, 3)
        loss_fn = {"cdl2": chamfer_l2, "cdl1": chamfer_l1, "emd": emd_sinkhorn}[cfg.loss]
        per = loss_fn(rebuild.reshape(B * total, cfg.group_size, 3),
                      gt.reshape(B * total, cfg.group_size, 3), batch_reduction=None)
        loss = torch.mean(per)
        if vis:
            return loss, {"rebuild": rebuild, "gt": gt}
        return loss

    def legacy_forward(self, grouped: Grouped, noaug: bool = False, vis: bool = False,
                       mask_override: torch.Tensor | None = None,
                       generator: torch.Generator | None = None,
                       mask_uniform: torch.Tensor | None = None):
        """The legacy 'MAMBA' path on the groups: the mask (``mask_override``,
        or :meth:`mask` of the centres in the activation dtype), the visible
        tokens in their original order through the encoder stack and its
        norm (with ``noaug`` every token, and these features are returned,
        (B, G, C)); the decoder stack over [visible, mask tokens] with the
        decoder's position embedding of the visible then the masked centres,
        its norm on the last n_mask tokens, the rebuilt points against the
        masked groups: the mean Chamfer loss (with ``vis`` also {"rebuild",
        "gt"}, each (B, n_mask, M, 3))."""
        cfg = self.config
        dtype, C, M = self.dtype, cfg.trans_dim, cfg.group_size
        center = grouped.center.to(dtype)
        neighborhood = grouped.neighborhood.to(dtype)
        B, G = center.shape[:2]
        mask = (mask_override.float() if mask_override is not None
                else self.mask(center, noaug, generator, mask_uniform))
        n_mask = 0 if noaug or cfg.mask_ratio == 0 else cfg.num_mask
        n_vis = G - n_mask
        enc = self.MAE_encoder
        tokens = enc.encoder(neighborhood)
        center_vis = select_by_rank(center, mask, n_vis, masked=False)
        x_vis = enc.norm(enc.blocks(select_by_rank(tokens, mask, n_vis, masked=False),
                                    enc.pos_embed(center_vis), generator))
        if noaug:
            return x_vis
        center_mask = select_by_rank(center, mask, n_mask, masked=True)
        pos_full = torch.cat([self.decoder_pos_embed(center_vis),
                              self.decoder_pos_embed(center_mask)], dim=1)
        x_full = torch.cat([x_vis, self.mask_token.expand(B, n_mask, C).to(dtype)], dim=1)
        dec = self.MAE_decoder
        x_rec = dec.norm(dec.blocks(x_full, pos_full, generator)[:, -n_mask:])
        rebuild = self.increase_dim(x_rec.float()).reshape(B * n_mask, M, 3)
        gt = select_by_rank(neighborhood.reshape(B, G, -1), mask, n_mask, masked=True)
        gt = gt.float().reshape(B * n_mask, M, 3)
        loss = (chamfer_l2 if cfg.loss == "cdl2" else chamfer_l1)(rebuild, gt)
        if vis:
            return loss, {"rebuild": rebuild.reshape(B, n_mask, M, 3),
                          "gt": gt.reshape(B, n_mask, M, 3)}
        return loss
