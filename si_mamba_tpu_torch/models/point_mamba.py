"""PointMamba classifier.

PyTorch counterpart of ``si_mamba_tpu/models/point_mamba.py``: Group ->
PatchEncoder -> pos-embed -> ordering (SAST, HLT or xyz 'MAMBA') -> MixerModel
-> LayerNorm -> mean-pool -> classification head; with ``rms_norm`` every
norm of the stack is an RMSNorm, with ``add_after_layer`` the stack re-sorts
its tokens by the eigenvectors after every block (``MixerModelAdd``). HLT
orders the tokens within a bucket by a U(0, 1) draw: in training from the ``generator`` passed
to ``forward``, in eval the JAX model's own eval draw (``jax.random.uniform``
of ``jax.random.key(0)``, reproduced bit for bit), so an eval forward repeats
and equals the JAX model's on every device. Module names follow the
reference's state-dict keys. ``.train()`` is the JAX model's ``train=True``:
BatchNorm on batch statistics, DropPath and dropout drawing from the
``generator`` passed to ``forward``. With ``config.tp_axis`` and a ``mesh``
that has that axis every mixer is tensor-parallel over it; the rest of the
model is replicated on every rank of the axis.

``config.dtype`` is the activation dtype: 'float32', or 'bfloat16' (perf
mode, with ``spectral_method='subspace'`` in ``cfgs/finetune_modelnet_perf.yaml``,
and the SSD presets that inherit it) on every mixer route, under ``tp_axis``
too. Parameters, BatchNorm statistics and the scan state stay fp32; grouping
and the graph run on fp32 points and centres; the eigenvectors are rounded to
the activation dtype before the SAST sort, as the JAX model casts them; every
norm hands on the activation dtype and the logits come back in it. The
tensor-parallel Mamba-1 mixer promotes its bf16 input to fp32 at its fp32
weights, as the JAX package's does, so there the residual stream is fp32.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from si_mamba_tpu_torch.models.embed import ClsHead, Dropout, PatchEncoder, PosEmbedMLP
from si_mamba_tpu_torch.models.grouping import group_divider
from si_mamba_tpu_torch.models.layers import LayerNorm, MixerModel, MixerModelAdd
from si_mamba_tpu_torch.models.ordering import hlt_sequence, sast_sequence, xyz_sequence
from si_mamba_tpu_torch.parallel import draws
from si_mamba_tpu_torch.ops.graph import knn_adjacency, rw_laplacian, sym_laplacian
from si_mamba_tpu_torch.ops.spectral import (
    prng_key,
    topk_eigh,
    topk_smallest_subspace,
    uniform,
)
from si_mamba_tpu_torch.parallel.mesh import Mesh, MeshAxis, data_axis, set_data_axis
from si_mamba_tpu_torch.utils.weights import mixer_segments


# the activation dtypes the port runs, by the config's name
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class PointMambaConfig:
    """The reference model YAML keys (cfgs/finetune_*.yaml), the same fields
    and defaults as the JAX package's ``PointMambaConfig``."""

    trans_dim: int = 384
    depth: int = 12
    cls_dim: int = 40
    group_size: int = 32
    num_group: int = 64
    encoder_dims: int = 384
    rms_norm: bool = False
    drop_path: float = 0.1
    drop_out: float = 0.0
    drop_out_in_block: float = 0.0
    cls_head_dropout: float = 0.5
    use_cls_token: bool = False
    method: str = "SAST"  # SAST | HLT | MAMBA
    reverse: bool = True
    reverse_2: bool = False
    reverse_3: bool = False
    knn_graph: int = 20
    k_top_eigenvectors: int = 4
    alpha: float = 100.0
    smallest: bool = True
    symmetric: bool = True
    self_loop: bool = False
    binary: bool = True
    matrix: str = "laplacian"  # laplacian | symmetric
    add_after_layer: bool = False
    scan_impl: str = "auto"
    spectral_method: str = "eigh"
    mixer: str = "mamba"
    ssd_chunk: int = 128
    dtype: str = "float32"
    tp_axis: Optional[str] = None

    @property
    def seq_len(self) -> int:
        if self.method == "MAMBA":
            return 3 * self.num_group
        if self.method == "HLT":
            return 2 * self.num_group
        mult = 2 if (self.reverse or self.reverse_2) else 1
        return mult * self.k_top_eigenvectors * self.num_group

    @classmethod
    def from_dict(cls, d) -> "PointMambaConfig":
        """Build from a config-model mapping, ignoring non-field keys."""
        return cls(**{k: v for k, v in dict(d).items() if k in cls.__dataclass_fields__})


def _check_supported(cfg: PointMambaConfig, mesh: Mesh | None = None) -> None:
    """Raise for the combinations the JAX model refuses too (``add_after_layer``
    with the SSD mixer or with ``tp_axis``), and for a one-sided tensor
    parallelism: ``tp_axis`` without a mesh that has that axis, or a mesh
    with a model axis larger than 1 and no ``tp_axis`` (the check of the JAX
    finetune runner)."""
    if cfg.dtype not in DTYPES:
        raise NotImplementedError(f"dtype={cfg.dtype!r}: the port runs {sorted(DTYPES)}")
    if cfg.add_after_layer and cfg.mixer != "mamba":
        raise NotImplementedError("mixer='ssd' with add_after_layer")
    if cfg.add_after_layer and cfg.tp_axis is not None:
        raise NotImplementedError("tp_axis with add_after_layer")
    if cfg.tp_axis is not None and (mesh is None or cfg.tp_axis not in mesh):
        raise ValueError(f"tensor parallelism needs a mesh with the axis tp_axis="
                         f"{cfg.tp_axis!r}; pass mesh=parallel.make_mesh(...)")
    if cfg.tp_axis is None and mesh is not None:
        wide = [n for n in mesh.axis_names if n != "data" and mesh.size(n) > 1]
        if wide:
            raise ValueError(f"the mesh has the axes {wide} of size > 1 but the config no "
                             f"tp_axis: set tp_axis to shard the mixers over one of them")
    if cfg.spectral_method not in ("eigh", "subspace"):
        raise ValueError(f"unknown spectral_method {cfg.spectral_method!r}")
    if cfg.mixer not in ("mamba", "ssd"):
        raise ValueError(f"unknown mixer {cfg.mixer!r}")
    if cfg.method not in ("SAST", "HLT", "MAMBA"):
        raise ValueError(f"unknown method {cfg.method!r}")
    if cfg.reverse_3:
        raise NotImplementedError(
            "reverse_3 is a dead config in the reference (hard-coded 32-token blocks)")


def order_noise(batch: int, groups: int, device, training: bool,
                generator: torch.Generator | None = None,
                eval_key: tuple[int, int] = prng_key(0),
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """HLT's U(0, 1) tie-break draw, (batch, groups) fp32 on ``device``: in
    training from ``generator`` (required); in eval ``jax.random.uniform`` of
    the raw threefry ``eval_key`` (by default ``jax.random.key(0)``'s, the JAX
    classifier's eval draw), the same on every call and device. At a bf16
    ``dtype`` the draw is JAX's of that dtype, which the codes' dtype sets:
    multiples of 1/128 below 1, exact in bf16 (in eval bit for bit JAX's)."""
    bf16 = dtype == torch.bfloat16
    if not training:
        return torch.from_numpy(uniform(eval_key, (batch, groups), bf16)).to(device)
    if generator is None:
        raise ValueError("the HLT ordering in training mode needs a torch.Generator")
    noise = draws.rand((batch, groups), generator, device=device)
    return torch.floor(noise * 128) / 128 if bf16 else noise


def spectral_eigvecs(center: torch.Tensor, cfg: PointMambaConfig):
    """Graph -> Laplacian -> top-k eigenpairs: (eigvals (B, k), eigvecs (B, G, k)).
    The k smallest of the random-walk Laplacian come from the subspace
    eigensolver when ``spectral_method`` is 'subspace', else from ``eigh`` (a
    config without that field, the segmentation model's, takes ``eigh``)."""
    A = knn_adjacency(center, k=cfg.knn_graph, alpha=cfg.alpha, symmetric=cfg.symmetric,
                      self_loop=cfg.self_loop, binary=cfg.binary)
    if cfg.matrix == "laplacian":
        L = rw_laplacian(A, eps=1e-6, eps_mode="add")
        if getattr(cfg, "spectral_method", "eigh") == "subspace" and cfg.smallest:
            return topk_smallest_subspace(L, cfg.k_top_eigenvectors)
        vals, vecs, _, _ = topk_eigh(L, cfg.k_top_eigenvectors, smallest=cfg.smallest)
        return vals, vecs
    # the symmetric variant computes k+1 pairs and drops the first
    vals, vecs, _, _ = topk_eigh(sym_laplacian(A), cfg.k_top_eigenvectors + 1,
                                 smallest=cfg.smallest)
    return vals[..., 1:], vecs[..., 1:]


class PointMamba(nn.Module):
    """The classifier. Built on the CPU from a seeded ``torch.Generator``
    (seed 0 when none is given); move it with ``.to(device)``. In training
    mode a forward with a drop rate above 0 needs a ``generator`` on the
    input's device for its random draws.

    ``mesh`` (``parallel.make_mesh``) with ``config.tp_axis``: the mixers are
    tensor-parallel over that axis and each rank holds its shard of their
    parameters, the same weights as the single-process model built from the
    same generator (``utils/weights.shard_state_dict`` cuts a full state dict
    to this rank's). Every rank of the axis must run the same forwards on the
    same inputs, with generators of the same seed. A ``data`` axis of the
    mesh shards the batch: the BatchNorms take their training statistics over
    it (``parallel.set_data_axis``; a mesh without one makes them rank-local)."""

    def __init__(self, config: PointMambaConfig, generator: torch.Generator | None = None,
                 mesh: Mesh | None = None):
        super().__init__()
        _check_supported(config, mesh)
        self.config = cfg = config
        self.dtype = DTYPES[cfg.dtype]
        self.mesh = mesh
        self.encoder = PatchEncoder(cfg.encoder_dims)
        self.pos_embed = PosEmbedMLP(cfg.trans_dim)
        self.drop_out = Dropout(cfg.drop_out)
        if cfg.add_after_layer:
            self.blocks = MixerModelAdd(cfg.trans_dim, cfg.depth, drop_path=cfg.drop_path,
                                        drop_out_in_block=cfg.drop_out_in_block,
                                        scan_impl=cfg.scan_impl, rms_norm=cfg.rms_norm)
        else:
            self.blocks = MixerModel(cfg.trans_dim, cfg.depth, drop_path=cfg.drop_path,
                                     drop_out_in_block=cfg.drop_out_in_block,
                                     scan_impl=cfg.scan_impl, mixer=cfg.mixer,
                                     ssd_chunk=cfg.ssd_chunk, mesh=mesh, tp_axis=cfg.tp_axis,
                                     rms_norm=cfg.rms_norm)
        self.norm = LayerNorm(cfg.trans_dim, eps=1e-5)  # LayerNorm whatever rms_norm says
        self.cls_head_finetune = ClsHead(cfg.trans_dim, cfg.cls_dim, drop=cfg.cls_head_dropout)
        self.reset_parameters(generator or torch.Generator().manual_seed(0))
        if mesh is not None:
            set_data_axis(self, data_axis(mesh))

    def reset_parameters(self, generator: torch.Generator) -> None:
        for m in (self.encoder, self.pos_embed, self.blocks, self.cls_head_finetune):
            m.reset_parameters(generator)
        for m in self.modules():
            if isinstance(m, nn.BatchNorm1d):
                m.reset_parameters()
        self.norm.reset_parameters()

    def tp_sharding(self) -> tuple[MeshAxis, dict] | None:
        """(the tensor-parallel axis, {parameter name: (dim, [(local length,
        sharded), ...])} for every parameter a rank holds a shard of), or
        None without tensor parallelism: what a global-norm clip over the
        logical parameters needs (``train/optim.py``). A segment that is not
        sharded (the SSD mixer's B|C rows of in_proj and conv1d) is whole on
        every rank and counts once."""
        if self.config.tp_axis is None:
            return None
        ax = self.mesh[self.config.tp_axis]
        segments = {}
        for i, layer in enumerate(self.blocks.layers):
            local = mixer_segments(layer.mixer.state_dict(), self.config.mixer, ax.size)
            segments |= {f"blocks.layers.{i}.mixer.{k}": v for k, v in local.items()}
        return ax, segments

    # -- the pieces of the forward, public so that tests can compose them --
    def embed(self, pts: torch.Tensor, fps_start_idx=0):
        """pts (B, N, 3) -> (tokens (B, G, C), pos (B, G, C) in the activation
        dtype, centres (B, G, 3) in the points' dtype)."""
        cfg = self.config
        grouped = group_divider(pts, cfg.num_group, cfg.group_size, start_idx=fps_start_idx)
        return (self.encoder(grouped.neighborhood.to(self.dtype)),
                self.pos_embed(grouped.center.to(self.dtype)), grouped.center)

    def sequence(self, tokens, pos, center, eigvecs=None, noise=None,
                 generator: torch.Generator | None = None):
        """Order the tokens: (x, pos_seq), each (B, seq_len, C). For SAST and
        HLT the eigenvectors are computed from ``center`` unless given, then
        used as rounded to the activation dtype (the stable sorts break the
        ties that the rounding makes by index, as the JAX model's do). HLT's
        tie-break ``noise`` (B, G) is drawn by :func:`order_noise` unless
        given."""
        cfg = self.config
        if cfg.method == "MAMBA":
            return xyz_sequence(center, tokens, pos)
        if eigvecs is None:
            _, eigvecs = spectral_eigvecs(center, cfg)
        if cfg.method == "HLT":
            if noise is None:
                noise = order_noise(center.shape[0], center.shape[1], center.device,
                                    self.training, generator, dtype=self.dtype)
            return hlt_sequence(eigvecs.to(self.dtype), cfg.k_top_eigenvectors, noise, tokens,
                                pos)
        eigvecs = eigvecs.to(self.dtype).to(eigvecs.dtype)
        return sast_sequence(eigvecs, tokens, pos, reverse=cfg.reverse, reverse_2=cfg.reverse_2)

    def classify(self, x, pos_seq, return_features: bool = False,
                 generator: torch.Generator | None = None, eigvecs=None):
        """Dropout -> Mamba stack -> LayerNorm -> mean-pool -> head: logits
        (B, cls_dim). With ``add_after_layer`` the stack re-sorts by
        ``eigvecs`` (B, G, k), the ones :meth:`sequence` ordered by (rounded
        to the activation dtype here, as there)."""
        x = self.drop_out(x, generator)
        if self.config.add_after_layer:
            if eigvecs is None:
                raise ValueError("add_after_layer re-sorts by the eigenvectors: pass eigvecs")
            eigvecs = eigvecs.to(self.dtype).to(eigvecs.dtype)
            h = self.blocks(x, pos_seq, eigvecs, reverse=self.config.reverse,
                            generator=generator)
        else:
            h = self.blocks(x, pos_seq, generator)
        feat = torch.mean(self.norm(h), dim=1)
        logits = self.cls_head_finetune(feat, generator)
        return (logits, feat) if return_features else logits

    def forward(self, pts: torch.Tensor, fps_start_idx=0, return_features: bool = False,
                generator: torch.Generator | None = None):
        tokens, pos, center = self.embed(pts, fps_start_idx)
        eigvecs = None
        if self.config.add_after_layer and self.config.method != "MAMBA":
            _, eigvecs = spectral_eigvecs(center, self.config)
        x, pos_seq = self.sequence(tokens, pos, center, eigvecs=eigvecs, generator=generator)
        return self.classify(x, pos_seq, return_features, generator, eigvecs=eigvecs)


def cross_entropy_loss_acc(logits: torch.Tensor, labels: torch.Tensor):
    """Per-sample CE loss and accuracy in percent."""
    logp = F.log_softmax(logits.float(), dim=-1)
    loss = -torch.gather(logp, -1, labels[:, None].long())[:, 0]
    acc = torch.mean((torch.argmax(logits, -1) == labels).float()) * 100.0
    return loss, acc
