"""The learned traversal-permutation policy (the classifier's ``tau`` path):
the counterpart of ``si_mamba_tpu/models/permute_policy.py`` (the
reference's PointMamba.forward :900-955, MixerModel2 :275-278 and
new_layers.StochasticNeuralSortPermuter :122-166).

A 3-block Mamba stack over the detached token sequence plus an eigen
embedding gives inner (per traversal and token) and outer (per traversal)
logits; a Gumbel-perturbed argsort of each gives hard permutations, and
their Plackett-Luce log-probability is the policy term. Off in every
published configuration; like the JAX module it stands alone and is not
wired into ``PointMamba``.

Module names are the JAX module's (the reference's torch keys for these
layers are not cited anywhere the port can read): ``eigen_fc1``,
``eigen_fc2``, ``logit_blocks`` (a ``MixerModel``: ``layers.{i}``,
``norm_f``), ``logit_norm``, ``logit_head_{fc1,ln,fc2}`` and
``logit_head2_{fc1,ln,fc2}``.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from si_mamba_tpu_torch.models.embed import Linear, _init_linear
from si_mamba_tpu_torch.models.layers import LayerNorm, MixerModel
from si_mamba_tpu_torch.ops.sinkhorn import plackett_luce_log_prob
from si_mamba_tpu_torch.parallel import draws


class StochasticNeuralSortPermuter(nn.Module):
    """A Gumbel-perturbed stable argsort: z (R, N) log-scores -> (R, N)
    permutation indices, argsort(z + tau g) with g = -log(-log(u + eps) +
    eps), u ~ U(0, 1) drawn from ``generator`` or given as ``uniform``."""

    def forward(self, z: torch.Tensor, tau: float, generator: torch.Generator | None = None,
                uniform: torch.Tensor | None = None) -> torch.Tensor:
        if uniform is None:
            if generator is None:
                raise ValueError("the permuter's Gumbel noise needs a torch.Generator or a "
                                 "uniform draw")
            uniform = draws.rand(z.shape, generator, device=z.device)
        eps = torch.finfo(z.dtype).eps
        g = -torch.log(-torch.log(uniform.to(z.dtype) + eps) + eps)
        return torch.argsort(z + tau * g, dim=-1, stable=True)


class PermutePolicy(nn.Module):
    """Permuted sequence indices and the policy's log-probability. Built on
    the CPU from a seeded ``torch.Generator`` (seed 0 when none is given), or
    on the device of a ``torch.device`` context with a generator there."""

    def __init__(self, trans_dim: int, num_group: int, k_top_eigenvectors: int, n_layer: int = 3,
                 rms_norm: bool = False, scan_impl: str = "auto",
                 generator: torch.Generator | None = None):
        super().__init__()
        self.trans_dim, self.num_group, self.k = trans_dim, num_group, k_top_eigenvectors
        self.eigen_fc1 = Linear(2, 128)
        self.eigen_fc2 = Linear(128, trans_dim)
        self.logit_blocks = MixerModel(trans_dim, n_layer, scan_impl=scan_impl, rms_norm=rms_norm)
        self.logit_norm = LayerNorm(trans_dim, eps=1e-5)
        for head in ("logit_head", "logit_head2"):  # Dense -> LayerNorm -> GELU -> Dense(1)
            setattr(self, f"{head}_fc1", Linear(trans_dim, trans_dim))
            setattr(self, f"{head}_ln", LayerNorm(trans_dim, eps=1e-5))
            setattr(self, f"{head}_fc2", Linear(trans_dim, 1))
        self.permuter = StochasticNeuralSortPermuter()
        self.reset_parameters(generator or torch.Generator().manual_seed(0))

    def reset_parameters(self, generator: torch.Generator) -> None:
        _init_linear(self.eigen_fc1, generator)
        _init_linear(self.eigen_fc2, generator)
        self.logit_blocks.reset_parameters(generator)
        self.logit_norm.reset_parameters()
        for head in ("logit_head", "logit_head2"):
            _init_linear(getattr(self, f"{head}_fc1"), generator)
            getattr(self, f"{head}_ln").reset_parameters()
            _init_linear(getattr(self, f"{head}_fc2"), generator)

    def _head(self, x: torch.Tensor, name: str) -> torch.Tensor:
        h = getattr(self, f"{name}_ln")(getattr(self, f"{name}_fc1")(x))
        return getattr(self, f"{name}_fc2")(F.gelu(h, approximate="none"))

    def logits(self, tokens_seq: torch.Tensor, pos_seq: torch.Tensor, eigvals: torch.Tensor,
               eigvecs: torch.Tensor, reverse: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
        """(inner logits (B, k, G), outer logits (B, k)) of the detached
        sequence."""
        B, G, k, C = tokens_seq.shape[0], self.num_group, self.k, self.trans_dim
        # the eigen embedding: each traversal's sorted eigenvector values,
        # negated, beside its eigenvalue
        sorted_vecs = torch.sort(eigvecs.transpose(1, 2), dim=2).values  # (B, k, G)
        stacked = torch.stack([-sorted_vecs, eigvals[..., None].expand_as(sorted_vecs)], dim=-1)
        emb = self.eigen_fc2(F.gelu(self.eigen_fc1(stacked), approximate="none"))
        emb = emb.reshape(B, k * G, C)
        emb = torch.cat([emb, emb.flip(1)], dim=1)
        feats = self.logit_norm(self.logit_blocks(tokens_seq.detach() + emb, pos_seq.detach()))
        if reverse:
            f1, f2 = feats.chunk(2, dim=1)
            feats = f1 + f2.flip(1)  # (B, kG, C)
        inner = self._head(feats, "logit_head").reshape(B, k, G)
        outer = self._head(feats.reshape(B, k, G, C).mean(dim=2), "logit_head2")[..., 0]
        return inner, outer

    def forward(self, tokens_seq: torch.Tensor, pos_seq: torch.Tensor, eigvals: torch.Tensor,
                eigvecs: torch.Tensor, tau: float, reverse: bool = True,
                generator: torch.Generator | None = None,
                gumbel_uniform: tuple[torch.Tensor, torch.Tensor] | None = None):
        """tokens_seq, pos_seq (B, 2kG, C) the sequence (detached here);
        eigvals (B, k); eigvecs (B, G, k). Returns (perm (B, kG) int64, policy
        (B,)). The Gumbel draws, inner (B k, G) then outer (B, k), come from
        ``generator`` or as ``gumbel_uniform``."""
        B, G, k = tokens_seq.shape[0], self.num_group, self.k
        inner, outer = self.logits(tokens_seq, pos_seq, eigvals, eigvecs, reverse)
        u_in, u_out = gumbel_uniform if gumbel_uniform is not None else (None, None)
        pi_in = self.permuter(inner.reshape(B * k, G), tau, generator, u_in).reshape(B, k, G)
        perm_outer = self.permuter(outer, tau, generator, u_out)  # (B, k)
        perm = (pi_in + perm_outer[..., None] * G).reshape(B, k * G)
        li = torch.gather(inner.reshape(B, k * G), 1, perm)
        lo = torch.gather(outer, 1, perm_outer)
        policy = (plackett_luce_log_prob(li.reshape(B, k, G)).sum(dim=1)
                  + plackett_luce_log_prob(lo))
        return perm, policy
