"""Token traversal orders: SAST (eigenvector sorts) and MAMBA (xyz sorts).

PyTorch counterparts of ``si_mamba_tpu/models/ordering.py``.
"""

from __future__ import annotations

import torch

from si_mamba_tpu_torch.ops.spectral import sort_orders_by_eigenvectors


def apply_orders(x: torch.Tensor, orders: torch.Tensor) -> torch.Tensor:
    """x: (B, G, C), orders: (B, k, G) -> (B, k*G, C) concatenated gathers."""
    B, k, G = orders.shape
    flat = orders.reshape(B, k * G)
    return torch.gather(x, 1, flat[..., None].expand(-1, -1, x.shape[-1]))


def sast_sequence(tokens: torch.Tensor, pos: torch.Tensor, eigvecs: torch.Tensor,
                  reverse: bool = True, reverse_2: bool = False):
    """Sort tokens and positions by each of the k eigenvectors and concatenate;
    then append the flipped sequence (``reverse``) or each block reversed
    (``reverse_2``). tokens/pos (B, G, C), eigvecs (B, G, k) -> (B, S, C)
    pairs, S = 2kG or kG."""
    orders = sort_orders_by_eigenvectors(eigvecs)  # (B, k, G)
    tok = apply_orders(tokens, orders)
    pp = apply_orders(pos, orders)
    if reverse:
        tok = torch.cat([tok, tok.flip(1)], dim=1)
        pp = torch.cat([pp, pp.flip(1)], dim=1)
    elif reverse_2:
        B, kG, C = tok.shape
        k, G = orders.shape[1], orders.shape[2]
        rev_tok = tok.reshape(B, k, G, C).flip(2).reshape(B, kG, C)
        rev_pos = pp.reshape(B, k, G, C).flip(2).reshape(B, kG, C)
        tok = torch.cat([tok, rev_tok], dim=1)
        pp = torch.cat([pp, rev_pos], dim=1)
    return tok, pp


def xyz_sequence(tokens: torch.Tensor, pos: torch.Tensor, center: torch.Tensor):
    """'MAMBA' ordering: concatenated stable sorts by the centres' x, y, z.
    -> (B, 3G, C) pairs."""
    orders = torch.stack([torch.argsort(center[..., d], dim=-1, stable=True)
                          for d in range(3)], dim=1)  # (B, 3, G)
    return apply_orders(tokens, orders), apply_orders(pos, orders)
