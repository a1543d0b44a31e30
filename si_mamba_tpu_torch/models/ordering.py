"""Token traversal orders: SAST (eigenvector sorts), HLT (multilevel buckets)
and MAMBA (xyz sorts).

PyTorch counterparts of ``si_mamba_tpu/models/ordering.py``. Each ordering
takes its key (eigenvectors or centres) and any number of (B, G, C) tensors,
and lays every one out in the same order: the classifier orders its tokens
and positions, the segmentation model those and the centres.
"""

from __future__ import annotations

import torch

from si_mamba_tpu_torch.ops.spectral import multilevel_codes, sort_orders_by_eigenvectors


def apply_orders(x: torch.Tensor, orders: torch.Tensor) -> torch.Tensor:
    """x: (B, G, C), orders: (B, k, G) -> (B, k*G, C) concatenated gathers."""
    B, k, G = orders.shape
    flat = orders.reshape(B, k * G)
    return torch.gather(x, 1, flat[..., None].expand(-1, -1, x.shape[-1]))


def sast_sequence(eigvecs: torch.Tensor, *xs: torch.Tensor, reverse: bool = True,
                  reverse_2: bool = False) -> tuple[torch.Tensor, ...]:
    """Sort each of ``xs`` (B, G, C) by each of the k eigenvectors (B, G, k)
    and concatenate; then append the flipped sequence (``reverse``) or each
    block reversed (``reverse_2``). -> one (B, S, C) a tensor, S = 2kG or kG."""
    orders = sort_orders_by_eigenvectors(eigvecs)  # (B, k, G)
    k, G = orders.shape[1], orders.shape[2]
    out = []
    for x in xs:
        seq = apply_orders(x, orders)
        if reverse:
            seq = torch.cat([seq, seq.flip(1)], dim=1)
        elif reverse_2:
            B, kG, C = seq.shape
            seq = torch.cat([seq, seq.reshape(B, k, G, C).flip(2).reshape(B, kG, C)], dim=1)
        out.append(seq)
    return tuple(out)


def xyz_sequence(center: torch.Tensor, *xs: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """'MAMBA' ordering: each of ``xs`` (B, G, C) in the concatenated stable
    sorts by the centres' (B, G, 3) x, y and z. -> one (B, 3G, C) a tensor."""
    orders = torch.stack([torch.argsort(center[..., d], dim=-1, stable=True)
                          for d in range(3)], dim=1)  # (B, 3, G)
    return tuple(apply_orders(x, orders) for x in xs)


def hlt_sequence(eigvecs: torch.Tensor, k: int, noise: torch.Tensor,
                 *xs: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """HLT ordering. The bucket order sorts the tokens (stably) by their
    multilevel codes of the first ``k`` eigenvectors (B, G, k') plus
    ``noise`` (B, G), a U(0, 1) draw that orders the tokens within a bucket at
    random. Each of ``xs`` (B, G, C), gathered in that order, is laid out on a
    2G-token canvas in chunks of 2^k: [c0, rev(c0), c1, ..., c_{nd-1},
    rev(c_{nd-1})], the tokens beyond nd * 2^k dropped and the rest of the
    canvas zeros (the reference's overlapping-write loop). -> one
    (B, max(2G, (nd + 2) 2^k), C) a tensor."""
    codes = multilevel_codes(eigvecs, k)
    order = torch.argsort(codes + noise.to(codes.dtype), dim=1, stable=True)
    ng = 2 ** k
    out = []
    for x in xs:
        B, G, C = x.shape
        nd = G // ng
        x = torch.gather(x, 1, order[..., None].expand(-1, -1, C))
        chunks = x[:, :nd * ng].reshape(B, nd, ng, C)
        seq = torch.cat([chunks[:, 0], chunks[:, 0].flip(1), *chunks[:, 1:].unbind(1),
                         chunks[:, nd - 1].flip(1)], dim=1)
        pad = 2 * G - seq.shape[1]
        if pad > 0:
            seq = torch.cat([seq, seq.new_zeros((B, pad, C))], dim=1)
        out.append(seq)
    return tuple(out)


def cross_merge(ys: torch.Tensor, orders: torch.Tensor) -> torch.Tensor:
    """A 2kG-token SAST sequence ys (B, 2kG, D), laid out in the k
    eigenvector sorts ``orders`` (B, k, G) and then flipped, merged back to
    token order and summed over the 2k traversals: (B, G, D). Each traversal
    goes through its inverse order (a stable argsort of its order); segment j
    of the flipped half carries traversal k-1-j reversed, and is paired with
    that traversal's inverse (the JAX package's pairing; the reference pairs
    it with traversal j's)."""
    B, L, D = ys.shape
    k, G = orders.shape[1], orders.shape[2]
    assert L == 2 * k * G, (
        f"cross_merge expects the k forward + k flipped layout (L = 2kG); got L={L}, k={k}, "
        f"G={G}: add_after_layer requires reverse=True")
    inv = torch.argsort(orders, dim=-1, stable=True)[..., None].expand(B, k, G, D)
    fwd = ys[:, :k * G].reshape(B, k, G, D)
    rev = ys[:, k * G:].reshape(B, k, G, D).flip(1).flip(2)
    return torch.sum(torch.gather(fwd, 2, inv) + torch.gather(rev, 2, inv), dim=1)


def resort_sequence(x: torch.Tensor, orders: torch.Tensor, reverse: bool = True) -> torch.Tensor:
    """Token features x (B, G, D) laid out in the k sorts ``orders`` (B, k, G)
    and, with ``reverse``, their flip: (B, 2kG or kG, D)."""
    seq = apply_orders(x, orders)
    return torch.cat([seq, seq.flip(1)], dim=1) if reverse else seq
