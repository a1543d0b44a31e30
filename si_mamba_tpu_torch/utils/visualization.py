"""Visualisation and analysis utilities, the counterparts of
``si_mamba_tpu/utils/visualization.py`` (the reference's reconstruction
renders, traversal viewer and t-SNE dump), with no matplotlib, sklearn or
plotly: the GPU host has none of them.

- Images are PNG files written by this module's own encoder (``zlib`` and
  ``struct``). The JAX package writes JPEG through matplotlib; the port
  writes ``.png`` in its place, as the GPU host has no JPEG encoder.
- :func:`render_cloud_figure` rasterises a cloud itself: an orthographic
  view under matplotlib's ``view_init(elev, azim)`` rotation, the points
  coloured by x through the jet map, nearer points drawn over farther ones.
- :func:`tsne_features` is a t-SNE of its own in torch, on the features'
  device: sklearn's ``TSNE(n_components=2, init='pca')`` schedule with the
  exact O(N^2) gradient (:func:`tsne_embed`).
"""

from __future__ import annotations

import logging
import math
import os
import struct
import zlib

import numpy as np
import torch

_LOG = logging.getLogger(__name__)

# matplotlib's 'jet' segments: (position, value) per channel
_JET = {"r": ((0.0, 0.0), (0.35, 0.0), (0.66, 1.0), (0.89, 1.0), (1.0, 0.5)),
        "g": ((0.0, 0.0), (0.125, 0.0), (0.375, 1.0), (0.64, 1.0), (0.91, 0.0), (1.0, 0.0)),
        "b": ((0.0, 0.5), (0.11, 1.0), (0.34, 1.0), (0.65, 0.0), (1.0, 0.0))}
# matplotlib's 'tab20' palette, 8-bit
TAB20 = np.array([(31, 119, 180), (174, 199, 232), (255, 127, 14), (255, 187, 120),
                  (44, 160, 44), (152, 223, 138), (214, 39, 40), (255, 152, 150),
                  (148, 103, 189), (197, 176, 213), (140, 86, 75), (196, 156, 148),
                  (227, 119, 194), (247, 182, 210), (127, 127, 127), (199, 199, 199),
                  (188, 189, 34), (219, 219, 141), (23, 190, 207), (158, 218, 229)], np.uint8)
PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------

def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(rgb: np.ndarray) -> bytes:
    """An (H, W, 3) uint8 image as PNG bytes: 8-bit RGB, no interlace, every
    row with filter 0, one zlib stream. The same image gives the same bytes."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w, c = rgb.shape
    if c != 3:
        raise ValueError(f"expected an (H, W, 3) image, got {rgb.shape}")
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, 3 * w)], axis=1)
    return (PNG_SIGNATURE + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _png_chunk(b"IDAT", zlib.compress(raw.tobytes(), 9)) + _png_chunk(b"IEND", b""))


def write_png(path: str, rgb: np.ndarray) -> None:
    if not str(path).endswith(".png"):
        raise ValueError(f"{path}: the port writes PNG images, name them .png")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(encode_png(rgb))


def jet(t: np.ndarray) -> np.ndarray:
    """matplotlib's jet map of values in [0, 1] -> (..., 3) uint8."""
    t = np.clip(np.asarray(t, np.float64), 0.0, 1.0)
    chans = [np.interp(t, [p for p, _ in seg], [v for _, v in seg])
             for seg in (_JET["r"], _JET["g"], _JET["b"])]
    return np.round(np.stack(chans, axis=-1) * 255.0).astype(np.uint8)


def _splat(size: int, px: np.ndarray, py: np.ndarray, colors: np.ndarray,
           radius: int) -> np.ndarray:
    """A white (size, size, 3) image with a disk of ``radius`` pixels at each
    (px, py), drawn in the given order: a later point covers an earlier one."""
    img = np.full((size * size, 3), 255, np.uint8)
    r = np.arange(-radius, radius + 1)
    oy, ox = np.meshgrid(r, r, indexing="ij")
    keep = ox ** 2 + oy ** 2 <= radius ** 2
    ox, oy = ox[keep], oy[keep]
    xs = np.round(px).astype(np.int64)[:, None] + ox[None, :]
    ys = np.round(py).astype(np.int64)[:, None] + oy[None, :]
    owner = np.broadcast_to(np.arange(len(px))[:, None], xs.shape)
    inside = (xs >= 0) & (xs < size) & (ys >= 0) & (ys < size)
    pix, owner = (ys * size + xs)[inside], owner[inside]
    # the last point drawn at a pixel owns it: first occurrence in reverse
    pix_rev, owner_rev = pix[::-1], owner[::-1]
    uniq, first = np.unique(pix_rev, return_index=True)
    img[uniq] = colors[owner_rev[first]]
    return img.reshape(size, size, 3)


# ---------------------------------------------------------------------------
# dumps and renders
# ---------------------------------------------------------------------------

def save_traversal_dump(path: str, center: np.ndarray, neighborhood: np.ndarray,
                        orders: np.ndarray) -> None:
    """``.npz`` traversal dump with the keys the reference's visualize.py
    reads: ``center``, ``neighborhood``, ``orders``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(path, center=center, neighborhood=neighborhood, orders=orders)


def render_cloud_figure(points: np.ndarray, out_path: str, roll: float = 0, pitch: float = 0,
                        size: int = 800, radius: int = 2) -> None:
    """Render a (N, 3) cloud as a ``size`` x ``size`` PNG: the JAX package's
    matplotlib scatter (``view_init(roll, pitch)``, axes (x, z, y) of the
    cloud, the cube [-max|p|, max|p|]^3, colour by x through jet) drawn by an
    orthographic projection, nearer points over farther ones."""
    pts = np.asarray(points, np.float64)
    x, z, y = pts.T  # the JAX render's axis order
    el, az = math.radians(roll), math.radians(pitch)
    u = -x * math.sin(az) + y * math.cos(az)
    v = -(x * math.cos(az) + y * math.sin(az)) * math.sin(el) + z * math.cos(el)
    depth = (x * math.cos(az) + y * math.sin(az)) * math.cos(el) + z * math.sin(el)
    mx = float(np.abs(pts).max()) if pts.size else 1.0
    scale = (size / 2 - radius - 1) / (math.sqrt(3.0) * (mx if mx > 0 else 1.0))
    span = float(x.max() - x.min()) if pts.size else 0.0
    colors = jet((x - x.min()) / span if span > 0 else np.zeros_like(x))
    order = np.argsort(depth, kind="stable")  # far first
    img = _splat(size, size / 2 + u[order] * scale, size / 2 - v[order] * scale,
                 colors[order], radius)
    write_png(out_path, img)


def save_reconstruction(out_dir: str, tag: str, full: np.ndarray, visible: np.ndarray) -> None:
    """Dump the clouds as ``;``-delimited text (``{tag}_full.txt``,
    ``{tag}_vis.txt``, byte for byte the JAX package's) and their renders as
    ``{tag}_full.png`` / ``{tag}_vis.png`` (the JAX package writes ``.jpg``)."""
    os.makedirs(out_dir, exist_ok=True)
    np.savetxt(os.path.join(out_dir, f"{tag}_full.txt"), full, delimiter=";")
    np.savetxt(os.path.join(out_dir, f"{tag}_vis.txt"), visible, delimiter=";")
    render_cloud_figure(full, os.path.join(out_dir, f"{tag}_full.png"))
    render_cloud_figure(visible, os.path.join(out_dir, f"{tag}_vis.png"))


def traversal_viewer_html(npz_path: str, out_html: str, sample: int = 0) -> bool:
    """A standalone Plotly viewer with a slider over the traversal orders, as
    the JAX package writes it. Needs plotly: without it, logs one line and
    returns False (the JAX package returns silently). True once written."""
    try:
        import plotly.graph_objects as go
    except ImportError:
        _LOG.warning("traversal_viewer_html: plotly is not installed; %s not written", out_html)
        return False
    data = np.load(npz_path)
    center, orders = data["center"], data["orders"]
    if center.ndim == 4:  # (B, K, G, 3)
        centers_k = center[sample]
    else:
        centers_k = center[sample].reshape(orders.shape[1], -1, 3)
    frames = []
    for k in range(centers_k.shape[0]):
        c = centers_k[k]
        frames.append(go.Frame(
            data=[go.Scatter3d(x=c[:, 0], y=c[:, 1], z=c[:, 2], mode="markers+lines",
                               marker=dict(size=3, color=np.arange(len(c)),
                                           colorscale="Viridis"))],
            name=str(k)))
    fig = go.Figure(data=frames[0].data, frames=frames)
    fig.update_layout(sliders=[{"steps": [{"args": [[f.name]], "label": f.name,
                                           "method": "animate"} for f in frames]}])
    fig.write_html(out_html)
    return True


# ---------------------------------------------------------------------------
# t-SNE
# ---------------------------------------------------------------------------

MACHINE_EPSILON = float(np.finfo(np.double).eps)
PERPLEXITY_TOLERANCE = 1e-5
# sklearn's TSNE defaults, which the JAX package's t-SNE calls
PERPLEXITY = 30.0
EARLY_EXAGGERATION = 12.0
EXPLORATION_ITERS = 250
MAX_ITER = 1000
WITHOUT_PROGRESS = 300
CHECK_EVERY = 50


def squared_distances(x: torch.Tensor) -> torch.Tensor:
    """(N, D) -> (N, N) squared Euclidean distances in fp64, zero diagonal."""
    x = x.double()
    sq = (x * x).sum(1)
    d = (sq[:, None] + sq[None, :] - 2.0 * (x @ x.T)).clamp_min_(0.0)
    return d.fill_diagonal_(0.0)


def conditional_probabilities(sqdist: torch.Tensor, perplexity: float,
                              steps: int = 100) -> torch.Tensor:
    """p_{j|i}: each row's Gaussian over the others, its precision found by
    sklearn's binary search (``_utils._binary_search_perplexity``: the
    distances rounded to fp32, beta from 1, doubled or halved until bracketed
    and then bisected, up to 100 steps, stopping at an entropy within 1e-5 of
    log(perplexity)), all rows at once."""
    d = sqdist.float().double()
    n = d.shape[0]
    off = ~torch.eye(n, dtype=torch.bool, device=d.device)
    target = math.log(float(np.float32(perplexity)))
    beta = torch.ones(n, dtype=torch.float64, device=d.device)
    lo = torch.full_like(beta, -math.inf)
    hi = torch.full_like(beta, math.inf)
    P = torch.zeros_like(d)
    active = torch.ones(n, dtype=torch.bool, device=d.device)
    for _ in range(steps):
        p = torch.exp(-d * beta[:, None]) * off
        s = p.sum(1)
        s = torch.where(s == 0.0, torch.full_like(s, 1e-8), s)
        p = p / s[:, None]
        diff = torch.log(s) + beta * (d * p).sum(1) - target
        P = torch.where(active[:, None], p, P)
        move = active & (diff.abs() > PERPLEXITY_TOLERANCE)
        up = diff > 0.0
        new_beta = torch.where(up, torch.where(torch.isinf(hi), beta * 2.0, (beta + hi) / 2.0),
                               torch.where(torch.isinf(lo), beta / 2.0, (beta + lo) / 2.0))
        lo = torch.where(move & up, beta, lo)
        hi = torch.where(move & ~up, beta, hi)
        beta = torch.where(move, new_beta, beta)
        active = move
        if not bool(active.any()):
            break
    return P


def joint_probabilities(sqdist: torch.Tensor, perplexity: float) -> torch.Tensor:
    """sklearn's ``_joint_probabilities`` as a full (N, N) matrix: p_{j|i} +
    p_{i|j} over its sum, floored at the fp64 epsilon off the diagonal, zero
    on it."""
    cond = conditional_probabilities(sqdist, perplexity)
    P = cond + cond.T
    P = P / P.sum().clamp_min(MACHINE_EPSILON)
    return P.clamp_min(MACHINE_EPSILON).fill_diagonal_(0.0)


def _kl_and_grad(Y: torch.Tensor, P: torch.Tensor, compute_error: bool):
    """KL(P || Q) of the Student-t (one degree of freedom) similarities of Y,
    and its gradient 4 sum_j (p_ij - q_ij)(1 + |y_i - y_j|^2)^-1 (y_i - y_j),
    as sklearn's exact ``_kl_divergence``."""
    w = 1.0 / (1.0 + squared_distances(Y))
    w.fill_diagonal_(0.0)
    Q = (w / w.sum()).clamp_min(MACHINE_EPSILON)
    kl = None
    if compute_error:
        kl = float((P * torch.log(P.clamp_min(MACHINE_EPSILON) / Q)).sum())
    PQd = (P - Q) * w
    grad = 4.0 * (PQd.sum(1)[:, None] * Y - PQd @ Y)
    return kl, grad


def _descend(Y, P, it: int, max_iter: int, momentum: float, learning_rate: float,
             without_progress: int, min_gain: float = 0.01, min_grad_norm: float = 1e-7):
    """sklearn's ``_gradient_descent``: momentum with per-coordinate gains,
    the error and gradient norm checked every 50 iterations (and the error
    at the last), stopping without progress or at a vanishing gradient."""
    update = torch.zeros_like(Y)
    gains = torch.ones_like(Y)
    best_error, best_iter, error, i = math.inf, it, math.inf, it
    for i in range(it, max_iter):
        check = (i + 1) % CHECK_EVERY == 0
        kl, grad = _kl_and_grad(Y, P, check or i == max_iter - 1)
        if kl is not None:
            error = kl
        inc = update * grad < 0.0
        gains = torch.where(inc, gains + 0.2, gains * 0.8).clamp_min_(min_gain)
        grad = grad * gains
        update = momentum * update - learning_rate * grad
        Y = Y + update
        if check:
            if error < best_error:
                best_error, best_iter = error, i
            elif i - best_iter > without_progress:
                break
            if float(torch.linalg.vector_norm(grad)) <= min_grad_norm:
                break
    return Y, error, i


def pca_init(x: torch.Tensor, n_components: int = 2) -> torch.Tensor:
    """The first principal components of x (each component's largest loading
    positive, sklearn's sign convention), scaled so that the first column's
    standard deviation is 1e-4: sklearn's ``init='pca'``."""
    x = x.double()
    xc = x - x.mean(0)
    _, _, vh = torch.linalg.svd(xc, full_matrices=False)
    comps = vh[:n_components]
    sign = torch.sign(comps.gather(1, comps.abs().argmax(1, keepdim=True)))
    emb = (xc @ (comps * sign).T).float().double()
    return emb / emb[:, 0].std(unbiased=False) * 1e-4


def tsne_embed(features) -> tuple[np.ndarray, float]:
    """A 2-D t-SNE of ``features`` (N, D), sklearn's ``TSNE(n_components=2,
    init='pca')`` with ``method='exact'``: the joint P at perplexity 30,
    early exaggeration 12 for 250 iterations at momentum 0.5, then momentum
    0.8 to iteration 1000, learning rate max(N / 12 / 4, 50), gains, the
    O(N^2) gradient, from the PCA start (which draws nothing, so a run is
    deterministic). Runs in fp64 on the features' device (a numpy array on
    the CPU). Returns (the (N, 2) embedding, the final KL divergence)."""
    x = features if isinstance(features, torch.Tensor) else torch.from_numpy(
        np.asarray(features))
    x = x.detach()
    n = x.shape[0]
    if not PERPLEXITY < n:
        raise ValueError(f"perplexity ({PERPLEXITY}) must be less than the number of "
                         f"samples ({n})")
    Y = pca_init(x)
    P = joint_probabilities(squared_distances(x), PERPLEXITY)
    lr = max(n / EARLY_EXAGGERATION / 4.0, 50.0)
    Y, error, it = _descend(Y, P * EARLY_EXAGGERATION, 0, EXPLORATION_ITERS, 0.5, lr,
                            EXPLORATION_ITERS)
    Y, error, it = _descend(Y, P, it + 1, MAX_ITER, 0.8, lr, WITHOUT_PROGRESS)
    return Y.float().cpu().numpy(), error


def tsne_features(features, labels: np.ndarray, out_path: str, size: int = 800) -> np.ndarray:
    """A 2-D t-SNE scatter of pooled features, coloured by label with the
    tab20 palette, written as a PNG (the JAX package's ``tsne.png`` through
    sklearn and matplotlib). Returns the embedding."""
    emb, _ = tsne_embed(features)
    labels = np.asarray(labels).reshape(-1)
    margin = 8
    lo, hi = emb.min(0), emb.max(0)
    scale = (size - 2 * margin) / max(float((hi - lo).max()), 1e-12)
    px = margin + (emb[:, 0] - lo[0]) * scale
    py = size - 1 - margin - (emb[:, 1] - lo[1]) * scale
    write_png(out_path, _splat(size, px, py, TAB20[labels % len(TAB20)], radius=3))
    return emb
