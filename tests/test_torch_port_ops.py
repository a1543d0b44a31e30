"""The PyTorch port's plain ops against the JAX package, on the same numpy
inputs: point ops, grouping, graph, spectral, ordering and the embedding
modules (weights carried over with ``state_dict_from_jax``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from si_mamba_tpu.models import embed as jembed
from si_mamba_tpu.models import grouping as jgrouping
from si_mamba_tpu.models import ordering as jordering
from si_mamba_tpu.ops import graph as jgraph
from si_mamba_tpu.ops import pointops as jpointops
from si_mamba_tpu.ops import spectral as jspectral
from si_mamba_tpu_torch.models import embed as tembed
from si_mamba_tpu_torch.models import grouping as tgrouping
from si_mamba_tpu_torch.models import ordering as tordering
from si_mamba_tpu_torch.ops import graph as tgraph
from si_mamba_tpu_torch.ops import pointops as tpointops
from si_mamba_tpu_torch.ops import spectral as tspectral
from si_mamba_tpu_torch.utils.weights import state_dict_from_jax

from tests import torch_oracle as oracle


def _clouds(b, n, seed):
    rng = np.random.default_rng(seed)
    pts = rng.standard_normal((b, n, 3)).astype(np.float32)
    return pts / np.abs(pts).max(axis=(1, 2), keepdims=True)


@pytest.fixture(scope="module")
def clouds():
    return _clouds(3, 256, seed=0)


@pytest.fixture(scope="module")
def centers(clouds):
    """FPS patch centres, the graph's input on the model path."""
    idx = np.asarray(jpointops.fps(jnp.asarray(clouds), 32))
    return np.take_along_axis(clouds, idx[..., None], axis=1)


def _t(a):
    return torch.tensor(np.asarray(a))


def test_pairwise_distances_match_jax(clouds):
    x, y = clouds[:, :40], clouds[:, 40:100]
    np.testing.assert_allclose(tpointops.pairwise_sqdist(_t(x), _t(y)).numpy(),
                               np.asarray(jpointops.pairwise_sqdist(x, y)),
                               rtol=1e-5, atol=1e-6)
    # the difference form sums three squares; the frameworks may round the
    # sum differently in the last place
    np.testing.assert_allclose(tpointops.pairwise_sqdist_exact(_t(x), _t(y)).numpy(),
                               np.asarray(jpointops.pairwise_sqdist_exact(x, y)),
                               rtol=1e-6, atol=0)
    np.testing.assert_allclose(tpointops.pairwise_dist(_t(x), _t(y)).numpy(),
                               np.asarray(jpointops.pairwise_dist(x, y)), rtol=1e-6, atol=0)


@pytest.mark.parametrize("start", [0, 17])
def test_fps_indices_match_jax(clouds, start):
    got = tpointops.fps(_t(clouds), 32, start_idx=start).numpy()
    want = np.asarray(jpointops.fps(jnp.asarray(clouds), 32, start_idx=start))
    np.testing.assert_array_equal(got, want)


def test_fps_per_cloud_start_matches_jax(clouds):
    start = np.array([0, 5, 200], np.int32)
    got = tpointops.fps(_t(clouds), 16, start_idx=torch.from_numpy(start)).numpy()
    want = np.asarray(jpointops.fps(jnp.asarray(clouds), 16, start_idx=jnp.asarray(start)))
    np.testing.assert_array_equal(got, want)


def test_knn_gather_group_match_jax(clouds, centers):
    got = tpointops.knn(_t(centers), _t(clouds), 16).numpy()
    want = np.asarray(jpointops.knn(jnp.asarray(centers), jnp.asarray(clouds), 16))
    np.testing.assert_array_equal(got, want)
    grouped = tpointops.group_points(_t(clouds), torch.from_numpy(got)).numpy()
    np.testing.assert_array_equal(
        grouped, np.asarray(jpointops.group_points(jnp.asarray(clouds), jnp.asarray(want))))


def test_group_divider_matches_jax(clouds):
    got = tgrouping.group_divider(_t(clouds), 32, 16)
    want = jgrouping.group_divider(jnp.asarray(clouds), 32, 16)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("symmetric,self_loop,binary", [
    (True, False, True),   # the published config
    (False, False, True),
    (True, True, False),
    (False, False, False),
])
def test_knn_adjacency_matches_jax(centers, symmetric, self_loop, binary):
    # alpha 1 keeps exp(-alpha d^2) out of the denormals, which XLA on the
    # CPU flushes to zero and PyTorch keeps
    kw = dict(k=8, alpha=1.0, symmetric=symmetric, self_loop=self_loop, binary=binary)
    got = tgraph.knn_adjacency(_t(centers), **kw).numpy()
    want = np.asarray(jgraph.knn_adjacency(jnp.asarray(centers), **kw))
    if binary:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_array_equal(got > 0, want > 0)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("eps_mode", ["add", "clamp"])
def test_laplacians_match_jax(centers, eps_mode):
    A = np.asarray(jgraph.knn_adjacency(jnp.asarray(centers), k=8, symmetric=True,
                                        binary=True))
    np.testing.assert_allclose(tgraph.rw_laplacian(_t(A), eps_mode=eps_mode).numpy(),
                               np.asarray(jgraph.rw_laplacian(jnp.asarray(A), eps_mode=eps_mode)),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tgraph.sym_laplacian(_t(A)).numpy(),
                               np.asarray(jgraph.sym_laplacian(jnp.asarray(A))),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("smallest", [True, False])
def test_topk_eigh_matches_jax(centers, smallest):
    A = jgraph.knn_adjacency(jnp.asarray(centers), k=8, symmetric=True, binary=True)
    L = np.asarray(jgraph.rw_laplacian(A))
    vals, vecs, _, _ = tspectral.topk_eigh(_t(L), 4, smallest=smallest)
    jvals, jvecs, _, _ = jspectral.topk_eigh(jnp.asarray(L), 4, smallest=smallest)
    np.testing.assert_allclose(vals.numpy(), np.asarray(jvals), atol=1e-5)
    jvecs = np.asarray(jvecs)
    assert oracle.eig_cosines(vecs, jvecs).min() > 1 - 1e-4
    aligned = oracle.align_signs(vecs, jvecs)
    if smallest:  # the SAST orders: identical once the signs agree
        np.testing.assert_array_equal(
            tspectral.sort_orders_by_eigenvectors(aligned).numpy(),
            np.asarray(jspectral.sort_orders_by_eigenvectors(jnp.asarray(jvecs))))


def test_tril_symmetrize_and_sign_canonicalisation_match_jax():
    M = np.random.default_rng(4).standard_normal((2, 6, 6)).astype(np.float32)
    np.testing.assert_array_equal(tspectral.tril_symmetrize(_t(M)).numpy(),
                                  np.asarray(jspectral.tril_symmetrize(jnp.asarray(M))))
    V = M[..., :3]
    np.testing.assert_array_equal(
        tspectral.canonicalize_eigenvector_signs(_t(V)).numpy(),
        np.asarray(jspectral.canonicalize_eigenvector_signs(jnp.asarray(V))))


def test_sort_orders_stable_on_ties():
    """Equal entries keep their index order, as jnp.argsort (stable) does."""
    v = np.array([[[0.5], [0.1], [0.5], [0.1], [0.3]]], np.float32)
    np.testing.assert_array_equal(
        tspectral.sort_orders_by_eigenvectors(_t(v)).numpy(),
        np.asarray(jspectral.sort_orders_by_eigenvectors(jnp.asarray(v))))


@pytest.mark.parametrize("reverse,reverse_2", [(True, False), (False, True), (False, False)])
def test_sast_sequence_matches_jax(reverse, reverse_2):
    rng = np.random.default_rng(5)
    tok = rng.standard_normal((2, 16, 8)).astype(np.float32)
    pos = rng.standard_normal((2, 16, 8)).astype(np.float32)
    eig = rng.standard_normal((2, 16, 3)).astype(np.float32)
    got = tordering.sast_sequence(_t(eig), _t(tok), _t(pos), reverse=reverse,
                                  reverse_2=reverse_2)
    want = jordering.sast_sequence(jnp.asarray(tok), jnp.asarray(pos), jnp.asarray(eig),
                                   reverse=reverse, reverse_2=reverse_2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_xyz_sequence_matches_jax(centers):
    rng = np.random.default_rng(6)
    tok = rng.standard_normal((3, 32, 8)).astype(np.float32)
    pos = rng.standard_normal((3, 32, 8)).astype(np.float32)
    got = tordering.xyz_sequence(_t(centers), _t(tok), _t(pos))
    want = jordering.xyz_sequence(jnp.asarray(tok), jnp.asarray(pos), jnp.asarray(centers))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _jax_vars(module, *args):
    """Init a flax module, then perturb the BatchNorm statistics so that eval
    BN is not the identity."""
    variables = module.init(jax.random.key(0), *args)
    rng = np.random.default_rng(7)
    stats = jax.tree.map(lambda v: np.asarray(v) + 0.1 * np.abs(
        rng.standard_normal(v.shape)).astype(np.float32), variables.get("batch_stats", {}))
    return {"params": variables["params"], "batch_stats": stats}


def _load(module, sd_prefix, sd):
    sub = {k[len(sd_prefix) + 1:]: v for k, v in sd.items() if k.startswith(sd_prefix + ".")}
    module.load_state_dict(sub, strict=True)
    return module.eval()


def _full_tree(enc=None, enc_s=None, pos=None, head=None, head_s=None):
    """A PointMamba-shaped variable tree around the given submodule trees,
    so that ``state_dict_from_jax`` can carry them (depth 0)."""
    ln = {"scale": np.ones(4, np.float32), "bias": np.zeros(4, np.float32)}
    return ({"encoder": enc, "pos_embed": pos, "blocks": {"norm_f": ln}, "norm": ln,
             "cls_head_finetune": head},
            {"encoder": enc_s, "cls_head_finetune": head_s})


def test_embed_modules_match_jax():
    rng = np.random.default_rng(8)
    groups = rng.standard_normal((2, 8, 16, 3)).astype(np.float32)
    centers = rng.standard_normal((2, 8, 3)).astype(np.float32)
    feats = rng.standard_normal((5, 48)).astype(np.float32)

    jenc = jembed.PatchEncoder(48)
    ev = _jax_vars(jenc, jnp.asarray(groups))
    jpos = jembed.PosEmbedMLP(48)
    pv = jpos.init(jax.random.key(1), jnp.asarray(centers))
    jhead = jembed.ClsHead(7)
    hv = _jax_vars(jhead, jnp.asarray(feats))
    params, stats = _full_tree(ev["params"], ev["batch_stats"], pv["params"],
                               hv["params"], hv["batch_stats"])
    sd = state_dict_from_jax(params, stats)

    enc = _load(tembed.PatchEncoder(48), "encoder", sd)
    pos = _load(tembed.PosEmbedMLP(48), "pos_embed", sd)
    head = _load(tembed.ClsHead(48, 7), "cls_head_finetune", sd)
    with torch.no_grad():
        np.testing.assert_allclose(enc(_t(groups)).numpy(),
                                   np.asarray(jenc.apply(ev, jnp.asarray(groups))),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(pos(_t(centers)).numpy(),
                                   np.asarray(jpos.apply(pv, jnp.asarray(centers))),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(head(_t(feats)).numpy(),
                                   np.asarray(jhead.apply(hv, jnp.asarray(feats))),
                                   rtol=1e-4, atol=1e-5)
