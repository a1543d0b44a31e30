"""Perf mode on the Mamba-1 per-op route against the JAX package on the CPU:
bf16 activations (fp32 parameters, BatchNorm statistics and scan state) and
the subspace eigensolver, as cfgs/finetune_modelnet_perf.yaml sets them.

Held here, at small sizes with inputs from numpy seeds: the Rademacher start
bit for bit; ``topk_smallest_subspace``; the bf16 plain versions of K1/K5
and K2/K3/K4 against the Pallas kernels in interpret mode (values and
``jax.vjp``); the bf16 mixer on both conv routes; the bf16 ``PointMamba``
with ``eigh`` and with ``subspace``; one bf16 train step's loss and
gradients; ``Predictor.from_checkpoint(perf=True)``; the CLI on the perf
preset. The CUDA kernels' bf16 variants are held against these plain versions
on the card in tests/test_torch_port_cuda.py.

Tolerances are in bf16 ulps where a value is rounded to bf16 once by both
sides (the ulp taken at least at a floor of the output's max, since sums
that cancel lose relative accuracy in fp32 too), and relative to the max
where bf16 rounds at many points on both sides in different places
(matmuls, XLA's bf16 elementwise ops).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from si_mamba_tpu.models import PointMamba as JPointMamba
from si_mamba_tpu.models import PointMambaConfig as JConfig
from si_mamba_tpu.models.grouping import group_divider as j_group_divider
from si_mamba_tpu.models.point_mamba import cross_entropy_loss_acc as j_ce
from si_mamba_tpu.models.point_mamba import spectral_eigvecs as j_spectral_eigvecs
from si_mamba_tpu.ops.graph import knn_adjacency as j_knn, rw_laplacian as j_rw
from si_mamba_tpu.ops.pallas.causal_conv_kernel import causal_conv1d_silu_pallas
from si_mamba_tpu.ops.pallas.selective_scan_kernel import _vjp_fwd, selective_scan_pallas
from si_mamba_tpu.ops.spectral import sort_orders_by_eigenvectors as j_sort_orders
from si_mamba_tpu.ops.spectral import topk_smallest_subspace as j_subspace
from si_mamba_tpu.train.config import get_config as j_get_config
from si_mamba_tpu_torch.models import PointMamba, PointMambaConfig
from si_mamba_tpu_torch.models import point_mamba as port_pm
from si_mamba_tpu_torch.ops import selective_scan as tss
from si_mamba_tpu_torch.ops.graph import knn_adjacency, rw_laplacian
from si_mamba_tpu_torch.ops.kernels import causal_conv as kconv
from si_mamba_tpu_torch.ops.kernels import selective_scan as kscan
from si_mamba_tpu_torch.ops.spectral import (
    rademacher,
    sort_orders_by_eigenvectors,
    topk_smallest_subspace,
)
from si_mamba_tpu_torch.serving import Predictor
from si_mamba_tpu_torch.train import cli
from si_mamba_tpu_torch.train.config import get_config
from si_mamba_tpu_torch.utils.weights import state_dict_from_jax

from tests import torch_oracle as oracle
from tests.test_torch_port_harness import ROOT, _scalars, modelnet_tree  # noqa: F401

jss = importlib.import_module("si_mamba_tpu.ops.selective_scan")

BF = torch.bfloat16
SMALL = dict(trans_dim=96, encoder_dims=96, depth=2, cls_dim=10, num_group=32,
             group_size=16, drop_path=0.0, cls_head_dropout=0.0)
PERF = dict(dtype="bfloat16", spectral_method="subspace")


def _np(a) -> np.ndarray:
    """A torch tensor or JAX array of any float dtype as float32 numpy."""
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _ulps(got, want, floor: float = 1e-2) -> float:
    """The largest |got - want| in bf16 ulps of want (8 significant bits),
    each ulp taken at least at ``floor`` of max|want|."""
    got, want = _np(got), _np(want)
    mag = np.maximum(np.abs(want), floor * np.abs(want).max())
    return float(np.max(np.abs(got - want) / 2.0 ** (np.floor(np.log2(mag)) - 7)))


def _rel(got, want) -> float:
    """max |got - want| over max |want|."""
    got, want = _np(got), _np(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _bf16(a: np.ndarray):
    """The same bf16 values (round to nearest even) in both frameworks."""
    return torch.from_numpy(a).to(BF), jnp.asarray(a).astype(jnp.bfloat16)


def _clouds(b, n, seed):
    rng = np.random.default_rng(seed)
    pts = rng.standard_normal((b, n, 3)).astype(np.float32)
    return pts / np.abs(pts).max(axis=(1, 2), keepdims=True)


# ---------------------------------------------------------------------------
# the subspace eigensolver
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,shape", [(0, (3, 64, 8)), (1, (32, 64, 8)), (7, (2, 5, 3)),
                                        (2 ** 31 - 1, (4, 17))])
def test_rademacher_start_is_bitwise_jax(seed, shape):
    want = np.asarray(jax.random.rademacher(jax.random.key(seed), shape, jnp.float32))
    got = rademacher(seed, shape)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def _laplacians(seed, b=4, g=32):
    rng = np.random.default_rng(seed)
    center = rng.standard_normal((b, g, 3)).astype(np.float32)
    kw = dict(k=20, alpha=100.0, symmetric=True, self_loop=False, binary=True)
    L = rw_laplacian(knn_adjacency(torch.from_numpy(center), **kw), eps=1e-6, eps_mode="add")
    jL = j_rw(j_knn(jnp.asarray(center), **kw), eps=1e-6, eps_mode="add")
    np.testing.assert_allclose(L.numpy(), np.asarray(jL), rtol=1e-6, atol=1e-7)
    return L, jL


@pytest.mark.parametrize("seed", [0, 1])
def test_subspace_matches_jax(seed):
    """The same start and steps converge to the same pairs: eigenvalues within
    1e-5, eigenvectors within 1e-4 after sign alignment (the Ritz vectors'
    signs are eigh's arbitrary choice), and the same SAST orders."""
    L, jL = _laplacians(seed)
    vals, vecs = topk_smallest_subspace(L, 4)
    jvals, jvecs = j_subspace(jL, 4)
    jvecs = np.asarray(jvecs)
    assert vals.shape == (4, 4) and vecs.shape == (4, 32, 4)
    np.testing.assert_allclose(vals.numpy(), np.asarray(jvals), atol=1e-5)
    aligned = oracle.align_signs(vecs, jvecs)
    np.testing.assert_allclose(aligned.numpy(), jvecs, atol=1e-4)
    np.testing.assert_array_equal(sort_orders_by_eigenvectors(aligned).numpy(),
                                  np.asarray(j_sort_orders(jnp.asarray(jvecs))))


# ---------------------------------------------------------------------------
# K1/K5: the causal conv at bf16 against the Pallas kernel in interpret mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("l,d,off", [(50, 32, 0), (37, 24, 24)])
def test_conv_bf16_plain_matches_pallas_interpret(l, d, off):
    """x and g bf16 (a column view of a bf16 xz), weight and bias fp32: y and
    dx in bf16 within one ulp of the Pallas kernel's (each rounds one fp32
    sum), dw and db fp32 within 1e-5 of the max (sums in another order); the
    autograd Function on the CPU is the plain backward."""
    rng = np.random.default_rng(l)
    xz = rng.standard_normal((2, l, 2 * d)).astype(np.float32)
    w = (rng.standard_normal((d, 4)) * 0.5).astype(np.float32)
    b = (rng.standard_normal(d) * 0.1).astype(np.float32)
    g = rng.standard_normal((2, l, d)).astype(np.float32)
    (txz, jxz), (tg, jg) = _bf16(xz), _bf16(g)
    x, jx = txz[..., off:off + d], jxz[..., off:off + d]
    y = kconv.causal_conv1d_ref(x, torch.from_numpy(w), torch.from_numpy(b))
    jy, vjp = jax.vjp(lambda x, w, b: causal_conv1d_silu_pallas(x, w, b, interpret=True),
                      jx, jnp.asarray(w), jnp.asarray(b))
    assert y.dtype == BF and jy.dtype == jnp.bfloat16
    assert _ulps(y, jy) <= 1
    dx, dw, db = kconv.causal_conv1d_silu_bwd_ref(x, torch.from_numpy(w), torch.from_numpy(b), tg)
    jdx, jdw, jdb = vjp(jg)
    assert dx.dtype == BF and dw.dtype == db.dtype == torch.float32
    assert _ulps(dx, jdx) <= 1
    assert _rel(dw, jdw) <= 1e-5 and _rel(db, jdb) <= 1e-5
    leaves = [t.detach().clone().requires_grad_() for t in
              (x, torch.from_numpy(w), torch.from_numpy(b))]
    out = kconv.causal_conv1d_silu(*leaves)
    assert out.dtype == BF
    for got, want in zip(torch.autograd.grad(out, leaves, tg), (dx, dw, db)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("row,off,vx,vec", [(1536, 0, 4, 4), (1536, 2, 2, 2), (1537, 0, 1, 1),
                                            (1536, 4, 4, 4), (1536, 8, 4, 4)])
def test_conv_bf16_plans_count_elements(row, off, vx, vec):
    """The bf16 K5 plan counts its widths in bf16 elements (the Mamba-1 view,
    columns :768 of a 1536-wide bf16 xz, moves 4 a thread: 8 bytes), and so
    does the bf16 K1's: 4 channels as one 8-byte access where x allows, else
    2 (4 bytes), else one."""
    x = torch.empty((32, 512, row), device="meta", dtype=BF)[..., off:off + 768]
    g = torch.empty((32, 512, 768), device="meta", dtype=BF)
    plan = kconv.bwd_plan(x, g)
    assert plan.vx == vx and (plan.vx, plan.vg) in kconv.BWD_VARIANTS
    assert kconv.fwd_plan(x).vec == vec
    assert (plan.tile, plan.partial_shape) == (64, (64, 5, 768))


def _k1_bf16_arithmetic(x, w, b):
    """The bf16 K1's arithmetic on the CPU: x widened to fp32; s = bias, then
    one fused multiply-add a tap, oldest first (the product and sum taken in
    float64 and rounded to fp32 once, as an FMA rounds); y = s / (1 + exp(-s))
    as __fdividef takes it in fp32: s times the reciprocal, 0 where the
    denominator reaches 2^126; rounded to bf16 once. (The card's exp and
    reciprocal are within a few fp32 ulps of these.)"""
    B, L, D = x.shape
    xpad = torch.nn.functional.pad(x.float(), (0, 0, 3, 0))
    s = b.float().expand(B, L, D)
    for k in range(4):
        s = (s.double() + w[:, k].double() * xpad[:, k:k + L].double()).float()
    den = 1.0 + torch.exp(-s)
    y = torch.where(den.abs() >= 2.0 ** 126, torch.zeros_like(s), s * torch.reciprocal(den))
    return y.to(BF)


@pytest.mark.parametrize("l,d,off,scale", [(50, 32, 0, 1.0), (37, 24, 24, 1.0), (40, 16, 8, 40.0)])
def test_conv_bf16_kernel_silu_matches_pallas_interpret(l, d, off, scale):
    """The bf16 K1 computes SiLU as __fdividef(s, 1 + __expf(-s)) (a fast exp,
    an approximate reciprocal and a multiply), not the fp32 kernel's IEEE
    division: that arithmetic, emulated in fp32, stays within one bf16 ulp of
    the Pallas kernel in interpret mode and of the plain version, also where
    |s| reaches 100 and 1 + exp(-s) passes 2^126 or overflows."""
    rng = np.random.default_rng(l + d)
    xz = (rng.standard_normal((2, l, 2 * d)) * scale).astype(np.float32)
    w = (rng.standard_normal((d, 4)) * 0.5).astype(np.float32)
    b = (rng.standard_normal(d) * 0.1).astype(np.float32)
    txz, jxz = _bf16(xz)
    x, jx = txz[..., off:off + d], jxz[..., off:off + d]
    y = _k1_bf16_arithmetic(x, torch.from_numpy(w), torch.from_numpy(b))
    jy = causal_conv1d_silu_pallas(jx, jnp.asarray(w), jnp.asarray(b), interpret=True)
    assert _ulps(y, jy) <= 1
    ref = kconv.causal_conv1d_ref(x, torch.from_numpy(w), torch.from_numpy(b))
    assert _ulps(y, ref) <= 1


# ---------------------------------------------------------------------------
# K2/K3/K4: the selective scan at bf16 against the Pallas kernels
# ---------------------------------------------------------------------------

def _scan_bf16(b, l, d, n, seed):
    """Activations bf16 (B and C column views of one bf16 x_dbl, as the
    mixer makes them), A, D and delta_bias fp32: (port args, JAX args, g)."""
    rng = np.random.default_rng(seed)
    mk = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    u, delta, z, x_dbl, g = (_bf16(a) for a in (mk(b, l, d), mk(b, l, d) * 0.5, mk(b, l, d),
                                                  mk(b, l, 2 + 2 * n), mk(b, l, d)))
    A, D, db = -np.exp(mk(d, n)), mk(d), mk(d) * 0.1
    port = [u[0], delta[0], torch.from_numpy(A), x_dbl[0][..., 2:2 + n],
            x_dbl[0][..., 2 + n:], torch.from_numpy(D), z[0], torch.from_numpy(db)]
    jx = [u[1], delta[1], jnp.asarray(A), x_dbl[1][..., 2:2 + n], x_dbl[1][..., 2 + n:],
          jnp.asarray(D), z[1], jnp.asarray(db)]
    return port, jx, g


@pytest.mark.parametrize("l", [64, 50])
def test_scan_bf16_plain_matches_pallas_interpret(l):
    """The lean forward's y within one bf16 ulp of the Pallas kernel's (floor
    1e-2 of max|y|), the training forward's y equal to it; through
    SelectiveScanFn on the CPU every gradient against ``jax.vjp`` of the
    Pallas kernel: du, ddelta, dz, dB and dC in bf16 (dz from y_pre rounded to
    bf16 on both sides) within 2 ulps at a floor of 2e-2 of their max (fp32
    sums over states and channels in other orders, then one rounding), dA,
    dD and ddelta_bias in fp32 within 1e-4 of their max."""
    port, jx, g = _scan_bf16(2, l, 32, 4, seed=l)
    y = kscan.selective_scan_ref(*port[:5], D=port[5], z=port[6], delta_bias=port[7])
    y3, _ = kscan.selective_scan_fwd_residuals_ref(*port)
    jy, vjp = jax.vjp(lambda *a: selective_scan_pallas(
        *a[:5], D=a[5], z=a[6], delta_bias=a[7], block_d=16, chunk=16, interpret=True), *jx)
    assert y.dtype == BF and jy.dtype == jnp.bfloat16
    assert torch.equal(y3, y)
    assert _ulps(y, jy) <= 1
    leaves = [t.detach().clone().requires_grad_() for t in port]
    out = kscan.SelectiveScanFn.apply(*leaves)
    grads = torch.autograd.grad(out, leaves, g[0])
    names = ("du", "ddelta", "dA", "dB", "dC", "dD", "dz", "ddelta_bias")
    for name, got, want, leaf in zip(names, grads, vjp(g[1]), leaves):
        assert got.dtype == leaf.dtype, name
        if leaf.dtype == BF:
            assert _ulps(got, want, floor=2e-2) <= 2, name
        else:
            assert _rel(got, want) <= 1e-4, name


def test_scan_bf16_residual_entries_match_jax():
    """The bf16 training forward's fp32 entry states, one per 16 steps, equal
    JAX's ``_vjp_fwd`` entries (one per 128 steps) on the shared boundaries."""
    port, jx, _ = _scan_bf16(2, 256, 32, 4, seed=3)
    _, h_entries = kscan.selective_scan_fwd_residuals_ref(*port)
    assert h_entries.dtype == torch.float32
    _, res = _vjp_fwd(*jx, 32, 128, True)
    np.testing.assert_allclose(h_entries[:, ::128 // kscan.CHUNK].numpy(), np.asarray(res[8]),
                               rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# the mixer at bf16, both conv routes
# ---------------------------------------------------------------------------

def _mixer_params(d_model=16, d_state=4, dt_rank=2, seed=3):
    rng = np.random.default_rng(seed)
    di = 2 * d_model
    mk = lambda *s, sc=0.3: (rng.standard_normal(s) * sc).astype(np.float32)  # noqa: E731
    return {"in_proj_w": mk(d_model, 2 * di), "conv_w": mk(di, 4), "conv_b": mk(di, sc=0.1),
            "x_proj_w": mk(di, dt_rank + 2 * d_state), "dt_proj_w": mk(dt_rank, di),
            "dt_proj_b": mk(di, sc=0.1),
            "A_log": np.log(np.tile(np.arange(1, d_state + 1, dtype=np.float32), (di, 1))),
            "D": np.ones(di, np.float32), "out_proj_w": mk(di, d_model)}


def _jax_mixer_kernel_route(p, x, d_state, dt_rank):
    """``mamba_mixer_apply``'s Pallas route at bf16 (what the JAX package runs
    on the TPU), with both kernels in interpret mode: the fp32 conv weights
    into the conv kernel, every matmul weight cast to bf16."""
    cdt = x.dtype
    xz = x @ p["in_proj_w"].astype(cdt)
    di = xz.shape[-1] // 2
    xi = causal_conv1d_silu_pallas(xz[..., :di], p["conv_w"], p["conv_b"], interpret=True)
    x_dbl = xi @ p["x_proj_w"].astype(cdt)
    dt = x_dbl[..., :dt_rank] @ p["dt_proj_w"].astype(cdt)
    y = selective_scan_pallas(xi, dt, -jnp.exp(p["A_log"]), x_dbl[..., dt_rank:dt_rank + d_state],
                              x_dbl[..., dt_rank + d_state:], D=p["D"], z=xz[..., di:],
                              delta_bias=p["dt_proj_b"], block_d=32, chunk=16, interpret=True)
    return y.astype(cdt) @ p["out_proj_w"].astype(cdt)


@pytest.mark.parametrize("route,impls", [("xla conv", ("seq", "chunked", "auto")),
                                         ("kernel conv", ("pallas",))])
def test_mixer_bf16_matches_jax(route, impls):
    """bf16 in, bf16 out, within 2e-2 of the max: the plain routes take the
    bf16-cast conv weights (JAX's XLA conv, 'seq'), the kernel route the
    fp32 ones (JAX's Pallas route); bf16 rounds after every matmul and, in
    XLA's conv, after every shifted add, in places the two frameworks do not
    share."""
    p = _mixer_params()
    x = np.random.default_rng(4).standard_normal((2, 40, 16)).astype(np.float32)
    tx, jx = _bf16(x)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    if route == "xla conv":
        want = jss.mamba_mixer_apply(jp, jx, d_state=4, dt_rank=2, impl="seq")
    else:
        want = _jax_mixer_kernel_route(jp, jx, 4, 2)
    assert want.dtype == jnp.bfloat16
    for impl in impls:
        got = tss.mamba_mixer_apply({k: torch.from_numpy(v) for k, v in p.items()}, tx,
                                    d_state=4, dt_rank=2, impl=impl)
        assert got.dtype == BF, impl
        assert _rel(got, want) <= 2e-2, (impl, _rel(got, want))


# ---------------------------------------------------------------------------
# the model, a train step, the predictor, the CLI
# ---------------------------------------------------------------------------

def _models(method_kw, seed=0):
    """A JAX ``PointMamba`` at ``method_kw`` (dtype, spectral_method) and the
    port's, loaded with its JAX-initialised (fp32) weights."""
    jcfg = JConfig(**SMALL, **method_kw)
    jmodel = JPointMamba(jcfg)
    variables = jmodel.init(jax.random.key(seed), jnp.zeros((2, 256, 3)), train=False)
    model = PointMamba(PointMambaConfig(**SMALL, **method_kw))
    model.load_state_dict(state_dict_from_jax(variables["params"], variables["batch_stats"]),
                          strict=True)
    return jcfg, jmodel, variables, model


def _aligned_eigvecs(monkeypatch, jcfg, pts):
    """Make the port's eigenvectors take JAX's signs for these clouds (the
    solvers' signs are arbitrary); asserts that the pairs agree and that the
    SAST orders of the bf16-rounded vectors are JAX's."""
    grouped = j_group_divider(jnp.asarray(pts), jcfg.num_group, jcfg.group_size)
    jeig = np.asarray(j_spectral_eigvecs(grouped.center, jcfg)[1])
    real = port_pm.spectral_eigvecs

    def aligned(center, cfg):
        vals, vecs = real(center, cfg)
        assert oracle.eig_cosines(vecs, jeig).min() > 1 - 1e-4
        vecs = oracle.align_signs(vecs, jeig)
        np.testing.assert_array_equal(
            sort_orders_by_eigenvectors(vecs.to(BF).float()).numpy(),
            np.asarray(j_sort_orders(jnp.asarray(jeig).astype(jnp.bfloat16))))
        return vals, vecs

    monkeypatch.setattr(port_pm, "spectral_eigvecs", aligned)


@pytest.mark.parametrize("spectral_method", ["eigh", "subspace"])
def test_pointmamba_bf16_logits_match_jax(spectral_method, monkeypatch):
    """The bf16 classifier's eval logits (bf16, as JAX's) within 3e-2 of the
    max logit of JAX's, and its pooled features within 3e-2 of their max, on
    clouds whose bf16-rounded eigenvectors sort alike in both frameworks
    (a tie that one framework's rounding makes and the other's does not
    swaps two tokens; the orders are asserted equal)."""
    jcfg, jmodel, variables, model = _models(dict(dtype="bfloat16",
                                                  spectral_method=spectral_method))
    pts = _clouds(4, 256, seed=2)
    want, want_feat = jmodel.apply(variables, jnp.asarray(pts), train=False,
                                   return_features=True)
    _aligned_eigvecs(monkeypatch, jcfg, pts)
    with torch.no_grad():
        got, feat = model.eval()(torch.from_numpy(pts), return_features=True)
    assert got.dtype == BF and want.dtype == jnp.bfloat16
    assert _rel(got, want) <= 3e-2, _rel(got, want)
    assert _rel(feat, want_feat) <= 3e-2, _rel(feat, want_feat)


# Parameters whose exact gradient is 0: a per-channel constant that reaches a
# BatchNorm (through linear maps, max-pools and mean-pools only) is removed by
# it. In bf16 each framework's gradient for them is its own rounding noise.
ZERO_GRADIENT = ("encoder.first_conv.0.bias", "encoder.first_conv.3.bias",
                 "encoder.second_conv.0.bias", "norm.bias", "cls_head_finetune.0.bias",
                 "cls_head_finetune.4.bias")


def test_train_step_bf16_matches_jax(monkeypatch):
    """One train-mode forward and backward of the perf-mode classifier (bf16,
    subspace), drop rates 0: the loss within 1e-2 relative of JAX's; every
    parameter gradient fp32 and, but for the ZERO_GRADIENT leaves, at a
    cosine of at least 0.95 to JAX's with a norm within 20 % of it (bf16
    rounds every activation gradient; the max-pools route a gradient to
    whichever points tie in bf16, which differ between the frameworks, and
    the BatchNorms' backward cancels most of each sum, so element-wise
    errors reach 10-20 % of a leaf's max while its direction and norm hold);
    and the BatchNorm statistics moved alike (within 1e-2 of their max)."""
    jcfg, jmodel, variables, model = _models(PERF, seed=1)
    pts = _clouds(8, 256, seed=3)
    labels = np.random.default_rng(3).integers(0, SMALL["cls_dim"], 8)

    def loss_fn(params):
        logits, upd = jmodel.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                   jnp.asarray(pts), train=True, mutable=["batch_stats"])
        per, _ = j_ce(logits, jnp.asarray(labels, jnp.int32))
        return jnp.mean(per), upd["batch_stats"]

    (jloss, jstats), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(variables["params"])
    _aligned_eigvecs(monkeypatch, jcfg, pts)
    per, _ = port_pm.cross_entropy_loss_acc(model.train()(torch.from_numpy(pts)),
                                            torch.from_numpy(labels))
    loss = per.mean()
    loss.backward()
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-2)
    want = state_dict_from_jax(jgrads, jstats)
    for k, p in model.named_parameters():
        assert p.grad.dtype == torch.float32, k
        if k in ZERO_GRADIENT:
            continue
        g, w = (np.asarray(t, np.float64).ravel() for t in (p.grad.numpy(), want[k]))
        cos = g @ w / (np.linalg.norm(g) * np.linalg.norm(w))
        assert cos >= 0.95 and 0.8 <= np.linalg.norm(g) / np.linalg.norm(w) <= 1.25, k
    for k, v in model.state_dict().items():
        if "running" in k:
            w = np.asarray(want[k])
            assert float(np.abs(v.numpy() - w).max()) <= 1e-2 * max(np.abs(w).max(), 1e-6), k


def test_perf_predictor_on_the_cpu():
    """``perf=True`` sets bf16 and the subspace solver unless the config
    does, and serves fp32 logits equal to its model's bf16 forward."""
    sd = {k: v.numpy() for k, v in PointMamba(PointMambaConfig(**SMALL)).state_dict().items()}
    p = Predictor.from_checkpoint(sd, model_cfg=SMALL, npoints=256, max_batch=3, perf=True,
                                  device="cpu")
    assert (p.model.config.dtype, p.model.config.spectral_method) == ("bfloat16", "subspace")
    clouds = _clouds(5, 256, seed=4)
    got = p.logits(clouds)
    with torch.no_grad():  # the predictor's chunks of max_batch
        want = torch.cat([p.model(torch.from_numpy(clouds[s:s + 3])) for s in (0, 3)]).float()
    want = want.numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    exact = Predictor.from_checkpoint(sd, model_cfg={**SMALL, "spectral_method": "eigh"},
                                      npoints=256, perf=True, device="cpu")
    assert (exact.model.config.dtype, exact.model.config.spectral_method) == ("bfloat16", "eigh")


def test_perf_preset_config_matches_jax():
    """cfgs/finetune_modelnet_perf.yaml gives the port the JAX package's model
    config (the published width, bf16, subspace), and that model builds."""
    cfg = PointMambaConfig.from_dict(get_config(str(ROOT / "cfgs" / "finetune_modelnet_perf.yaml"))
                                     .model)
    jcfg = JConfig.from_dict(j_get_config(str(ROOT / "cfgs" / "finetune_modelnet_perf.yaml"))
                             .model)
    assert cfg.__dict__ == jcfg.__dict__
    assert (cfg.dtype, cfg.spectral_method, cfg.trans_dim, cfg.depth) == (
        "bfloat16", "subspace", 384, 12)
    assert PointMamba(cfg).dtype == BF


def test_cli_trains_the_perf_preset_on_the_cpu(modelnet_tree, tmp_path, monkeypatch):  # noqa: F811
    """The CLI on a config whose base is the perf preset (narrowed to the
    small model): one epoch of two steps at bf16 with the subspace solver,
    a finite epoch loss, fp32 parameters, ``--test`` of ckpt-last.pth equal
    to the last validation."""
    monkeypatch.chdir(tmp_path)
    cfg = tmp_path / "tiny_perf.yaml"
    body = {**{k: v for k, v in SMALL.items()}, "cls_dim": 5}
    cfg.write_text(
        f"_base_: {ROOT}/cfgs/finetune_modelnet_perf.yaml\n"
        "dataset:\n" + "".join(
            f"  {s}: {{_base_: {modelnet_tree}/modelnet.yaml, others: {{subset: '{sub}'}}}}\n"
            for s, sub in (("train", "train"), ("val", "test"), ("test", "test"))) +
        "model: {" + ", ".join(f"{k}: {v}" for k, v in body.items()) + "}\n"
        "scheduler: {type: CosLR, kwargs: {epochs: 3, initial_epochs: 0}}\n"
        "total_bs: 8\nmax_epoch: 0\n")
    args = ["--config", str(cfg), "--device", "cpu", "--num_workers", "2"]
    state, _ = cli.main(args)
    assert (state.model.config.dtype, state.model.config.spectral_method) == (
        "bfloat16", "subspace")
    assert state.step == 2
    exp = tmp_path / "experiments" / "tiny_perf" / "default"
    losses = [r["value"] for r in _scalars(exp) if r["tag"] == "Loss/Epoch/Loss"]
    assert len(losses) == 1 and np.isfinite(losses).all()
    for p in state.model.parameters():
        assert p.dtype == torch.float32
    last_acc = [r["value"] for r in _scalars(exp) if r["tag"] == "Metric/ACC"][-1]
    acc = cli.main(args + ["--test", "--ckpts", str(exp / "ckpt-last.pth"), "--exp_name", "t"])
    assert acc == last_acc
