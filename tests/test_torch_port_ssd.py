"""The SSD-mixer slice of the port against the JAX package on the CPU: the
plain versions of K8 and K9 against the Pallas xbc kernel in interpret mode,
the chunked core and the mixer, the SSD ``PointMamba``'s logits with weights
carried over by ``state_dict_from_jax``, and one train step. Inputs are made
with numpy from a seed and handed to both frameworks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from si_mamba_tpu.models import PointMamba as JPointMamba
from si_mamba_tpu.models import PointMambaConfig as JConfig
from si_mamba_tpu.models.grouping import group_divider as j_group_divider
from si_mamba_tpu.models.layers import SSDMixer as JSSDMixer
from si_mamba_tpu.models.point_mamba import cross_entropy_loss_acc as j_ce
from si_mamba_tpu.models.point_mamba import spectral_eigvecs as j_spectral_eigvecs
from si_mamba_tpu.ops import ssd as jssd
from si_mamba_tpu.ops.pallas import ssd_kernel as jk
from si_mamba_tpu_torch.models import PointMamba, PointMambaConfig
from si_mamba_tpu_torch.models import point_mamba as port_pm
from si_mamba_tpu_torch.models.layers import SSDMixer
from si_mamba_tpu_torch.ops import ssd as tssd
from si_mamba_tpu_torch.ops.kernels import ssd as kssd
from si_mamba_tpu_torch.utils import weights
from si_mamba_tpu_torch.utils.weights import state_dict_from_jax

from tests import ssd_emulation as emu
from tests import torch_oracle as oracle

FWD_TOL = dict(rtol=2e-5, atol=2e-5)  # tests/test_ssd_pallas.py:38
GRAD_TOL = dict(rtol=5e-4, atol=5e-5)  # tests/test_ssd_pallas.py:69


def _core_case(b, l, h, p, n, seed, pad=0):
    """xbc (b, l, h*p + 2n), dt (b, l, h) post-softplus, A (h,) < 0, D (h,);
    the last ``pad`` rows are a zero-dt, zero-input tail, as the mixer pads."""
    rng = np.random.default_rng(seed)
    xbc = rng.standard_normal((b, l, h * p + 2 * n)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, l, h)))).astype(np.float32)
    if pad:
        xbc[:, l - pad:] = 0.0
        dt[:, l - pad:] = 0.0
    A = (-np.exp(rng.standard_normal(h))).astype(np.float32)
    D = rng.standard_normal(h).astype(np.float32)
    return xbc, dt, A, D


def _chunk_layout(dt, A, chunk):
    """(dt, S) in the kernels' (b, h, nc, q) layout, computed by JAX."""
    b, l, h = dt.shape
    dth = jnp.asarray(dt).transpose(0, 2, 1).reshape(b, h, l // chunk, chunk)
    S = jnp.cumsum(dth * jnp.asarray(A)[None, :, None, None], axis=-1)
    return np.asarray(dth), np.asarray(S)


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a).copy()) for a in arrays]


# ---------------------------------------------------------------------------
# the plain versions of K8 and K9
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk,l,pad", [(32, 128, 0), (64, 192, 0), (64, 64, 0),
                                         (32, 128, 28)],
                         ids=["nc4", "nc3", "single_chunk", "padded_tail"])
def test_plain_k8_matches_pallas_interpret(chunk, l, pad):
    """y and the per-chunk entry states of ``ssd_xbc_fwd_ref`` against the
    Pallas xbc kernel's forward in interpret mode, and y against the XLA
    chunked core."""
    h, p, n = 3, 16, 8
    xbc, dt, A, D = _core_case(2, l, h, p, n, seed=chunk + l + pad, pad=pad)
    dth, S = _chunk_layout(dt, A, chunk)
    SD = jk._stack_sdd(jnp.asarray(S), jnp.asarray(dth), jnp.asarray(D))
    y_j, hin_j, _ = jk._fwd_call_xbc(SD, jnp.asarray(xbc), h * p, True, emit_states=True)
    y, h_in = kssd.ssd_xbc_fwd_ref(*_t(xbc, dth, S, D), h * p, chunk, emit_states=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), **FWD_TOL)
    np.testing.assert_allclose(h_in.numpy(), np.asarray(hin_j), **FWD_TOL)
    x = xbc[..., :h * p].reshape(2, l, h, p)
    y_x = jssd.ssd_chunked(jnp.asarray(x), jnp.asarray(dt), jnp.asarray(A),
                           jnp.asarray(xbc[..., h * p:h * p + n]),
                           jnp.asarray(xbc[..., h * p + n:]), jnp.asarray(D), chunk=chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_x).reshape(2, l, h * p), **FWD_TOL)
    lean = kssd.ssd_xbc_fwd(*_t(xbc, dth, S, D), h * p, chunk)
    assert torch.equal(lean, y)


@pytest.mark.parametrize("chunk,l,h", [(32, 96, 2), (64, 128, 3)])
def test_plain_k9_matches_jax_vjp_of_the_pallas_kernel(chunk, l, h):
    """dxbc, ddt, dS and dD of ``ssd_xbc_bwd_ref`` against ``jax.vjp`` of the
    Pallas xbc core (its custom VJP: the backward kernel, interpret mode)."""
    p, n = 16, 8
    xbc, dt, A, D = _core_case(2, l, h, p, n, seed=7 + l)
    dth, S = _chunk_layout(dt, A, chunk)
    dy = np.random.default_rng(8).standard_normal((2, l, h * p)).astype(np.float32)
    core = lambda a, b_, c, d_: jk._ssd_fused_xbc(a, b_, c, d_, h * p, True)  # noqa: E731
    _, vjp = jax.vjp(core, *(jnp.asarray(a) for a in (xbc, dth, S, D)))
    want = vjp(jnp.asarray(dy))
    _, h_in = kssd.ssd_xbc_fwd_ref(*_t(xbc, dth, S, D), h * p, chunk, emit_states=True)
    xbc_t, dth_t, S_t, D_t, dy_t = _t(xbc, dth, S, D, dy)
    got = kssd.ssd_xbc_bwd_ref(xbc_t, dth_t, S_t, D_t, h_in, dy_t, h * p, chunk)
    for name, g, w in zip(("dxbc", "ddt", "dS", "dD"), got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name, **GRAD_TOL)


def test_ssd_chunked_xbc_grads_match_jax_grad():
    """Gradients of the port's ``ssd_chunked_xbc`` (the autograd Function over
    the plain K8/K9, S taken outside it) with respect to xbc, dt, A_log and D,
    against ``jax.grad`` of ``ssd_chunked_pallas_xbc`` in interpret mode."""
    h, p, n, chunk, l = 2, 16, 8, 32, 128
    xbc, dt, _, D = _core_case(2, l, h, p, n, seed=9)
    A_log = np.random.default_rng(10).standard_normal(h).astype(np.float32)

    def j_loss(xbc_, dt_, A_log_, D_):
        y = jk.ssd_chunked_pallas_xbc(xbc_, dt_, -jnp.exp(A_log_), D_, d_inner=h * p,
                                      chunk=chunk, interpret=True)
        return jnp.sum(jnp.sin(y) * jnp.cos(0.3 * y))

    want = jax.grad(j_loss, argnums=(0, 1, 2, 3))(*(jnp.asarray(a) for a in (xbc, dt, A_log, D)))
    leaves = [t.requires_grad_() for t in _t(xbc, dt, A_log, D)]
    y = kssd.ssd_chunked_xbc(leaves[0], leaves[1], -torch.exp(leaves[2]), leaves[3],
                             d_inner=h * p, chunk=chunk)
    assert isinstance(y.grad_fn, kssd.SSDChunkedXbcFn._backward_cls)
    torch.sum(torch.sin(y) * torch.cos(0.3 * y)).backward()
    for name, leaf, w in zip(("xbc", "dt", "A_log", "D"), leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w), err_msg=name, **GRAD_TOL)


def test_no_grad_takes_the_lean_forward():
    xbc, dt, A, D = _core_case(1, 64, 2, 16, 8, seed=11)
    xbc_t, dt_t, A_t, D_t = _t(xbc, dt, A, D)
    D_t.requires_grad_()
    with torch.no_grad():
        y = kssd.ssd_chunked_xbc(xbc_t, dt_t, A_t, D_t, d_inner=32, chunk=32)
    assert y.grad_fn is None
    assert isinstance(kssd.ssd_chunked_xbc(xbc_t, dt_t, A_t, D_t, d_inner=32, chunk=32).grad_fn,
                      kssd.SSDChunkedXbcFn._backward_cls)


# ---------------------------------------------------------------------------
# the plain core: oracle, chunked form, strong decay, carry
# ---------------------------------------------------------------------------

def _split_case(b, l, h, p, n, seed):
    xbc, dt, A, D = _core_case(b, l, h, p, n, seed)
    x = xbc[..., :h * p].reshape(b, l, h, p)
    return x, dt, A, xbc[..., h * p:h * p + n], xbc[..., h * p + n:], D


def test_ssd_chunked_and_scan_ref_match_jax():
    args = _split_case(2, 96, 2, 8, 4, seed=12)
    jargs = [jnp.asarray(a) for a in args]
    want = np.asarray(jssd.ssd_scan_ref(*jargs))
    np.testing.assert_allclose(tssd.ssd_scan_ref(*_t(*args)).numpy(), want, **FWD_TOL)
    y, decay, h_fin = tssd.ssd_chunked(*_t(*args), chunk=32, return_carry=True)
    y_j, decay_j, hfin_j = jssd.ssd_chunked(*jargs, chunk=32, return_carry=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), **FWD_TOL)
    np.testing.assert_allclose(y.numpy(), want, **FWD_TOL)
    # atol: XLA on the CPU flushes fp32 denormals to zero, PyTorch keeps them
    np.testing.assert_allclose(decay.numpy(), np.asarray(decay_j), rtol=1e-5, atol=1e-37)
    np.testing.assert_allclose(h_fin.numpy(), np.asarray(hfin_j), **FWD_TOL)


def test_strong_decay_stays_finite():
    """dt |A| up to 16 a step: the masked-out exponents reach about 2000, so
    masking after the exponential would give inf * 0 = NaN (the case of
    tests/test_ssd.py:51), in the chunked core and in both plain kernels."""
    r = np.random.default_rng(2)
    b, l, h, p, n = 1, 128, 2, 4, 8
    x = r.standard_normal((b, l, h, p)).astype(np.float32)
    dt = r.uniform(0.5, 1.0, (b, l, h)).astype(np.float32)
    A = np.full(h, -16.0, np.float32)
    Bm, Cm = (r.standard_normal((b, l, n)).astype(np.float32) for _ in range(2))
    D = np.zeros(h, np.float32)
    got = tssd.ssd_chunked(*_t(x, dt, A, Bm, Cm, D), chunk=128)
    assert torch.isfinite(got).all()
    ref = np.asarray(jssd.ssd_scan_ref(*(jnp.asarray(a) for a in (x, dt, A, Bm, Cm, D))))
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-5, atol=2e-5 * np.abs(ref).max())
    xbc = np.concatenate([x.reshape(b, l, h * p), Bm, Cm], axis=-1)
    leaves = [t.requires_grad_() for t in _t(xbc, dt)]
    y = kssd.ssd_chunked_xbc(leaves[0], leaves[1], torch.from_numpy(A), torch.from_numpy(D),
                             d_inner=h * p, chunk=64)
    np.testing.assert_allclose(y.detach().numpy(), ref.reshape(b, l, h * p), rtol=2e-5,
                               atol=2e-5 * np.abs(ref).max())
    y.sum().backward()
    assert all(torch.isfinite(t.grad).all() for t in leaves)


# ---------------------------------------------------------------------------
# the 3xTF32 arithmetic of the K8/K9 kernels, emulated
# ---------------------------------------------------------------------------

def _k8_k9_3xtf32(xbc, dth, S, D, dy, d, chunk, mm=emu.mm3):
    """K8 with states and K9 as csrc/ssd_xbc_{fwd,bwd}.cu split them
    (``tests/ssd_emulation.py``), every product through ``mm`` (3xTF32 by
    default), in fp32. Returns (y, h_in, (dxbc, ddt, dS, dD))."""
    b, l, _ = xbc.shape
    h, nc = dth.shape[1], l // chunk
    x, Bc, Cc = kssd._split_xbc(xbc, d, h, chunk)  # (b, h, nc, q, p), (b, nc, q, n)
    dyh = dy.reshape(b, nc, chunk, h, d // h).permute(0, 3, 1, 2, 4)
    y, h_in, _, (dx, ddt, dS, dB, dC, dD) = emu.chunked_3xtf32(x, Bc, Cc, dth, S, dyh, D=D,
                                                              mm=mm)
    n = Bc.shape[-1]
    dxbc = torch.cat([dx.permute(0, 2, 3, 1, 4).reshape(b, l, d), dB.reshape(b, l, n),
                      dC.reshape(b, l, n)], dim=-1)
    return y.permute(0, 2, 3, 1, 4).reshape(b, l, d), h_in.transpose(1, 2), (dxbc, ddt, dS, dD)


def _tf32_case(chunk):
    """The K8/K9 inputs of the emulation tests at the SSD classifier's width
    (6 heads of 128, d_state 128, L 512), B=1: (xbc, dth, S, D, dy, d)."""
    rng = np.random.default_rng(40)
    b, l, h, d, n = 1, 512, 6, 768, 128
    xbc = torch.tensor(rng.standard_normal((b, l, d + 2 * n)).astype(np.float32) * 0.5)
    dt = torch.nn.functional.softplus(torch.tensor(rng.standard_normal((b, l, h)),
                                                   dtype=torch.float32) - 1.0)
    A = -torch.exp(torch.tensor(rng.standard_normal(h), dtype=torch.float32))
    dth = dt.transpose(1, 2).reshape(b, h, l // chunk, chunk).contiguous()
    S = torch.cumsum(dth * A[None, :, None, None], dim=-1)
    D = torch.tensor(rng.standard_normal(h), dtype=torch.float32)
    dy = torch.tensor(rng.standard_normal((b, l, d)), dtype=torch.float32)
    return xbc, dth, S, D, dy, d


def _tf32_errors(chunk, mm):
    """The error of the max of each K8/K9 output, emulated through ``mm``,
    against the plain versions in float64, and chip_smoke.py's tolerance for
    it (1e-4 for K8's y and h_in and for each of K9's outputs)."""
    xbc, dth, S, D, dy, d = _tf32_case(chunk)
    y, h_in, grads = _k8_k9_3xtf32(xbc, dth, S, D, dy, d, chunk, mm)
    y64, h64 = kssd.ssd_xbc_fwd_ref(*(t.double() for t in (xbc, dth, S, D)), d, chunk,
                                    emit_states=True)
    want = kssd.ssd_xbc_bwd_ref(*(t.double() for t in (xbc, dth, S, D, h64, dy)), d, chunk)
    errors = {}
    for name, got, ref in [("y", y, y64), ("h_in", h_in, h64),
                           *zip(("dxbc", "ddt", "dS", "dD"), grads, want)]:
        assert got.shape == ref.shape, name
        errors[name] = (emu.rel_err_of_max(got, ref), 1e-4)
    return errors


@pytest.mark.parametrize("chunk", [256, 64], ids=["nc2", "nc8"])
def test_3xtf32_k8_k9_arithmetic_meets_the_card_tolerances(chunk):
    """The kernels' split of K8/K9 with every product as 3xTF32, at the SSD
    classifier's width (6 heads of 128, d_state 128, L 512) and B=1, against
    the plain versions in float64, within chip_smoke.py's tolerances: K8's y
    and h_in and each of K9's outputs within 1e-4 of their max. The
    errors found (of the max) at nc 2 / 8: y 6.7e-07 / 6.7e-07, h_in 1.5e-07
    / 2.1e-07, dxbc 6.4e-07 / 4.4e-07, ddt 3.6e-07 / 3.0e-07, dS 6.3e-07 /
    5.8e-07, dD 8.3e-07 (no product: fp32 sums)."""
    errors = _tf32_errors(chunk, emu.mm3)
    print("3xTF32 error of the max:", {k: f"{v:.1e}" for k, (v, _) in errors.items()})
    for name, (err, tol) in errors.items():
        assert err <= tol, (name, err)


@pytest.mark.parametrize("chunk", [256, 64], ids=["nc2", "nc8"])
def test_one_tf32_product_misses_the_k8_tolerance(chunk):
    """The same split with every product as one TF32 product: K8's y or h_in
    and K9's dxbc, ddt or dS lie above chip_smoke.py's 1e-4 of the max, so
    both checks tell 3xTF32 from a single TF32 product (dD, a sum of
    elementwise products, has no matrix product). Printed, the error of the
    max of each output."""
    errors = _tf32_errors(chunk, emu.mm1)
    print("one TF32 product, error of the max:",
          {k: f"{v:.1e}" for k, (v, _) in errors.items()})
    assert max(errors["y"][0], errors["h_in"][0]) > 1e-4
    assert max(errors[k][0] for k in ("dxbc", "ddt", "dS")) > 1e-4


# ---------------------------------------------------------------------------
# the mixer
# ---------------------------------------------------------------------------

def _mixer_params(d_model, n_heads, d_state, seed):
    rng = np.random.default_rng(seed)
    d_inner = 2 * d_model
    conv = d_inner + 2 * d_state
    return {
        "in_proj_w": rng.standard_normal((d_model, 2 * d_inner + 2 * d_state + n_heads)) * 0.1,
        "conv_w": rng.standard_normal((conv, 4)) * 0.2,
        "conv_b": rng.standard_normal(conv) * 0.1,
        "dt_bias": rng.standard_normal(n_heads),
        "A_log": rng.standard_normal(n_heads),
        "D": rng.standard_normal(n_heads),
        "norm_scale": 1.0 + 0.1 * rng.standard_normal(d_inner),
        "out_proj_w": rng.standard_normal((d_inner, d_model)) * 0.1,
    }


@pytest.mark.parametrize("impl", ["ssd_fused", "xla"])
@pytest.mark.parametrize("l,chunk", [(100, 32), (128, 64)])
def test_mixer_apply_matches_jax_fused_interpret(impl, l, chunk):
    """Both routes of the port's ``ssd_mixer_apply`` against JAX's
    ``impl='ssd_fused'`` in interpret mode, including L = 100 padded to a
    multiple of 32 (tests/test_ssd_pallas.py:98)."""
    d_model, n_heads, d_state = 32, 2, 8
    params = {k: v.astype(np.float32) for k, v in
              _mixer_params(d_model, n_heads, d_state, seed=l).items()}
    u = np.random.default_rng(13).standard_normal((2, l, d_model)).astype(np.float32)
    want = jssd.ssd_mixer_apply({k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(u),
                                n_heads=n_heads, d_state=d_state, chunk=chunk,
                                impl="ssd_fused", _interpret=True)
    got = tssd.ssd_mixer_apply({k: torch.from_numpy(v) for k, v in params.items()},
                               torch.from_numpy(u), n_heads=n_heads, d_state=d_state,
                               chunk=chunk, impl=impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)


def test_mixer_rejects_unknown_impl():
    params = {k: torch.from_numpy(v.astype(np.float32))
              for k, v in _mixer_params(16, 1, 8, seed=0).items()}
    with pytest.raises(ValueError, match="unknown SSD impl"):
        tssd.ssd_mixer_apply(params, torch.zeros(1, 8, 16), n_heads=1, d_state=8, impl="auto")


def _port_mixer_from_jax(mixer, variables):
    sd = {}
    weights._ssd_mixer(sd, "m", variables["params"])
    mixer.load_state_dict({k[2:]: v for k, v in sd.items()}, strict=True)
    return mixer


def test_mixer_head_dim_fallback_matches_jax():
    """d_model 224: d_inner 448 is no multiple of head_dim 128, so both
    mixers take its largest divisor below 128, 112, as four heads
    (tests/test_ssd.py:272); the same weights give the same output."""
    jm = JSSDMixer(d_model=224, d_state=16, chunk=32)
    u = np.random.default_rng(0).standard_normal((2, 64, 224)).astype(np.float32)
    variables = jm.init(jax.random.key(0), jnp.asarray(u))
    mixer = _port_mixer_from_jax(SSDMixer(224, d_state=16, chunk=32), variables)
    assert (mixer.head_dim, mixer.n_heads) == (112, 4)
    with torch.no_grad():
        got = mixer(torch.from_numpy(u)).numpy()
    np.testing.assert_allclose(got, np.asarray(jm.apply(variables, jnp.asarray(u))),
                               rtol=2e-5, atol=2e-5)


def test_ssd_mixer_initialiser_forms():
    """The JAX initialisers' forms, by their statistics: A_log = log U(1, 16),
    dt_bias the inverse softplus of a log-uniform dt in [1e-3, 0.1], D and the
    norm scale ones, in_proj U(+-d_model^-1/2), out_proj that over sqrt(n)."""
    mixer = SSDMixer(256, d_state=16, head_dim=1, out_proj_div=2.0)  # 512 heads of 1
    mixer.reset_parameters(torch.Generator().manual_seed(0))
    A = torch.exp(mixer.A_log)
    assert A.min() >= 1.0 and A.max() <= 16.0
    assert abs(A.mean().item() - 8.5) < 5 * 15 / (12 * 512) ** 0.5
    dt = torch.nn.functional.softplus(mixer.dt_bias)
    assert dt.min() >= 1e-3 * 0.999 and dt.max() <= 0.1 * 1.001
    log_dt = torch.log(dt)  # uniform in [log 1e-3, log 0.1]
    mid, width = (np.log(1e-3) + np.log(0.1)) / 2, np.log(0.1) - np.log(1e-3)
    assert abs(log_dt.mean().item() - mid) < 5 * width / (12 * 512) ** 0.5
    assert torch.all(mixer.D == 1) and torch.all(mixer.norm.weight == 1)
    w = mixer.in_proj.weight
    assert w.abs().max() <= 256 ** -0.5 and abs(w.std().item() - 256 ** -0.5 / 3 ** 0.5) < 2e-3
    assert mixer.out_proj.weight.abs().max() <= 512 ** -0.5 / 2.0
    assert mixer.in_proj.weight.shape == (2 * 512 + 2 * 16 + 512, 256)
    assert mixer.conv1d.weight.shape == (512 + 32, 1, 4)


# ---------------------------------------------------------------------------
# the whole slice: the SSD PointMamba
# ---------------------------------------------------------------------------

# depth 2, two heads of 128 at trans_dim 128, 16 groups of 8: L = 2 * 4 * 16 =
# 128, two chunks of 64, so the carry between chunks is exercised
SSD_SMALL = dict(trans_dim=128, encoder_dims=128, depth=2, cls_dim=10, num_group=16,
                 group_size=8, drop_path=0.0, cls_head_dropout=0.0, mixer="ssd",
                 ssd_chunk=64, knn_graph=8)


def _clouds(b, n, seed):
    rng = np.random.default_rng(seed)
    pts = rng.standard_normal((b, n, 3)).astype(np.float32)
    return pts / np.abs(pts).max(axis=(1, 2), keepdims=True)


@pytest.fixture(scope="module")
def ssd_jax_model():
    jcfg = JConfig(**SSD_SMALL)
    jmodel = JPointMamba(jcfg)
    # jitted: eager flax init and apply of this model take seconds each
    variables = jax.jit(lambda key: jmodel.init(key, jnp.zeros((2, 128, 3)), train=False))(
        jax.random.key(0))
    return jcfg, jmodel, variables


def _aligned_eigvecs(jcfg, pts):
    """Wrap the port's spectral step so its eigenvectors take JAX's signs."""
    jeig = np.asarray(jax.jit(lambda x: j_spectral_eigvecs(
        j_group_divider(x, jcfg.num_group, jcfg.group_size).center, jcfg)[1])(jnp.asarray(pts)))
    real = port_pm.spectral_eigvecs

    def aligned(center, cfg):
        vals, vecs = real(center, cfg)
        assert oracle.eig_cosines(vecs, jeig).min() > 1 - 1e-4
        return vals, oracle.align_signs(vecs, jeig)

    return aligned


def _port_ssd_model(variables, **overrides):
    model = PointMamba(PointMambaConfig(**{**SSD_SMALL, "scan_impl": "ssd_fused", **overrides}))
    model.load_state_dict(state_dict_from_jax(variables["params"], variables["batch_stats"]),
                          strict=True)
    return model


def test_ssd_model_logits_match_jax(ssd_jax_model):
    """A JAX SSD classifier loaded with strict=True: the port's eval logits
    (the K8/K9 route, plain on the CPU) and those of its 'xla' route against
    ``PointMamba.apply``, SAST with sign-aligned eigenvectors on a tie-free
    seed."""
    jcfg, jmodel, variables = ssd_jax_model
    pts = _clouds(4, 128, seed=2)
    want = np.asarray(jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(variables,
                                                                             jnp.asarray(pts)))
    scale = float(np.abs(want).max())
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_pm, "spectral_eigvecs", _aligned_eigvecs(jcfg, pts))
        for impl in ("ssd_fused", "xla"):
            model = _port_ssd_model(variables, scan_impl=impl).eval()
            assert model.blocks.layers[0].mixer.impl == impl
            with torch.no_grad():
                got = model(torch.from_numpy(pts)).numpy()
            np.testing.assert_allclose(got, want, atol=1e-3 * scale, rtol=2e-3, err_msg=impl)


def test_ssd_train_step_matches_jax(ssd_jax_model):
    """One train step (drop rates 0) of the port's SSD model through the
    K8/K9 route against JAX's value_and_grad + AdamW update: the loss, every
    parameter's gradient (within 1.5e-2 of the largest, dominant leaves 1.5 %
    relative, tests/test_full_parity.py:541-545) and the updated parameters."""
    from si_mamba_tpu.train import optim as joptim
    from si_mamba_tpu.train.train_state import TrainState as JTrainState
    from si_mamba_tpu_torch.train import optim
    from si_mamba_tpu_torch.train.train_state import TrainState, make_classifier_train_step

    jcfg, jmodel, variables = ssd_jax_model
    lr, wd = 1e-3, 0.05
    pts = _clouds(4, 128, seed=2)
    labels = np.array([0, 3, 5, 9])
    tx, _ = joptim.build_optimizer(variables["params"], lr=lr, weight_decay=wd, epochs=4,
                                   warmup_epochs=0, steps_per_epoch=1, grad_clip=10.0)
    jstate = JTrainState.create(variables["params"], variables["batch_stats"], tx)

    def loss_fn(p, bs):
        logits, upd = jmodel.apply({"params": p, "batch_stats": bs}, jnp.asarray(pts),
                                   train=True, mutable=["batch_stats"],
                                   rngs={"dropout": jax.random.key(0)})
        return jnp.mean(j_ce(logits, jnp.asarray(labels))[0]), upd["batch_stats"]

    (j_loss, bs), j_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jstate.params, jstate.batch_stats)
    jstate = jax.jit(lambda st, g, b_: st.apply_gradients(g, new_batch_stats=b_))(
        jstate, j_grads, bs)

    model = _port_ssd_model(variables)
    optimizer, _ = optim.build_optimizer(model, lr=lr, weight_decay=wd, epochs=4,
                                         warmup_epochs=0, steps_per_epoch=1, grad_clip=10.0)
    state = TrainState.create(model, optimizer)
    grads = {}
    for name, p in model.named_parameters():
        p.register_hook(lambda g, name=name: grads.__setitem__(name, g.clone()))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_pm, "spectral_eigvecs", _aligned_eigvecs(jcfg, pts))
        state, metrics = make_classifier_train_step(model)(
            state, torch.from_numpy(pts), torch.from_numpy(labels), None)
    np.testing.assert_allclose(float(metrics["loss"]), float(j_loss), rtol=2e-4)

    want = state_dict_from_jax(j_grads, variables["batch_stats"])
    assert set(grads) == {k for k, _ in model.named_parameters()}
    gmax = max(float(want[k].abs().max()) for k in grads)
    for k, g in grads.items():
        diff = float((g - want[k]).abs().max())
        assert diff < 1.5e-2 * gmax, (k, diff, gmax)
        if float(want[k].abs().max()) > 0.1 * gmax:
            assert diff / float(want[k].abs().max()) < 1.5e-2, k
    after = state_dict_from_jax(jstate.params, jstate.batch_stats)
    for k, v in model.state_dict().items():
        if "num_batches_tracked" not in k:
            np.testing.assert_allclose(v.numpy(), after[k].numpy(), rtol=1e-4,
                                       atol=2.5 * lr, err_msg=k)


def test_ssd_with_add_after_layer_raises():
    with pytest.raises(NotImplementedError, match="add_after_layer"):
        PointMamba(PointMambaConfig(**{**SSD_SMALL, "add_after_layer": True}))
