"""The kernels' plain versions at the shapes their Pallas kernels compile for
and the tuned CUDA kernels are not built for, against the JAX package on the
CPU (the Pallas kernels in interpret mode, their VJPs by ``jax.vjp``); the
routing predicates that pick the CUDA variants; the strip layout that runs
chunks which are no multiple of 64. On the card the variants are held against
these same plain versions (tests/test_torch_port_cuda.py, chip_smoke.py).

Shapes: the conv at widths 1, 2, 3, 5; the scan at d_state 1, 8, 32, 64; the
whole mixer at d_inner 1152 and 2560 (d_state 16), d_state 8 and 32 and conv
width 3; the SSD core (K8/K9 and K6/K7, every entry point) at chunks 8, 32,
96 (L padded with a zero-dt, zero-input tail, as the mixer pads) and 512.
Tolerances are those of the files whose helpers this one reuses:
tests/test_torch_port_kernels.py (conv rtol 1e-5 / atol 1e-6 forward, 1e-5
backward; scan rtol 1e-4 / atol 1e-5 forward, rtol 2e-3 / atol 1e-4 backward),
tests/test_torch_port_fused_mixer.py (y rtol 2e-4 / atol 2e-5, gradients rtol
2e-3 / atol 2e-4 of each one's max), tests/test_torch_port_ssd.py and
tests/test_torch_port_ssd_split.py (forward 2e-5, gradients rtol 5e-4 / atol
5e-5).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from si_mamba_tpu.ops.pallas import fused_mixer_kernel as jfk
from si_mamba_tpu.ops.pallas import ssd_kernel as jk
from si_mamba_tpu.ops.pallas.causal_conv_kernel import causal_conv1d_silu_pallas
from si_mamba_tpu.ops.pallas.selective_scan_kernel import selective_scan_pallas
from si_mamba_tpu_torch.ops import ssd as tssd
from si_mamba_tpu_torch.ops.kernels import causal_conv as kconv
from si_mamba_tpu_torch.ops.kernels import fused_mixer as kfm
from si_mamba_tpu_torch.ops.kernels import selective_scan as kscan
from si_mamba_tpu_torch.ops.kernels import ssd as kssd
from tests.test_torch_port_fused_mixer import (
    FWD_TOL as FUSED_FWD_TOL,
    _close_to_max,
    _core_inputs,
    _folded,
    _params,
)
from tests.test_torch_port_kernels import _fn_grads, _jax_args, _jax_vjp_pallas, _scan_inputs
from tests.test_torch_port_ssd import FWD_TOL, GRAD_TOL, _chunk_layout, _core_case
from tests.test_torch_port_ssd_split import _case as _split_case
from tests.test_torch_port_ssd_split import _jax_chunks, _kernel_layout


def _t(*arrays):
    return [torch.from_numpy(np.array(a, dtype=np.float32)) for a in arrays]


# ---------------------------------------------------------------------------
# K1/K5: the conv at any width
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("W", [1, 2, 3, 5])
def test_conv_plain_matches_pallas_at_width(W):
    """y and (dx, dw, db) of the plain versions against the Pallas conv and
    its VJP in interpret mode, on a column view of xz, at conv width W."""
    rng = np.random.default_rng(W)
    l, d = 45, 32
    xz = rng.standard_normal((2, l, 2 * d)).astype(np.float32)
    w = (rng.standard_normal((d, W)) * 0.5).astype(np.float32)
    b = (rng.standard_normal(d) * 0.1).astype(np.float32)
    g = rng.standard_normal((2, l, d)).astype(np.float32)
    x = _t(xz)[0][..., :d]
    y = kconv.causal_conv1d_ref(x, *_t(w, b))
    jy, vjp = jax.vjp(lambda x_, w_, b_: causal_conv1d_silu_pallas(x_, w_, b_, interpret=True),
                      jnp.asarray(xz[..., :d]), jnp.asarray(w), jnp.asarray(b))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5, atol=1e-6)
    got = kconv.causal_conv1d_silu_bwd_ref(x, *_t(w, b, g))
    for a, want in zip(got, vjp(jnp.asarray(g))):
        np.testing.assert_allclose(a.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_conv_wrapper_takes_any_width_on_the_cpu():
    """On the CPU the wrapper is the plain version at any width, and counts no
    launch of the tuned kernel or of its any-width variant."""
    rng = np.random.default_rng(9)
    x, g = (torch.tensor(rng.standard_normal((2, 20, 16)).astype(np.float32)) for _ in range(2))
    w, b = torch.ones(16, 3) * 0.2, torch.zeros(16)
    counts = lambda: [c.launches for c in kconv.ANY_LAUNCHES.values()]  # noqa: E731
    before = counts()
    assert torch.equal(kconv.causal_conv1d_silu_fwd(x, w, b), kconv.causal_conv1d_ref(x, w, b))
    for a, r in zip(kconv.causal_conv1d_silu_bwd(x, w, b, g),
                    kconv.causal_conv1d_silu_bwd_ref(x, w, b, g)):
        assert torch.equal(a, r)
    assert counts() == before


# ---------------------------------------------------------------------------
# K2/K3/K4: the scan at any d_state
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 8, 32, 64])
def test_scan_plain_matches_pallas_at_d_state(n):
    """y, h_entries and every gradient of the plain versions against the
    Pallas scan (interpret mode) and its VJP at d_state n; the CPU route of
    ``SelectiveScanFn`` is the plain backward."""
    l = 40
    kw = _scan_inputs(b=2, l=l, d=32, n=n, seed=n)
    jkw = {k: jnp.asarray(kw[k]) for k in ("D", "z", "delta_bias")}
    want = selective_scan_pallas(*_jax_args(kw), **jkw, block_d=16, chunk=16, interpret=True)
    args = _t(*(kw[k] for k in ("u", "delta", "A", "B", "C", "D", "z", "delta_bias")))
    y, h_entries = kscan.selective_scan_fwd_residuals_ref(*args)
    np.testing.assert_allclose(y.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    assert h_entries.shape == (2, -(-l // kscan.CHUNK), n, 32)
    g = np.random.default_rng(n + 1).standard_normal((2, l, 32)).astype(np.float32)
    for a, w in zip(_fn_grads(kw, g), _jax_vjp_pallas(kw, g, block_d=16, chunk=16)):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=2e-3, atol=1e-4)


# ---------------------------------------------------------------------------
# K10/K11: the whole mixer at any shape fused_mixer_supported admits
# ---------------------------------------------------------------------------

FUSED_SHAPES = [
    pytest.param(576, 16, 4, 36, id="d_inner1152"),
    pytest.param(1280, 16, 4, 80, id="d_inner2560"),
    pytest.param(64, 8, 3, 4, id="d_state8-W3"),
    pytest.param(64, 32, 3, 4, id="d_state32-W3"),
]


@pytest.mark.parametrize("d_model,d_state,d_conv,dt_rank", FUSED_SHAPES)
def test_fused_plain_matches_pallas_at_shape(d_model, d_state, d_conv, dt_rank):
    """y, the chunk-entry states and the eight gradients of the plain K10/K11
    against the Pallas fused kernel (W_dt folded, interpret mode) and its
    VJP, at shapes the tuned kernels are not built for. The JAX kernel
    takes the conv width from its weight; x_dbl's width is dt_rank + 2N."""
    L, chunk = 20, 64
    p = _params(d_model=d_model, d_state=d_state, dt_rank=dt_rank, d_conv=d_conv,
                seed=d_model + d_state)
    # the helper's scales suit d_model 32; at these widths each product is
    # scaled by its fan-in, as the mixer's initialiser scales it, so that the
    # activations stay O(1) (else dt saturates and y reaches 1e4)
    p["in_proj_w"] = p["in_proj_w"] * (5.0 / np.sqrt(d_model))
    p["x_proj_w"] = p["x_proj_w"] * (5.0 / np.sqrt(2 * d_model))
    args = _core_inputs(p, 2, L, dt_rank=dt_rank, d_state=d_state, seed=d_conv)
    assert not kfm.tuned_shape(2 * d_model, d_state, d_conv, dt_rank)
    assert kfm.fused_mixer_supported(2 * d_model, d_state, L)
    folded = [jnp.asarray(a) for a in _folded(args, dt_rank, d_state)]
    xz_p, _ = jfk._pad_L(folded[0], chunk)
    xz, conv_wt, conv_b, wdt, dtb, wbc, at, d = folded
    y_j, hent_j = jfk._fused_fwd_call(xz_p, conv_wt, conv_b[None], wdt, dtb[None], wbc, at,
                                      d[None], chunk=chunk, sub_block=8, interpret=True)
    y, hent = kfm.fused_mixer_fwd_ref(*_t(*args), chunk=chunk, emit_states=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j)[:, :L], **FUSED_FWD_TOL)
    np.testing.assert_allclose(hent.numpy(), np.asarray(hent_j), **FUSED_FWD_TOL)

    g = np.random.default_rng(d_model).standard_normal((2, L, 2 * d_model)).astype(np.float32)
    core = lambda *a: jfk._fused_core(*a, chunk, 8, True)  # noqa: E731
    _, vjp = jax.vjp(core, *folded)
    dxz, dconv_wt, dconv_b, dwdt, ddtb, dwbc, dat, dd = (
        np.asarray(w, dtype=np.float64) for w in vjp(jnp.asarray(g)))
    x_proj, dt_proj = args[3].astype(np.float64), args[4].astype(np.float64)
    want = (dxz, dconv_wt, dconv_b, np.concatenate([dwdt @ dt_proj.T, dwbc], axis=1),
            x_proj[:, :dt_rank].T @ dwdt, ddtb, dat, dd)
    _, hent16 = kfm.fused_mixer_fwd_ref(*_t(*args), chunk=kfm.CHUNK, emit_states=True)
    got = kfm.fused_mixer_bwd_ref(*_t(*args), hent16, *_t(g), chunk=kfm.CHUNK)
    names = ("dxz", "dconv_wt", "dconv_b", "dx_proj", "ddt_proj", "ddtb", "dat", "dd")
    for name, a, w in zip(names, got, want):
        assert a.shape == w.shape, name
        _close_to_max(a.numpy(), w, name)


def test_fused_tuned_shape_predicate():
    """The tuned K10/K11 serve d_state 16, conv width 4, d_inner up to 1024
    and x_proj up to 64 columns; every other admitted shape takes the
    any-shape variant."""
    assert kfm.tuned_shape(768, 16, 4, 24)
    assert kfm.tuned_shape(1024, 16, 4, 32)
    for shape in ((1152, 16, 4, 36), (1536, 16, 4, 48), (768, 8, 4, 24), (768, 16, 3, 24),
                  (768, 16, 4, 34), (768, 32, 4, 24)):
        assert not kfm.tuned_shape(*shape), shape
    assert kfm.fused_mixer_supported(2560, 32, 7)
    assert not kfm.fused_mixer_supported(2560, 33, 7)
    assert not kfm.fused_mixer_supported(1000, 16, 7)


# ---------------------------------------------------------------------------
# K6-K9: the SSD core at every chunk JAX compiles
# ---------------------------------------------------------------------------

SSD_CHUNKS = [pytest.param(8, 64, 0, id="chunk8"), pytest.param(32, 128, 0, id="chunk32"),
              pytest.param(96, 288, 88, id="chunk96-padded"),
              pytest.param(512, 512, 0, id="chunk512")]


@pytest.mark.parametrize("chunk,l,pad", SSD_CHUNKS)
def test_plain_k8_k9_match_pallas_at_chunk(chunk, l, pad):
    """K8's y, entry states and final state, and K9's gradients unseeded and
    seeded with a cotangent of the final state, of the plain versions against
    the Pallas xbc kernels (interpret mode) and their VJPs at ``chunk``."""
    h, p, n = 2, 16, 8
    xbc, dt, A, D = _core_case(2, l, h, p, n, seed=chunk, pad=pad)
    dth, S = _chunk_layout(dt, A, chunk)
    SD = jk._stack_sdd(jnp.asarray(S), jnp.asarray(dth), jnp.asarray(D))
    y_j, hin_j, hfin_j = jk._fwd_call_xbc(SD, jnp.asarray(xbc), h * p, True, emit_states=True,
                                          emit_hfin=True)
    ref_args = _t(xbc, dth, S, D)
    y, h_in, h_fin = kssd.ssd_xbc_fwd_ref(*ref_args, h * p, chunk, emit_states=True,
                                          emit_hfin=True)
    for got, want in ((y, y_j), (h_in, hin_j), (h_fin, hfin_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)
    rng = np.random.default_rng(chunk + 1)
    dy = rng.standard_normal((2, l, h * p)).astype(np.float32)
    dhf = rng.standard_normal((2, h, n, p)).astype(np.float32)
    jargs = [jnp.asarray(a) for a in (xbc, dth, S, D)]
    _, vjp = jax.vjp(lambda *a: jk._ssd_fused_xbc(*a, h * p, True), *jargs)
    _, vjp_c = jax.vjp(lambda *a: jk._ssd_fused_xbc_carry(*a, h * p, True), *jargs)
    for seed, want in ((None, vjp(jnp.asarray(dy))),
                       (dhf, vjp_c((jnp.asarray(dy), jnp.asarray(dhf))))):
        got = kssd.ssd_xbc_bwd_ref(*ref_args, h_in, *_t(dy), h * p, chunk,
                                   dh_fin=None if seed is None else _t(seed)[0])
        for name, g, w in zip(("dxbc", "ddt", "dS", "dD"), got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w).reshape(g.shape),
                                       err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("chunk,l,pad", SSD_CHUNKS)
def test_plain_k6_k7_match_pallas_at_chunk(chunk, l, pad):
    """K6's y, entry states and final state, and K7's gradients unseeded and
    seeded, of the plain versions against the Pallas split kernels and their
    VJPs at ``chunk``."""
    h, p, n = 2, 16, 8
    x, dt, A, Bm, Cm, _ = _split_case(2, l, h, p, n, seed=chunk + 3)
    if pad:
        x[:, l - pad:], dt[:, l - pad:], Bm[:, l - pad:], Cm[:, l - pad:] = 0, 0, 0, 0
    xf, dth, S, _, _ = _kernel_layout(x, dt, A, Bm, Cm, chunk)
    SD = jk._stack_sd(jnp.asarray(S), jnp.asarray(dth))
    y_j, hin_j, hfin_j = jk._fwd_call(SD, jnp.asarray(xf), _jax_chunks(Bm, chunk),
                                      _jax_chunks(Cm, chunk), True, emit_states=True,
                                      emit_hfin=True)
    xt, dtt, St, Bt, Ct = _t(xf, dth, S, Bm, Cm)
    y, h_in, h_fin = kssd.ssd_split_fwd_ref(xt, dtt, St, Bt, Ct, chunk, emit_states=True,
                                            emit_hfin=True)
    for got, want in ((y, y_j), (h_in, hin_j), (h_fin, hfin_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)
    rng = np.random.default_rng(chunk + 2)
    dy = rng.standard_normal(xf.shape).astype(np.float32)
    dhf = rng.standard_normal((2, h, n, p)).astype(np.float32)
    jargs = (jnp.asarray(xf), jnp.asarray(dth), jnp.asarray(S), _jax_chunks(Bm, chunk),
             _jax_chunks(Cm, chunk))
    _, vjp = jax.vjp(lambda *a: jk._ssd_fused(*a, True), *jargs)
    _, vjp_c = jax.vjp(lambda *a: jk._ssd_fused_carry(*a, True), *jargs)
    for seeded, want in ((False, vjp(jnp.asarray(dy))),
                         (True, vjp_c((jnp.asarray(dy), jnp.asarray(dhf))))):
        if seeded:
            got = kssd.ssd_split_bwd_seeded(xt, dtt, St, Bt, Ct, h_in, *_t(dy, dhf), chunk)
        else:
            got = kssd.ssd_split_bwd(xt, dtt, St, Bt, Ct, h_in, *_t(dy), chunk)
        for name, g, w in zip(("dx", "ddt", "dS", "dB", "dC"), got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w).reshape(g.shape),
                                       err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("chunk", [8, 40, 96, 200])
def test_strip_layout_is_exact(chunk):
    """A chunk that is no multiple of 64 runs laid out in 64-row strips: the
    plain versions at the strip length on the laid-out operands give, after
    the inverse layout (and dS of the held S folded onto the chunk's last
    row), the plain versions at ``chunk`` itself, every output within fp64
    rounding; the split core likewise."""
    torch.manual_seed(chunk)
    b, h, p, n, nc = 2, 2, 16, 8, 3
    l, d = nc * chunk, h * p
    f64 = dict(dtype=torch.float64)
    xbc = torch.randn(b, l, d + 2 * n, **f64) * 0.5
    dth = torch.rand(b, h, nc, chunk, **f64) * 0.2
    S = torch.cumsum(dth * -torch.rand(h, **f64)[None, :, None, None], -1)
    D = torch.randn(h, **f64)
    dy, dhf = torch.randn(b, l, d, **f64), torch.randn(b, h, n, p, **f64)
    qs, dts, Ss, xbcs, dys = kssd._strip_operands(chunk, dth, S, xbc, dy)
    assert dts.shape[-1] == Ss.shape[-1] == qs and qs % kssd.STRIP == 0
    want = kssd.ssd_xbc_fwd_ref(xbc, dth, S, D, d, chunk, emit_states=True, emit_hfin=True)
    got = kssd.ssd_xbc_fwd_ref(xbcs, dts, Ss, D, d, qs, emit_states=True, emit_hfin=True)
    got = (kssd._from_strips(got[0], chunk), *got[1:])
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=0, atol=1e-12)
    want = kssd.ssd_xbc_bwd_ref(xbc, dth, S, D, want[1], dy, d, chunk, dh_fin=dhf)
    dxbc, ddt, dS, dD = kssd.ssd_xbc_bwd_ref(xbcs, dts, Ss, D, got[1], dys, d, qs, dh_fin=dhf)
    ddt, dS, dxbc = kssd._grads_from_strips(chunk, ddt, dS, dxbc)
    got = (dxbc, ddt, dS, dD)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=0, atol=1e-12)
    x, Bm, Cm = xbc[..., :d], xbc[..., d:d + n], xbc[..., d + n:]
    _, h_in, _ = kssd.ssd_split_fwd_ref(x, dth, S, Bm, Cm, chunk, emit_states=True)
    want = kssd.ssd_split_bwd_ref(x, dth, S, Bm, Cm, h_in, dy, chunk, dh_fin=dhf)
    _, _, _, xs, Bs, Cs = kssd._strip_operands(chunk, dth, S, x, Bm, Cm)
    dx, ddt, dS, dB, dC = kssd.ssd_split_bwd_ref(xs, dts, Ss, Bs, Cs, h_in, dys, qs, dh_fin=dhf)
    ddt, dS, dx, dB, dC = kssd._grads_from_strips(chunk, ddt, dS, dx, dB, dC)
    got = (dx, ddt, dS, dB, dC)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=0, atol=1e-12)


def test_chunk_variants():
    """Which variant runs a chunk: the tuned strips at multiples of 64 up to
    256, '_strip' for any chunk that is no multiple of 64, '_long' above 256;
    at a d_state or head_dim other than 128 each of them followed by
    '_wide'; every variant of every entry point has its launch count."""
    assert [kssd.chunk_variant(c) for c in (64, 128, 192, 256)] == [""] * 4
    assert [kssd.chunk_variant(c) for c in (8, 32, 96, 200, 520)] == ["_strip"] * 5
    assert [kssd.chunk_variant(c) for c in (320, 512, 1024)] == ["_long"] * 3
    assert kssd._variant_name("ssd_xbc_fwd_states_bf16", "_strip") == \
        "ssd_xbc_fwd_states_strip_bf16"
    assert [kssd.kernel_variant(c, 256, 128) for c in (64, 32, 512)] == \
        ["_wide", "_strip_wide", "_long_wide"]
    assert kssd.kernel_variant(512, 128, 128) == "_long"
    assert len(kssd.VARIANT_LAUNCHES) == 5 * 24 + 6  # and the Hopper bf16 body's six
    assert "ssd_split_bwd_seeded_long" in kssd.VARIANT_LAUNCHES
    assert "ssd_xbc_fwd_states_strip_wide_bf16" in kssd.VARIANT_LAUNCHES


@pytest.mark.parametrize("chunk", [8, 16, 24, 32, 96, 512, 1024])
def test_ssd_routing_on_cuda_admits_what_jax_compiles(chunk):
    """``ssd_fused_route`` and ``ssd_fused_engaged`` on a "cuda" device admit
    every chunk the JAX kernels compile (a multiple of 8, L padded to a
    multiple of the chunk) at d_state = head_dim = 128, as JAX's own
    ``ssd_fused_supported`` does; d_state 256, which JAX compiles, is admitted
    too (the wide instantiation), and d_state 64 raises by name (JAX's
    compiled kernel refuses it too)."""
    l = 1024 if chunk == 1024 else 512
    lp = l + (-l) % chunk
    assert jk.ssd_fused_supported(lp, chunk, 128, 128)
    assert tssd.ssd_fused_supported(lp, chunk, 128, 128)
    assert tssd.ssd_fused_route("ssd_fused", lp, chunk, 128, 128, "cuda")
    assert tssd.ssd_fused_engaged(l, chunk=chunk, device="cuda")
    assert not tssd.ssd_fused_engaged(l, chunk=chunk, device="cpu")
    assert jk.ssd_fused_supported(lp, chunk, 256, 128)
    assert tssd.ssd_fused_route("ssd_fused", lp, chunk, 256, 128, "cuda")
    assert tssd.ssd_fused_engaged(l, chunk=chunk, d_state=256, device="cuda")
    assert not jk.ssd_fused_supported(lp, chunk, 64, 128)
    with pytest.raises(ValueError, match="multiples of 128.*d_state 64"):
        tssd.ssd_fused_route("ssd_fused", lp, chunk, 64, 128, "cuda")
    assert not tssd.ssd_fused_engaged(l, chunk=chunk, d_state=64, device="cuda")


def test_ssd_routing_refuses_what_jax_refuses():
    """A chunk that is no multiple of 8 raises on CUDA, as JAX's compiled
    kernel refuses it."""
    for chunk in (4, 12, 100):
        lp = 512 + (-512) % chunk
        assert not jk.ssd_fused_supported(lp, chunk, 128, 128)
        with pytest.raises(ValueError, match="multiple of 8"):
            tssd.ssd_fused_route("ssd_fused", lp, chunk, 128, 128, "cuda")
