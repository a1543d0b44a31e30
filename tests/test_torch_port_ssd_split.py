"""The split SSD core of the port against the JAX package on the CPU: the
plain versions of K6 and K7 (``ops/kernels/ssd.py``) against the Pallas split
kernel in interpret mode and ``jax.vjp`` of it, the seeded backward of the
sequence-parallel carry included, and ``ssd_chunked_split`` against
``ssd_chunked_pallas``; then the kernels' own split of the work with their
3xTF32 products, emulated, against the plain versions in float64. Inputs are
made with numpy from a seed and handed to both frameworks.

Tolerances as tests/test_ssd_pallas.py: values rtol/atol 2e-5, gradients
rtol 5e-4, atol 5e-5; the emulation within chip_smoke.py's 1e-4 of the
max."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from si_mamba_tpu.ops.pallas import ssd_kernel as jk
from si_mamba_tpu_torch.ops import ssd as tssd
from si_mamba_tpu_torch.ops.kernels import ssd as kssd

from tests import ssd_emulation as emu

FWD_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=5e-4, atol=5e-5)


def _case(b, l, h, p, n, seed):
    """x (b, l, h, p), dt (b, l, h) post-softplus, A (h,) < 0, B and C
    (b, l, n), D (h,)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, l, h)))).astype(np.float32)
    A = (-np.exp(rng.standard_normal(h))).astype(np.float32)
    Bm, Cm = (rng.standard_normal((b, l, n)).astype(np.float32) for _ in range(2))
    D = rng.standard_normal(h).astype(np.float32)
    return x, dt, A, Bm, Cm, D


def _kernel_layout(x, dt, A, Bm, Cm, chunk):
    """The kernels' operands: x (b, l, h p), dt and S (b, h, nc, q), B and C
    (b, l, n), S computed by JAX."""
    b, l, h, p = x.shape
    dth = jnp.asarray(dt).transpose(0, 2, 1).reshape(b, h, l // chunk, chunk)
    S = jnp.cumsum(dth * jnp.asarray(A)[None, :, None, None], axis=-1)
    return x.reshape(b, l, h * p), np.asarray(dth), np.asarray(S), Bm, Cm


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a).copy()) for a in arrays]


def _jax_chunks(a, chunk):
    """(b, l, n) -> the Pallas kernel's (b, nc, q, n)."""
    b, l, n = a.shape
    return jnp.asarray(a).reshape(b, l // chunk, chunk, n)


# ---------------------------------------------------------------------------
# the plain versions of K6 and K7
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk,l", [(32, 128), (64, 192), (64, 64)],
                         ids=["nc4", "nc3", "single_chunk"])
def test_plain_k6_matches_pallas_interpret(chunk, l):
    """y, the per-chunk entry states and the final state of
    ``ssd_split_fwd_ref`` against the Pallas split forward (``_fwd_call``)
    in interpret mode; every variant's wrapper gives the same y."""
    h, p, n = 3, 16, 8
    x, dt, A, Bm, Cm, _ = _case(2, l, h, p, n, seed=chunk + l)
    xf, dth, S, _, _ = _kernel_layout(x, dt, A, Bm, Cm, chunk)
    SD = jk._stack_sd(jnp.asarray(S), jnp.asarray(dth))
    y_j, hin_j, hfin_j = jk._fwd_call(SD, jnp.asarray(xf), _jax_chunks(Bm, chunk),
                                      _jax_chunks(Cm, chunk), True, emit_states=True,
                                      emit_hfin=True)
    args = (*_t(xf, dth, S, Bm, Cm), chunk)
    y, h_in, h_fin = kssd.ssd_split_fwd_ref(*args, emit_states=True, emit_hfin=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), **FWD_TOL)
    np.testing.assert_allclose(h_in.numpy(), np.asarray(hin_j), **FWD_TOL)
    np.testing.assert_allclose(h_fin.numpy(), np.asarray(hfin_j), **FWD_TOL)
    assert torch.equal(kssd.ssd_split_fwd(*args), y)
    for got in (kssd.ssd_split_fwd_states(*args), kssd.ssd_split_fwd_hfin(*args),
                kssd.ssd_split_fwd_states_hfin(*args)):
        assert torch.equal(got[0], y)
    assert torch.equal(kssd.ssd_split_fwd_states(*args)[1], h_in)
    assert torch.equal(kssd.ssd_split_fwd_hfin(*args)[1], h_fin)


@pytest.mark.parametrize("seeded", [False, True], ids=["unseeded", "seeded"])
@pytest.mark.parametrize("chunk,l,h", [(32, 96, 2), (64, 64, 3)], ids=["nc3", "single_chunk"])
def test_plain_k7_matches_jax_vjp_of_the_pallas_kernel(chunk, l, h, seeded):
    """dx, ddt, dS, dB and dC of ``ssd_split_bwd_ref`` against ``jax.vjp`` of
    the Pallas split core (its custom VJP: the backward kernel, interpret
    mode); seeded, of the carry core, with a cotangent of h_fin that seeds
    the reverse carry (and the last chunk's dS_end term)."""
    p, n = 16, 8
    x, dt, A, Bm, Cm, _ = _case(2, l, h, p, n, seed=7 + l + h)
    xf, dth, S, _, _ = _kernel_layout(x, dt, A, Bm, Cm, chunk)
    rng = np.random.default_rng(8)
    dy = rng.standard_normal(xf.shape).astype(np.float32)
    dhf = rng.standard_normal((2, h, n, p)).astype(np.float32)
    jargs = (jnp.asarray(xf), jnp.asarray(dth), jnp.asarray(S), _jax_chunks(Bm, chunk),
             _jax_chunks(Cm, chunk))
    if seeded:
        _, vjp = jax.vjp(lambda *a: jk._ssd_fused_carry(*a, True), *jargs)
        want = vjp((jnp.asarray(dy), jnp.asarray(dhf)))
    else:
        _, vjp = jax.vjp(lambda *a: jk._ssd_fused(*a, True), *jargs)
        want = vjp(jnp.asarray(dy))
    xt, dtt, St, Bt, Ct = _t(xf, dth, S, Bm, Cm)
    _, h_in, _ = kssd.ssd_split_fwd_ref(xt, dtt, St, Bt, Ct, chunk, emit_states=True)
    if seeded:
        got = kssd.ssd_split_bwd_seeded(xt, dtt, St, Bt, Ct, h_in, *_t(dy, dhf), chunk)
    else:
        got = kssd.ssd_split_bwd(xt, dtt, St, Bt, Ct, h_in, *_t(dy), chunk)
    for name, g, w in zip(("dx", "ddt", "dS", "dB", "dC"), got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w.reshape(g.shape), err_msg=name, **GRAD_TOL)


def test_the_seed_reaches_the_carried_gradients():
    """A zero seed is the unseeded backward; a non-zero one moves dx, ddt, dS
    and dB (the carry reaches every chunk) and leaves dC, which reads dy and
    h_in only."""
    chunk = 32
    x, dt, A, Bm, Cm, _ = _case(1, 96, 2, 16, 8, seed=3)
    xt, dtt, St, Bt, Ct = _t(*_kernel_layout(x, dt, A, Bm, Cm, chunk))
    _, h_in, _ = kssd.ssd_split_fwd_ref(xt, dtt, St, Bt, Ct, chunk, emit_states=True)
    dy = torch.randn(xt.shape, generator=torch.Generator().manual_seed(0))
    base = kssd.ssd_split_bwd(xt, dtt, St, Bt, Ct, h_in, dy, chunk)
    zero = kssd.ssd_split_bwd_seeded(xt, dtt, St, Bt, Ct, h_in, dy, torch.zeros(1, 2, 8, 16),
                                     chunk)
    seeded = kssd.ssd_split_bwd_seeded(xt, dtt, St, Bt, Ct, h_in, dy,
                                       torch.ones(1, 2, 8, 16), chunk)
    for name, a, z, s in zip(("dx", "ddt", "dS", "dB", "dC"), base, zero, seeded):
        assert torch.equal(a, z), name
        assert torch.equal(a, s) if name == "dC" else not torch.allclose(a, s), name


# ---------------------------------------------------------------------------
# ssd_chunked_split: the entry function
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("return_carry", [False, True], ids=["plain", "carry"])
def test_ssd_chunked_split_matches_pallas(return_carry):
    """Values of ``ssd_chunked_split`` (the lean plain K6 under no_grad)
    against ``ssd_chunked_pallas(interpret=True)``, with and without the
    carry (y, total decay, h_fin), and against the plain chunked core."""
    args = _case(2, 128, 2, 16, 8, seed=9)
    want = jk.ssd_chunked_pallas(*(jnp.asarray(a) for a in args), chunk=32,
                                 return_carry=return_carry, interpret=True)
    with torch.no_grad():
        got = kssd.ssd_chunked_split(*_t(*args), chunk=32, return_carry=return_carry)
        plain = tssd.ssd_chunked(*_t(*args), chunk=32, return_carry=return_carry)
    if not return_carry:
        got, want, plain = (got,), (want,), (plain,)
    for name, g, w, q in zip(("y", "total_decay", "h_fin"), got, want, plain):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name, **FWD_TOL)
        np.testing.assert_allclose(g.numpy(), q.numpy(), err_msg=name, **FWD_TOL)


@pytest.mark.parametrize("return_carry", [False, True], ids=["plain", "carry"])
def test_ssd_chunked_split_grads_match_jax(return_carry):
    """Gradients of x, dt, A, B, C and D through ``ssd_chunked_split`` (the
    autograd Functions over the plain K6/K7, S and the D skip outside them)
    against ``jax.grad`` of ``ssd_chunked_pallas`` in interpret mode; with the
    carry the loss reads y, the total decay and h_fin, as
    tests/test_ssd_pallas.py:166-189, so the seeded backward runs."""
    args = _case(2, 128, 2, 16, 8, seed=10)

    def j_loss(*a):
        out = jk.ssd_chunked_pallas(*a, chunk=32, return_carry=return_carry, interpret=True)
        if not return_carry:
            return jnp.sum(jnp.sin(out))
        y, dec, hf = out
        return jnp.sum(jnp.sin(y)) + jnp.sum(dec * 3.0) + jnp.sum(jnp.cos(hf))

    want = jax.grad(j_loss, argnums=tuple(range(6)))(*(jnp.asarray(a) for a in args))
    leaves = [t.requires_grad_() for t in _t(*args)]
    out = kssd.ssd_chunked_split(*leaves, chunk=32, return_carry=return_carry)
    if return_carry:
        y, dec, hf = out
        assert isinstance(hf.grad_fn, kssd.SSDChunkedSplitCarryFn._backward_cls)
        loss = torch.sum(torch.sin(y)) + torch.sum(dec * 3.0) + torch.sum(torch.cos(hf))
    else:
        loss = torch.sum(torch.sin(out))
    loss.backward()
    for name, leaf, w in zip(("x", "dt", "A", "B", "C", "D"), leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w), err_msg=name, **GRAD_TOL)


def test_split_core_takes_strided_views():
    """B and C as column views of one (b, l, 2n) buffer and x as a column
    view of a wider one, as the tensor-parallel mixer makes them: the same
    values and gradients as contiguous copies."""
    x, dt, A, Bm, Cm, D = _case(2, 64, 2, 16, 8, seed=11)
    bc = torch.from_numpy(np.concatenate([Bm, Cm], axis=-1)).requires_grad_()
    wide = torch.from_numpy(np.concatenate([x.reshape(2, 64, 32), np.zeros((2, 64, 5),
                                                                          np.float32)], -1))
    wide.requires_grad_()
    xv = wide[..., :32].reshape(2, 64, 2, 16)
    dt_t, A_t, D_t = _t(dt, A, D)
    y = kssd.ssd_chunked_split(xv, dt_t, A_t, bc[..., :8], bc[..., 8:], D_t, chunk=32)
    y.sum().backward()
    leaves = [t.requires_grad_() for t in _t(x, Bm, Cm)]
    y2 = kssd.ssd_chunked_split(leaves[0], dt_t, A_t, leaves[1], leaves[2], D_t, chunk=32)
    y2.sum().backward()
    torch.testing.assert_close(y, y2, rtol=0, atol=0)
    torch.testing.assert_close(wide.grad[..., :32].reshape(2, 64, 2, 16), leaves[0].grad)
    torch.testing.assert_close(bc.grad, torch.cat([leaves[1].grad, leaves[2].grad], -1))


def test_no_grad_takes_the_lean_forward():
    x, dt, A, Bm, Cm, D = _t(*_case(1, 64, 2, 16, 8, seed=12))
    D.requires_grad_()
    with torch.no_grad():
        assert kssd.ssd_chunked_split(x, dt, A, Bm, Cm, D, chunk=32).grad_fn is None
        assert kssd.ssd_chunked_split(x, dt, A, Bm, Cm, D, chunk=32,
                                      return_carry=True)[2].grad_fn is None
    x.requires_grad_()
    y = kssd.ssd_chunked_split(x, dt, A, Bm, Cm, D, chunk=32)
    assert isinstance(y.grad_fn.next_functions[0][0].next_functions[0][0],
                      kssd.SSDChunkedSplitFn._backward_cls)


def test_fused_route_predicate():
    """'ssd_fused' routes on any geometry on the CPU (the plain versions) and
    raises on CUDA for one the kernels are not built for, where JAX's
    predicate would quietly take the einsum route; 'xla' never routes."""
    assert tssd.ssd_fused_route("ssd_fused", 128, 32, 8, 16, "cpu")
    assert not tssd.ssd_fused_route("xla", 512, 256, 128, 128, "cuda")
    assert tssd.ssd_fused_route("ssd_fused", 512, 256, 128, 128, "cuda")
    with pytest.raises(ValueError, match="built for"):
        tssd.ssd_fused_route("ssd_fused", 512, 128, 64, 128, "cuda")
    with pytest.raises(ValueError, match="unknown SSD impl"):
        tssd.ssd_fused_route("auto", 512, 128, 128, 128, "cpu")
    assert tssd.ssd_fused_engaged(500, chunk=128, device="cuda")
    assert not tssd.ssd_fused_engaged(512, chunk=128, device="cpu")
    # chunk 96 (L padded to 576) runs laid out in strips; chunk 12, which the
    # JAX kernels do not compile either (not a multiple of 8), raises
    assert tssd.ssd_fused_engaged(512, chunk=96, device="cuda")
    assert not tssd.ssd_fused_engaged(512, chunk=12, device="cuda")
    with pytest.raises(ValueError, match="built for"):
        tssd.ssd_fused_route("ssd_fused", 516, 12, 128, 128, "cuda")


# ---------------------------------------------------------------------------
# the 3xTF32 arithmetic of the K6/K7 kernels, emulated
# ---------------------------------------------------------------------------

def _split_tf32_errors(chunk: int, seeded: bool, mm):
    """The error of the max of each K6/K7 output at the tensor-parallel
    shard's width (3 heads of 128, d_state 128, L 512, B=1), the kernels'
    split emulated through ``mm`` with no D terms, h_fin out and the dh
    carry seeded with a dh_fin or from 0, against ``ssd_split_fwd_ref`` /
    ``ssd_split_bwd_ref`` in float64."""
    rng = np.random.default_rng(44)
    b, l, h, p, n = 1, 512, 3, 128, 128
    x = torch.tensor(rng.standard_normal((b, l, h * p)).astype(np.float32) * 0.5)
    Bm, Cm = (torch.tensor(rng.standard_normal((b, l, n)).astype(np.float32) * 0.5)
              for _ in range(2))
    dt = torch.nn.functional.softplus(torch.tensor(rng.standard_normal((b, l, h)),
                                                   dtype=torch.float32) - 1.0)
    A = -torch.exp(torch.tensor(rng.standard_normal(h), dtype=torch.float32))
    dth = dt.transpose(1, 2).reshape(b, h, l // chunk, chunk).contiguous()
    S = torch.cumsum(dth * A[None, :, None, None], dim=-1)
    dy = torch.tensor(rng.standard_normal((b, l, h * p)), dtype=torch.float32)
    dh_fin = torch.tensor(0.1 * rng.standard_normal((b, h, n, p)), dtype=torch.float32) \
        if seeded else None

    xh, Bh, Ch = kssd._split_operands(x, Bm, Cm, h, chunk)
    dyh = kssd._split_operands(dy, Bm, Cm, h, chunk)[0]
    y, h_in, h_fin, (dx, ddt, dS, dB, dC, _) = emu.chunked_3xtf32(
        xh, Bh, Ch, dth, S, dyh, dh_fin=dh_fin, mm=mm)
    as_rows = lambda a: a.permute(0, 2, 3, 1, 4).reshape(b, l, -1)  # noqa: E731
    y64, h64, hf64 = kssd.ssd_split_fwd_ref(*(t.double() for t in (x, dth, S, Bm, Cm)), chunk,
                                            emit_states=True, emit_hfin=True)
    want = kssd.ssd_split_bwd_ref(*(t.double() for t in (x, dth, S, Bm, Cm, h64, dy)), chunk,
                                  dh_fin=None if dh_fin is None else dh_fin.double())
    got = [("y", as_rows(y), y64), ("h_in", h_in.transpose(1, 2), h64), ("h_fin", h_fin, hf64),
           *zip(("dx", "ddt", "dS", "dB", "dC"),
                (as_rows(dx), ddt, dS, dB.reshape(b, l, n), dC.reshape(b, l, n)), want)]
    errors = {}
    for name, g, w in got:
        assert g.shape == w.shape, name
        errors[name] = emu.rel_err_of_max(g, w)
    return errors


@pytest.mark.parametrize("seeded", [False, True], ids=["unseeded", "seeded"])
@pytest.mark.parametrize("chunk", [256, 64], ids=["nc2", "nc8"])
def test_3xtf32_k6_k7_arithmetic_meets_the_card_tolerances(chunk, seeded):
    """K6 with states and h_fin and K7 (from 0, or seeded: the last chunk's
    dh terms and its dS_end term then not 0) as the chunk-parallel body splits
    them, every product as 3xTF32, within chip_smoke.py's 1e-4 of the max of
    each output against the plain versions in float64."""
    errors = _split_tf32_errors(chunk, seeded, emu.mm3)
    print("3xTF32 error of the max:", {k: f"{v:.1e}" for k, v in errors.items()})
    for name, err in errors.items():
        assert err <= 1e-4, (name, err)


@pytest.mark.parametrize("chunk", [256, 64], ids=["nc2", "nc8"])
def test_one_tf32_product_misses_the_k6_k7_tolerance(chunk):
    """The same split, seeded, with every product as one TF32 product: the
    forward's and the backward's outputs lie above chip_smoke.py's 1e-4 of the
    max, so its checks tell 3xTF32 from a single TF32 product."""
    errors = _split_tf32_errors(chunk, True, emu.mm1)
    print("one TF32 product, error of the max:", {k: f"{v:.1e}" for k, v in errors.items()})
    assert max(errors[k] for k in ("y", "h_in", "h_fin")) > 1e-4
    assert max(errors[k] for k in ("dx", "ddt", "dS", "dB", "dC")) > 1e-4
