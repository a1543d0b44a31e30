"""The port's kernels (causal conv + SiLU forward and backward, selective-scan
forward, training forward and backward): their plain versions against the
JAX package's XLA oracles and its Pallas kernels in interpret mode (values
and ``jax.vjp``), on the same numpy inputs; the autograd Functions, the
dispatch and the mixer. The CUDA kernels themselves are held against these
plain versions on the card in tests/test_torch_port_cuda.py."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from si_mamba_tpu.ops.pallas.causal_conv_kernel import causal_conv1d_silu_pallas
from si_mamba_tpu.ops.pallas.selective_scan_kernel import _vjp_fwd, selective_scan_pallas
from si_mamba_tpu_torch.ops import selective_scan as tss
from si_mamba_tpu_torch.ops.kernels import causal_conv as kconv
from si_mamba_tpu_torch.ops.kernels import selective_scan as kscan

# the package re-exports the function under the module's name
jss = importlib.import_module("si_mamba_tpu.ops.selective_scan")


def _t(a, device="cpu"):
    return torch.tensor(np.asarray(a), device=device)


# ---------------------------------------------------------------------------
# K1: causal conv + SiLU
# ---------------------------------------------------------------------------

def _conv_inputs(b=2, l=37, d=24, w=4, seed=0):
    rng = np.random.default_rng(seed)
    xz = rng.standard_normal((b, l, 2 * d)).astype(np.float32)
    weight = (rng.standard_normal((d, w)) * 0.5).astype(np.float32)
    bias = (rng.standard_normal(d) * 0.1).astype(np.float32)
    return xz, weight, bias


@pytest.mark.parametrize("bias_on,activation", [(True, "silu"), (True, None), (False, "silu")])
def test_conv_plain_matches_jax_oracle(bias_on, activation):
    xz, w, b = _conv_inputs()
    x = xz[..., :24]
    bias = b if bias_on else None
    got = kconv.causal_conv1d_ref(_t(xz)[..., :24], _t(w),
                                  _t(bias) if bias_on else None, activation=activation)
    want = jss.causal_conv1d(jnp.asarray(x), jnp.asarray(w),
                             None if bias is None else jnp.asarray(bias), activation=activation)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_conv_plain_matches_pallas_interpret():
    xz, w, b = _conv_inputs(l=50, d=32)
    got = kconv.causal_conv1d_ref(_t(xz)[..., :32], _t(w), _t(b))
    want = causal_conv1d_silu_pallas(jnp.asarray(xz[..., :32]), jnp.asarray(w),
                                     jnp.asarray(b), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_conv_wrapper_on_cpu_is_the_plain_version():
    xz, w, b = _conv_inputs()
    before = kconv.causal_conv1d_silu.launches
    got = kconv.causal_conv1d_silu(_t(xz)[..., :24], _t(w), _t(b))
    np.testing.assert_array_equal(got.numpy(),
                                  kconv.causal_conv1d_ref(_t(xz)[..., :24], _t(w), _t(b)).numpy())
    assert kconv.causal_conv1d_silu.launches == before  # counts kernel launches only


F32, BF = torch.float32, torch.bfloat16
MIXER_VIEWS = ("Mamba-1 xi", "SSD x|B|C")


@pytest.mark.parametrize("what,dtype,shape,row,off,plan", [
    ("Mamba-1 xi, columns :768 of xz", F32, (32, 512, 768), 1536, 0, (2, 8, 4, (192, 32))),
    ("Mamba-1 xi at one cloud", F32, (1, 512, 768), 1536, 0, (2, 4, 4, (384, 1))),
    ("Mamba-1 xi at 20 clouds", F32, (20, 512, 768), 1536, 0, (2, 8, 4, (192, 20))),
    ("Mamba-1 xi at 64 clouds", F32, (64, 512, 768), 1536, 0, (2, 8, 4, (192, 64))),
    ("SSD x|B|C, columns 768:1792 of zxbcdt", F32, (32, 512, 1024), 1798, 768,
     (2, 8, 4, (256, 32))),
    ("SSD x|B|C at one cloud", F32, (1, 512, 1024), 1798, 768, (2, 4, 4, (512, 1))),
    ("SSD x|B|C at 20 clouds", F32, (20, 512, 1024), 1798, 768, (2, 8, 4, (256, 20))),
    ("SSD x|B|C at 64 clouds", F32, (64, 512, 1024), 1798, 768, (2, 8, 4, (256, 64))),
    ("tensor-parallel SSD x shard, contiguous", F32, (32, 512, 384), 384, 0, (2, 8, 4, (96, 32))),
    ("tensor-parallel SSD B|C, contiguous", F32, (32, 512, 256), 256, 0, (2, 8, 4, (64, 32))),
    ("tensor-parallel Mamba-1 xi, columns :384 of its xz", F32, (32, 512, 384), 768, 0,
     (2, 8, 4, (96, 32))),
    ("odd address", F32, (3, 37, 24), 50, 1, (1, 4, 1, (8, 3))),
    ("ragged L, D % 4 != 0", F32, (2, 100, 6), 6, 0, (2, 4, 1, (3, 2))),
    ("base offset by two elements, D % 4 != 0", F32, (1, 130, 130), 262, 2, (2, 4, 1, (68, 1))),
    ("Mamba-1 xi, columns :768 of xz", BF, (32, 512, 768), 1536, 0, (4, 8, 4, (96, 32))),
    ("Mamba-1 xi at one cloud", BF, (1, 512, 768), 1536, 0, (4, 4, 4, (192, 1))),
    ("Mamba-1 xi at 20 clouds", BF, (20, 512, 768), 1536, 0, (4, 8, 4, (96, 20))),
    ("Mamba-1 xi at 64 clouds", BF, (64, 512, 768), 1536, 0, (4, 8, 4, (96, 64))),
    ("SSD x|B|C, columns 768:1792 of zxbcdt", BF, (32, 512, 1024), 1798, 768, (2, 8, 4, (256, 32))),
    ("SSD x|B|C at one cloud", BF, (1, 512, 1024), 1798, 768, (2, 4, 4, (512, 1))),
    ("SSD x|B|C at 20 clouds", BF, (20, 512, 1024), 1798, 768, (2, 8, 4, (256, 20))),
    ("SSD x|B|C at 64 clouds", BF, (64, 512, 1024), 1798, 768, (2, 8, 4, (256, 64))),
    ("tensor-parallel SSD x shard, contiguous", BF, (32, 512, 384), 384, 0, (4, 8, 4, (48, 32))),
    ("tensor-parallel SSD B|C, contiguous", BF, (32, 512, 256), 256, 0, (4, 8, 4, (32, 32))),
    ("tensor-parallel Mamba-1 xi, columns :384 of its xz", BF, (32, 512, 384), 768, 0,
     (4, 8, 4, (48, 32))),
    ("odd address", BF, (3, 37, 24), 50, 1, (1, 4, 1, (8, 3))),
    ("ragged L, D % 4 != 0", BF, (2, 100, 6), 6, 0, (2, 4, 1, (3, 2))),
    ("base offset by two elements, D % 4 != 0", BF, (1, 130, 130), 262, 2, (2, 4, 1, (68, 1))),
])
def test_conv_fwd_plan(what, dtype, shape, row, off, plan):
    """K1's plan on the H100's 132 SMs: the widest access of 8 and 4 bytes
    that x's address and strides and D allow (the bf16 SSD view moves two
    channels, 4 bytes, a thread), else one element; the longer time tile (8)
    where its (channel vector, tile) pairs give every SM 8 warps, else 4;
    blocks of 4, 2 or 1 warps, at least one an SM where the shape has that
    many warps; the grid covers every pair of every batch row once, and a
    mixer view takes at least 132 blocks at one cloud."""
    B, L, D = shape
    x = torch.empty((B, L, row), device="meta", dtype=dtype)[..., off:off + D]
    got = kconv.fwd_plan(x)
    assert (got.vec, got.tile, got.warps, got.grid) == plan, what
    assert D % got.vec == 0 and got.vec * x.element_size() <= 8
    pairs = D // got.vec * -(-L // got.tile)
    block = 32 * got.warps
    assert got.grid[1] == B and got.grid[0] * block >= pairs > (got.grid[0] - 1) * block
    if B == 1 and what.startswith(MIXER_VIEWS):
        assert got.grid[0] >= 132
    # a tile is shorter only where the longer one would give under 8 warps an SM
    longer = [t for t in kconv.FWD_TILES if t > got.tile]
    assert all(D // got.vec * -(-L // t) * B < 32 * 8 * 132 for t in longer)


# ---------------------------------------------------------------------------
# K2: selective scan forward
# ---------------------------------------------------------------------------

def _scan_inputs(b=2, l=64, d=32, n=4, seed=0):
    """As in tests/test_pallas_scan.py; B and C are also given as column
    slices of one (b, l, 2 + 2n) buffer, as the mixer's x_dbl makes them."""
    rng = np.random.default_rng(seed)
    mk = lambda *s: rng.standard_normal(s).astype(np.float32)
    kw = dict(u=mk(b, l, d), delta=mk(b, l, d) * 0.5, A=-np.exp(mk(d, n)),
              x_dbl=mk(b, l, 2 + 2 * n), D=mk(d), z=mk(b, l, d), delta_bias=mk(d) * 0.1)
    kw["B"] = kw["x_dbl"][..., 2:2 + n]
    kw["C"] = kw["x_dbl"][..., 2 + n:]
    return kw


def _jax_args(kw):
    return [jnp.asarray(kw[k]) for k in ("u", "delta", "A", "B", "C")]


def _port_args(kw, device="cpu"):
    n = kw["A"].shape[1]
    x_dbl = _t(kw["x_dbl"], device)
    return [_t(kw["u"], device), _t(kw["delta"], device), _t(kw["A"], device),
            x_dbl[..., 2:2 + n], x_dbl[..., 2 + n:]]


def _port_kw(kw, device="cpu"):
    return dict(D=_t(kw["D"], device), z=_t(kw["z"], device),
                delta_bias=_t(kw["delta_bias"], device))


@pytest.mark.parametrize("impl", ["seq", "chunked"])
@pytest.mark.parametrize("l", [64, 50])
def test_scan_plain_matches_jax_seq_and_pallas(impl, l):
    kw = _scan_inputs(l=l)
    fn = tss.selective_scan_seq if impl == "seq" else tss.selective_scan_chunked
    got = fn(*_port_args(kw), **_port_kw(kw)).numpy()
    jkw = dict(D=jnp.asarray(kw["D"]), z=jnp.asarray(kw["z"]),
               delta_bias=jnp.asarray(kw["delta_bias"]))
    want_seq = jss.selective_scan_seq(*_jax_args(kw), **jkw)
    want_pallas = selective_scan_pallas(*_jax_args(kw), **jkw, block_d=32, chunk=16,
                                        interpret=True)
    np.testing.assert_allclose(got, np.asarray(want_seq), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(want_pallas), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("optional", [dict(), dict(D=None), dict(z=None),
                                      dict(delta_bias=None, delta_softplus=False)])
def test_scan_plain_optional_terms_match_jax(optional):
    kw = _scan_inputs(l=20, seed=1)
    pkw = {**_port_kw(kw), **optional}
    jkw = {k: (jnp.asarray(v.numpy()) if isinstance(v, torch.Tensor) else v)
           for k, v in pkw.items()}
    want = np.asarray(jss.selective_scan_seq(*_jax_args(kw), **jkw))
    for fn in (tss.selective_scan_seq, tss.selective_scan_chunked):
        got = fn(*_port_args(kw), **pkw).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_scan_wrapper_on_cpu_is_the_plain_version():
    kw = _scan_inputs(l=16)
    before = kscan.selective_scan_fwd.launches
    args, pkw = _port_args(kw), _port_kw(kw)
    got = kscan.selective_scan_fwd(*args, pkw["D"], pkw["z"], pkw["delta_bias"])
    np.testing.assert_array_equal(got.numpy(), kscan.selective_scan_ref(*args, **pkw).numpy())
    assert kscan.selective_scan_fwd.launches == before


def test_scan_dispatch():
    kw = _scan_inputs(l=24)
    args, pkw = _port_args(kw), _port_kw(kw)
    np.testing.assert_array_equal(tss.selective_scan(*args, **pkw, impl="auto").numpy(),
                                  tss.selective_scan_chunked(*args, **pkw).numpy())
    np.testing.assert_array_equal(tss.selective_scan(*args, **pkw, impl="pallas").numpy(),
                                  tss.selective_scan_seq(*args, **pkw).numpy())
    # 'assoc', the whole-sequence log-depth scan, equals the sequential oracle
    np.testing.assert_allclose(tss.selective_scan(*args, **pkw, impl="assoc").numpy(),
                               tss.selective_scan_seq(*args, **pkw).numpy(),
                               rtol=1e-5, atol=1e-6)
    # 'fused' is a route of mamba_mixer_apply, not a scan: unknown here, as in JAX
    with pytest.raises(ValueError, match="unknown impl"):
        tss.selective_scan(*args, **pkw, impl="fused")
    with pytest.raises(NotImplementedError, match="delta_bias"):
        tss.selective_scan(*args, **{**pkw, "delta_bias": None}, impl="pallas")
    with pytest.raises(ValueError, match="unknown impl"):
        tss.selective_scan(*args, **pkw, impl="nope")


@pytest.mark.parametrize("optional", [dict(D=None), dict(z=None), dict(delta_bias=None),
                                      dict(delta_softplus=False)])
def test_scan_auto_on_cpu_is_chunked_for_a_partial_signature(optional):
    """Only a CPU tensor takes the plain scan under 'auto' (a CUDA tensor
    with a partial signature raises, tests/test_torch_port_cuda.py)."""
    kw = _scan_inputs(l=24, seed=2)
    args, pkw = _port_args(kw), {**_port_kw(kw), **optional}
    np.testing.assert_array_equal(tss.selective_scan(*args, **pkw, impl="auto").numpy(),
                                  tss.selective_scan_chunked(*args, **pkw).numpy())


# ---------------------------------------------------------------------------
# the mixer: the same parameter dict through both packages
# ---------------------------------------------------------------------------

def _mixer_params(d_model=16, d_state=4, dt_rank=2, d_conv=4, seed=3):
    rng = np.random.default_rng(seed)
    di = 2 * d_model
    mk = lambda *s, sc=0.3: (rng.standard_normal(s) * sc).astype(np.float32)
    return {
        "in_proj_w": mk(d_model, 2 * di), "conv_w": mk(di, d_conv), "conv_b": mk(di),
        "x_proj_w": mk(di, dt_rank + 2 * d_state), "dt_proj_w": mk(dt_rank, di),
        "dt_proj_b": mk(di, sc=0.1),
        "A_log": np.log(np.tile(np.arange(1, d_state + 1, dtype=np.float32), (di, 1))),
        "D": np.ones(di, np.float32), "out_proj_w": mk(di, d_model),
    }


@pytest.mark.parametrize("impl", ["auto", "pallas", "seq", "chunked"])
def test_mixer_matches_jax(impl):
    p = _mixer_params()
    x = np.random.default_rng(4).standard_normal((2, 40, 16)).astype(np.float32)
    got = tss.mamba_mixer_apply({k: _t(v) for k, v in p.items()}, _t(x), d_state=4,
                                dt_rank=2, impl=impl)
    want = jss.mamba_mixer_apply({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                                 d_state=4, dt_rank=2, impl="seq")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


def test_mixer_rejects_unported_impls_and_dtypes():
    p = {k: _t(v) for k, v in _mixer_params().items()}
    x = torch.zeros(1, 4, 16)
    # 'assoc' runs (the plain conv and the whole-sequence scan) and equals 'seq'
    xr = torch.from_numpy(np.random.default_rng(5).standard_normal((1, 12, 16)).astype(np.float32))
    np.testing.assert_allclose(
        tss.mamba_mixer_apply(p, xr, d_state=4, dt_rank=2, impl="assoc").numpy(),
        tss.mamba_mixer_apply(p, xr, d_state=4, dt_rank=2, impl="seq").numpy(),
        rtol=1e-5, atol=1e-6)
    with pytest.raises(NotImplementedError, match="float16"):
        tss.mamba_mixer_apply(p, x.half(), d_state=4, dt_rank=2)
    # bf16 on the 'fused' routes is what JAX does with it: 'fused' refuses
    # d_inner 32 at either dtype, 'fused_interpret' runs (bf16 in, bf16 out)
    with pytest.raises(ValueError, match="d_inner % 128 == 0"):
        tss.mamba_mixer_apply(p, x.bfloat16(), d_state=4, dt_rank=2, impl="fused")
    y = tss.mamba_mixer_apply(p, x.bfloat16(), d_state=4, dt_rank=2, impl="fused_interpret")
    assert y.dtype == torch.bfloat16 and y.shape == (1, 4, 16) and torch.isfinite(y).all()


# ---------------------------------------------------------------------------
# K5: causal conv backward; K3, K4: the scan's training forward and backward
# ---------------------------------------------------------------------------

def _grads(fn, args, g):
    """Torch autograd of fn at args (leaves made here) for output gradient g."""
    leaves = [a.detach().clone().requires_grad_() for a in args]
    return torch.autograd.grad(fn(*leaves), leaves, g)


@pytest.mark.parametrize("l,d,row,off", [
    pytest.param(37, 24, None, 0, id="37-24"),
    pytest.param(50, 32, None, 0, id="50-32"),
    # as the SSD mixer's view, columns 768:1792 of the 1798-wide in_proj output:
    # a row stride of 2 (mod 4), here columns 16:48 of a 70-wide buffer
    pytest.param(64, 32, 70, 16, id="ssd-view-64-32"),
])
def test_conv_plain_backward_matches_jax_vjp_and_autograd(l, d, row, off):
    xz, w, b = _conv_inputs(l=l, d=d, seed=3)
    if row is not None:
        xz = np.random.default_rng(5).standard_normal((2, l, row)).astype(np.float32)
    g = np.random.default_rng(4).standard_normal((2, l, d)).astype(np.float32)
    x = _t(xz)[..., off:off + d]  # a column slice, as in the mixer
    assert row is None or x.stride(1) % 4 == 2
    got = kconv.causal_conv1d_silu_bwd_ref(x, _t(w), _t(b), _t(g))
    _, vjp = jax.vjp(lambda x, w, b: causal_conv1d_silu_pallas(x, w, b, interpret=True),
                     jnp.asarray(xz[..., off:off + d]), jnp.asarray(w), jnp.asarray(b))
    auto = _grads(lambda *a: kconv.causal_conv1d_ref(*a), (x, _t(w), _t(b)), _t(g))
    for a, jw, tw in zip(got, vjp(jnp.asarray(g)), auto):
        np.testing.assert_allclose(a.numpy(), np.asarray(jw), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(a.numpy(), tw.numpy(), rtol=1e-5, atol=1e-5)


def _meta_view(shape, row, off):
    """A (B, L, D) column view at columns off:off+D of a (B, L, row) buffer,
    on the meta device: strides and an address (0 plus the offset), no memory."""
    B, L, D = shape
    return torch.empty((B, L, row), device="meta")[..., off:off + D]


@pytest.mark.parametrize("what,shape,row,off,width,variant", [
    ("Mamba-1 x, columns :768 of xz", (32, 512, 768), 1536, 0, 4, (4, 4)),
    ("SSD x|B|C, columns 768:1792 of zxbcdt", (32, 512, 1024), 1798, 768, 2, (2, 4)),
    ("tensor-parallel x shard, contiguous", (32, 512, 384), 384, 0, 4, (4, 4)),
    ("tensor-parallel B|C, contiguous", (32, 512, 256), 256, 0, 4, (4, 4)),
    ("odd row stride", (32, 512, 768), 1537, 0, 1, (1, 1)),
    ("base offset by one float", (32, 512, 768), 1536, 1, 1, (1, 1)),
    ("base offset by two floats", (32, 512, 768), 1536, 2, 2, (2, 4)),
])
def test_conv_bwd_plan_vector_widths(what, shape, row, off, width, variant):
    """K5 moves x 16, 8 or 4 bytes a thread at a time and g and dx 16 or 4,
    in the widest of its three built variants that the operands' bases and
    strides allow; dx is allocated contiguous."""
    x = _meta_view(shape, row, off)
    g = torch.empty(shape, device="meta")
    plan = kconv.bwd_plan(x, g)
    assert (plan.vx, plan.vg) == variant, what
    assert kconv.vector_width(x.data_ptr(), *shape[:2], x.stride(0), x.stride(1)) == width
    # g and dx share a width: a g narrower than 16 bytes takes the scalar variant
    swapped = kconv.bwd_plan(g, x)
    assert (swapped.vx, swapped.vg) == ((4, 4) if width == 4 else (1, 1))
    # a width of D that is not a multiple of 4 makes dx's rows narrower
    odd = kconv.bwd_plan(*(torch.empty((*shape[:2], 130), device="meta"),) * 2)
    assert (odd.vx, odd.vg) == (1, 1)
    assert {(plan.vx, plan.vg), (odd.vx, odd.vg)} <= set(kconv.BWD_VARIANTS)


@pytest.mark.parametrize("shape,tile,partials", [
    ((32, 512, 768), 64, (64, 5, 768)),     # Mamba-1: 6 x 32 x 8 = 1536 warps
    ((32, 512, 1024), 64, (64, 5, 1024)),   # SSD: 2048 warps
    ((32, 512, 384), 32, (128, 5, 384)),    # tensor-parallel x shard: 1536 warps at 32
    ((32, 512, 256), 16, (256, 5, 256)),    # tensor-parallel B|C: 2048 warps at 16
    ((1, 512, 768), 16, (8, 5, 768)),       # one cloud: the shortest tile
    ((3, 130, 200), 16, (9, 5, 200)),       # ragged L and D: 9 tiles, 3 blocks a row
])
def test_conv_bwd_plan_tile_and_partials(shape, tile, partials):
    """The time tile is the longest of 64, 32 and 16 that gives every one of
    the H100's 132 SMs at least 8 warps; the partials hold one (W+1, D) row
    per block, BWD_WARPS tiles a block."""
    x = torch.empty(shape, device="meta")
    plan = kconv.bwd_plan(x, x)
    assert plan.tile == tile
    assert plan.partial_shape == partials
    time_blocks = partials[0] // shape[0]  # blocks along a batch row, 4 tiles each
    assert time_blocks * 4 * tile >= shape[1] > (time_blocks - 1) * 4 * tile
    assert kconv.bwd_partials(*shape, 4, tile) == partials


def test_conv_bwd_wrapper_on_cpu_is_the_plain_version():
    xz, w, b = _conv_inputs(l=40, d=32, seed=6)
    g = _t(np.random.default_rng(7).standard_normal((2, 40, 32)).astype(np.float32))
    x = _t(xz)[..., 32:]
    before = kconv.causal_conv1d_silu_bwd.launches
    got = kconv.causal_conv1d_silu_bwd(x, _t(w), _t(b), g)
    want = kconv.causal_conv1d_silu_bwd_ref(x, _t(w), _t(b), g)
    for a, r in zip(got, want):
        assert torch.equal(a, r)
    assert kconv.causal_conv1d_silu_bwd.launches == before  # counts kernel launches only


def _jax_vjp_pallas(kw, g, **pallas_kw):
    jargs = _jax_args(kw) + [jnp.asarray(kw[k]) for k in ("D", "z", "delta_bias")]
    _, vjp = jax.vjp(lambda u, dl, A, B, C, D, z, db: selective_scan_pallas(
        u, dl, A, B, C, D=D, z=z, delta_bias=db, interpret=True, **pallas_kw), *jargs)
    return vjp(jnp.asarray(g))


def _fn_grads(kw, g):
    """Gradients through SelectiveScanFn on the CPU (the plain backward), in
    (u, delta, A, B, C, D, z, delta_bias) order; B and C are column views of
    one x_dbl leaf, so their gradients are read back from its gradient."""
    n = kw["A"].shape[1]
    leaves = {k: _t(kw[k]).requires_grad_() for k in ("u", "delta", "A", "x_dbl", "D", "z",
                                                      "delta_bias")}
    x_dbl = leaves["x_dbl"]
    y = kscan.SelectiveScanFn.apply(leaves["u"], leaves["delta"], leaves["A"],
                                    x_dbl[..., 2:2 + n], x_dbl[..., 2 + n:], leaves["D"],
                                    leaves["z"], leaves["delta_bias"])
    assert isinstance(y.grad_fn, kscan.SelectiveScanFn._backward_cls)
    y.backward(_t(g))
    gx = leaves["x_dbl"].grad
    np.testing.assert_array_equal(gx[..., :2].numpy(), 0.0)
    return [leaves["u"].grad, leaves["delta"].grad, leaves["A"].grad, gx[..., 2:2 + n],
            gx[..., 2 + n:], leaves["D"].grad, leaves["z"].grad, leaves["delta_bias"].grad]


@pytest.mark.parametrize("l", [64, 50])
def test_scan_plain_backward_matches_jax_pallas_vjp(l):
    kw = _scan_inputs(b=2, l=l, d=32, n=4, seed=5)
    g = np.random.default_rng(6).standard_normal((2, l, 32)).astype(np.float32)
    got = _fn_grads(kw, g)
    want = _jax_vjp_pallas(kw, g, block_d=16, chunk=16)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-3, atol=1e-4)


def test_scan_plain_backward_matches_autograd_of_the_sequential_scan():
    kw = _scan_inputs(b=2, l=45, d=24, n=4, seed=7)
    g = np.random.default_rng(8).standard_normal((2, 45, 24)).astype(np.float32)
    got = _fn_grads(kw, g)
    args = _port_args(kw) + [_t(kw[k]) for k in ("D", "z", "delta_bias")]
    want = _grads(lambda u, dl, A, B, C, D, z, db: kscan.selective_scan_ref(
        u, dl, A, B, C, D=D, z=z, delta_bias=db), args, _t(g))
    for a, b in zip(got, want):
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= 1e-4 * scale


@pytest.mark.parametrize("l", [256, 200])
def test_scan_plain_residuals_match_lean_forward_and_jax_entries(l):
    """The training forward's y equals the lean forward's, and its entry
    states, one per 16 steps, equal JAX's ``_vjp_fwd`` entries (one per 128
    steps) where the two grids share a boundary."""
    kw = _scan_inputs(b=2, l=l, d=32, n=4, seed=9)
    args, pkw = _port_args(kw), _port_kw(kw)
    y, h_entries = kscan.selective_scan_fwd_residuals_ref(*args, pkw["D"], pkw["z"],
                                                          pkw["delta_bias"])
    np.testing.assert_array_equal(y.numpy(), kscan.selective_scan_ref(*args, **pkw).numpy())
    assert h_entries.shape == (2, -(-l // kscan.CHUNK), 4, 32)
    np.testing.assert_array_equal(h_entries[:, 0].numpy(), 0.0)
    jargs = _jax_args(kw) + [jnp.asarray(kw[k]) for k in ("D", "z", "delta_bias")]
    _, res = _vjp_fwd(*jargs, 32, 128, True)
    jh = np.asarray(res[8])  # (b, ceil(l/128), n, d)
    step = 128 // kscan.CHUNK
    np.testing.assert_allclose(h_entries[:, ::step].numpy(), jh, rtol=1e-4, atol=1e-5)


def test_functions_keep_the_graph_on_a_tensor_that_requires_grad():
    """The conv and the fused scan return outputs whose grad_fn is their
    autograd Function, so every upstream parameter gets its gradient."""
    xz, w, b = _conv_inputs()
    x = _t(xz).requires_grad_()
    y = kconv.causal_conv1d_silu(x[..., :24], _t(w), _t(b))
    assert isinstance(y.grad_fn, kconv.CausalConv1dSiluFn._backward_cls)
    kw = _scan_inputs(l=20, seed=10)
    args, pkw = _port_args(kw), _port_kw(kw)
    u = args[0].requires_grad_()
    out = tss.selective_scan(u, *args[1:], **pkw, impl="pallas")
    assert isinstance(out.grad_fn, kscan.SelectiveScanFn._backward_cls)
    with torch.no_grad():
        assert tss.selective_scan(u, *args[1:], **pkw, impl="pallas").grad_fn is None
    (y.sum() + out.sum()).backward()
    assert x.grad is not None and u.grad is not None


def test_mixer_pallas_grads_on_the_cpu_match_seq():
    """Every mixer parameter's gradient through the Functions' plain backward
    equals autograd through the plain sequential scan and conv."""
    p = _mixer_params(d_model=16, d_state=4, dt_rank=2)
    x = _t(np.random.default_rng(11).standard_normal((2, 40, 16)).astype(np.float32))
    grads = {}
    for impl in ("pallas", "seq"):
        leaves = {k: _t(v).requires_grad_() for k, v in p.items()}
        tss.mamba_mixer_apply(leaves, x, d_state=4, dt_rank=2, impl=impl).square().sum().backward()
        grads[impl] = {k: v.grad for k, v in leaves.items()}
    for k in p:
        scale = float(grads["seq"][k].abs().max())
        assert float((grads["pallas"][k] - grads["seq"][k]).abs().max()) <= 1e-4 * scale, k


# ---------------------------------------------------------------------------
# the conv weights the kernel routes hand K1/K5, by width
# ---------------------------------------------------------------------------

def _spy_conv(monkeypatch):
    """Record the (weight, bias) every call of ``causal_conv1d_silu`` gets,
    whichever module calls it."""
    seen, real = [], kconv.causal_conv1d_silu

    def spy(x, weight, bias):
        seen.append((weight.detach().clone(), bias.detach().clone()))
        return real(x, weight, bias)

    from si_mamba_tpu_torch.ops import ssd as tssd

    for mod in (kconv, tss, tssd):
        monkeypatch.setattr(mod, "causal_conv1d_silu", spy, raising=False)
    return seen


def _ssd_conv_params(d_inner, d_state, n_heads, d_model=16, seed=7):
    rng = np.random.default_rng(seed)
    conv = d_inner + 2 * d_state
    mk = lambda *s, sc=0.3: torch.from_numpy((rng.standard_normal(s) * sc).astype(np.float32))  # noqa: E731
    return {"in_proj_w": mk(d_model, 2 * d_inner + 2 * d_state + n_heads), "conv_w": mk(conv, 4),
            "conv_b": mk(conv, sc=0.1), "dt_bias": mk(n_heads, sc=0.1),
            "A_log": mk(n_heads, sc=0.1), "D": mk(n_heads), "norm_scale": 1 + mk(d_inner, sc=0.1),
            "out_proj_w": mk(d_inner, d_model)}


@pytest.mark.parametrize("mixer,width", [("mamba", 96), ("mamba", 128), ("ssd", 96), ("ssd", 128)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernel_route_conv_weights_follow_jax_by_width(monkeypatch, mixer, width, dtype):
    """The kernel routes ('pallas', 'ssd_fused') hand ``causal_conv1d_silu``
    the fp32 conv weights where the conv width is a multiple of 128 (the
    TPU's Pallas conv) and, at any other width, the weights rounded to the
    activation dtype (JAX's XLA conv there); at fp32 the weights as given."""
    seen = _spy_conv(monkeypatch)
    d_model = width // 2 if mixer == "mamba" else 16
    x = _t(np.random.default_rng(8).standard_normal((2, 24, d_model)).astype(np.float32))
    if mixer == "mamba":
        p = {k: _t(v) for k, v in _mixer_params(d_model=d_model, d_state=4, dt_rank=2).items()}
        tss.mamba_mixer_apply(p, x.to(dtype), d_state=4, dt_rank=2, impl="pallas")
    else:
        from si_mamba_tpu_torch.ops.ssd import ssd_mixer_apply

        d_state = 16  # conv width d_inner + 2 d_state
        p = _ssd_conv_params(width - 2 * d_state, d_state, n_heads=2)
        ssd_mixer_apply(p, x.to(dtype), n_heads=2, d_state=d_state, chunk=8, impl="ssd_fused")
    (w, b), = seen
    assert w.dtype == b.dtype == torch.float32
    rounded = dtype == torch.bfloat16 and width % 128 != 0
    want_w = p["conv_w"].to(dtype).float() if rounded else p["conv_w"]
    want_b = p["conv_b"].to(dtype).float() if rounded else p["conv_b"]
    assert torch.equal(w, want_w) and torch.equal(b, want_b)
    if dtype == torch.bfloat16 and width % 128 == 0:
        assert not torch.equal(w, p["conv_w"].to(dtype).float())  # the fp32 originals


def test_mixer_kernel_route_at_width_96_bf16_holds_jax():
    """At d_inner 96 and bf16 the 'pallas' route reads the conv weights that
    JAX's mixer reads there (its XLA conv, weights cast to bf16): on the CPU
    its output equals the port's plain 'seq' route bitwise, and both lie
    within 8 bf16 ulps of the output's max from JAX's ``mamba_mixer_apply``.
    JAX's XLA conv rounds every shifted add to bf16 on the CPU while the
    port's conv (kernel and plain) accumulates in fp32, so the two frameworks
    part by several ulps at any width (5 on these inputs)."""
    p = _mixer_params(d_model=48, d_state=4, dt_rank=3, seed=3)
    x = np.random.default_rng(4).standard_normal((2, 40, 48)).astype(np.float32)
    got = {impl: tss.mamba_mixer_apply({k: _t(v) for k, v in p.items()},
                                       torch.from_numpy(x).bfloat16(), d_state=4, dt_rank=3,
                                       impl=impl).float().numpy() for impl in ("pallas", "seq")}
    np.testing.assert_array_equal(got["pallas"], got["seq"])
    want = np.asarray(jss.mamba_mixer_apply(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x).astype(jnp.bfloat16),
        d_state=4, dt_rank=3, impl="seq").astype(jnp.float32))
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    assert np.abs(got["pallas"] - want).max() <= 8 * ulp
