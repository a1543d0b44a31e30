"""The SSD presets as shipped against the JAX package on the CPU: bf16
activations (fp32 parameters, decay math and state carry) with the subspace
eigensolver, as cfgs/finetune_modelnet_ssd.yaml and
cfgs/finetune_modelnet_ssd_fused.yaml set them.

Held here, at small sizes with inputs from numpy seeds: the bf16 plain
versions of K8/K9 and K6/K7 against the Pallas kernels in interpret mode
(values and the custom VJPs), the bf16 arithmetic of the CUDA kernels' split
(tests/ssd_emulation.py) against those plain versions within chip_smoke.py's
tolerances, ``ssd_chunked`` and ``ssd_mixer_apply`` (both routes) at bf16,
the bf16 SSD ``PointMamba``'s logits and one train step, the predictor in
perf mode on an SSD checkpoint, the presets through the CLI, and the options
that stay refused at bf16. The tensor- and sequence-parallel paths at bf16
are in tests/test_torch_port_ssd_bf16_parallel.py; the CUDA kernels' bf16
variants are held against these plain versions on the card in
tests/test_torch_port_cuda.py.

Tolerances: where both sides round the same fp32 value to bf16 once, in bf16
ulps (the ulp taken at least at a floor of the output's max, since sums that
cancel lose relative accuracy in fp32 too); fp32 outputs relative to their
max; where bf16 rounds at many points in places the two frameworks do not
share (XLA's and torch's bf16 elementwise ops, the conv), relative to the
max, as tests/test_torch_port_perf.py does.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from si_mamba_tpu.models import PointMamba as JPointMamba
from si_mamba_tpu.models import PointMambaConfig as JConfig
from si_mamba_tpu.models.point_mamba import cross_entropy_loss_acc as j_ce
from si_mamba_tpu.ops import ssd as jssd
from si_mamba_tpu.ops.pallas import ssd_kernel as jk
from si_mamba_tpu.ops.pallas.causal_conv_kernel import causal_conv1d_silu_pallas
from si_mamba_tpu.train.config import get_config as j_get_config
from si_mamba_tpu_torch.models import PointMamba, PointMambaConfig
from si_mamba_tpu_torch.models import point_mamba as port_pm
from si_mamba_tpu_torch.ops import ssd as tssd
from si_mamba_tpu_torch.ops.kernels import ssd as kssd
from si_mamba_tpu_torch.serving import Predictor
from si_mamba_tpu_torch.train import cli
from si_mamba_tpu_torch.train.config import get_config
from si_mamba_tpu_torch.utils.weights import state_dict_from_jax

from tests import ssd_emulation as emu
from tests.test_torch_port_harness import ROOT, _scalars, modelnet_tree  # noqa: F401
from tests.test_torch_port_perf import ZERO_GRADIENT, _aligned_eigvecs, _bf16, _clouds, _rel, \
    _ulps

jss = importlib.import_module("si_mamba_tpu.ops.selective_scan")

BF = torch.bfloat16
JBF = jnp.bfloat16
# the SSD presets' model settings (bf16, subspace, the SSD mixer) at a small
# size: depth 2, trans_dim 64 (one head of 128), d_state 128 (the SSD mixer's
# default), 16 groups of 8 (L = 128, two chunks of 64)
SSD_PERF = dict(trans_dim=64, encoder_dims=64, depth=2, cls_dim=10, num_group=16, group_size=8,
                drop_path=0.0, cls_head_dropout=0.0, knn_graph=8, mixer="ssd", ssd_chunk=64,
                dtype="bfloat16", spectral_method="subspace")


def _rel0(got, want) -> float:
    """max |got - want| over max(max |want|, 1): the error of a tensor that may
    be all zeros (the entry states of a single chunk)."""
    got, want = (np.asarray(torch.as_tensor(np.asarray(a, np.float32)) if not isinstance(
        a, torch.Tensor) else a.float()) for a in (got, want))
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1.0))


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _core_case(b, l, h, p, n, chunk, seed):
    """xbc (b, l, h*p + 2n) bf16 in both frameworks, dt and S in the
    kernels' (b, h, nc, q) layout (S by JAX), D (h,): ((port), (JAX))."""
    rng = np.random.default_rng(seed)
    xbc = rng.standard_normal((b, l, h * p + 2 * n)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, l, h)))).astype(np.float32)
    A = (-np.exp(rng.standard_normal(h))).astype(np.float32)
    D = rng.standard_normal(h).astype(np.float32)
    dth = jnp.asarray(dt).transpose(0, 2, 1).reshape(b, h, l // chunk, chunk)
    S = jnp.cumsum(dth * jnp.asarray(A)[None, :, None, None], axis=-1)
    txbc, jxbc = _bf16(xbc)
    return (txbc, *_t(dth, S, D)), (jxbc, dth, S, jnp.asarray(D))


def _dy(shape, seed):
    return _bf16(np.random.default_rng(seed).standard_normal(shape).astype(np.float32))


# ---------------------------------------------------------------------------
# the plain versions of K8/K9 and K6/K7 at bf16
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk,l", [(32, 128), (64, 64)], ids=["nc4", "single_chunk"])
def test_plain_k8_k9_bf16_match_pallas_interpret(chunk, l):
    """y (bf16) and h_in (fp32) of ``ssd_xbc_fwd_ref`` against the Pallas xbc
    kernel in interpret mode, and dxbc (bf16), ddt, dS, dD (fp32) of
    ``ssd_xbc_bwd_ref`` against ``jax.vjp`` of its custom VJP: both round at
    the same points (xdt, GM, the decayed xdt, h_in and dG as product
    operands), so the bf16 outputs lie within one ulp (floor 1e-2 of the max)
    and the fp32 ones within 1e-5 of their max."""
    h, p, n = 3, 16, 8
    (xbc, dth, S, D), (jxbc, jdth, jS, jD) = _core_case(2, l, h, p, n, chunk, seed=l + chunk)
    SD = jk._stack_sdd(jS, jdth, jD)
    y_j, hin_j, _ = jk._fwd_call_xbc(SD, jxbc, h * p, True, emit_states=True)
    y, h_in = kssd.ssd_xbc_fwd_ref(xbc, dth, S, D, h * p, chunk, emit_states=True)
    assert y.dtype == BF and y_j.dtype == JBF and h_in.dtype == torch.float32
    assert _ulps(y, y_j) <= 1
    assert _rel0(h_in, hin_j) <= 1e-5
    assert torch.equal(kssd.ssd_xbc_fwd(xbc, dth, S, D, h * p, chunk), y)

    tdy, jdy = _dy((2, l, h * p), seed=l)
    _, vjp = jax.vjp(lambda *a: jk._ssd_fused_xbc(*a, h * p, True), jxbc, jdth, jS, jD)
    got = kssd.ssd_xbc_bwd_ref(xbc, dth, S, D, h_in, tdy, h * p, chunk)
    for name, g, w in zip(("dxbc", "ddt", "dS", "dD"), got, vjp(jdy)):
        assert g.shape == w.shape, name
        if name == "dxbc":
            assert g.dtype == BF and _ulps(g, w) <= 1, name
        else:
            assert g.dtype == torch.float32 and _rel(g, w) <= 1e-5, name


@pytest.mark.parametrize("seeded", [False, True], ids=["from_zero", "seeded"])
def test_plain_k6_k7_bf16_match_pallas_interpret(seeded):
    """The split core at bf16 (x, B and C separate bf16 operands): every K6
    variant's y, h_in and h_fin against ``_fwd_call`` in interpret mode, and
    K7 from 0 or seeded with a dh_fin against ``_split_bwd``: dx, dB, dC
    (bf16) within one ulp, ddt and dS (fp32) within 1e-5 of their max."""
    b, l, h, p, n, chunk = 2, 128, 3, 16, 8, 32
    (xbc, dth, S, _), (jxbc, jdth, jS, _) = _core_case(b, l, h, p, n, chunk, seed=21)
    x, Bm, Cm = (xbc[..., :h * p], xbc[..., h * p:h * p + n], xbc[..., h * p + n:])
    jx, jB, jC = (jxbc[..., :h * p], jxbc[..., h * p:h * p + n].reshape(b, l // chunk, chunk, n),
                  jxbc[..., h * p + n:].reshape(b, l // chunk, chunk, n))
    SD = jk._stack_sd(jS, jdth)
    y_j, hin_j, hf_j = jk._fwd_call(SD, jx, jB, jC, True, emit_states=True, emit_hfin=True)
    y, h_in, h_fin = kssd.ssd_split_fwd_ref(x, dth, S, Bm, Cm, chunk, emit_states=True,
                                            emit_hfin=True)
    assert y.dtype == BF and h_in.dtype == h_fin.dtype == torch.float32
    assert _ulps(y, y_j) <= 1
    assert _rel(h_in, hin_j) <= 1e-5 and _rel(h_fin, hf_j) <= 1e-5
    for fn in (kssd.ssd_split_fwd, kssd.ssd_split_fwd_states, kssd.ssd_split_fwd_hfin,
               kssd.ssd_split_fwd_states_hfin):
        out = fn(x, dth, S, Bm, Cm, chunk)
        assert torch.equal(out if isinstance(out, torch.Tensor) else out[0], y)

    tdy, jdy = _dy((b, l, h * p), seed=22)
    dh_fin = np.random.default_rng(23).standard_normal((b, h, n, p)).astype(np.float32) * 0.1
    seed_t, seed_j = (_t(dh_fin)[0], jnp.asarray(dh_fin)) if seeded else (None, None)
    want = jk._split_bwd((SD, jx, jB, jC, hin_j), jdy, True, dh_fin=seed_j)
    got = kssd.ssd_split_bwd_ref(x, dth, S, Bm, Cm, h_in, tdy, chunk, dh_fin=seed_t)
    for name, g, w in zip(("dx", "ddt", "dS", "dB", "dC"), got, want):
        w = w.reshape(g.shape)
        if name in ("dx", "dB", "dC"):
            assert g.dtype == BF and _ulps(g, w) <= 1, name
        else:
            assert g.dtype == torch.float32 and _rel(g, w) <= 1e-5, name


def test_bf16_kernel_wrappers_take_the_plain_versions_on_the_cpu():
    """On a CPU tensor each ``_bf16`` wrapper is the plain version at bf16
    (and refuses fp32), and the autograd Functions keep the dtypes: bf16
    gradients for the bf16 operands, fp32 for dt, S and D."""
    h, p, n, chunk, l = 2, 16, 8, 32, 64
    (xbc, dth, S, D), _ = _core_case(1, l, h, p, n, chunk, seed=5)
    assert torch.equal(kssd.ssd_xbc_fwd_bf16(xbc, dth, S, D, h * p, chunk),
                       kssd.ssd_xbc_fwd_ref(xbc, dth, S, D, h * p, chunk)[0])
    with pytest.raises(TypeError, match="bfloat16"):
        kssd.ssd_xbc_fwd_bf16(xbc.float(), dth, S, D, h * p, chunk)
    x, Bm, Cm = xbc[..., :h * p], xbc[..., h * p:h * p + n], xbc[..., h * p + n:]
    y, h_fin = kssd.ssd_split_fwd_hfin_bf16(x, dth, S, Bm, Cm, chunk)
    assert y.dtype == BF and h_fin.dtype == torch.float32
    leaves = [t.detach().clone().requires_grad_() for t in (xbc, dth, S, D)]
    out = kssd.SSDChunkedXbcFn.apply(*leaves, h * p, chunk)
    out.float().sum().backward()
    assert [t.grad.dtype for t in leaves] == [BF, torch.float32, torch.float32, torch.float32]


# ---------------------------------------------------------------------------
# the CUDA kernels' bf16 arithmetic, emulated
# ---------------------------------------------------------------------------

def _bf16_case(chunk, heads=6):
    """The kernels' inputs at the SSD classifier's width (heads of 128,
    d_state 128, L 512), B=1, bf16 activations: (x, B, C, dy (b, h, nc, q, p)
    or (b, nc, q, n) holding bf16 values in fp32, dth, S, D)."""
    rng = np.random.default_rng(41)
    b, l, h, p, n = 1, 512, heads, 128, 128
    nc = l // chunk
    rnd = lambda a: emu.bf16(torch.tensor(a.astype(np.float32)))  # noqa: E731
    x = rnd(rng.standard_normal((b, h, nc, chunk, p)) * 0.5)
    Bc, Cc = (rnd(rng.standard_normal((b, nc, chunk, n)) * 0.5) for _ in range(2))
    dt = torch.nn.functional.softplus(torch.tensor(rng.standard_normal((b, h, nc, chunk)),
                                                   dtype=torch.float32) - 1.0)
    A = -torch.exp(torch.tensor(rng.standard_normal(h), dtype=torch.float32))
    S = torch.cumsum(dt * A[None, :, None, None], dim=-1)
    D = torch.tensor(rng.standard_normal(h), dtype=torch.float32)
    dy = rnd(rng.standard_normal((b, h, nc, chunk, p)))
    return x, Bc, Cc, dy, dt, S, D


def _plain_bf16(x, Bc, Cc, dy, dt, S, D, dh_fin):
    """The plain bf16 versions on the same values: (y, h_in, h_fin, (dx, ddt,
    dS, dB, dC, dD or None)), heads next to the batch."""
    b, h, nc, q, p = x.shape
    to_seq = lambda t: t.permute(0, 2, 3, 1, 4).reshape(b, nc * q, h * p).to(BF)  # noqa: E731
    xs, dys = to_seq(x), to_seq(dy)
    Bs, Cs = Bc.reshape(b, nc * q, -1).to(BF), Cc.reshape(b, nc * q, -1).to(BF)
    if D is not None:
        xbc = torch.cat([xs, Bs, Cs], dim=-1)
        y, h_in = kssd.ssd_xbc_fwd_ref(xbc, dt, S, D, h * p, q, emit_states=True)
        dxbc, ddt, dS, dD = kssd.ssd_xbc_bwd_ref(xbc, dt, S, D, h_in, dys, h * p, q)
        dx, dB, dC, h_fin = dxbc[..., :h * p], dxbc[..., h * p:h * p + 128], dxbc[..., -128:], None
    else:
        y, h_in, h_fin = kssd.ssd_split_fwd_ref(xs, dt, S, Bs, Cs, q, emit_states=True,
                                                emit_hfin=True)
        dx, ddt, dS, dB, dC = kssd.ssd_split_bwd_ref(xs, dt, S, Bs, Cs, h_in, dys, q,
                                                     dh_fin=dh_fin)
        dD = None
    heads = lambda t: t.float().reshape(b, nc, q, h, p).permute(0, 3, 1, 2, 4)  # noqa: E731
    return heads(y), h_in.transpose(1, 2), h_fin, (heads(dx), ddt, dS, dB.float().reshape(
        Bc.shape), dC.float().reshape(Cc.shape), dD)


@pytest.mark.parametrize("variant,chunk", [("k8_k9", 256), ("k8_k9", 64), ("k6_k7_seeded", 256)])
def test_bf16_kernel_arithmetic_meets_the_card_tolerances(variant, chunk):
    """The kernels' split at bf16 (``tests/ssd_emulation.chunked_bf16``: the
    bf16 products where ``_make_fwd_kernel(_xbc)`` and ``_bwd_head`` round,
    3xTF32 where they stay fp32, dB and dC from the head sum of bf16(dG), the
    factors E and T_end after their products) against the plain versions at
    the SSD classifier's width, B=1, within chip_smoke.py's bf16 tolerances:
    a bf16 output within 2 ulps of the plain version's at a floor of 2e-2 of
    its max, an fp32 output within 1e-3 of its max. K8/K9 with the D terms;
    K6/K7 at the tensor-parallel shard's 3 heads, seeded with a dh_fin."""
    heads, D_on, seeded = (6, True, False) if variant == "k8_k9" else (3, False, True)
    x, Bc, Cc, dy, dt, S, D = _bf16_case(chunk, heads)
    D = D if D_on else None
    dh_fin = (0.1 * torch.randn(1, heads, 128, 128, generator=torch.Generator().manual_seed(3))
              if seeded else None)
    got = emu.chunked_bf16(x, Bc, Cc, dt, S, dy, D=D, dh_fin=dh_fin)
    want = _plain_bf16(x, Bc, Cc, dy, dt, S, D, dh_fin)
    named = [("y", got[0], want[0], True), ("h_in", got[1], want[1], False)]
    if not D_on:
        named.append(("h_fin", got[2], want[2], False))
    names = ("dx", "ddt", "dS", "dB", "dC", "dD")
    named += [(k, g, w, k in ("dx", "dB", "dC")) for k, g, w in zip(names, got[3], want[3])
              if w is not None]
    errors = {}
    for name, g, w, rounded in named:
        assert g.shape == w.shape, name
        errors[name] = _ulps(g, w, floor=2e-2) if rounded else _rel(g, w)
    print(f"{variant} at chunk {chunk}: " + ", ".join(f"{k} {v:.3g}" for k, v in errors.items()))
    for name, _, _, rounded in named:
        assert errors[name] <= (2 if rounded else 1e-3), (name, errors[name])


# ---------------------------------------------------------------------------
# the chunked core and the mixer at bf16
# ---------------------------------------------------------------------------

def test_ssd_chunked_bf16_matches_jax():
    """``ssd_chunked`` on bf16 x, B, C against JAX's, with the carry: y (bf16)
    within 2e-2 of its max (both round xdt, its decayed copy, GM and h_in,
    then y before the D skip, but torch's and XLA's bf16 products of x and dt
    round separately), the total decay equal and h_fin (fp32) within 1e-2."""
    rng = np.random.default_rng(30)
    b, l, h, p, n, chunk = 2, 96, 2, 16, 8, 32
    x, Bm, Cm = (rng.standard_normal(s).astype(np.float32) for s in
                 ((b, l, h, p), (b, l, n), (b, l, n)))
    dt = np.log1p(np.exp(rng.standard_normal((b, l, h)))).astype(np.float32)
    A, D = (-np.exp(rng.standard_normal(h))).astype(np.float32), rng.standard_normal(h)
    (tx, jx), (tB, jB), (tC, jC) = _bf16(x), _bf16(Bm), _bf16(Cm)
    want = jssd.ssd_chunked(jx, jnp.asarray(dt), jnp.asarray(A), jB, jC,
                            jnp.asarray(D, jnp.float32), chunk=chunk, return_carry=True)
    got = tssd.ssd_chunked(tx, *_t(dt, A), tB, tC, torch.tensor(D, dtype=torch.float32),
                           chunk=chunk, return_carry=True)
    assert got[0].dtype == BF and want[0].dtype == JBF
    assert _rel(got[0], want[0]) <= 2e-2
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-6)
    assert got[2].dtype == torch.float32 and _rel(got[2], want[2]) <= 1e-2


def _mixer_params(d_model=64, n_heads=2, d_state=16, seed=3):
    rng = np.random.default_rng(seed)
    di = 2 * d_model
    conv = di + 2 * d_state
    mk = lambda *s, sc=0.3: (rng.standard_normal(s) * sc).astype(np.float32)  # noqa: E731
    return {"in_proj_w": mk(d_model, 2 * di + 2 * d_state + n_heads, sc=0.15),
            "conv_w": mk(conv, 4), "conv_b": mk(conv, sc=0.1), "dt_bias": mk(n_heads),
            "A_log": mk(n_heads), "D": mk(n_heads), "norm_scale": 1.0 + mk(di, sc=0.1),
            "out_proj_w": mk(di, d_model, sc=0.1)}


def _jax_ssd_mixer_kernel_route(p, u, n_heads, d_state, chunk):
    """``ssd_mixer_apply``'s route on the TPU at bf16, both kernels in
    interpret mode: the Pallas conv on the fp32 conv weights, the
    boundary-fused SSD kernel, every matmul weight cast to bf16."""
    cdt = u.dtype
    l = u.shape[1]
    zxbcdt = u @ p["in_proj_w"].astype(cdt)
    d_inner = (zxbcdt.shape[-1] - 2 * d_state - n_heads) // 2
    z, xbc, dt_raw = jnp.split(zxbcdt, [d_inner, 2 * d_inner + 2 * d_state], axis=-1)
    xbc = causal_conv1d_silu_pallas(xbc, p["conv_w"], p["conv_b"], interpret=True)
    dt = jax.nn.softplus(dt_raw.astype(jnp.float32) + p["dt_bias"])
    pad = ((0, 0), (0, (-l) % chunk), (0, 0))
    y = jk.ssd_chunked_pallas_xbc(jnp.pad(xbc, pad), jnp.pad(dt, pad), -jnp.exp(p["A_log"]),
                                  p["D"], d_inner=d_inner, chunk=chunk, interpret=True)[:, :l]
    y = y.astype(jnp.float32) * jax.nn.silu(z.astype(jnp.float32))
    y = y * jax.lax.rsqrt(jnp.mean(jnp.square(y), axis=-1, keepdims=True) + 1e-5)
    return (y * p["norm_scale"]).astype(cdt) @ p["out_proj_w"].astype(cdt)


_XLA_CONV = jss.causal_conv1d


def _conv_accumulating_in_fp32(x, weight, bias=None, activation="silu"):
    """JAX's XLA conv with its sum taken in fp32 and rounded once to x's
    dtype, as the port's plain conv takes it."""
    return _XLA_CONV(x.astype(jnp.float32), weight.astype(jnp.float32),
                     bias.astype(jnp.float32), activation).astype(x.dtype)


@pytest.mark.parametrize("impl", ["xla", "ssd_fused"])
def test_ssd_mixer_bf16_matches_jax(impl, monkeypatch):
    """bf16 in, bf16 out, at L = 100 padded to a chunk multiple. 'ssd_fused'
    against JAX's TPU route (the Pallas conv on the fp32 weights, the fused
    SSD kernel) within 4e-3 of the max (two bf16 ulps at the max: the output
    is a bf16 rounding of sums taken in other orders). 'xla' against JAX's XLA
    route (the plain conv on bf16-cast weights, ``ssd_chunked``) within 3e-2
    of the max: JAX's XLA conv rounds to bf16 after every shifted product and
    add, the port's plain conv sums in fp32 and rounds once; with that one
    difference taken out (JAX's conv summing in fp32) within 4e-3. Gradients
    of both routes run, fp32 for every parameter."""
    p = _mixer_params()
    u = np.random.default_rng(4).standard_normal((2, 100, 64)).astype(np.float32)
    tu, ju = _bf16(u)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    kw = dict(n_heads=2, d_state=16, chunk=32)
    leaves = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
    got = tssd.ssd_mixer_apply(leaves, tu, impl=impl, **kw)
    assert got.dtype == BF
    if impl == "xla":
        want = jssd.ssd_mixer_apply(jp, ju, impl="xla", **kw)
        assert want.dtype == JBF and _rel(got, want) <= 3e-2, _rel(got, want)
        monkeypatch.setattr(jss, "causal_conv1d", _conv_accumulating_in_fp32)
        want = jssd.ssd_mixer_apply(jp, ju, impl="xla", **kw)
    else:
        want = _jax_ssd_mixer_kernel_route(jp, ju, 2, 16, 32)
    assert want.dtype == JBF and _rel(got, want) <= 4e-3, _rel(got, want)
    got.float().square().sum().backward()
    for k, v in leaves.items():
        assert v.grad.dtype == torch.float32 and torch.isfinite(v.grad).all(), k


@pytest.mark.parametrize("l", [100, 256])
def test_ssd_mixer_bf16_gradients_match_jax(l):
    """Every parameter gradient of the bf16 mixer on the presets' route
    ('ssd_fused': K1 on the fp32 conv weights, K8/K9, plain on the CPU)
    against JAX's TPU route (the Pallas conv and the boundary-fused SSD
    kernel in interpret mode) for the loss sum(y r): the per-head scalars
    (dt_bias, A_log, D) and the other vectors within 1e-3 of the leaf's max, the two
    projection matrices within 3e-3. Both frameworks round at the same points
    here, so the port lies within 5.1e-4 (vectors) and 2.2e-3 (matrices) of
    JAX's bf16 gradient, while JAX's own fp32 gradient lies 4.9e-3 to 3.6e-2
    from it: the controls assert that JAX's fp32 gradient and a zero gradient
    both fail each leaf's bound."""
    p = _mixer_params()
    rng = np.random.default_rng(4)
    u = rng.standard_normal((2, l, 64)).astype(np.float32)
    r = rng.standard_normal((2, l, 64)).astype(np.float32)
    tu, ju = _bf16(u)
    leaves = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
    got = tssd.ssd_mixer_apply(leaves, tu, impl="ssd_fused", n_heads=2, d_state=16, chunk=32)
    (got.float() * torch.from_numpy(r)).sum().backward()

    def loss(params, x):
        y = _jax_ssd_mixer_kernel_route(params, x, 2, 16, 32)
        return jnp.sum(y.astype(jnp.float32) * r)

    jp = {k: jnp.asarray(v) for k, v in p.items()}
    want, want32 = (jax.grad(loss)(jp, x) for x in (ju, ju.astype(jnp.float32)))
    for k, v in leaves.items():
        w = np.asarray(want[k])
        tol = (3e-3 if k.endswith("proj_w") else 1e-3) * np.abs(w).max()
        assert v.grad.dtype == torch.float32, k
        assert np.abs(v.grad.numpy() - w).max() <= tol, (k, np.abs(v.grad.numpy() - w).max(), tol)
        assert np.abs(np.asarray(want32[k]) - w).max() > tol, k  # fp32 precision fails
        assert np.abs(w).max() > tol, k  # so does a zero gradient


# ---------------------------------------------------------------------------
# the SSD classifier at the presets' settings
# ---------------------------------------------------------------------------

def _models(seed=0, **over):
    jcfg = JConfig(**{**SSD_PERF, **over})
    jmodel = JPointMamba(jcfg)
    variables = jax.jit(lambda key: jmodel.init(key, jnp.zeros((2, 128, 3)), train=False))(
        jax.random.key(seed))
    model = PointMamba(PointMambaConfig(**{**SSD_PERF, "scan_impl": "ssd_fused", **over}))
    model.load_state_dict(state_dict_from_jax(variables["params"], variables["batch_stats"]),
                          strict=True)
    return jcfg, jmodel, variables, model


@pytest.mark.parametrize("impl", ["ssd_fused", "xla"])
def test_ssd_pointmamba_bf16_logits_match_jax(impl, monkeypatch):
    """The bf16 SSD classifier with the subspace solver: eval logits (bf16) and
    pooled features within 3e-2 of the max of JAX's (its 'ssd_fused' route,
    interpret mode off the TPU: the XLA route), on clouds whose bf16-rounded
    eigenvectors sort alike in both frameworks (asserted)."""
    jcfg, jmodel, variables, model = _models(scan_impl=impl)
    pts = _clouds(4, 128, seed=2)
    want, want_feat = jax.jit(lambda v, x: jmodel.apply(v, x, train=False,
                                                        return_features=True))(
        variables, jnp.asarray(pts))
    _aligned_eigvecs(monkeypatch, jcfg, pts)
    with torch.no_grad():
        got, feat = model.eval()(torch.from_numpy(pts), return_features=True)
    assert got.dtype == BF and want.dtype == JBF
    assert _rel(got, want) <= 3e-2, _rel(got, want)
    assert _rel(feat, want_feat) <= 3e-2, _rel(feat, want_feat)


# The SSD mixers' per-head scalars: each one's gradient is a sum over every
# token of terms that cancel, so at bf16 it is mostly rounding noise at the
# model level: JAX's own bf16 gradient of them lies 0.05x to 20x its fp32 one
# at this size. test_ssd_mixer_bf16_gradients_match_jax holds them at the
# mixer, where that noise is small.
PER_HEAD = ("mixer.dt_bias", "mixer.A_log", "mixer.D")


def _jax_kernel_route(params, x, n_heads, d_state, chunk, impl):
    """JAX's ``ssd_mixer_apply`` as it runs the presets' 'ssd_fused' route on
    the TPU, its kernels in interpret mode."""
    return _jax_ssd_mixer_kernel_route(params, x, n_heads, d_state, chunk)


def _jax_grads(jmodel, variables, pts, labels, dtype):
    """JAX's train-mode loss, updated BatchNorm statistics and gradients at
    ``dtype`` for the same parameters."""
    model = JPointMamba(JConfig(**{**SSD_PERF, "dtype": dtype}))

    def loss_fn(params):
        logits, upd = model.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                  jnp.asarray(pts), train=True, mutable=["batch_stats"])
        per, _ = j_ce(logits, jnp.asarray(labels, jnp.int32))
        return jnp.mean(per), upd["batch_stats"]

    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])


def _leaf_agrees(g, w, floor) -> bool:
    """A gradient leaf g against JAX's bf16 one w: a cosine of at least 0.95
    (or, for a leaf whose fp32 gradient lies at a cosine ``floor`` < 0.9 to
    JAX's bf16 one, mostly noise, at least floor - 0.02) and a norm within
    20 %."""
    cos = g @ w / (np.linalg.norm(g) * np.linalg.norm(w))
    least = 0.95 if floor >= 0.9 else floor - 0.02
    return cos >= least and 0.8 <= np.linalg.norm(g) / np.linalg.norm(w) <= 1.25


def test_ssd_train_step_bf16_matches_jax(monkeypatch):
    """One train-mode forward and backward of the bf16 SSD classifier through
    the K8/K9 route (plain on the CPU), drop rates 0, against JAX's model on
    the route it takes on the TPU (the Pallas conv and SSD kernels in
    interpret mode): the loss within 1e-2 relative of JAX's; every parameter
    gradient fp32 and, but for the leaves whose exact gradient is 0 and the
    mixers' per-head scalars, held by ``_leaf_agrees`` (the tolerance of
    tests/test_torch_port_perf.py's Mamba-1 step, for the same reasons; the
    final LayerNorm's bias is the one leaf whose fp32 gradient lies below a
    cosine of 0.9, at 0.87). Control: JAX's fp32 gradients fail that check on
    at least one leaf (on 12 of them: they lie at cosines 0.930 to 0.950), so a
    port that took its backward at fp32 fails too.
    Each per-head scalar only within twice the distance between JAX's bf16 and
    fp32 gradients of it, plus 1e-4 of the largest gradient: a coarse bound
    (it exceeds the value itself in layer 0), their precision is held at the
    mixer. The BatchNorm statistics moved alike."""
    jcfg, jmodel, variables, model = _models(seed=1)
    pts = _clouds(8, 128, seed=3)
    labels = np.random.default_rng(3).integers(0, SSD_PERF["cls_dim"], 8)
    with monkeypatch.context() as m:
        m.setattr(jssd, "ssd_mixer_apply", _jax_kernel_route)
        (jloss, jstats), jgrads = _jax_grads(jmodel, variables, pts, labels, "bfloat16")
        _, jgrads32 = _jax_grads(jmodel, variables, pts, labels, "float32")
    want, want32 = (state_dict_from_jax(g, jstats) for g in (jgrads, jgrads32))
    _aligned_eigvecs(monkeypatch, jcfg, pts)
    per, _ = port_pm.cross_entropy_loss_acc(model.train()(torch.from_numpy(pts)),
                                            torch.from_numpy(labels))
    loss = per.mean()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-2)
    gmax = max(float(np.abs(np.asarray(want[k])).max()) for k, _ in model.named_parameters())
    fp32_fails = []
    for k, p in model.named_parameters():
        assert p.grad.dtype == torch.float32, k
        if k in ZERO_GRADIENT:
            continue
        g, w, w32 = (np.asarray(t, np.float64).ravel() for t in (p.grad.numpy(), want[k],
                                                                 want32[k]))
        if k.endswith(PER_HEAD):
            bound = 2 * np.abs(w - w32) + 1e-4 * gmax
            assert np.all(np.abs(g - w) <= bound), (k, g, w, bound)
            continue
        floor = w32 @ w / (np.linalg.norm(w32) * np.linalg.norm(w))
        assert _leaf_agrees(g, w, floor), k
        if not _leaf_agrees(w32, w, floor):
            fp32_fails.append(k)
    assert fp32_fails, "the check cannot tell JAX's fp32 gradients from its bf16 ones"
    for k, v in model.state_dict().items():
        if "running" in k:
            w = np.asarray(want[k])
            assert float(np.abs(v.numpy() - w).max()) <= 1e-2 * max(np.abs(w).max(), 1e-6), k


def test_perf_predictor_on_an_ssd_checkpoint_matches_jax(monkeypatch):
    """``Predictor.from_checkpoint(state dict, SSD model_cfg, perf=True)``: the
    weights carried over unchanged (every parameter fp32, equal to the state
    dict's), bf16 and subspace set, and its fp32 logits within 3e-2 of the
    max of JAX's perf-mode logits for the same weights and clouds."""
    jcfg, jmodel, variables, _ = _models(seed=4)
    sd = {k: v.numpy() for k, v in state_dict_from_jax(variables["params"],
                                                       variables["batch_stats"]).items()}
    cfg = {k: v for k, v in SSD_PERF.items() if k not in ("dtype", "spectral_method")}
    p = Predictor.from_checkpoint(sd, model_cfg={**cfg, "scan_impl": "ssd_fused"}, npoints=128,
                                  max_batch=4, perf=True, device="cpu")
    assert (p.model.config.dtype, p.model.config.spectral_method) == ("bfloat16", "subspace")
    for k, v in p.model.state_dict().items():
        assert v.dtype == torch.as_tensor(sd[k]).dtype, k
        assert torch.equal(v, torch.as_tensor(sd[k])), k
    pts = _clouds(4, 128, seed=6)
    _aligned_eigvecs(monkeypatch, jcfg, pts)
    got = p.logits(pts)
    want = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(variables, jnp.asarray(pts))
    assert got.dtype == np.float32
    assert _rel(got, want) <= 3e-2, _rel(got, want)


@pytest.mark.parametrize("override,match", [
    (dict(scan_impl="fused"), "K10/K11"), (dict(scan_impl="fused_interpret"), "K10/K11"),
    (dict(mixer="mamba", tp_axis="model"), "promotes bf16")])
def test_refused_at_bf16(override, match):
    """The options that raised at bf16 until the whole-mixer kernels K10/K11
    had bf16 variants and the tensor-parallel Mamba-1 mixer (which promotes
    bf16 to fp32 at its uncast weights, as JAX's) was ported now do what the
    JAX model does with them (``match`` names what was refused): the SSD
    mixer with scan_impl 'fused' or 'fused_interpret' builds and runs its
    'xla' route (JAX's SSD mixer has no 'fused' route), giving the 'xla'
    model's logits; the Mamba-1 mixer with tp_axis passes the check and then
    asks for a mesh, as the SSD mixer with tp_axis does."""
    cfg = PointMambaConfig(**{**SSD_PERF, **override})
    if cfg.tp_axis is not None:
        with pytest.raises(ValueError, match="needs a mesh"):
            PointMamba(cfg)
        with pytest.raises(ValueError, match="needs a mesh"):
            PointMamba(PointMambaConfig(**{**SSD_PERF, "tp_axis": "model"}))
        return
    model = PointMamba(cfg).eval()
    assert all(layer.mixer.impl == "xla" for layer in model.blocks.layers), match
    xla = PointMamba(PointMambaConfig(**{**SSD_PERF, "scan_impl": "xla"})).eval()
    xla.load_state_dict(model.state_dict())
    pts = torch.from_numpy(_clouds(2, 128, seed=7))
    with torch.no_grad():
        got = model(pts)
        assert got.dtype == BF and torch.equal(got, xla(pts))


# ---------------------------------------------------------------------------
# the presets through the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("preset", ["finetune_modelnet_ssd.yaml",
                                    "finetune_modelnet_ssd_fused.yaml"])
def test_ssd_preset_config_matches_jax(preset):
    """Each SSD preset gives the port the JAX package's model config (the
    published width, bf16, subspace, the SSD mixer; the fused one with
    scan_impl 'ssd_fused' and chunk 256), and that model builds at bf16."""
    cfg = PointMambaConfig.from_dict(get_config(str(ROOT / "cfgs" / preset)).model)
    jcfg = JConfig.from_dict(j_get_config(str(ROOT / "cfgs" / preset)).model)
    assert cfg.__dict__ == jcfg.__dict__
    assert (cfg.dtype, cfg.spectral_method, cfg.mixer, cfg.trans_dim, cfg.depth) == (
        "bfloat16", "subspace", "ssd", 384, 12)
    if preset.endswith("fused.yaml"):
        assert (cfg.scan_impl, cfg.ssd_chunk) == ("ssd_fused", 256)
    assert PointMamba(cfg).dtype == BF


@pytest.mark.parametrize("preset,impl", [("finetune_modelnet_ssd_fused.yaml", "ssd_fused"),
                                         ("finetune_modelnet_ssd.yaml", "auto")])
def test_cli_trains_the_ssd_presets_on_the_cpu(modelnet_tree, tmp_path, monkeypatch,  # noqa: F811
                                               preset, impl):
    """The CLI on a config whose base is an SSD preset (narrowed to the small
    model, the fused preset's chunk to 64): one epoch of two steps at bf16
    with the subspace solver on the preset's SSD route, a finite epoch loss,
    fp32 parameters, ``--test`` of ckpt-last.pth equal to the last
    validation."""
    monkeypatch.chdir(tmp_path)
    cfg = tmp_path / "tiny_ssd.yaml"
    body = {k: v for k, v in SSD_PERF.items() if k not in ("dtype", "spectral_method", "mixer")}
    body["cls_dim"] = 5
    cfg.write_text(
        f"_base_: {ROOT}/cfgs/{preset}\n"
        "dataset:\n" + "".join(
            f"  {s}: {{_base_: {modelnet_tree}/modelnet.yaml, others: {{subset: '{sub}'}}}}\n"
            for s, sub in (("train", "train"), ("val", "test"), ("test", "test"))) +
        "model: {" + ", ".join(f"{k}: {v}" for k, v in body.items()) + "}\n"
        "scheduler: {type: CosLR, kwargs: {epochs: 3, initial_epochs: 0}}\n"
        "total_bs: 8\nmax_epoch: 0\n")
    args = ["--config", str(cfg), "--device", "cpu", "--num_workers", "2"]
    state, _ = cli.main(args)
    c = state.model.config
    assert (c.dtype, c.spectral_method, c.mixer, c.scan_impl) == (
        "bfloat16", "subspace", "ssd", impl)
    assert state.step == 2
    exp = tmp_path / "experiments" / "tiny_ssd" / "default"
    losses = [r["value"] for r in _scalars(exp) if r["tag"] == "Loss/Epoch/Loss"]
    assert len(losses) == 1 and np.isfinite(losses).all()
    for p in state.model.parameters():
        assert p.dtype == torch.float32
    last_acc = [r["value"] for r in _scalars(exp) if r["tag"] == "Metric/ACC"][-1]
    acc = cli.main(args + ["--test", "--ckpts", str(exp / "ckpt-last.pth"), "--exp_name", "t"])
    assert acc == last_acc
