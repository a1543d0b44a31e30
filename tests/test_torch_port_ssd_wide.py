"""The SSD core and mixer at the d_state and head_dim beyond 128 that the JAX
kernels compile for (positive multiples of 128), against the JAX package on
the CPU: the plain versions of K8/K9 and K6/K7, which hold the wide CUDA
kernels on the card (tests/test_torch_port_cuda.py, chip_smoke.py phase 57),
against the Pallas kernels in interpret mode and ``jax.vjp`` of them; the
``SSDMixer`` at d_state = head_dim = 256 with weights carried over by
``utils/weights.py``; the routing predicate and the backward's scratch at
those shapes. Inputs are made with numpy from a seed and handed to both
frameworks.

Geometries (d_state, head_dim): (256, 256), (256, 128), (128, 256) and
(384, 128), at chunks 32 and 64. Tolerances: fp32 within 1e-5 of each
output's max (dA and the mixer's per-head scalars, sums over every step,
within 5e-5: ``DA_TOL``); bf16 as tests/test_torch_port_ssd_bf16.py holds the
plain versions (bf16 outputs within one bf16 ulp at a floor of 1e-2 of the max,
fp32 outputs within 1e-5 of their max).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from si_mamba_tpu.models.layers import SSDMixer as JSSDMixer
from si_mamba_tpu.ops import ssd as jssd
from si_mamba_tpu.ops.pallas import ssd_kernel as jk
from si_mamba_tpu_torch.models.layers import SSDMixer
from si_mamba_tpu_torch.ops import ssd as tssd
from si_mamba_tpu_torch.ops.kernels import ssd as kssd
from si_mamba_tpu_torch.utils import weights

from tests.test_torch_port_perf import _bf16, _rel, _ulps

BF = torch.bfloat16
GEOMETRIES = [(256, 256), (256, 128), (128, 256), (384, 128)]
IDS = [f"n{n}_p{p}" for n, p in GEOMETRIES]
# dA is one sum of dS dt over every step: at (256, 128), chunk 32, each
# framework's fp32 dA lies 4e-6 and 7e-6 of its max from the float64 value, on
# opposite sides, so it is held at the gradient tolerance of
# tests/test_torch_port_ssd.py (atol 5e-5) relative to its max
DA_TOL = 5e-5


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """The tensors here are small, and the suite runs one worker a core: more
    than one intra-op thread a worker only contends for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _heads(p: int) -> int:
    return 2 if p == 128 else 1  # two heads where they are narrow: the head sums


def _case(n, p, l, seed):
    """xbc (1, l, h p + 2n), dt (1, l, h) post-softplus, A (h,) < 0, D (h,),
    the cotangents of y, the total decay and h_fin; all float32 numpy."""
    h = _heads(p)
    rng = np.random.default_rng(seed)
    xbc = (rng.standard_normal((1, l, h * p + 2 * n)) * 0.5).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((1, l, h)) - 1.0)).astype(np.float32)
    A = (-np.exp(rng.standard_normal(h))).astype(np.float32)
    D = rng.standard_normal(h).astype(np.float32)
    gy = rng.standard_normal((1, l, h * p)).astype(np.float32)
    gd = rng.standard_normal((1, h)).astype(np.float32)
    gh = (rng.standard_normal((1, h, n, p)) * 0.1).astype(np.float32)
    return h, xbc, dt, A, D, gy, gd, gh


def _close(got, want, name, tol=1e-5):
    want = np.asarray(want, dtype=np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, (name, err)


@pytest.mark.parametrize("form", ["xbc", "split"])
@pytest.mark.parametrize("chunk,carry", [(32, True), (64, False)], ids=["q32_carry", "q64"])
@pytest.mark.parametrize("n,p", GEOMETRIES, ids=IDS)
def test_chunked_core_matches_pallas_interpret(n, p, chunk, carry, form):
    """``ssd_chunked_xbc`` (K8/K9's plain versions) or ``ssd_chunked_split``
    (K6/K7's) against ``ssd_chunked_pallas_xbc`` / ``ssd_chunked_pallas``
    in interpret mode: y, and with ``return_carry`` the total decay and
    h_fin, then the gradients of every input by ``jax.vjp``, at fp32."""
    l = 128
    h, xbc, dt, A, D, gy, gd, gh = _case(n, p, l, seed=n + p + chunk)
    d = h * p

    def jfn(xbc_, dt_, A_, D_):
        if form == "xbc":
            return jk.ssd_chunked_pallas_xbc(xbc_, dt_, A_, D_, d_inner=d, chunk=chunk,
                                             return_carry=carry, interpret=True)
        x_ = xbc_[..., :d].reshape(1, l, h, p)
        out = jk.ssd_chunked_pallas(x_, dt_, A_, xbc_[..., d:d + n], xbc_[..., d + n:], D_,
                                    chunk=chunk, return_carry=carry, interpret=True)
        return (out[0].reshape(1, l, d), *out[1:]) if carry else out.reshape(1, l, d)

    leaves = [torch.from_numpy(a).requires_grad_() for a in (xbc, dt, A, D)]
    if form == "xbc":
        got = kssd.ssd_chunked_xbc(*leaves, d_inner=d, chunk=chunk, return_carry=carry)
    else:
        t_xbc = leaves[0]
        out = kssd.ssd_chunked_split(t_xbc[..., :d].reshape(1, l, h, p), leaves[1], leaves[2],
                                     t_xbc[..., d:d + n], t_xbc[..., d + n:], leaves[3],
                                     chunk=chunk, return_carry=carry)
        got = (out[0].reshape(1, l, d), *out[1:]) if carry else out.reshape(1, l, d)
    want, vjp = jax.vjp(jfn, *(jnp.asarray(a) for a in (xbc, dt, A, D)))
    cts = (gy, gd, gh) if carry else (gy,)
    got, want = (got, want) if carry else ((got,), (want,))
    for name, g, w in zip(("y", "total_decay", "h_fin"), got, want):
        _close(g, w, name)
    torch.autograd.backward(got, [torch.from_numpy(c) for c in cts])
    for name, leaf, w in zip(("dxbc", "ddt", "dA", "dD"), leaves,
                             vjp(tuple(jnp.asarray(c) for c in cts) if carry
                                 else jnp.asarray(gy))):
        _close(leaf.grad, w, name, tol=DA_TOL if name == "dA" else 1e-5)


@pytest.mark.parametrize("seeded", [False, True], ids=["from_zero", "seeded"])
@pytest.mark.parametrize("n,p", GEOMETRIES, ids=IDS)
def test_plain_kernels_bf16_match_pallas_interpret(n, p, seeded):
    """At bf16, every output of K8/K9's plain versions against
    ``_fwd_call_xbc`` / ``_bwd_call_xbc`` in interpret mode, and of K6/K7's
    against ``_fwd_call`` / ``_split_bwd``, the backward from 0 or seeded
    with a dh_fin: bf16 outputs within one bf16 ulp, fp32 ones within 1e-5
    of their max."""
    chunk, l = 32, 64
    h, xbc, dt, A, D, gy, _, gh = _case(n, p, l, seed=2 * n + p + seeded)
    d, b = h * p, 1
    dth = jnp.asarray(dt).transpose(0, 2, 1).reshape(b, h, l // chunk, chunk)
    S = jnp.cumsum(dth * jnp.asarray(A)[None, :, None, None], axis=-1)
    txbc, jxbc = _bf16(xbc)
    tdy, jdy = _bf16(gy)
    tdth, tS, tD = (torch.from_numpy(np.array(a)) for a in (dth, S, D))
    jD = jnp.asarray(D)
    seed_t, seed_j = (torch.from_numpy(gh), jnp.asarray(gh)) if seeded else (None, None)

    def hold(names, got, want):
        for name, g, w in zip(names, got, want):
            w = jnp.reshape(w, g.shape)
            if g.dtype == BF:
                assert _ulps(g, w) <= 1, name
            else:
                assert g.dtype == torch.float32 and _rel(g, w) <= 1e-5, name

    SD = jk._stack_sdd(S, dth, jD)
    y_j, hin_j, hf_j = jk._fwd_call_xbc(SD, jxbc, d, True, emit_states=True, emit_hfin=True)
    y, h_in, h_fin = kssd.ssd_xbc_fwd_ref(txbc, tdth, tS, tD, d, chunk, emit_states=True,
                                          emit_hfin=True)
    hold(("y", "h_in", "h_fin"), (y, h_in, h_fin), (y_j, hin_j, hf_j))
    got = kssd.ssd_xbc_bwd_ref(txbc, tdth, tS, tD, h_in, tdy, d, chunk, dh_fin=seed_t)
    want = jk._xbc_bwd((SD, jxbc, hin_j), jdy, d, True, dh_fin=seed_j)
    hold(("dxbc", "ddt", "dS", "dD"), got, want)

    x, Bm, Cm = txbc[..., :d], txbc[..., d:d + n], txbc[..., d + n:]
    jx = jxbc[..., :d]
    jB, jC = (t.reshape(b, l // chunk, chunk, n) for t in (jxbc[..., d:d + n],
                                                          jxbc[..., d + n:]))
    SD2 = jk._stack_sd(S, dth)
    y_j, hin_j, hf_j = jk._fwd_call(SD2, jx, jB, jC, True, emit_states=True, emit_hfin=True)
    y, h_in, h_fin = kssd.ssd_split_fwd_ref(x, tdth, tS, Bm, Cm, chunk, emit_states=True,
                                            emit_hfin=True)
    hold(("split y", "split h_in", "split h_fin"), (y, h_in, h_fin), (y_j, hin_j, hf_j))
    want = jk._split_bwd((SD2, jx, jB, jC, hin_j), jdy, True, dh_fin=seed_j)
    got = kssd.ssd_split_bwd_ref(x, tdth, tS, Bm, Cm, h_in, tdy, chunk, dh_fin=seed_t)
    hold(("dx", "split ddt", "split dS", "dB", "dC"), got, want)


def test_ssd_mixer_at_state_and_head_256_matches_jax(monkeypatch):
    """The port's ``SSDMixer(d_model 128, d_state 256, head_dim 256)`` (one
    head of 256), its weights from JAX's by ``utils/weights.py``, against
    JAX's ``SSDMixer`` with ``scan_impl='ssd_fused'`` and the kernel in
    interpret mode: the output within 1e-5 of its max, the gradients of the
    input and of every parameter within 1e-5 of their max (the per-head
    scalars A_log, D and dt_bias, each a sum over every step, within
    ``DA_TOL``)."""
    orig = jssd.ssd_mixer_apply
    monkeypatch.setattr(jssd, "ssd_mixer_apply",
                        lambda *a, **k: orig(*a, **k, _interpret=True))
    kw = dict(d_state=256, head_dim=256, chunk=32)
    jm = JSSDMixer(d_model=128, scan_impl="ssd_fused", **kw)
    rng = np.random.default_rng(7)
    u = rng.standard_normal((2, 64, 128)).astype(np.float32)
    g = rng.standard_normal((2, 64, 128)).astype(np.float32)
    variables = jm.init(jax.random.key(1), jnp.asarray(u))
    sd = {}
    weights._ssd_mixer(sd, "m", variables["params"])
    mixer = SSDMixer(128, scan_impl="ssd_fused", **kw)
    mixer.load_state_dict({k[2:]: v for k, v in sd.items()}, strict=True)
    assert (mixer.n_heads, mixer.head_dim, mixer.d_state) == (1, 256, 256)

    def loss(params, x):
        return jnp.sum(jm.apply({"params": params}, x) * jnp.asarray(g))

    want_y = jm.apply(variables, jnp.asarray(u))
    want_gp, want_gu = jax.grad(loss, argnums=(0, 1))(variables["params"], jnp.asarray(u))
    x = torch.from_numpy(u).requires_grad_()
    y = mixer(x)
    _close(y, want_y, "y")
    (y * torch.from_numpy(g)).sum().backward()
    _close(x.grad, want_gu, "du")
    gsd = {}
    weights._ssd_mixer(gsd, "m", want_gp)
    for k, p in mixer.named_parameters():
        _close(p.grad, gsd["m." + k], k, tol=DA_TOL if k in ("A_log", "D", "dt_bias") else 1e-5)


def test_routing_on_cuda_takes_every_multiple_of_128():
    """``ssd_fused_route`` on a "cuda" device admits d_state and head_dim of
    256 and 384 as JAX's ``ssd_fused_supported`` compiles them, and raises
    by name for 64 and 192 in either, which JAX's compiled kernel refuses;
    ``ssd_fused_engaged`` follows the same predicate."""
    for n, p in [(256, 256), (256, 128), (128, 256), (384, 384)]:
        assert jk.ssd_fused_supported(512, 256, n, p)
        assert tssd.ssd_fused_route("ssd_fused", 512, 256, n, p, "cuda")
        assert tssd.ssd_fused_engaged(500, chunk=256, d_state=n, head_dim=p, device="cuda")
    for n, p in [(64, 128), (192, 128), (128, 64), (128, 192)]:
        assert not jk.ssd_fused_supported(512, 256, n, p)
        with pytest.raises(ValueError, match=f"d_state {n}, head_dim {p}"):
            tssd.ssd_fused_route("ssd_fused", 512, 256, n, p, "cuda")
        assert not tssd.ssd_fused_engaged(512, chunk=256, d_state=n, head_dim=p, device="cuda")
    assert tssd.ssd_fused_route("ssd_fused", 512, 256, 64, 64, "cpu")  # the plain versions


@pytest.mark.parametrize("n,p", [(128, 128), *GEOMETRIES, (384, 384)])
def test_backward_scratch_is_the_carve_of_n_and_p(n, p):
    """``bwd_scratch_floats`` is the sum of the carve the C side makes at
    (b, l, h, chunk, n, p): G and dG, the dh carry, dlogM's row and column
    sums, dT and dE, and n p / 1024 partials of sum(dh (.) h_in) a chunk
    (16 at n = p = 128)."""
    b, l, h, chunk = 2, 512, 3, 128
    nc, pairs = l // chunk, (chunk // 64) * (chunk // 64 + 1) // 2
    parts = n * p // 1024
    carve = dict(G=b * nc * chunk * chunk, dG=b * nc * chunk * chunk, dh=b * nc * h * n * p,
                 rs=b * h * nc * pairs * 64, cs=b * h * nc * pairs * 64, dT=b * h * l,
                 dE=b * h * l, hsum=b * h * nc * parts)
    assert kssd.carry_parts(n, p) == parts
    assert kssd.bwd_scratch_floats(b, l, h, chunk, n, p) == sum(carve.values())
    assert kssd.carry_parts(128, 128) == 16
    assert kssd.kernel_variant(chunk, n, p) == ("" if (n, p) == (128, 128) else "_wide")
