"""K8/K9's carry entry points against the JAX package on the CPU:
``ssd_chunked_xbc(return_carry=True)`` (K8 with h_fin, and under a gradient
K8 with states and h_fin and the seeded K9, their plain versions here) against
``ssd_chunked_pallas_xbc(return_carry=True, interpret=True)``, at fp32 and
bf16: y, the total decay and h_fin, and the gradients through a loss that
consumes h_fin, so that the backward's dh carry starts at its cotangent
(tests/test_ssd_pallas.py:317). The CUDA entry points are held against these
plain versions on the card in tests/test_torch_port_cuda.py and
chip_smoke.py.

Tolerances: at fp32 those of tests/test_ssd_pallas.py:317 for the same
contract (values 2e-5, gradients 3e-4 relative to their max); at bf16 the
bf16 outputs within one bf16 ulp of JAX's (both round the same fp32 value
once, at the same product operands; the ulp taken at least at 1e-2 of the
max) and every fp32 output (h_fin, the gradients of dt and D) within 1e-5
of its max, as tests/test_torch_port_ssd_bf16.py holds the plain K8/K9; A's
gradient, a sum over every (b, t) of dS dt that autograd takes in another
order than JAX (its two entries 2.2 and -36.6 here), within 1e-4 of its max.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from si_mamba_tpu.ops.pallas.ssd_kernel import ssd_chunked_pallas_xbc
from si_mamba_tpu_torch.ops.kernels import ssd as kssd

from tests.test_torch_port_perf import _rel, _ulps

CASE = dict(b=2, l=128, h=2, p=16, n=8, chunk=32)  # four chunks
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _inputs(dtype: str, seed: int = 3):
    """xbc (b, l, h p + 2n) in ``dtype``, dt (b, l, h) post-softplus, A and D
    (h,), fp32: ((port), (JAX)), the same values on both sides."""
    c = CASE
    rng = np.random.default_rng(seed)
    xbc = rng.standard_normal((c["b"], c["l"], c["h"] * c["p"] + 2 * c["n"])).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((c["b"], c["l"], c["h"])))).astype(np.float32)
    A = (-np.exp(rng.standard_normal(c["h"]))).astype(np.float32)
    D = rng.standard_normal(c["h"]).astype(np.float32)
    tdt, jdt = DTYPES[dtype]
    port = (torch.from_numpy(xbc).to(tdt), *(torch.from_numpy(a) for a in (dt, A, D)))
    return port, (jnp.asarray(xbc).astype(jdt), *(jnp.asarray(a) for a in (dt, A, D)))


def _kw():
    return dict(d_inner=CASE["h"] * CASE["p"], chunk=CASE["chunk"])


def _loss(y, h_fin, sin, cos, f32):
    """A loss of y and of the carry, so that h_fin's cotangent is not 0."""
    return sin(f32(y)).sum() + cos(h_fin).sum()


def _hold(name, got, want, dtype, fp32_rel):
    assert tuple(got.shape) == tuple(want.shape), name
    if got.dtype == torch.bfloat16:
        assert want.dtype == jnp.bfloat16 and _ulps(got, want) <= 1, (name, _ulps(got, want))
    else:
        assert got.dtype == torch.float32, name
        assert _rel(got, want) <= fp32_rel, (name, _rel(got, want))


@pytest.mark.parametrize("dtype", DTYPES)
def test_return_carry_values_match_pallas_interpret(dtype):
    """Without a gradient (the lean K8 with h_fin): y in xbc's dtype, the
    total decay exp(sum of each chunk's last S) and h_fin (b, h, n, p) fp32
    against the Pallas xbc kernel in interpret mode; the same y as the
    variant without the carry."""
    (xbc, dt, A, D), jargs = _inputs(dtype)
    y_j, dec_j, hf_j = ssd_chunked_pallas_xbc(*jargs, **_kw(), return_carry=True,
                                              interpret=True)
    y, dec, hf = kssd.ssd_chunked_xbc(xbc, dt, A, D, **_kw(), return_carry=True)
    c = CASE
    assert hf.shape == (c["b"], c["h"], c["n"], c["p"]) and hf.dtype == torch.float32
    assert y.dtype == xbc.dtype and dec.dtype == torch.float32
    rel = 2e-5 if dtype == "float32" else 1e-5
    _hold("y", y, y_j, dtype, rel)
    _hold("h_fin", hf, hf_j, dtype, rel)
    assert _rel(dec, dec_j) <= 1e-6
    assert torch.equal(kssd.ssd_chunked_xbc(xbc, dt, A, D, **_kw()), y)


@pytest.mark.parametrize("dtype", DTYPES)
def test_return_carry_gradients_match_pallas_interpret(dtype):
    """Under a gradient (``SSDChunkedXbcCarryFn``: K8 with states and h_fin,
    then K9 seeded with h_fin's cotangent): y and h_fin as without one, and
    the gradients of xbc, dt, A and D through a loss of y and h_fin against
    ``jax.grad`` of the Pallas path (its custom VJP: ``_bwd_call_xbc`` with
    ``dh_fin``). Control: the gradients of the same loss without its h_fin
    term differ from these, so the seed is not 0."""
    port, jargs = _inputs(dtype, seed=4)
    f32 = lambda t: t.astype(jnp.float32)  # noqa: E731

    def j_loss(*a):
        y, _, hf = ssd_chunked_pallas_xbc(*a, **_kw(), return_carry=True, interpret=True)
        return _loss(y, hf, jnp.sin, jnp.cos, f32)

    want = jax.grad(j_loss, argnums=(0, 1, 2, 3))(*jargs)
    leaves = [t.clone().requires_grad_() for t in port]
    y, _, hf = kssd.ssd_chunked_xbc(*leaves, **_kw(), return_carry=True)
    assert isinstance(y.grad_fn, kssd.SSDChunkedXbcCarryFn._backward_cls)
    _loss(y, hf, torch.sin, torch.cos, lambda t: t.float()).backward()
    rel = 3e-4 if dtype == "float32" else 1e-5
    for name, t, w in zip(("xbc", "dt", "A", "D"), leaves, want):
        _hold(f"d{name}", t.grad, w, dtype, max(rel, 1e-4) if name == "A" else rel)
    unseeded = [t.detach().clone().requires_grad_() for t in port]
    torch.sin(kssd.ssd_chunked_xbc(*unseeded, **_kw()).float()).sum().backward()
    assert _rel(unseeded[0].grad, leaves[0].grad) > 10 * rel


def test_carry_wrappers_take_the_plain_versions_on_the_cpu():
    """On CPU tensors each carry wrapper is its plain version (it counts no
    launch); the variants with and without states give the same y and h_fin;
    a ``_bf16`` wrapper refuses fp32 xbc; the seeded backward seeded with 0
    is the unseeded one."""
    (xbc, dt, A, D), _ = _inputs("bfloat16", seed=5)
    c, kw = CASE, _kw()
    dth = dt.transpose(1, 2).reshape(c["b"], c["h"], -1, c["chunk"]).contiguous()
    S = torch.cumsum(dth * A[None, :, None, None], dim=-1)
    args = (xbc, dth, S, D, kw["d_inner"], kw["chunk"])
    before = {n: getattr(kssd, n).launches for n in (
        "ssd_xbc_fwd_hfin_bf16", "ssd_xbc_fwd_states_hfin_bf16", "ssd_xbc_bwd_seeded_bf16")}
    y, hf = kssd.ssd_xbc_fwd_hfin_bf16(*args)
    y2, h_in, hf2 = kssd.ssd_xbc_fwd_states_hfin_bf16(*args)
    assert torch.equal(y, y2) and torch.equal(hf, hf2)
    y_ref, h_ref, hf_ref = kssd.ssd_xbc_fwd_ref(*args, emit_states=True, emit_hfin=True)
    assert torch.equal(y, y_ref) and torch.equal(h_in, h_ref) and torch.equal(hf, hf_ref)
    dy = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (c["b"], c["l"], kw["d_inner"])).astype(np.float32)).to(torch.bfloat16)
    seeded = kssd.ssd_xbc_bwd_seeded_bf16(xbc, dth, S, D, h_in, dy, torch.zeros_like(hf),
                                          kw["d_inner"], kw["chunk"])
    for a, w in zip(seeded, kssd.ssd_xbc_bwd_bf16(xbc, dth, S, D, h_in, dy, kw["d_inner"],
                                                  kw["chunk"])):
        assert torch.equal(a, w)
    assert {n: getattr(kssd, n).launches for n in before} == before
    with pytest.raises(TypeError, match="bfloat16"):
        kssd.ssd_xbc_fwd_hfin_bf16(xbc.float(), *args[1:])


class _RecordingLib:
    """A stand-in for a built library: each entry point records its
    arguments and returns 0 (cudaSuccess)."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


@pytest.mark.parametrize("dtype", DTYPES)
def test_carry_entry_points_take_their_declared_arguments(dtype):
    """``run_fwd(hfin=True)`` and ``run_bwd(dh_fin=...)`` call
    ``ssd_xbc_fwd_hfin`` / ``ssd_xbc_bwd_seeded`` (``_bf16`` for bf16 xbc)
    with as many arguments as ``FWD_ENTRIES`` / ``BWD_ENTRIES`` declare for
    them, h_fin right after the states flag and dh_fin right after dy, as the
    C signatures in csrc/ssd_xbc_fwd.cu and csrc/ssd_xbc_bwd.cu take them;
    without the carry they call the plain entry points. At chunk 64 (a
    multiple of the kernels' 64-row strip) the operands reach the entry
    points as they are; at CASE's chunk 32 they reach them laid out in
    strips (``ssd._to_strips``): chunk 64, twice the rows."""
    (xbc, dt, A, D), _ = _inputs(dtype, seed=7)
    c, kw = CASE, dict(_kw(), chunk=64)
    dth = dt.transpose(1, 2).reshape(c["b"], c["h"], -1, kw["chunk"]).contiguous()
    S = torch.cumsum(dth * A[None, :, None, None], dim=-1)
    suffix = "_bf16" if dtype == "bfloat16" else ""
    lib = _RecordingLib()
    y, h_in, h_fin = kssd.run_fwd(lib, xbc, dth, S, D, kw["d_inner"], kw["chunk"], True, None,
                                  hfin=True)
    kssd.run_fwd(lib, xbc, dth, S, D, kw["d_inner"], kw["chunk"], False, None)
    dy = torch.zeros((c["b"], c["l"], kw["d_inner"]), dtype=xbc.dtype)
    dh_fin = torch.zeros_like(h_fin)
    kssd.run_bwd(lib, xbc, dth, S, D, h_in, dy, kw["d_inner"], kw["chunk"], None, dh_fin=dh_fin)
    kssd.run_bwd(lib, xbc, dth, S, D, h_in, dy, kw["d_inner"], kw["chunk"], None)
    names = [name for name, _ in lib.calls]
    assert names == [n + suffix for n in ("ssd_xbc_fwd_hfin", "ssd_xbc_fwd",
                                          "ssd_xbc_bwd_seeded", "ssd_xbc_bwd")]
    (_, fwd_hfin), (_, fwd), (_, bwd_seeded), (_, bwd) = lib.calls
    assert len(fwd_hfin) == len(kssd.FWD_ENTRIES["ssd_xbc_fwd_hfin"])
    assert len(fwd) == len(kssd.FWD_ENTRIES["ssd_xbc_fwd"])
    assert len(bwd_seeded) == len(kssd.BWD_ENTRIES["ssd_xbc_bwd_seeded"])
    assert len(bwd) == len(kssd.BWD_ENTRIES["ssd_xbc_bwd"])
    assert fwd_hfin[7] == 1 and fwd_hfin[8] == h_fin.data_ptr() and fwd_hfin[6] == h_in.numel()
    assert bwd_seeded[5] == dy.data_ptr() and bwd_seeded[6] == dh_fin.data_ptr()
    assert h_fin.shape == (c["b"], c["h"], c["n"], c["p"]) and h_fin.dtype == torch.float32
    dth = dt.transpose(1, 2).reshape(c["b"], c["h"], -1, c["chunk"]).contiguous()
    S = torch.cumsum(dth * A[None, :, None, None], dim=-1)
    strips = _RecordingLib()
    _, h_in, _ = kssd.run_fwd(strips, xbc, dth, S, D, kw["d_inner"], c["chunk"], True, None,
                              hfin=True)
    assert h_in.shape[1] == c["l"] // c["chunk"]  # a state a chunk, as without the strips
    kssd.run_bwd(strips, xbc, dth, S, D, h_in, dy, kw["d_inner"], c["chunk"], None,
                 dh_fin=dh_fin)
    (_, fwd_hfin), (_, bwd_seeded) = strips.calls
    assert (fwd_hfin[12], fwd_hfin[17]) == (2 * c["l"], 64)  # L, Q of the strips
    assert (bwd_seeded[15], bwd_seeded[20]) == (2 * c["l"], 64)
    assert bwd_seeded[6] == dh_fin.data_ptr()
