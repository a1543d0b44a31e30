"""The SSD mixer's tensor- and sequence-parallel paths at bf16 against the
JAX package on the CPU: ``ssd_mixer_tp`` on 2 ``gloo`` ranks and
``ssd_seq_parallel`` on 4, both routes ('ssd_fused': the plain bf16 K6/K7
here; 'xla': ``ssd_chunked``), on the inputs of
tests/test_torch_port_parallel.py rounded to bf16, each against JAX's
counterpart on the 8-device CPU mesh of ``tests/conftest.py``. As there, the
rank bodies import no JAX and the ranks are spawned once per module.

Tolerances, relative to the max: the tensor-parallel mixer's output 3e-2
(JAX's tensor-parallel mixer runs the XLA conv, which rounds to bf16 after
every shifted product and add, where the port's conv sums in fp32 and rounds
once; 4e-3, two bf16 ulps of the max, with JAX's conv summing in fp32 too);
the sequence-parallel core's output 4e-3 (the same roundings, the carry's
fix-up added in bf16 on both sides); gradients 3e-2 (bf16 gradients rounded
at every op, in places the two frameworks do not share), 6e-2 for the
tensor-parallel mixer's per-head scalars (sums over every token of bf16
products).
"""

from __future__ import annotations

import importlib

import numpy as np
import pytest
import torch

from tests.test_torch_port_parallel import SP_SSD, SSD_MIX, _jax_loss, _jax_mesh, _loss, \
    _run_ranks, _sp_ssd_inputs, _ssd_mixer_params

VAL_REL = 4e-3
TP_VAL_REL = 3e-2
GRAD_REL = 3e-2
# the per-head scalars' gradients: each a sum over every token of a product
# that the D skip (y + bf16(D) x) and the decay take in bf16 on both sides
PER_HEAD_REL = 6e-2


def _bf16_values(a: np.ndarray) -> np.ndarray:
    """The fp32 array of a's values rounded to bf16 (to nearest even)."""
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def _tp_bf16_rank(rank, world, data_path):
    from si_mamba_tpu_torch.parallel import make_mesh
    from si_mamba_tpu_torch.parallel.tensor_parallel import shard_ssd_mixer_params, ssd_mixer_tp

    data = torch.load(data_path, weights_only=False)
    mesh = make_mesh(("model",), (world,))
    a, c, out = data["ssd_mixer"], SSD_MIX, {}
    for impl in ("ssd_fused", "xla"):
        full = {k: torch.from_numpy(v) for k, v in a.items() if k != "u"}
        p = {k: v.clone().requires_grad_() for k, v in shard_ssd_mixer_params(
            full, rank, world, n_heads=c["n_heads"], d_state=c["d_state"]).items()}
        u = torch.from_numpy(a["u"].copy()).to(torch.bfloat16).requires_grad_()
        y = ssd_mixer_tp(p, u, mesh=mesh, n_heads=c["n_heads"], d_state=c["d_state"],
                         chunk=c["chunk"], impl=impl)
        _loss(y.float()).backward()
        out[impl] = dict(y=y.detach(), du=u.grad, grads={k: v.grad for k, v in p.items()})
    return out


def _sp_bf16_rank(rank, world, data_path):
    from si_mamba_tpu_torch.parallel import make_mesh
    from si_mamba_tpu_torch.parallel.seq_scan import ssd_seq_parallel

    data = torch.load(data_path, weights_only=False)
    mesh = make_mesh(("seq",), (world,))
    a, out = data["ssd"], {}
    l_loc = SP_SSD["l"] // world
    part = slice(rank * l_loc, (rank + 1) * l_loc)
    for impl in ("ssd_fused", "xla"):
        t = {}
        for k, v in a.items():
            v = torch.from_numpy(v[:, part].copy() if v.ndim > 1 else v.copy())
            t[k] = (v.to(torch.bfloat16) if k in ("x", "Bm", "Cm") else v).requires_grad_()
        y = ssd_seq_parallel(t["x"], t["dt"], t["A"], t["Bm"], t["Cm"], t["D"], mesh=mesh,
                             chunk=SP_SSD["chunk"], impl=impl)
        _loss(y.float()).backward()
        out[impl] = dict(y=y.detach(), grads={k: v.grad for k, v in t.items()})
    return out


@pytest.fixture(scope="module")
def tp_bf16_ranks(tmp_path_factory):
    data = dict(ssd_mixer=_ssd_mixer_params(1))
    tmp = tmp_path_factory.mktemp("tp_bf16")
    torch.save(data, tmp / "data.pt")
    return data, _run_ranks(_tp_bf16_rank, 2, tmp, str(tmp / "data.pt"))


@pytest.fixture(scope="module")
def sp_bf16_ranks(tmp_path_factory):
    data = dict(ssd=_sp_ssd_inputs(5))
    tmp = tmp_path_factory.mktemp("sp_bf16")
    torch.save(data, tmp / "data.pt")
    return data, _run_ranks(_sp_bf16_rank, 4, tmp, str(tmp / "data.pt"))


def _rel(got, want) -> float:
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _conv_accumulating_in_fp32(conv):
    import jax.numpy as jnp

    def summed(x, weight, bias=None, activation="silu"):
        return conv(x.astype(jnp.float32), weight.astype(jnp.float32),
                    bias.astype(jnp.float32), activation).astype(x.dtype)

    return summed


@pytest.mark.parametrize("impl", ["ssd_fused", "xla"])
def test_ssd_mixer_tp_bf16_matches_jax(tp_bf16_ranks, impl, monkeypatch):
    """``ssd_mixer_tp`` at bf16 on 2 ranks against JAX's ``ssd_mixer_tp`` at
    bf16 on a 2-device model mesh, on the same route (the fused one in
    interpret mode): the
    bf16 output within 3e-2 of the max, and within 4e-3 once JAX's conv sums
    in fp32 as the port's does; the bf16 input gradient and the gathered fp32
    parameter gradients within 3e-2 of their max, the per-head scalars'
    (dt_bias, A_log, D) within 6e-2."""
    import jax
    import jax.numpy as jnp

    jtp = importlib.import_module("si_mamba_tpu.parallel.tensor_parallel")
    data, ranks = tp_bf16_ranks
    a, c = data["ssd_mixer"], SSD_MIX
    mesh = _jax_mesh(("model",), 2)
    full = {k: jnp.asarray(v) for k, v in a.items() if k != "u"}
    u = jnp.asarray(a["u"]).astype(jnp.bfloat16)
    kw = dict(mesh=mesh, n_heads=c["n_heads"], d_state=c["d_state"], chunk=c["chunk"],
              impl=impl, _interpret=True)
    p = jtp.shard_ssd_mixer_params(full, mesh, n_heads=c["n_heads"], d_state=c["d_state"])
    y = jax.jit(lambda p, u: jtp.ssd_mixer_tp(p, u, **kw))(p, u)
    assert y.dtype == jnp.bfloat16
    got = [r[impl] for r in ranks]
    for r in got:
        assert r["y"].dtype == torch.bfloat16 and r["du"].dtype == torch.bfloat16
        assert _rel(r["y"], y) <= TP_VAL_REL, _rel(r["y"], y)
    monkeypatch.setattr(jtp, "causal_conv1d", _conv_accumulating_in_fp32(jtp.causal_conv1d))
    y = jax.jit(lambda p, u: jtp.ssd_mixer_tp(p, u, **kw))(p, u)
    gp, gu = jax.jit(jax.grad(lambda p, u: _jax_loss(jtp.ssd_mixer_tp(p, u, **kw).astype(
        jnp.float32)), argnums=(0, 1)))(p, u)
    for r in got:
        assert _rel(r["y"], y) <= VAL_REL, _rel(r["y"], y)
        assert _rel(r["du"], gu) <= GRAD_REL, _rel(r["du"], gu)
    for k, want in gp.items():
        axis = 1 if k.startswith("in_proj") and k != "in_proj_bc" else 0
        if k in ("in_proj_bc", "conv_bc_w", "conv_bc_b"):  # replicated: whole on each rank
            for r in got:
                assert r["grads"][k].dtype == torch.float32
                assert _rel(r["grads"][k], want) <= GRAD_REL, (k, _rel(r["grads"][k], want))
            continue
        gathered = torch.cat([r["grads"][k] for r in got], dim=axis)
        tol = PER_HEAD_REL if k in ("dt_bias", "A_log", "D") else GRAD_REL
        assert gathered.dtype == torch.float32 and _rel(gathered, want) <= tol, (
            k, _rel(gathered, want))


@pytest.mark.parametrize("impl", ["ssd_fused", "xla"])
def test_ssd_seq_parallel_bf16_matches_jax(sp_bf16_ranks, impl):
    """``ssd_seq_parallel`` at bf16 (x, B and C bf16; dt, A and D fp32) on 4
    ranks against JAX's on a 4-device seq mesh, on the same route (the fused
    one in interpret mode): the concatenated bf16 output within 4e-3 of its max, the
    gathered gradients of x, B and C (bf16) and of dt (fp32) within 3e-2 of
    theirs, A's and D's (fp32, replicated: summed over the ranks, whole on
    each) within 3e-2."""
    import jax
    import jax.numpy as jnp

    from si_mamba_tpu.parallel.seq_scan import ssd_seq_parallel

    data, ranks = sp_bf16_ranks
    a = data["ssd"]
    mesh = _jax_mesh(("seq",), 4)
    args = [jnp.asarray(a[k]).astype(jnp.bfloat16) if k in ("x", "Bm", "Cm")
            else jnp.asarray(a[k]) for k in ("x", "dt", "A", "Bm", "Cm", "D")]
    kw = dict(mesh=mesh, chunk=SP_SSD["chunk"], impl=impl, _interpret=True)
    y = jax.jit(lambda *t: ssd_seq_parallel(*t, **kw))(*args)
    grads = jax.jit(jax.grad(lambda *t: _jax_loss(ssd_seq_parallel(*t, **kw).astype(
        jnp.float32)), argnums=tuple(range(6))))(*args)
    got = [r[impl] for r in ranks]
    y_port = torch.cat([r["y"] for r in got], dim=1)
    assert y_port.dtype == torch.bfloat16 and y.dtype == jnp.bfloat16
    assert _rel(y_port, y) <= VAL_REL, _rel(y_port, y)
    for k, want in zip(("x", "dt", "A", "Bm", "Cm", "D"), grads):
        parts = [r["grads"][k] for r in got]
        assert parts[0].dtype == (torch.bfloat16 if k in ("x", "Bm", "Cm") else torch.float32)
        if k in ("A", "D"):  # replicated: summed over the ranks, whole on each
            for g in parts:
                assert _rel(g, want) <= GRAD_REL, (k, _rel(g, want))
        else:
            g = torch.cat(parts, dim=1)
            assert _rel(g, want) <= GRAD_REL, (k, _rel(g, want))
