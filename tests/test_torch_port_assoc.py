"""The whole-sequence associative scan (``impl='assoc'``) and the
associative local scan of the Mamba-1 sequence-parallel path, against the
JAX package on the CPU: ``selective_scan_assoc`` against JAX's ``lax.
associative_scan`` form (fp32: rtol 1e-5, atol 1e-5 max; bf16 inputs within
one bf16 ulp), the mixer's 'assoc' route and its gradient against
``jax.grad`` (rtol 1e-4), a 2-block ``PointMamba`` with ``scan_impl:
assoc`` (the repo's composed tolerance), and ``selective_scan_seq_parallel``
on two gloo ranks against JAX's on a 2-device seq mesh (forward within 1e-5
of its max, every gradient within 1e-4 of its max).

The spawned ranks re-import this module, so JAX is imported inside the
JAX-side code only."""

from __future__ import annotations

import importlib

import numpy as np
import pytest
import torch

from si_mamba_tpu_torch.models import PointMamba, PointMambaConfig
from si_mamba_tpu_torch.ops import selective_scan as tss

from tests.test_torch_port_parallel import _jax_loss, _jax_mesh, _loss, _run_ranks

SCAN = dict(b=2, l=45, d=16, n=4)  # L not a power of two: the scan's last level is partial
SP = dict(b=2, l=32, d=8, n=4)


def _jss():
    return importlib.import_module("si_mamba_tpu.ops.selective_scan")


def _scan_inputs(seed, c=SCAN):
    rng = np.random.default_rng(seed)
    b, l, d, n = c["b"], c["l"], c["d"], c["n"]
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return dict(u=f(b, l, d), delta=0.5 * f(b, l, d), A=-np.exp(f(d, n)).astype(np.float32),
                B=f(b, l, n), C=f(b, l, n), D=f(d), z=f(b, l, d), delta_bias=0.1 * f(d))


ORDER = ("u", "delta", "A", "B", "C")


@pytest.mark.parametrize("drop", [(), ("D",), ("z",), ("delta_bias",), ("D", "z", "delta_bias")])
def test_selective_scan_assoc_matches_jax_fp32(drop):
    import jax
    import jax.numpy as jnp

    a = _scan_inputs(1)
    kw = {k: a[k] for k in ("D", "z", "delta_bias") if k not in drop}
    got = tss.selective_scan_assoc(*(torch.from_numpy(a[k]) for k in ORDER),
                                   **{k: torch.from_numpy(v) for k, v in kw.items()}).numpy()
    want = np.asarray(jax.jit(_jss().selective_scan_assoc)(
        *(jnp.asarray(a[k]) for k in ORDER), **{k: jnp.asarray(v) for k, v in kw.items()}))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("drop", [(), ("D", "z", "delta_bias")])
def test_selective_scan_assoc_matches_jax_bf16(drop):
    """bf16 u, delta, B, C, z (A, D, the dt bias fp32): the fp32 state and
    sums, y rounded once to bf16, so the two frameworks' y are within one
    bf16 ulp of each element (at a floor of 1e-2 of the max)."""
    import jax
    import jax.numpy as jnp

    a = _scan_inputs(2)
    low = ("u", "delta", "B", "C", "z")
    kw = {k: a[k] for k in ("D", "z", "delta_bias") if k not in drop}
    t = {k: (torch.from_numpy(v).bfloat16() if k in low else torch.from_numpy(v))
         for k, v in a.items()}
    j = {k: (jnp.asarray(v).astype(jnp.bfloat16) if k in low else jnp.asarray(v))
         for k, v in a.items()}
    got = tss.selective_scan_assoc(*(t[k] for k in ORDER), **{k: t[k] for k in kw})
    want = jax.jit(_jss().selective_scan_assoc)(*(j[k] for k in ORDER), **{k: j[k] for k in kw})
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    got, want = got.float().numpy(), np.asarray(want.astype(jnp.float32))
    mag = np.maximum(np.abs(want), 1e-2 * np.abs(want).max())
    assert np.max(np.abs(got - want) / 2.0 ** (np.floor(np.log2(mag)) - 7)) <= 1.0


def _mixer_params(d_model=16, d_state=4, dt_rank=2, seed=3):
    rng = np.random.default_rng(seed)
    di = 2 * d_model
    mk = lambda *s, sc=0.3: (rng.standard_normal(s) * sc).astype(np.float32)  # noqa: E731
    return {"in_proj_w": mk(d_model, 2 * di), "conv_w": mk(di, 4), "conv_b": mk(di, sc=0.1),
            "x_proj_w": mk(di, dt_rank + 2 * d_state), "dt_proj_w": mk(dt_rank, di),
            "dt_proj_b": mk(di, sc=0.1),
            "A_log": np.log(np.tile(np.arange(1, d_state + 1, dtype=np.float32), (di, 1))),
            "D": np.ones(di, np.float32), "out_proj_w": mk(di, d_model)}


def test_mixer_assoc_and_its_gradient_match_jax():
    """``mamba_mixer_apply(impl='assoc')``: y and every parameter's and the
    input's gradient of sum(sin(y) cos(0.3 y)) against JAX's route
    (``jax.grad``), rtol 1e-4 (atol 1e-4 of each gradient's max)."""
    import jax
    import jax.numpy as jnp

    p = _mixer_params()
    x = np.random.default_rng(4).standard_normal((2, 40, 16)).astype(np.float32)
    leaves = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
    tx = torch.from_numpy(x).requires_grad_()
    y = tss.mamba_mixer_apply(leaves, tx, d_state=4, dt_rank=2, impl="assoc")
    _loss(y).backward()

    def f(params, xx):
        return _jss().mamba_mixer_apply(params, xx, d_state=4, dt_rank=2, impl="assoc")

    jp, jx = {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jax.jit(f)(jp, jx)), rtol=1e-4,
                               atol=1e-5)
    gp, gx = jax.jit(jax.grad(lambda pp, xx: _jax_loss(f(pp, xx)), argnums=(0, 1)))(jp, jx)
    for name, got, want in [(k, v.grad, gp[k]) for k, v in leaves.items()] + [("x", tx.grad, gx)]:
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4 * np.abs(want).max(),
                                   err_msg=name)


def test_point_mamba_with_scan_impl_assoc_matches_jax():
    """A 2-block classifier with ``scan_impl: assoc`` in both packages, JAX's
    initial weights carried over by ``state_dict_from_jax`` (the xyz
    ordering): logits within atol 1e-3 max|logit|, rtol 2e-3."""
    import jax
    import jax.numpy as jnp

    from si_mamba_tpu.models import PointMamba as JPointMamba
    from si_mamba_tpu.models import PointMambaConfig as JConfig
    from si_mamba_tpu_torch.utils.weights import state_dict_from_jax

    cfg = dict(trans_dim=32, encoder_dims=32, depth=2, cls_dim=10, num_group=16, group_size=8,
               knn_graph=4, drop_path=0.0, method="MAMBA", scan_impl="assoc")
    jmodel = JPointMamba(JConfig(**cfg))
    variables = jax.jit(lambda k: jmodel.init(k, jnp.zeros((2, 128, 3)), train=False))(
        jax.random.key(0))
    rng = np.random.default_rng(5)
    pts = rng.standard_normal((3, 128, 3)).astype(np.float32)
    pts /= np.abs(pts).max(axis=(1, 2), keepdims=True)
    want = np.asarray(jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(variables, pts))
    model = PointMamba(PointMambaConfig(**cfg))
    model.load_state_dict(state_dict_from_jax(variables["params"], variables["batch_stats"]),
                          strict=True)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(pts)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-3 * np.abs(want).max(), rtol=2e-3)


# ---------------------------------------------------------------------------
# the Mamba-1 sequence-parallel scan on two gloo ranks (no JAX in the ranks)
# ---------------------------------------------------------------------------

NAMES = ("u", "delta", "A", "B", "C", "D", "z", "delta_bias")
SEQ = ("u", "delta", "B", "C", "z")


def _sp_rank(rank, world, data):
    from si_mamba_tpu_torch.parallel import make_mesh
    from si_mamba_tpu_torch.parallel.seq_scan import selective_scan_seq_parallel

    mesh = make_mesh(("seq",), (world,))
    l_loc = SP["l"] // world
    part = slice(rank * l_loc, (rank + 1) * l_loc)
    t = {k: torch.from_numpy(v[:, part].copy() if k in SEQ else v.copy()).requires_grad_()
         for k, v in data.items()}
    y = selective_scan_seq_parallel(t["u"], t["delta"], t["A"], t["B"], t["C"], D=t["D"],
                                    z=t["z"], delta_bias=t["delta_bias"], mesh=mesh)
    _loss(y).backward()
    return dict(y=y.detach(), grads={k: v.grad for k, v in t.items()})


def test_selective_scan_seq_parallel_on_two_ranks_matches_jax(tmp_path):
    """Each rank scans its half of L with the associative scan from a zero
    state; the carry crosses the axis. y and every input's gradient (A, D and
    the dt bias summed over the ranks, whole on each) against JAX's on a
    2-device seq mesh."""
    import jax
    import jax.numpy as jnp

    from si_mamba_tpu.parallel.seq_scan import selective_scan_seq_parallel as j_sp

    data = _scan_inputs(6, SP)
    ranks = _run_ranks(_sp_rank, 2, tmp_path, data)
    mesh = _jax_mesh(("seq",), 2)

    def f(u, delta, A, B, C, D, z, db):
        return j_sp(u, delta, A, B, C, D=D, z=z, delta_bias=db, mesh=mesh)

    args = [jnp.asarray(data[k]) for k in NAMES]
    want = np.asarray(jax.jit(f)(*args))
    got = np.concatenate([r["y"].numpy() for r in ranks], axis=1)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    grads = jax.jit(jax.grad(lambda *a: _jax_loss(f(*a)), argnums=tuple(range(8))))(*args)
    for k, g in zip(NAMES, grads):
        g = np.asarray(g)
        if k in SEQ:
            mine = [np.concatenate([r["grads"][k].numpy() for r in ranks], axis=1)]
        else:  # replicated: the sum over the ranks, whole on each
            mine = [r["grads"][k].numpy() for r in ranks]
        for m in mine:
            assert np.abs(m - g).max() <= 1e-4 * np.abs(g).max(), k
