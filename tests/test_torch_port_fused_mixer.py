"""The whole-mixer slice of the port (``scan_impl='fused'``) against the JAX
package on the CPU: the plain versions of K10 and K11 against the Pallas
fused-mixer kernel in interpret mode and ``jax.vjp`` of it, the mixer's
'fused' and 'fused_interpret' routes, the ``PointMamba``'s logits with
weights carried over by ``state_dict_from_jax``, and one train step. Inputs
are made with numpy from a seed and handed to both frameworks.

Tolerances start from the JAX package's own limits for its fused kernel
against 'seq' (tests/test_fused_mixer.py:42,59-65): y rtol 2e-4 / atol 2e-5,
gradients rtol 2e-3 / atol 2e-4 relative to each one's max. The Pallas
kernel's in-kernel products round at about 2^-16 relative (bf16 hi/lo
passes, ``_dot_f32``), the port's plain versions in fp32, and the difference
compounds through exp(delta A) in the scan."""

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
from si_mamba_tpu.ops.pallas import fused_mixer_kernel as jfk
from si_mamba_tpu.ops.selective_scan import mamba_mixer_apply as j_mixer_apply
from si_mamba_tpu_torch.models import PointMamba, PointMambaConfig
from si_mamba_tpu_torch.models import point_mamba as port_pm
from si_mamba_tpu_torch.ops import selective_scan as tss
from si_mamba_tpu_torch.ops.kernels import fused_mixer as kfm
from si_mamba_tpu_torch.utils.weights import state_dict_from_jax

from tests import torch_oracle as oracle

FWD_TOL = dict(rtol=2e-4, atol=2e-5)  # tests/test_fused_mixer.py:42
GRAD_TOL = dict(rtol=2e-3, atol=2e-4)  # tests/test_fused_mixer.py:59-65, relative to max


def _params(d_model=32, d_state=4, dt_rank=2, d_conv=4, seed=0):
    """The mixer's parameters in ``mamba_mixer_apply``'s layout, as
    tests/test_fused_mixer.py makes them."""
    d_inner = 2 * d_model
    rng = np.random.default_rng(seed)
    mk = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {
        "in_proj_w": mk(d_model, 2 * d_inner) * 0.2,
        "conv_w": mk(d_inner, d_conv) * 0.3,
        "conv_b": mk(d_inner) * 0.1,
        "x_proj_w": mk(d_inner, dt_rank + 2 * d_state) * 0.2,
        "dt_proj_w": mk(dt_rank, d_inner) * 0.3,
        "dt_proj_b": mk(d_inner) * 0.1,
        "A_log": np.log(np.abs(mk(d_inner, d_state)) + 0.5).astype(np.float32),
        "D": mk(d_inner),
        "out_proj_w": mk(d_inner, d_model) * 0.2,
    }


def _core_inputs(p, b, l, dt_rank=2, d_state=4, seed=1):
    """The kernels' inputs (xz, conv_wt, conv_b, wdt, dtb, wbc, at, d) as
    numpy arrays, W_dt folded in float64 and rounded once."""
    x = np.random.default_rng(seed).standard_normal((b, l, p["in_proj_w"].shape[0]))
    xz = (x.astype(np.float32) @ p["in_proj_w"]).astype(np.float32)
    wdt = (p["x_proj_w"][:, :dt_rank].astype(np.float64) @ p["dt_proj_w"]).astype(np.float32)
    wbc = np.ascontiguousarray(p["x_proj_w"][:, dt_rank:dt_rank + 2 * d_state])
    at = np.ascontiguousarray((-np.exp(p["A_log"])).T).astype(np.float32)
    return (xz, np.ascontiguousarray(p["conv_w"].T), p["conv_b"], wdt, p["dt_proj_b"], wbc, at,
            p["D"])


def _t(*arrays):
    return [torch.from_numpy(np.array(a, dtype=np.float32)) for a in arrays]


def _close_to_max(got, want, name, rtol=GRAD_TOL["rtol"], atol=GRAD_TOL["atol"]):
    scale = np.abs(want).max() + 1e-6
    np.testing.assert_allclose(got / scale, want / scale, rtol=rtol, atol=atol, err_msg=name)


# ---------------------------------------------------------------------------
# the plain versions of K10 and K11
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("L", [7, 64, 80, 192])  # sub-chunk, aligned, ragged, three chunks
def test_plain_k10_matches_pallas_interpret(L):
    """y and the chunk-entry states of ``fused_mixer_fwd_ref`` at chunk 64
    against ``_fused_fwd_call`` in interpret mode (xz zero-padded to a
    multiple of 64, as ``_pad_L`` does)."""
    args = _core_inputs(_params(), 2, L)
    xz_p, _ = jfk._pad_L(jnp.asarray(args[0]), 64)
    xz, conv_wt, conv_b, wdt, dtb, wbc, at, d = (jnp.asarray(a) for a in args)
    y_j, hent_j = jfk._fused_fwd_call(xz_p, conv_wt, conv_b[None], wdt, dtb[None], wbc, at,
                                      d[None], chunk=64, sub_block=8, interpret=True)
    y, hent = kfm.fused_mixer_fwd_ref(*_t(*args), chunk=64, emit_states=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j)[:, :L], **FWD_TOL)
    np.testing.assert_allclose(hent.numpy(), np.asarray(hent_j), **FWD_TOL)
    lean = kfm.fused_mixer_fwd(*_t(*args))  # the wrapper's CPU path, at its own chunk
    np.testing.assert_allclose(lean.numpy(), y.numpy(), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("L", [80, 192])
def test_plain_k11_matches_jax_vjp_of_the_pallas_core(L):
    """dxz and the seven weight gradients of ``fused_mixer_bwd_ref`` against
    ``jax.vjp`` of the Pallas core (its custom VJP: the backward kernel,
    interpret mode), each relative to its max."""
    args = _core_inputs(_params(seed=3), 2, L, seed=4)
    g = np.random.default_rng(5).standard_normal((2, L, 64)).astype(np.float32)
    core = lambda *a: jfk._fused_core(*a, 64, 8, True)  # noqa: E731
    _, vjp = jax.vjp(core, *(jnp.asarray(a) for a in args))
    want = vjp(jnp.asarray(g))
    _, hent = kfm.fused_mixer_fwd_ref(*_t(*args), chunk=kfm.CHUNK, emit_states=True)
    got = kfm.fused_mixer_bwd_ref(*_t(*args), hent, *_t(g), chunk=kfm.CHUNK)
    names = ("dxz", "dconv_wt", "dconv_b", "dwdt", "ddtb", "dwbc", "dat", "dd")
    for name, a, w in zip(names, got, want):
        assert a.shape == w.shape, name
        _close_to_max(a.numpy(), np.asarray(w), name)


def test_fused_mamba_mixer_grads_match_jax_vjp():
    """Autograd through the port's ``fused_mamba_mixer`` (the W_dt fold and
    the transposes outside ``FusedMixerFn``, its plain backward inside)
    against ``jax.vjp`` of JAX's ``fused_mamba_mixer`` in interpret mode: xz
    and all seven mixer parameters."""
    p = _params(seed=6)
    names = ("conv_w", "conv_b", "x_proj_w", "dt_proj_w", "dt_proj_b", "A", "D")
    leaves = {k: p[k] for k in names if k != "A"} | {"A": -np.exp(p["A_log"])}
    xz = _core_inputs(p, 2, 80, seed=7)[0]
    g = np.random.default_rng(8).standard_normal((2, 80, 64)).astype(np.float32)
    fn = lambda xz_, *w: jfk.fused_mamba_mixer(xz_, *w, dt_rank=2, d_state=4,  # noqa: E731
                                               interpret=True)
    _, vjp = jax.vjp(fn, jnp.asarray(xz), *(jnp.asarray(leaves[k]) for k in names))
    want = vjp(jnp.asarray(g))
    ts = [t.requires_grad_() for t in _t(xz, *(leaves[k] for k in names))]
    y = kfm.fused_mamba_mixer(*ts, dt_rank=2, d_state=4)
    assert isinstance(y.grad_fn, kfm.FusedMixerFn._backward_cls)
    y.backward(torch.from_numpy(g))
    for name, t, w in zip(("xz",) + names, ts, want):
        _close_to_max(t.grad.numpy(), np.asarray(w), name)


def test_fused_mixer_fn_keeps_the_graph_and_no_grad_takes_the_lean_forward():
    """With a parameter that needs a gradient the output hangs on
    ``FusedMixerFn`` (a wrapper that wrote into a fresh tensor would cut the
    graph); under no_grad it has no grad_fn."""
    p = {k: torch.from_numpy(v) for k, v in _params(d_model=64, seed=9).items()}
    p["x_proj_w"].requires_grad_()
    x = torch.from_numpy(np.random.default_rng(10).standard_normal((1, 20, 64)).astype(np.float32))
    y = tss.mamba_mixer_apply(p, x, d_state=4, dt_rank=2, impl="fused")
    seen, stack = set(), [y.grad_fn]
    while stack:
        node = stack.pop()
        if node is not None and node not in seen:
            seen.add(node)
            stack.extend(f for f, _ in node.next_functions)
    assert any(isinstance(node, kfm.FusedMixerFn._backward_cls) for node in seen)
    y.sum().backward()
    assert torch.isfinite(p["x_proj_w"].grad).all() and p["x_proj_w"].grad.abs().max() > 0
    with torch.no_grad():
        assert tss.mamba_mixer_apply(p, x, d_state=4, dt_rank=2, impl="fused").grad_fn is None


# ---------------------------------------------------------------------------
# the mixer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl,d_model", [("fused_interpret", 32), ("fused", 64)])
def test_mixer_fused_routes_match_jax_and_seq(impl, d_model):
    """``mamba_mixer_apply`` with 'fused_interpret' (d_inner 64, which
    'fused' refuses) and 'fused' (d_inner 128) against JAX's
    'fused_interpret' and the port's own 'seq', forward and every
    parameter gradient."""
    p = _params(d_model=d_model, seed=11)
    x = np.random.default_rng(12).standard_normal((2, 80, d_model)).astype(np.float32)
    g = np.random.default_rng(13).standard_normal((2, 80, d_model)).astype(np.float32)

    def j_loss(params, x_):
        return jnp.sum(j_mixer_apply(params, x_, d_state=4, dt_rank=2,
                                     impl="fused_interpret") * jnp.asarray(g))

    jp = {k: jnp.asarray(v) for k, v in p.items()}
    want_y = np.asarray(j_mixer_apply(jp, jnp.asarray(x), d_state=4, dt_rank=2,
                                      impl="fused_interpret"))
    want_g = jax.grad(j_loss)(jp, jnp.asarray(x))
    results = {}
    for name in (impl, "seq"):
        tp = {k: t.requires_grad_() for k, t in zip(p, _t(*p.values()))}
        y = tss.mamba_mixer_apply(tp, torch.from_numpy(x), d_state=4, dt_rank=2, impl=name)
        y.backward(torch.from_numpy(g))
        results[name] = y.detach().numpy(), {k: t.grad.numpy() for k, t in tp.items()}
    y, grads = results[impl]
    # the forward's atol relative to max |y| (68.7 at d_model 64, where JAX's
    # 'fused_interpret' and 'seq' differ by 5.2e-4)
    _close_to_max(y, want_y, "y", **FWD_TOL)
    _close_to_max(y, results["seq"][0], "y (seq)", **FWD_TOL)
    for k, gk in grads.items():
        _close_to_max(gk, np.asarray(want_g[k]), k)
        _close_to_max(gk, results["seq"][1][k], k + " (seq)")


@pytest.mark.parametrize("d_model,d_state", [(32, 4), (64, 33)],
                         ids=["d_inner_64", "d_state_33"])
def test_mixer_fused_rejects_unsupported_shapes(d_model, d_state):
    """d_inner % 128 != 0 or d_state > 32: ``ValueError`` on any device, as
    JAX's 'fused' raises (si_mamba_tpu/ops/selective_scan.py:267-272);
    'fused_interpret' takes the shape."""
    p = {k: torch.from_numpy(v) for k, v in _params(d_model=d_model, d_state=d_state).items()}
    x = torch.zeros(1, 8, d_model)
    with pytest.raises(ValueError, match="d_inner % 128 == 0 and d_state <= 32"):
        tss.mamba_mixer_apply(p, x, d_state=d_state, dt_rank=2, impl="fused")
    y = tss.mamba_mixer_apply(p, x, d_state=d_state, dt_rank=2, impl="fused_interpret")
    assert y.shape == (1, 8, d_model) and torch.isfinite(y).all()


# ---------------------------------------------------------------------------
# the whole slice: PointMamba with scan_impl='fused'
# ---------------------------------------------------------------------------

# depth 2 at trans_dim 64 (d_inner 128, d_state 16, dt_rank 4), 16 groups of 8:
# L = 2 * 4 * 16 = 128, two chunks of 64 in the JAX kernel, eight of 16 in the port's
FUSED_SMALL = dict(trans_dim=64, encoder_dims=64, depth=2, cls_dim=10, num_group=16,
                   group_size=8, drop_path=0.0, cls_head_dropout=0.0, knn_graph=8)


def _clouds(b, n, seed):
    rng = np.random.default_rng(seed)
    pts = rng.standard_normal((b, n, 3)).astype(np.float32)
    return pts / np.abs(pts).max(axis=(1, 2), keepdims=True)


@pytest.fixture(scope="module")
def fused_jax_model():
    jcfg = JConfig(**FUSED_SMALL, scan_impl="fused_interpret")
    jmodel = JPointMamba(jcfg)
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


def _port_model(variables, scan_impl="fused"):
    model = PointMamba(PointMambaConfig(**FUSED_SMALL, scan_impl=scan_impl))
    model.load_state_dict(state_dict_from_jax(variables["params"], variables["batch_stats"]),
                          strict=True)
    return model


def test_fused_model_logits_match_jax(fused_jax_model):
    """A JAX ``PointMamba(scan_impl='fused_interpret')`` loaded with
    strict=True: the port's eval logits with 'fused' (the plain K10 on the
    CPU) against ``PointMamba.apply``, within the composed-logits limit of
    tests/test_full_parity.py:83, SAST with sign-aligned eigenvectors."""
    jcfg, jmodel, variables = fused_jax_model
    pts = _clouds(4, 128, seed=2)
    want = np.asarray(jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(variables,
                                                                             jnp.asarray(pts)))
    scale = float(np.abs(want).max())
    model = _port_model(variables).eval()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_pm, "spectral_eigvecs", _aligned_eigvecs(jcfg, pts))
        with torch.no_grad():
            got = model(torch.from_numpy(pts)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-3 * scale, rtol=2e-3)


def test_fused_train_step_matches_jax(fused_jax_model):
    """One train step (drop rates 0) of the port's 'fused' model against JAX's
    value_and_grad + AdamW update of its 'fused_interpret' model: the loss,
    every parameter's gradient (within 1.5e-2 of the largest, dominant leaves
    1.5 % relative, tests/test_full_parity.py:541-545) and the updated
    parameters."""
    from si_mamba_tpu.train import optim as joptim
    from si_mamba_tpu.train.train_state import TrainState as JTrainState
    from si_mamba_tpu_torch.train import optim
    from si_mamba_tpu_torch.train.train_state import TrainState, make_classifier_train_step

    jcfg, jmodel, variables = fused_jax_model
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

    model = _port_model(variables)
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
