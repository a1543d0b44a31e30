"""The whole slice: the port's ``PointMamba`` eval forward against the JAX
package's, with the JAX-initialised weights carried over by
``state_dict_from_jax`` (SAST with sign-aligned eigenvectors, and the xyz
'MAMBA' ordering), plus the reference-keyed state dict, the config and the
options that are not ported yet (the HLT ordering is tests/test_torch_port_hlt.py)."""

import dataclasses

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
from si_mamba_tpu.ops.spectral import sort_orders_by_eigenvectors as j_sort_orders
from si_mamba_tpu.utils.torch_import import import_pointmamba, to_variables
from si_mamba_tpu_torch.models import PointMamba, PointMambaConfig
from si_mamba_tpu_torch.models.point_mamba import cross_entropy_loss_acc, spectral_eigvecs
from si_mamba_tpu_torch.ops.spectral import sort_orders_by_eigenvectors
from si_mamba_tpu_torch.utils.weights import state_dict_from_jax

from tests import torch_oracle as oracle
from tests.test_torch_import import synthetic_state_dict

SMALL = dict(trans_dim=96, encoder_dims=96, depth=2, cls_dim=10, num_group=32,
             group_size=16, drop_path=0.0)


def _clouds(b, n, seed):
    rng = np.random.default_rng(seed)
    pts = rng.standard_normal((b, n, 3)).astype(np.float32)
    return pts / np.abs(pts).max(axis=(1, 2), keepdims=True)


def _jax_model(method, seed=0):
    cfg = JConfig(**SMALL, method=method)
    model = JPointMamba(cfg)
    variables = model.init(jax.random.key(seed), jnp.zeros((2, 256, 3)), train=False)
    return cfg, model, variables


def _port_model(method, variables):
    model = PointMamba(PointMambaConfig(**SMALL, method=method))
    model.load_state_dict(state_dict_from_jax(variables["params"], variables["batch_stats"]),
                          strict=True)
    return model.eval()


def _assert_logits_close(got, want):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, atol=1e-3 * scale, rtol=2e-3)


def test_config_mirrors_jax():
    assert ([(f.name, f.default) for f in dataclasses.fields(PointMambaConfig)]
            == [(f.name, f.default) for f in dataclasses.fields(JConfig)])
    for kw in (dict(), dict(method="MAMBA"), dict(reverse=False), dict(method="HLT")):
        assert PointMambaConfig(**kw).seq_len == JConfig(**kw).seq_len
    raw = dict(NAME="PointMamba", rotation=False, trans_dim=48, depth=3)
    assert PointMambaConfig.from_dict(raw) == PointMambaConfig(trans_dim=48, depth=3)


def test_sast_logits_match_jax_with_aligned_eigenvectors():
    jcfg, jmodel, variables = _jax_model("SAST")
    model = _port_model("SAST", variables)
    # Some clouds put two tokens at exactly equal eigenvector entries in one
    # framework and a few ulps apart in the other, which swaps them in the
    # traversal; this seed has no such tie, and the orders are checked below.
    pts = _clouds(4, 256, seed=2)
    want_logits, want_feat = jmodel.apply(variables, jnp.asarray(pts), train=False,
                                          return_features=True)
    grouped = j_group_divider(jnp.asarray(pts), jcfg.num_group, jcfg.group_size)
    _, jeig = j_spectral_eigvecs(grouped.center, jcfg)
    jeig = np.asarray(jeig)

    with torch.no_grad():
        tokens, pos, center = model.embed(torch.from_numpy(pts))
        np.testing.assert_array_equal(center.numpy(), np.asarray(grouped.center))
        _, eig = spectral_eigvecs(center, model.config)
        assert oracle.eig_cosines(eig, jeig).min() > 1 - 1e-4
        aligned = oracle.align_signs(eig, jeig)
        np.testing.assert_array_equal(
            sort_orders_by_eigenvectors(aligned).numpy(),
            np.asarray(j_sort_orders(jnp.asarray(jeig))))
        x, pos_seq = model.sequence(tokens, pos, center, eigvecs=aligned)
        logits, feat = model.classify(x, pos_seq, return_features=True)
    _assert_logits_close(logits.numpy(), np.asarray(want_logits))
    np.testing.assert_allclose(feat.numpy(), np.asarray(want_feat), rtol=2e-3,
                               atol=1e-3 * float(np.abs(want_feat).max()))


def test_forward_is_its_own_piecewise_composition():
    _, _, variables = _jax_model("SAST")
    model = _port_model("SAST", variables)
    pts = torch.from_numpy(_clouds(4, 256, seed=2))
    with torch.no_grad():
        whole = model(pts)
        tokens, pos, center = model.embed(pts)
        pieces = model.classify(*model.sequence(tokens, pos, center))
    assert torch.equal(whole, pieces)


def test_xyz_logits_match_jax():
    _, jmodel, variables = _jax_model("MAMBA", seed=1)
    model = _port_model("MAMBA", variables)
    pts = _clouds(4, 256, seed=3)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(pts), train=False))
    with torch.no_grad():
        got = model(torch.from_numpy(pts)).numpy()
    _assert_logits_close(got, want)


def test_reference_state_dict_loads_strict_and_matches_jax():
    """A reference-keyed dict (the layout of released checkpoints) loads with
    strict=True and gives the JAX package's logits for the same dict."""
    cfg = PointMambaConfig(**SMALL, method="MAMBA")
    jcfg = JConfig(**SMALL, method="MAMBA")
    sd = synthetic_state_dict(jcfg, seed=4)
    model = PointMamba(cfg)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    params, stats, unexpected = import_pointmamba(sd, depth=cfg.depth)
    assert unexpected == []
    pts = _clouds(3, 256, seed=5)
    want = np.asarray(JPointMamba(jcfg).apply(to_variables(params, stats), jnp.asarray(pts),
                                              train=False))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(pts)).numpy()
    _assert_logits_close(got, want)


def test_fresh_model_is_seeded_and_finite():
    cfg = PointMambaConfig(**SMALL)
    a = PointMamba(cfg, generator=torch.Generator().manual_seed(3)).eval()
    b = PointMamba(cfg, generator=torch.Generator().manual_seed(3)).eval()
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    mixer = a.blocks.layers[0].mixer
    assert mixer.A_log.shape == (192, 16) and torch.all(mixer.D == 1)
    dt = torch.nn.functional.softplus(mixer.dt_proj.bias)
    assert dt.min() >= 1e-4 * 0.999 and dt.max() <= 0.1 * 1.001
    pts = torch.from_numpy(_clouds(2, 256, seed=6))
    with torch.no_grad():
        logits, feat = a(pts, return_features=True)
    assert logits.shape == (2, 10) and feat.shape == (2, 96)
    assert torch.isfinite(logits).all()


@pytest.mark.parametrize("override", [dict(mixer="ssd", add_after_layer=True),
                                      dict(tp_axis="model", add_after_layer=True),
                                      dict(dtype="float16"),
                                      dict(reverse_3=True)])
def test_unported_options_raise(override):
    with pytest.raises(NotImplementedError):
        PointMamba(PointMambaConfig(**SMALL, **override))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tp_axis_needs_a_mesh_at_either_dtype(dtype):
    """tp_axis with the Mamba-1 mixer passes the dtype check at bf16 as at
    fp32 and then asks for a mesh with that axis, as the JAX model needs
    one; tests/test_torch_port_fused_bf16.py runs it on two ranks."""
    with pytest.raises(ValueError, match="needs a mesh"):
        PointMamba(PointMambaConfig(**SMALL, dtype=dtype, tp_axis="model"))


@pytest.mark.parametrize("override", [dict(dtype="bfloat16"), dict(spectral_method="subspace"),
                                      dict(dtype="bfloat16", spectral_method="subspace"),
                                      dict(dtype="bfloat16", scan_impl="fused", trans_dim=64,
                                           encoder_dims=64),
                                      dict(dtype="bfloat16", mixer="ssd", scan_impl="fused"),
                                      dict(dtype="bfloat16", spectral_method="subspace",
                                           method="HLT"),
                                      dict(method="HLT", mixer="ssd")])
def test_perf_mode_options_build_and_run(override):
    """bf16 and the subspace eigensolver (perf mode) build and give finite
    logits in the activation dtype, on the whole-mixer route too (d_inner
    128, which 'fused' needs), and with the HLT ordering; the SSD mixer with
    scan_impl 'fused' runs its 'xla' route, as the JAX model's does (its SSD
    mixer has no 'fused' route). tests/test_torch_port_perf.py,
    tests/test_torch_port_fused_bf16.py and tests/test_torch_port_hlt.py hold
    them against the JAX package."""
    cfg = PointMambaConfig(**{**SMALL, **override})
    model = PointMamba(cfg).eval()
    with torch.no_grad():
        logits = model(torch.from_numpy(_clouds(2, 256, seed=6)))
    assert logits.dtype == getattr(torch, override.get("dtype", "float32"))
    assert torch.isfinite(logits.float()).all()
    if cfg.mixer == "ssd":
        assert all(layer.mixer.impl == "xla" for layer in model.blocks.layers)
        xla = PointMamba(PointMambaConfig(**{**SMALL, **override, "scan_impl": "xla"})).eval()
        xla.load_state_dict(model.state_dict())
        with torch.no_grad():
            assert torch.equal(xla(torch.from_numpy(_clouds(2, 256, seed=6))), logits)
    assert logits.shape == (2, 10) and torch.isfinite(logits.float()).all()


@pytest.mark.parametrize("bn_momentum", [None, 0.7])
def test_training_forward_matches_jax_train_mode(bn_momentum):
    """Train mode with drop rates 0: BatchNorm on batch statistics (biased
    variance to normalise, unbiased into the running statistics) and the
    momentum override give the JAX model's logits and updated statistics."""
    from si_mamba_tpu_torch.models.embed import set_bn_momentum

    cfg = dict(SMALL, method="MAMBA", cls_head_dropout=0.0)
    jmodel = JPointMamba(JConfig(**cfg))
    variables = jmodel.init(jax.random.key(2), jnp.zeros((2, 256, 3)), train=False)
    pts = _clouds(4, 256, seed=8)
    kw = {} if bn_momentum is None else {"bn_momentum": bn_momentum}
    want, upd = jmodel.apply(variables, jnp.asarray(pts), train=True, mutable=["batch_stats"],
                             rngs={"dropout": jax.random.key(0)}, **kw)
    model = PointMamba(PointMambaConfig(**cfg)).train()
    model.load_state_dict(state_dict_from_jax(variables["params"], variables["batch_stats"]),
                          strict=True)
    if bn_momentum is not None:
        set_bn_momentum(model, bn_momentum)
    with torch.no_grad():
        got = model(torch.from_numpy(pts)).numpy()
    _assert_logits_close(got, np.asarray(want))
    stats = state_dict_from_jax(variables["params"], upd["batch_stats"])
    for k, v in model.state_dict().items():
        if "running_" in k:
            np.testing.assert_allclose(v.numpy(), stats[k].numpy(), rtol=1e-4, atol=1e-5,
                                       err_msg=k)


def test_training_forward_draws_from_the_callers_generator():
    """With drop rates above 0 a train-mode forward needs a generator; the
    same generator state gives the same logits, and eval mode draws nothing."""
    model = PointMamba(PointMambaConfig(**{**SMALL, "drop_path": 0.3, "drop_out": 0.1,
                                           "drop_out_in_block": 0.1,
                                           "cls_head_dropout": 0.5})).train()
    pts = torch.from_numpy(_clouds(2, 256, seed=9))
    with pytest.raises(ValueError, match="Generator"):
        model(pts)
    with torch.no_grad():
        a = model(pts, generator=torch.Generator().manual_seed(4))
        b = model(pts, generator=torch.Generator().manual_seed(4))
        c = model(pts, generator=torch.Generator().manual_seed(5))
        e1, e2 = model.eval()(pts), model(pts)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(e1, e2) and torch.isfinite(a).all()


def test_drop_path_is_identity_in_eval_and_per_sample_in_training():
    from si_mamba_tpu_torch.models.layers import DropPath

    x = torch.ones(64, 3, 2)
    dp = DropPath(0.25)
    assert dp.eval()(x) is x
    y = dp.train()(x, torch.Generator().manual_seed(0))
    per_sample = y.reshape(64, -1)
    kept = per_sample[:, 0] != 0
    assert torch.all(per_sample[kept] == 1 / 0.75) and torch.all(per_sample[~kept] == 0)
    assert 0 < int(kept.sum()) < 64


def test_cross_entropy_loss_acc_matches_jax():
    rng = np.random.default_rng(7)
    logits = rng.standard_normal((6, 5)).astype(np.float32)
    labels = np.array([0, 1, 2, 3, 4, 0])
    loss, acc = cross_entropy_loss_acc(torch.from_numpy(logits), torch.from_numpy(labels))
    jloss, jacc = j_ce(jnp.asarray(logits), jnp.asarray(labels))
    np.testing.assert_allclose(loss.numpy(), np.asarray(jloss), rtol=1e-6, atol=1e-6)
    assert float(acc) == pytest.approx(float(jacc))
