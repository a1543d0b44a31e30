"""The HLT ordering: ``spectral.multilevel_codes``, ``ordering.hlt_sequence``,
the threefry draws of the eval tie-break and the classifier's HLT route,
against the JAX package's, with JAX's own ``jax.random.uniform(key, (B, G))``
handed to the port's ordering as its tie-break.

An HLT bit is ``eigvec >= mean``, so an entry within an ulp of its mean could
take another bit in the other framework. The seeds here have no such entry:
the codes are asserted equal before anything is built on them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from si_mamba_tpu.models import PointMamba as JPointMamba
from si_mamba_tpu.models import PointMambaConfig as JConfig
from si_mamba_tpu.models.grouping import group_divider as j_group_divider
from si_mamba_tpu.models.ordering import hlt_sequence as j_hlt_sequence
from si_mamba_tpu.models.point_mamba import spectral_eigvecs as j_spectral_eigvecs
from si_mamba_tpu.ops.spectral import multilevel_codes as j_multilevel_codes
from si_mamba_tpu_torch.models import PointMamba, PointMambaConfig
from si_mamba_tpu_torch.models.ordering import hlt_sequence
from si_mamba_tpu_torch.models.point_mamba import order_noise, spectral_eigvecs
from si_mamba_tpu_torch.ops.spectral import fold_in, multilevel_codes, prng_key, uniform
from si_mamba_tpu_torch.utils.weights import state_dict_from_jax

from tests import torch_oracle as oracle

SMALL = dict(trans_dim=96, encoder_dims=96, depth=2, cls_dim=10, num_group=32,
             group_size=16, drop_path=0.0, method="HLT")


def _clouds(b, n, seed):
    rng = np.random.default_rng(seed)
    pts = rng.standard_normal((b, n, 3)).astype(np.float32)
    return pts / np.abs(pts).max(axis=(1, 2), keepdims=True)


@pytest.mark.parametrize("level", [1, 3, 4])
def test_multilevel_codes_equal_jax(level):
    eig = np.random.default_rng(level).standard_normal((3, 64, 4)).astype(np.float32)
    want = np.asarray(j_multilevel_codes(jnp.asarray(eig), level))
    got = multilevel_codes(torch.from_numpy(eig), level).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.max() <= 2 ** level - 1 and len(np.unique(got)) > 1


@pytest.mark.parametrize("G,k", [(32, 3), (128, 4), (16, 4)])
def test_hlt_sequence_equals_jax(G, k):
    """Canvases equal: [c0, rev(c0), c1, ..., rev(c_{nd-1})] then zeros to
    2G; at G = 16, k = 4 one chunk of 16 makes a canvas of 48 > 2G, kept
    whole as the JAX package keeps it."""
    rng = np.random.default_rng(G + k)
    tokens = rng.standard_normal((2, G, 5)).astype(np.float32)
    pos = rng.standard_normal((2, G, 5)).astype(np.float32)
    eig = rng.standard_normal((2, G, 4)).astype(np.float32)
    key = jax.random.key(7)
    noise = np.array(jax.random.uniform(key, (2, G)))
    want = j_hlt_sequence(jnp.asarray(tokens), jnp.asarray(pos), jnp.asarray(eig), k, key)
    got = hlt_sequence(torch.from_numpy(eig), k, torch.from_numpy(noise),
                       torch.from_numpy(tokens), torch.from_numpy(pos))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    nd = G // 2 ** k
    assert got[0].shape[1] == max(2 * G, (nd + 2) * 2 ** k)


@pytest.mark.parametrize("seed,data", [(0, 1), (7, 3213575472), (2 ** 31 - 1, 2 ** 32 - 1)])
def test_threefry_fold_in_and_uniform_equal_jax(seed, data):
    key = jax.random.key(seed)
    folded = fold_in(prng_key(seed), data)
    want = jax.random.fold_in(key, jnp.uint32(data))
    assert folded == tuple(int(x) for x in jax.random.key_data(want))
    np.testing.assert_array_equal(uniform(prng_key(seed), (3, 5, 7)),
                                  np.asarray(jax.random.uniform(key, (3, 5, 7))))
    np.testing.assert_array_equal(uniform(folded, (4, 9)),
                                  np.asarray(jax.random.uniform(want, (4, 9))))


def test_order_noise_repeats_in_eval_and_follows_the_generator_in_training():
    """In eval the draw is ``jax.random.uniform`` of the eval key, by default
    ``jax.random.key(0)``, the JAX classifier's eval draw."""
    a = order_noise(2, 8, "cpu", training=False)
    assert torch.equal(a, order_noise(2, 8, "cpu", training=False))
    np.testing.assert_array_equal(a.numpy(),
                                  np.asarray(jax.random.uniform(jax.random.key(0), (2, 8))))
    b = order_noise(2, 8, "cpu", training=False, eval_key=fold_in(prng_key(0), 1))
    np.testing.assert_array_equal(b.numpy(), np.asarray(jax.random.uniform(
        jax.random.fold_in(jax.random.key(0), 1), (2, 8))))
    g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    assert torch.equal(order_noise(2, 8, "cpu", True, g1), order_noise(2, 8, "cpu", True, g2))
    with pytest.raises(ValueError, match="Generator"):
        order_noise(2, 8, "cpu", training=True)


@pytest.mark.parametrize("seed", [0, 7])
def test_order_noise_at_bf16_is_jaxs_bf16_draw(seed):
    """At bf16 the HLT codes are bf16 and JAX draws the tie-break in their
    dtype (8 random bits, 7 of them kept): the eval draw bit for bit
    ``jax.random.uniform(key, shape, jnp.bfloat16)``, the training draw
    multiples of 1/128 below 1, as JAX's are. An fp32 draw rounded to bf16
    is another order (and can reach 1.0, the next bucket's code)."""
    got = order_noise(3, 64, "cpu", False, eval_key=prng_key(seed), dtype=torch.bfloat16)
    want = jax.random.uniform(jax.random.key(seed), (3, 64), jnp.bfloat16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want.astype(jnp.float32)))
    assert not torch.equal(got, order_noise(3, 64, "cpu", False, eval_key=prng_key(seed))
                           .to(torch.bfloat16).float())
    t = order_noise(3, 64, "cpu", True, torch.Generator().manual_seed(seed),
                    dtype=torch.bfloat16)
    assert torch.equal(t * 128, torch.floor(t * 128))
    assert t.min() >= 0 and t.max() <= 127 / 128 and len(torch.unique(t)) > 32


def _jax_hlt(seed=0):
    cfg = JConfig(**SMALL)
    model = JPointMamba(cfg)
    variables = jax.jit(lambda key, x: model.init(key, x, train=False))(
        jax.random.key(seed), jnp.zeros((2, 256, 3)))
    port = PointMamba(PointMambaConfig(**SMALL))
    port.load_state_dict(state_dict_from_jax(variables["params"], variables["batch_stats"]),
                         strict=True)
    return cfg, model, variables, port.eval()


def test_hlt_classifier_logits_match_jax():
    """The JAX model in eval orders with ``jax.random.key(0)``'s uniform draw,
    the port's eval forward with its own copy of that draw (the centres'
    canvas equal to JAX's) and the sign-aligned eigenvectors. Logits to atol
    1e-3 max|logit|, rtol 2e-3 (the classifier's rule)."""
    jcfg, jmodel, variables, model = _jax_hlt()
    pts = _clouds(4, 256, seed=2)
    want_logits, want_feat = jax.jit(
        lambda v, x: jmodel.apply(v, x, train=False, return_features=True))(
        variables, jnp.asarray(pts))
    grouped = j_group_divider(jnp.asarray(pts), jcfg.num_group, jcfg.group_size)
    _, jeig = j_spectral_eigvecs(grouped.center, jcfg)
    jeig = np.asarray(jeig)
    key = jax.random.key(0)
    noise = torch.from_numpy(np.array(jax.random.uniform(key, (4, jcfg.num_group))))
    with torch.no_grad():
        tokens, pos, center = model.embed(torch.from_numpy(pts))
        _, eig = spectral_eigvecs(center, model.config)
        assert oracle.eig_cosines(eig, jeig).min() > 1 - 1e-4
        aligned = oracle.align_signs(eig, jeig)
        k = jcfg.k_top_eigenvectors
        np.testing.assert_array_equal(multilevel_codes(aligned, k).numpy(),
                                      np.asarray(j_multilevel_codes(jnp.asarray(jeig), k)))
        want_centres, _ = j_hlt_sequence(grouped.center, grouped.center, jnp.asarray(jeig), k, key)
        np.testing.assert_array_equal(hlt_sequence(aligned, k, noise, center)[0].numpy(),
                                      np.asarray(want_centres))
        x, pos_seq = model.sequence(tokens, pos, center, eigvecs=aligned)
        assert x.shape[1] == model.config.seq_len
        logits, feat = model.classify(x, pos_seq, return_features=True)
    scale = float(np.abs(want_logits).max())
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), atol=1e-3 * scale,
                               rtol=2e-3)
    np.testing.assert_allclose(feat.numpy(), np.asarray(want_feat), rtol=2e-3,
                               atol=1e-3 * float(np.abs(want_feat).max()))


def test_hlt_classifier_eval_repeats_and_trains():
    """An HLT eval forward draws its tie-break from a generator seeded 0, so
    it repeats; in training the draw follows the generator passed (the same
    seed, the same logits) and a forward without one raises."""
    model = PointMamba(PointMambaConfig(**{**SMALL, "depth": 1}))
    pts = torch.from_numpy(_clouds(2, 256, seed=3))
    with torch.no_grad():
        a, b = model.eval()(pts), model(pts)
        assert torch.equal(a, b) and torch.isfinite(a).all()
        model.train()
        t1 = model(pts, generator=torch.Generator().manual_seed(4))
        t2 = model(pts, generator=torch.Generator().manual_seed(4))
        assert torch.equal(t1, t2)
        with pytest.raises(ValueError, match="Generator"):
            model(pts)
