"""The classifier's permutation policy (the tau path) and the standalone ops
of the port against the JAX package on the CPU: ``plackett_luce_log_prob``,
``neural_sort_perm``, ``sinkhorn_perm_ift`` and its implicit-function
gradient, ``PermutePolicy`` (at tau 0 against JAX's, at tau > 0 by its
properties, and its policy gradient), and the wavelet transforms
``chebyshev_sgwt``, ``complex_meyer_sgwt`` and ``graph_scattering``. Small
sizes: d_model 32, G = 16, k = 2, 3 policy blocks. Each test states its
tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from si_mamba_tpu.models import permute_policy as jpp
from si_mamba_tpu.ops import sinkhorn as jsink
from si_mamba_tpu.ops import wavelets as jwave
from si_mamba_tpu_torch.models import permute_policy as ppp
from si_mamba_tpu_torch.ops import sinkhorn as psink
from si_mamba_tpu_torch.ops import wavelets as pwave
from si_mamba_tpu_torch.utils.weights import permute_policy_state_dict_from_jax

B, G, K, C = 2, 16, 2, 32


def _np(x):
    return np.array(x)  # a writable copy of a JAX array


def _t(x):
    return torch.from_numpy(_np(x))


def _normal(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _assert_close(got, want, rtol, atol_of_max=0.0):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=atol_of_max * float(np.abs(want).max()))


# ---------------------------------------------------------------------------
# the ops
# ---------------------------------------------------------------------------

def test_plackett_luce_log_prob_matches_jax():
    """rtol 1e-5 (atol 1e-6), on logits (3, 4, 16) and (5, 7)."""
    for shape, seed in (((3, 4, 16), 1), ((5, 7), 2)):
        x = _normal(shape, seed, 2.0)
        _assert_close(psink.plackett_luce_log_prob(_t(x)).numpy(),
                      jsink.plackett_luce_log_prob(jnp.asarray(x)), rtol=1e-5)
        np.testing.assert_allclose(
            psink.plackett_luce_log_prob(_t(x)).numpy(),
            np.sum(x - np.log(np.cumsum(np.exp(x[..., ::-1]), -1)[..., ::-1]), -1), rtol=1e-5)


@pytest.mark.parametrize("tau", [1.0, 0.3])
def test_neural_sort_perm_matches_jax(tau):
    """The straight-through matrix (the hard permutation's value, up to the
    rounding of P_hard + P_hat - P_hat) within 1e-6 and its row argmaxes
    equal, and the gradient of a weighted sum of it (the soft matrix's)
    within rtol 1e-5 (atol 1e-6 of its max)."""
    s = _normal((3, 12), 3)
    w = _normal((3, 12, 12), 4)
    want = _np(jsink.neural_sort_perm(jnp.asarray(s), tau))
    jgrad = _np(jax.grad(lambda v: jnp.sum(jsink.neural_sort_perm(v, tau) * w))(jnp.asarray(s)))
    st = _t(s).requires_grad_()
    got = psink.neural_sort_perm(st, tau)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got.detach().argmax(-1).numpy(), want.argmax(-1))
    assert sorted(want.argmax(-1)[0].tolist()) == list(range(12))
    (grad,) = torch.autograd.grad(torch.sum(got * _t(w)), st)
    _assert_close(grad.numpy(), jgrad, rtol=1e-5, atol_of_max=1e-6)


@pytest.mark.parametrize("tau,n_iters", [(1.0, 20), (0.5, 40)])
def test_sinkhorn_perm_ift_and_its_gradient_match_jax(tau, n_iters):
    """P within rtol 1e-5 (atol 1e-6) of JAX's; the gradient of a weighted
    sum of P through the implicit-function backward within rtol 1e-4 (atol
    1e-4 of its max) of JAX's custom VJP, and within 1e-3 of its max of the
    plain reverse mode through many more unrolled iterations (the fixed
    point the IFT differentiates)."""
    Cm = np.abs(_normal((2, 8, 8), 5))
    w = _normal((2, 8, 8), 6)
    want = _np(jsink.sinkhorn_perm_ift(jnp.asarray(Cm), tau, n_iters))
    jgrad = _np(jax.grad(lambda c: jnp.sum(jsink.sinkhorn_perm_ift(c, tau, n_iters) * w))(
        jnp.asarray(Cm)))
    ct = _t(Cm).requires_grad_()
    got = psink.sinkhorn_perm_ift(ct, tau, n_iters)
    _assert_close(got.detach().numpy(), want, rtol=1e-5, atol_of_max=1e-6)
    (grad,) = torch.autograd.grad(torch.sum(got * _t(w)), ct)
    _assert_close(grad.numpy(), jgrad, rtol=1e-4, atol_of_max=1e-4)

    unrolled = _t(Cm).double().requires_grad_()
    K = torch.exp(-unrolled / tau)
    u = v = torch.full((2, 8), 1 / 8, dtype=torch.float64)
    for _ in range(500):
        u = 1 / torch.einsum("...ij,...j->...i", K, v)
        v = 1 / torch.einsum("...ji,...j->...i", K, u)
    (ref,) = torch.autograd.grad(torch.sum(u[..., :, None] * K * v[..., None, :] * _t(w)),
                                 unrolled)
    _assert_close(grad.double().numpy(), ref.numpy(), rtol=0, atol_of_max=1e-3)


def _laplacian(seed, n=12):
    """A random-walk Laplacian of a symmetric kNN-like graph (spectrum in
    [0, 2])."""
    rng = np.random.default_rng(seed)
    A = (rng.random((B, n, n)) < 0.3).astype(np.float32)
    A = np.maximum(A, A.transpose(0, 2, 1))
    A[:, np.arange(n), np.arange(n)] = 0
    A[:, np.arange(n), (np.arange(n) + 1) % n] = 1  # a ring keeps every degree above 0
    A[:, (np.arange(n) + 1) % n, np.arange(n)] = 1
    return (np.eye(n, dtype=np.float32) - A / A.sum(-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("kw", [dict(), dict(tight_frame=False, scales=[0.5, 1.0, 2.0]),
                                dict(K=10, J=2)], ids=["meyer", "heat", "K10-J2"])
def test_chebyshev_sgwt_matches_jax(kw):
    """Within rtol 1e-5 (atol 1e-5 of the max coefficient)."""
    x, L = _normal((B, 12, 3), 7), _laplacian(8)
    want = _np(jwave.chebyshev_sgwt(jnp.asarray(x), jnp.asarray(L), **kw))
    got = pwave.chebyshev_sgwt(_t(x), _t(L), **kw).numpy()
    assert got.shape == want.shape
    _assert_close(got, want, rtol=1e-5, atol_of_max=1e-5)


@pytest.mark.parametrize("kw", [dict(), dict(use_delta=True, jackson=True),
                                dict(use_complex=False, J=2, K=12)],
                         ids=["complex", "delta-jackson", "real"])
def test_complex_meyer_sgwt_matches_jax(kw):
    """Complex64 (or real) bands within rtol 1e-5 (atol 1e-5 of the max
    modulus); the delta band's eigenvalues from ``eigvalsh``."""
    x, L = _normal((B, 12, 3), 9), _laplacian(10)
    want = _np(jwave.complex_meyer_sgwt(jnp.asarray(x), jnp.asarray(L), **kw))
    got = pwave.complex_meyer_sgwt(_t(x), _t(L), **kw).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    _assert_close(got, want, rtol=1e-5, atol_of_max=1e-5)


@pytest.mark.parametrize("level", [1, 2])
def test_graph_scattering_matches_jax(level):
    """Over the Chebyshev SGWT (J = 3: S0, three first-order and three
    second-order paths at level 2) and over the complex Meyer SGWT with its
    delta band (complex S0, the moduli promoted): within rtol 1e-5 (atol 1e-5
    of the max)."""
    x, L = _normal((B, 12, 2), 11), _laplacian(12)
    for jfn, pfn in (
            (lambda a, l: jnp.swapaxes(jwave.chebyshev_sgwt(a, l, K=12, J=3).reshape(
                *a.shape[:2], 4, a.shape[2]), -1, -2),
             lambda a, l: pwave.chebyshev_sgwt(a, l, K=12, J=3).reshape(
                *a.shape[:2], 4, a.shape[2]).transpose(-1, -2)),
            (lambda a, l: jwave.complex_meyer_sgwt(a, l, J=2, K=12, use_delta=True),
             lambda a, l: pwave.complex_meyer_sgwt(a, l, J=2, K=12, use_delta=True))):
        want = _np(jwave.graph_scattering(jnp.asarray(x), jnp.asarray(L), jfn, level=level))
        got = pwave.graph_scattering(_t(x), _t(L), pfn, level=level).numpy()
        assert got.shape == want.shape and got.dtype == want.dtype
        _assert_close(got, want, rtol=1e-5, atol_of_max=1e-5)


# ---------------------------------------------------------------------------
# the policy
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def policies():
    """The JAX policy (init key 0) and the port's, loaded with its weights."""
    jm = jpp.PermutePolicy(trans_dim=C, num_group=G, k_top_eigenvectors=K)
    args = _inputs()
    variables = jm.init({"params": jax.random.key(0), "policy": jax.random.key(1)},
                        *map(jnp.asarray, args), 0.0)
    port = ppp.PermutePolicy(C, G, K)
    port.load_state_dict(permute_policy_state_dict_from_jax(variables["params"]), strict=True)
    return jm, variables, port


def _inputs(seed=0):
    """tokens_seq, pos_seq (B, 2kG, C), eigvals (B, k), eigvecs (B, G, k)
    with no ties."""
    return (_normal((B, 2 * K * G, C), seed), _normal((B, 2 * K * G, C), seed + 1),
            np.sort(np.abs(_normal((B, K), seed + 2)), -1), _normal((B, G, K), seed + 3, 0.3))


def test_policy_at_tau_zero_matches_jax(policies):
    """At tau 0 the permutation is the argsort of the logits: perm equal to
    JAX's, and to the stable argsort of the port's inner logits offset by the
    outer order; the policy within rtol 2e-3 (atol 1e-3 of its max), the
    composed-logit tolerance."""
    jm, variables, port = policies
    args = _inputs(3)
    jperm, jpolicy = jm.apply(variables, *map(jnp.asarray, args), 0.0,
                              rngs={"policy": jax.random.key(5)})
    with torch.no_grad():
        perm, policy = port(*map(_t, args), 0.0, generator=torch.Generator().manual_seed(0))
        inner, outer = port.logits(*map(_t, args))
    np.testing.assert_array_equal(perm.numpy(), _np(jperm))
    order = torch.argsort(outer, dim=-1, stable=True)
    want = (torch.argsort(inner, dim=-1, stable=True) + order[..., None] * G).reshape(B, K * G)
    assert torch.equal(perm, want)
    _assert_close(policy.numpy(), jpolicy, rtol=2e-3, atol_of_max=1e-3)


def test_policy_at_positive_tau_by_its_properties(policies):
    """At tau 1: each traversal's indices a permutation of one block of G
    (the blocks a permutation of the traversals), a draw from the generator
    repeats with its seed and an injected uniform draw gives the Gumbel
    noise's order; the policy equal (rtol 1e-6) to ``plackett_luce_log_prob``
    of the logits taken in the drawn order; its gradient reaches the policy
    stack and the heads (every ``logit_blocks`` mixer weight and every head
    weight nonzero; the heads' last biases shift all logits of a ranking
    alike, which Plackett-Luce does not see) and not the detached sequence."""
    _, _, port = policies
    tok, pos, vals, vecs = map(_t, _inputs(4))
    tok.requires_grad_()
    perm, policy = port(tok, pos, vals, vecs, 1.0, generator=torch.Generator().manual_seed(2))
    again, _ = port(tok, pos, vals, vecs, 1.0, generator=torch.Generator().manual_seed(2))
    assert torch.equal(perm, again)
    blocks = perm.reshape(B, K, G)
    for b in range(B):
        starts = sorted(int(blk.min()) for blk in blocks[b])
        assert starts == [j * G for j in range(K)]
        for blk in blocks[b]:
            assert sorted(blk.tolist()) == list(range(int(blk.min()), int(blk.min()) + G))
    inner, outer = port.logits(tok, pos, vals, vecs)
    li = torch.gather(inner.reshape(B, K * G), 1, perm).reshape(B, K, G)
    lo = torch.gather(outer, 1, blocks[..., 0] // G)
    want = psink.plackett_luce_log_prob(li).sum(1) + psink.plackett_luce_log_prob(lo)
    torch.testing.assert_close(policy, want, rtol=1e-6, atol=0)

    u_in = torch.rand(B * K, G, generator=torch.Generator().manual_seed(3))
    u_out = torch.rand(B, K, generator=torch.Generator().manual_seed(4))
    drawn, _ = port(tok, pos, vals, vecs, 1.0, gumbel_uniform=(u_in, u_out))
    eps = torch.finfo(torch.float32).eps
    gumbel = -torch.log(-torch.log(u_in + eps) + eps)
    pi = torch.argsort(inner.reshape(B * K, G) + gumbel, dim=-1, stable=True).reshape(B, K, G)
    assert torch.equal(drawn.reshape(B, K, G) - pi, (drawn.reshape(B, K, G) // G) * G)

    port.zero_grad()
    policy.sum().backward()
    assert tok.grad is None
    for name, p in port.named_parameters():
        if name.endswith("weight") and (".mixer." in name or name.startswith("logit_head")):
            assert p.grad is not None and p.grad.abs().max() > 0, name
