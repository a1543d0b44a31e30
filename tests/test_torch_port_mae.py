"""The port's MAE pretraining slice against the JAX package on the CPU: the
Chamfer losses, the Sinkhorn sort and its roundings, the Jacobi eigensolver,
the diffusion-wavelet bases and the learned SGWT, ``PointMAEMamba`` (both
mixers: eval loss, noaug features, whole-path orders, two train steps with
JAX's draws replayed), the tau schedule, the on-device SVM probe against
sklearn's ``SVC(C=0.01, kernel='linear')``, and the pretrain CLI on the CPU
with its checkpoint taken up by the finetune CLI. Small sizes: depth 2,
decoder 1, d_model 32, G = 16 groups of 16, K = 2, N = 256. Each test states
its tolerance."""

import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from si_mamba_tpu.models import grouping as jgrouping
from si_mamba_tpu.models import point_mae as jmae
from si_mamba_tpu.ops import chamfer as jchamfer
from si_mamba_tpu.ops import graph as jgraph
from si_mamba_tpu.ops import jacobi as jjacobi
from si_mamba_tpu.ops import sinkhorn as jsink
from si_mamba_tpu.ops import wavelets as jwave
from si_mamba_tpu.train import optim as joptim
from si_mamba_tpu.train import runner_pretrain as jrp
from si_mamba_tpu.train.train_state import TrainState as JTrainState
from si_mamba_tpu_torch.models import point_mae as pmae
from si_mamba_tpu_torch.ops import chamfer as pchamfer
from si_mamba_tpu_torch.ops import graph as pgraph
from si_mamba_tpu_torch.ops import jacobi as pjacobi
from si_mamba_tpu_torch.ops import sinkhorn as psink
from si_mamba_tpu_torch.ops import wavelets as pwave
from si_mamba_tpu_torch.train import checkpoint as pckpt
from si_mamba_tpu_torch.train import cli
from si_mamba_tpu_torch.train import optim
from si_mamba_tpu_torch.train import runner_finetune as prf
from si_mamba_tpu_torch.train import runner_pretrain as prp
from si_mamba_tpu_torch.train import svm
from si_mamba_tpu_torch.train.train_state import TrainState
from si_mamba_tpu_torch.utils.weights import point_mae_state_dict_from_jax

ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(trans_dim=32, encoder_dims=32, depth=2, decoder_depth=1, group_size=16,
             num_group=16, knn_graph=4, k_top_eigenvectors=2, drop_path_rate=0.0)
MIXERS = {"mamba": {}, "ssd": dict(mixer="ssd", ssd_chunk=64, scan_impl="xla")}
# The whole-path clouds: the first seed of 0..19 whose JAX Sinkhorn matrices
# have no near-tie in the greedy rounding (each row's best free entry above
# the next by at least ORDER_MARGIN of itself). At random weights the scores
# spread little against epsilon = 0.05, so P_hat is nearly flat and most
# seeds hold a tie within 1e-5; the two frameworks' P_hat differ by ~1e-7.
ORDER_SEED, ORDER_MARGIN = 19, 1e-4
LR, WD, CLIP, EPOCHS, TAU = 1e-3, 0.05, 10.0, 10, 0.5
# the patch encoder's biases whose every path ends in a BatchNorm (first_conv.3's
# shifts each point's feature and their max alike, which second_conv.0 maps to
# a per-channel constant): the normalisation takes out their effect, so their
# gradients are rounding noise of either sign
NOISE_BIASES = {f"MAE_encoder.encoder.{k}.bias" for k in
                ("first_conv.0", "first_conv.3", "second_conv.0")}


def _np(x):
    return np.array(x)  # a writable copy of a JAX array


def _t(x):
    return torch.from_numpy(_np(x))


def _clouds(b, n, seed):
    return np.random.default_rng(seed).standard_normal((b, n, 3)).astype(np.float32)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The tensors here are tiny, and the suite runs one worker a core: more
    than one intra-op thread a worker only contends for the cores (the SMO's
    and the Jacobi rounds' thousands of small ops most of all)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_models():
    """Each mixer's JAX model and its variables (init key 0)."""
    out = {}
    for name, extra in MIXERS.items():
        model = jmae.PointMAEMamba(jmae.PointMAEConfig(**SMALL, **extra))
        variables = jax.jit(lambda k, m=model: m.init({"params": k, "mask": k, "gumbel": k},
                                                      jnp.zeros((2, 256, 3)), train=False))(
            jax.random.key(0))
        out[name] = (model, dict(variables))
    return out


def _port(mixer, variables):
    model = pmae.PointMAEMamba(pmae.PointMAEConfig(**SMALL, **MIXERS[mixer]))
    model.load_state_dict(point_mae_state_dict_from_jax(variables["params"],
                                                        variables["batch_stats"]), strict=True)
    return model


# ---------------------------------------------------------------------------
# the ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["chamfer_l2", "chamfer_l1"])
def test_chamfer_matches_jax(name):
    """Per-cloud and batch-mean Chamfer, rtol 1e-6."""
    x, y = _clouds(5, 16, 1), _clouds(5, 20, 2)
    for red in ("mean", None):
        want = _np(getattr(jchamfer, name)(jnp.asarray(x), jnp.asarray(y), batch_reduction=red))
        got = getattr(pchamfer, name)(_t(x), _t(y), batch_reduction=red).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("target", ["sorted", "self"])
def test_sinkhorn_soft_perm_and_its_gradient_match_jax(target):
    """P_hat within 1e-5; the gradient of a weighted sum of P_hat through the
    checkpointed iterations within 1e-5 of its largest (JAX's scan of
    checkpointed bodies), and equal to the unchecked reverse mode's."""
    s = np.random.default_rng(3).standard_normal((2, 3, 12)).astype(np.float32) * 0.3
    w = np.random.default_rng(4).standard_normal((2, 3, 12, 12)).astype(np.float32)
    want = _np(jsink.sinkhorn_soft_perm(jnp.asarray(s), target=target))
    jgrad = _np(jax.grad(lambda v: jnp.sum(jsink.sinkhorn_soft_perm(v, target=target) * w))(
        jnp.asarray(s)))
    st = _t(s).requires_grad_()
    got = psink.sinkhorn_soft_perm(st, target=target)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5)
    (grad,) = torch.autograd.grad(torch.sum(got * _t(w)), st)
    scale = np.abs(jgrad).max()
    np.testing.assert_allclose(grad.numpy(), jgrad, atol=1e-5 * scale)
    plain = _t(s).requires_grad_()  # the same iterations without checkpoints
    logK = -((torch.sort(plain, -1).values if target == "sorted" else plain)[..., :, None]
             - plain[..., None, :]) ** 2 / 0.05
    f, g = torch.zeros_like(plain), torch.zeros_like(plain)
    for _ in range(40):
        f, g = psink._iteration(f, g, logK, -math.log(12))
    ref = torch.exp(f[..., :, None] + logK + g[..., None, :])
    (ref_grad,) = torch.autograd.grad(torch.sum(ref * _t(w)), plain)
    torch.testing.assert_close(grad, ref_grad, rtol=0, atol=0)


@pytest.mark.parametrize("rounding", ["greedy", "hungarian"])
def test_roundings_equal_jax(rounding):
    """Hard permutations equal, on matrices with ties (a duplicated row, a
    duplicated column: the first index wins in both) and without."""
    rng = np.random.default_rng(5)
    P = rng.random((3, 2, 9, 9)).astype(np.float32)
    P[0, 0, 4] = P[0, 0, 2]
    P[1, 1, :, 7] = P[1, 1, :, 3]
    fn = {"greedy": (jsink.greedy_round, psink.greedy_round),
          "hungarian": (jsink.hungarian_round, psink.hungarian_round)}[rounding]
    want = _np(fn[0](jnp.asarray(P)))
    got = fn[1](_t(P)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got.sum(-1) == 1).all() and (got.sum(-2) == 1).all()
    Pb, Ph = psink.sinkhorn_sort_perm(_t(P[..., 0]), rounding=rounding)
    Pj, Phj = jsink.sinkhorn_sort_perm(jnp.asarray(P[..., 0]), rounding=rounding)
    np.testing.assert_array_equal(Pb.argmax(-1).numpy(), _np(jnp.argmax(Pj, -1)))


@pytest.mark.parametrize("n", [8, 15, 32])
def test_jacobi_eigh_matches_jax(n):
    """On symmetric matrices of spectral radius 1: eigenvalues (ascending)
    within 1e-5 of JAX's and of ``eigh``'s;
    eigenvectors within 1e-4 of JAX's after aligning each column's sign (the
    spectrum of a random symmetric matrix has no near-degenerate pair at
    these seeds); odd n through the padded path."""
    a = np.random.default_rng(n).standard_normal((3, n, n))
    a = a + a.transpose(0, 2, 1)
    # spectra in [-1, 1], as the Gram matrices of the bases have theirs in [0, 1]
    a = (a / np.abs(np.linalg.eigvalsh(a)).max(axis=1)[:, None, None]).astype(np.float32)
    jv, jV = (_np(x) for x in jjacobi.jacobi_eigh(jnp.asarray(a)))
    v, V = (x.numpy() for x in pjacobi.jacobi_eigh(_t(a)))
    np.testing.assert_allclose(v, jv, atol=1e-5)
    np.testing.assert_allclose(v, np.linalg.eigvalsh(a.astype(np.float64)), atol=1e-5)
    sign = np.sign(np.sum(V * jV, axis=1, keepdims=True))
    np.testing.assert_allclose(V * sign, jV, atol=1e-4)
    with pytest.raises(ValueError, match="n=128"):
        pjacobi.jacobi_eigh(torch.zeros(1, 130, 130))


def _laplacian(center, knn=4):
    A = jgraph.knn_adjacency(jnp.asarray(center), k=knn, alpha=10.0, symmetric=True,
                             binary=True)
    return _np(jgraph.rw_laplacian(A, eps=1e-6, eps_mode="clamp"))


def test_graph_and_expm_match_jax():
    """The binary kNN graph and its random-walk Laplacian equal to JAX's, the
    ``gaussian_sigma`` weights within rtol 1e-6, and the Taylor ``expm``
    within 1e-6 of JAX's and of ``matrix_exp``."""
    c = _clouds(2, 16, 6)
    for kw in (dict(binary=True), dict(binary=False, alpha=0.0, gaussian_sigma=True)):
        want = _np(jgraph.knn_adjacency(jnp.asarray(c), k=4, symmetric=True, **kw))
        got = pgraph.knn_adjacency(_t(c), 4, symmetric=True, **kw).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0 if kw["binary"] else 1e-7)
    L = _laplacian(c)
    got_L = pgraph.rw_laplacian(pgraph.knn_adjacency(_t(c), 4, 10.0, True, False, True),
                                1e-6, "clamp").numpy()
    np.testing.assert_array_equal(got_L, L)
    for scale in (0.35, 1.4):
        want = _np(jwave._expm_neg_psd(jnp.asarray(L), scale))
        got = pwave._expm_neg_psd(_t(L), scale)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
        np.testing.assert_allclose(got.numpy(), torch.linalg.matrix_exp(-scale * _t(L)).numpy(),
                                   atol=1e-6)




# The bases' seeds, by a rule each run re-checks: clouds whose wavelet
# complements W_j (j >= 1, before their QR) are well conditioned (the
# smallest |diag R| of each one's QR at least 1e-2: a nearly nested pair of
# spans leaves trailing columns of Q that follow rounding noise), and whose
# Gram spectra have a relative gap of at least 2 % at every rank cut
# (lambda_k >= 1.02 lambda_(k+1): the 'subspace' solver converges as
# (lambda_(k+1) / lambda_k)^iterations, and below that its span follows
# rounding; at seed 5, gap 1.1 %, its projections differ by 0.47 between the
# two frameworks). Of seeds 0..11, 0, 1, 2, 6, 7, 9, 10 and 11 pass.
BASES_SEEDS = (6, 7, 9)


def _gram_gaps(L: torch.Tensor, J: int = 3) -> list[float]:
    """The smallest lambda_k / lambda_(k+1) of each scale's Gram matrix."""
    L = L.double()
    V = pwave.scaling_bases(L, J, "eigh")
    gaps = []
    for j in range(1, J + 1):
        k = max(1, -(-L.shape[-1] // (1 << j)))
        M = torch.linalg.matrix_exp(-(math.log(2) / 2) * 2 ** (j - 1) * L) @ V[j - 1]
        ev = torch.linalg.eigvalsh(M.transpose(-1, -2) @ M).flip(-1)
        gaps.append(float((ev[:, k - 1] / ev[:, k]).min()))
    return gaps


@pytest.mark.parametrize("solver", ["eigh", "jacobi", "subspace"])
def test_wavelet_projections_match_jax(solver):
    """Each of the J + 1 projections V_J V_J^T, W_j W_j^T (sign- and
    basis-free) within 1e-4 of JAX's, on the seeds of the rule above (their
    clouds as one batch)."""
    L = np.concatenate([_laplacian(_clouds(2, 16, seed)) for seed in BASES_SEEDS])
    comp = pwave.wavelet_complements(pwave.scaling_bases(_t(L), 3, solver))
    for w in comp[1:]:
        assert torch.diagonal(torch.linalg.qr(w).R, dim1=-2, dim2=-1).abs().min() >= 1e-2
    assert min(_gram_gaps(_t(L))) >= 1.02
    got = pwave.wavelet_projections(_t(L), 3, solver).numpy()
    W, VJ = jwave.diffusion_wavelet_bases(jnp.asarray(L), 3, solver=solver)
    want = np.stack([_np(VJ @ jnp.swapaxes(VJ, -1, -2))]
                    + [_np(w @ jnp.swapaxes(w, -1, -2)) for w in W], axis=1)
    assert got.shape == want.shape == (6, 4, 16, 16)
    np.testing.assert_allclose(got, want, atol=1e-4)
    np.testing.assert_allclose(got[:, 1], np.broadcast_to(np.eye(16), (6, 16, 16)),
                               atol=1e-5)  # W_0 is square: its projection is I


def test_sgwt_and_scale_scores_match_jax(jax_models):
    """The learned SGWT with the JAX model's weights carried, on JAX's own
    projections (so the bases' LAPACK does not enter): deterministic and
    with the Gumbel noise of the same uniforms at tau 0.5, coefficients
    within 1e-5 of their max; the per-traversal scores likewise."""
    _, variables = jax_models["mamba"]
    center = _clouds(2, 16, 7)
    L = _laplacian(center)
    jmod = jwave.DiffusionWaveletSGWT(J=3, in_features=3)
    sg = {"params": variables["params"]["diff_sgwt"]}
    model = _port("mamba", variables)
    W, VJ = jwave.diffusion_wavelet_bases(jnp.asarray(L), 3)
    PJ = torch.from_numpy(np.stack([_np(VJ @ jnp.swapaxes(VJ, -1, -2))]
                                   + [_np(w @ jnp.swapaxes(w, -1, -2)) for w in W], axis=1))
    for train in (False, True):
        key = jax.random.key(11)
        want = _np(jmod.apply(sg, jnp.asarray(center), jnp.asarray(L), tau=0.5,
                              deterministic=not train, rngs={"gumbel": key}))
        u = _np(jax.random.uniform(jmod.apply(sg, method=lambda m: m.make_rng("gumbel"),
                                              rngs={"gumbel": key}), want.shape))
        with torch.no_grad():
            got = model.diff_sgwt(_t(center), PJ, tau=0.5, deterministic=not train,
                                  gumbel_uniform=torch.from_numpy(u))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5 * np.abs(want).max())
        np.testing.assert_allclose(pwave.scale_scores(got, k=2).numpy(),
                                   _np(jwave.scale_scores(jnp.asarray(want), k=2)),
                                   atol=1e-5 * np.abs(want).max())


def test_masks_and_token_restoration_equal_jax():
    """random_mask from the same uniforms, block_mask from the same seed
    group, restore_tokens and select_by_rank: equal."""
    u = jax.random.uniform(jax.random.key(3), (3, 16))
    np.testing.assert_array_equal(pmae.random_mask(3, 16, 9, uniform_draw=_t(u)).numpy(),
                                  _np(jmae.random_mask(jax.random.key(3), 3, 16, 9)))
    center = _clouds(3, 16, 2)
    seed = _np(jax.random.randint(jax.random.key(4), (3,), 0, 16))
    np.testing.assert_array_equal(
        pmae.block_mask(_t(center), 9, seed=torch.from_numpy(seed)).numpy(),
        _np(jmae.block_mask(jax.random.key(4), jnp.asarray(center), 9)))
    m = _np(jmae.random_mask(jax.random.key(5), 3, 16, 9))
    vis = _clouds(3, 7, 8)
    mt = _clouds(3, 9, 9)
    np.testing.assert_array_equal(
        pmae.restore_tokens(_t(m), _t(vis), _t(mt)).numpy(),
        _np(jmae.restore_tokens(jnp.asarray(m), jnp.asarray(vis), jnp.asarray(mt))))
    x = _clouds(3, 16, 10)
    for masked, count in ((True, 9), (False, 7)):
        np.testing.assert_array_equal(
            pmae.select_by_rank(_t(x), _t(m), count, masked).numpy(),
            _np(jmae.select_by_rank(jnp.asarray(x), jnp.asarray(m), count, masked)))


def test_tau_schedule_equals_jax():
    for epoch in (-1, 0, 1, 7, 20, 21, 150, 299, 300):
        for total in (300, 1):
            assert prp.tau_schedule(epoch, total_epochs=total) == jrp.tau_schedule(
                epoch, total_epochs=total)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _margin(P):
    """The smallest relative gap between the best and the second-best free
    entry over the greedy rounding's rows (the last row has one choice)."""
    P = P.reshape(-1, P.shape[-2], P.shape[-1])
    out = np.inf
    for p in P:
        free = np.ones(p.shape[-1], bool)
        for i in range(p.shape[0] - 1):
            row = np.where(free, p[i], -np.inf)
            top = np.sort(row)[::-1]
            out = min(out, (top[0] - top[1]) / top[0])
            free[np.argmax(row)] = False
    return out


@pytest.mark.parametrize("mixer", list(MIXERS))
def test_mae_eval_loss_and_features_match_jax(jax_models, mixer):
    """With JAX's weights carried: the eval loss with the same
    ``mask_override`` and ``orders_override`` within rtol 1e-5; then the
    whole path (the orders computed, the mask of ``jax.random.key(0)``) on
    the clouds of ORDER_SEED: the JAX Sinkhorn matrices clear of near-ties
    (smallest greedy margin >= ORDER_MARGIN), P_hat within 1e-6, the port's
    orders equal to JAX's, the eval loss within rtol 1e-5 and the noaug
    features within 1e-4 of their max."""
    jm, variables = jax_models[mixer]
    model = _port(mixer, variables).eval()
    rng = np.random.default_rng(1)
    pts = _clouds(2, 256, 3)
    mask = np.zeros((2, 16), np.float32)
    for b in range(2):
        mask[b, rng.permutation(16)[:9]] = 1
    orders = np.stack([np.stack([rng.permutation(16) for _ in range(2)]) for _ in range(2)])
    want = float(jax.jit(lambda v, p, m, o: jm.apply(v, p, train=False, mask_override=m,
                                                      orders_override=o))(
        variables, jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(orders)))
    with torch.no_grad():
        got = float(model(_t(pts), mask_override=_t(mask),
                          orders_override=torch.from_numpy(orders)))
    np.testing.assert_allclose(got, want, rtol=1e-5)

    pts = _clouds(2, 256, ORDER_SEED)
    g = jgrouping.group_divider(jnp.asarray(pts), 16, 16)
    coeffs = jwave.DiffusionWaveletSGWT(J=3, in_features=3).apply(
        {"params": variables["params"]["diff_sgwt"]}, g.center,
        jnp.asarray(_laplacian(_np(g.center))), tau=None, deterministic=True)
    P, P_hat = jsink.sinkhorn_sort_perm(jnp.swapaxes(jwave.scale_scores(coeffs, k=2), 1, 2))
    assert _margin(_np(P_hat)) >= ORDER_MARGIN
    with torch.no_grad():
        grouped = model.group(_t(pts))
        order_idx, got_P_hat = model.orders(grouped.center)
    np.testing.assert_allclose(got_P_hat.numpy(), _np(P_hat), atol=1e-6)
    np.testing.assert_array_equal(order_idx.numpy(), _np(jnp.argmax(P, -1)))
    want = float(jax.jit(lambda v, p: jm.apply(v, p, train=False))(variables, jnp.asarray(pts)))
    jfeat = _np(jax.jit(lambda v, p: jm.apply(v, p, train=False, noaug=True))(
        variables, jnp.asarray(pts)))
    with torch.no_grad():
        got = float(model(_t(pts)))
        feat = model(_t(pts), noaug=True).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert feat.shape == jfeat.shape == (2, 2 * 2 * 16, 32)
    np.testing.assert_allclose(feat, jfeat, atol=1e-4 * np.abs(jfeat).max())


def _port_in_state(mixer, jstate):
    """The port's model, optimizer and train state in JAX's train state:
    weights, BatchNorm statistics, the update count and Adam's moments."""
    model = _port(mixer, {"params": jstate.params, "batch_stats": jstate.batch_stats})
    optimizer, _ = optim.build_optimizer(model, lr=LR, weight_decay=WD, epochs=EPOCHS,
                                         warmup_epochs=0, steps_per_epoch=1, grad_clip=CLIP)
    count = int(jstate.step)
    if count:
        (adam,) = [s for s in jax.tree_util.tree_leaves(
            jstate.opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
            if isinstance(s, optax.ScaleByAdamState)]
        mu = point_mae_state_dict_from_jax(adam.mu, jstate.batch_stats)
        nu = point_mae_state_dict_from_jax(adam.nu, jstate.batch_stats)
        for name, p in model.named_parameters():
            optimizer.torch_optimizer.state[p] = {"step": torch.tensor(float(count)),
                                                  "exp_avg": mu[name], "exp_avg_sq": nu[name]}
        optimizer.count = count
    return model, TrainState(step=count, model=model, optimizer=optimizer)


def _state(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()
            if "num_batches_tracked" not in k}


@pytest.mark.parametrize("mixer", list(MIXERS))
def test_pretrain_steps_match_jax(jax_models, monkeypatch, mixer):
    """Two steps of ``make_pretrain_step`` against JAX's (drop_path 0, tau
    0.5, AdamW at lr 1e-3, clip 10), each step's draws (the scale and shift,
    the Gumbel noise, the mask) recorded from JAX's and replayed: run on from
    the same weights the losses agree within rtol 1e-5; each step, started
    from JAX's state before it, moves every parameter (``diff_sgwt`` and
    ``mask_token`` among them) as JAX's does, each leaf's update within 1e-3
    of JAX's in L2 norm plus two ulps of the parameter (the three biases that only feed BatchNorms, whose
    gradients are rounding noise, elementwise within 2 lr), and the
    BatchNorm statistics to JAX's within 1e-5 (rtol; atol 1e-7)."""
    jm, variables = jax_models[mixer]
    pts = _clouds(2, 256, 21)
    tx, schedule = joptim.build_optimizer(variables["params"], lr=LR, weight_decay=WD,
                                          epochs=EPOCHS, warmup_epochs=0, steps_per_epoch=1,
                                          grad_clip=CLIP)
    state = JTrainState.create(variables["params"], variables["batch_stats"], tx)
    rng = jax.random.key(9)
    jstep = jax.jit(jrp.make_pretrain_step(jm))
    real_uniform, drawn = jax.random.uniform, []
    # the shapes of the step's draws: the scale and the shift, the mask, the
    # Gumbel noise (flax's initialisers, which it traces to check parameter
    # shapes, draw others)
    shapes = {(2, 1, 3), (2, 16), (2, 16, 1, 4)}

    def recording_uniform(key, shape=(), *a, **k):
        if tuple(shape) in shapes:
            drawn.append(real_uniform(key, shape))
        return real_uniform(key, shape, *a, **k)

    def draws(state, s):
        """The step's uniforms as its forward draws them: JAX's step with
        the recording ``uniform``."""
        drawn.clear()
        jrp.make_pretrain_step(jm)(state, jnp.asarray(pts), rng, TAU)
        return list(drawn)

    with monkeypatch.context() as mp:
        mp.setattr(jax.random, "uniform", recording_uniform)
        replay = jax.jit(draws, static_argnums=1)
        steps = []
        for s in range(2):
            u = [torch.from_numpy(_np(x)) for x in replay(state, s)]
            before = state
            state, m = jstep(state, jnp.asarray(pts), rng, TAU)
            by_shape = {tuple(x.shape): x for x in u[2:]}
            steps.append((before, dict(aug_uniform=(u[0], u[1]),
                                       mask_uniform=by_shape[(2, 16)],
                                       gumbel_uniform=by_shape[(2, 16, 1, 4)]),
                          float(m["loss"])))
    assert len(u) == 4 and tuple(u[0].shape) == tuple(u[1].shape) == (2, 1, 3)
    states = [s[0] for s in steps] + [state]

    model, pstate = _port_in_state(mixer, states[0])
    step = prp.make_pretrain_step(model)
    for _, d, jloss in steps:
        pstate, m = step(pstate, _t(pts), None, TAU, **d)
        np.testing.assert_allclose(float(m["loss"]), jloss, rtol=1e-5)
    assert pstate.step == 2

    for s, (before, d, jloss) in enumerate(steps):
        model, pstate = _port_in_state(mixer, before)
        start = _state(model)
        want = point_mae_state_dict_from_jax(states[s + 1].params, states[s + 1].batch_stats)
        pstate, m = prp.make_pretrain_step(model)(pstate, _t(pts), None, TAU, **d)
        np.testing.assert_allclose(float(m["loss"]), jloss, rtol=1e-5)
        lr = float(schedule(s))
        after = _state(model)
        for name, _ in model.named_parameters():
            got, ref = after[name] - start[name], want[name] - start[name]
            assert float(ref.norm()) > 0, name
            err = float((got - ref).norm())
            if name in NOISE_BIASES:  # Adam moves each element by at most about lr
                assert float((got - ref).abs().max()) <= 2.02 * lr, name
            else:  # plus two ulps of the parameter, the resolution of after - before
                ulp = float(np.linalg.norm(np.spacing(np.abs(start[name].numpy()))))
                assert err <= 1e-3 * float(ref.norm()) + 2 * ulp, \
                    f"{name}: {err:.3g} of {float(ref.norm()):.3g}"
        for k in after:
            if "running_" in k:
                assert not torch.equal(after[k], start[k]), k
                np.testing.assert_allclose(after[k].numpy(), want[k].numpy(), rtol=1e-5,
                                           atol=1e-7, err_msg=k)


# ---------------------------------------------------------------------------
# the SVM probe and the CLI
# ---------------------------------------------------------------------------

def test_svm_matches_sklearn():
    """40 classes of seeded 64-d features (480 train, 400 test): the decision
    values of every class pair within 5e-3 of sklearn's ``SVC(C=0.01,
    kernel='linear', decision_function_shape='ovo')`` (libsvm stops at a KKT
    tolerance of 1e-3, from other iterates), predictions equal on at least
    99 % and the accuracy within 0.5 points."""
    from sklearn.svm import SVC

    rng = np.random.default_rng(0)
    centers = rng.standard_normal((40, 64))
    ytr, yte = rng.integers(0, 40, 480), rng.integers(0, 40, 400)
    xtr = (centers[ytr] * 0.6 + rng.standard_normal((480, 64))).astype(np.float32)
    xte = (centers[yte] * 0.6 + rng.standard_normal((400, 64))).astype(np.float32)
    clf = SVC(C=0.01, kernel="linear", decision_function_shape="ovo").fit(xtr, ytr)
    model = svm.fit_ovo(torch.from_numpy(xtr), torch.from_numpy(ytr))
    dec = svm.decision_function(model, torch.from_numpy(xte)).numpy()
    np.testing.assert_allclose(dec, clf.decision_function(xte), atol=5e-3)
    pred = svm.predict(model, torch.from_numpy(xte)).numpy()
    assert np.mean(pred == clf.predict(xte)) >= 0.99
    assert abs(100.0 * np.mean(pred == yte) - 100.0 * clf.score(xte, yte)) <= 0.5
    # labels that skip classes come back as themselves
    sub = svm.fit_ovo(torch.from_numpy(xtr[:20]), torch.from_numpy(3 * ytr[:20] + 1))
    assert set(svm.predict(sub, torch.from_numpy(xte)).tolist()) <= set((3 * ytr[:20] + 1).tolist())


def _write_shapenet(root: Path, n: int, points: int = 1100) -> Path:
    """A ShapeNet-55 tree: ``train.txt`` / ``test.txt`` and one ``.npy``
    cloud a shape under ``shapenet_pc``."""
    rng = np.random.default_rng(2)
    (root / "shapenet_pc").mkdir(parents=True)
    names = [f"02691156-{i:04d}.npy" for i in range(n)]
    for name in names:
        np.save(root / "shapenet_pc" / name, rng.standard_normal((points, 3)).astype(np.float32))
    (root / "ShapeNet-55").mkdir()
    (root / "ShapeNet-55" / "train.txt").write_text("\n".join(names[: n - 8]) + "\n")
    (root / "ShapeNet-55" / "test.txt").write_text("\n".join(names[n - 8:]) + "\n")
    return root


def test_pretrain_cli_on_cpu_and_finetune_from_its_checkpoint(tmp_path, monkeypatch):
    """``cli.main --device cpu`` of cfgs/dev/tiny_pretrain_cpu.yaml at
    max_epoch 1 on a written ShapeNet-55 tree (24 shapes: one step an epoch
    at total_bs 16) and the committed ModelNet40 h5 fixtures: epochs 0 and 1,
    the probe after epoch 1, ckpt-best.pth and ckpt-last.pth written with the
    probe's accuracy; then the finetune CLI takes ckpt-last.pth through
    --finetune_model with every encoder key of the classifier matched (only
    the head missing)."""
    monkeypatch.chdir(tmp_path)
    sn = _write_shapenet(tmp_path / "sn", 24)
    (tmp_path / "shapenet.yaml").write_text(
        f"NAME: ShapeNet\nDATA_PATH: {sn / 'ShapeNet-55'}\nN_POINTS: 1024\n"
        f"PC_PATH: {sn / 'shapenet_pc'}\n")
    (tmp_path / "svm.yaml").write_text(f"NAME: ModelNet40SVM\nDATA_PATH: "
                                       f"{ROOT / 'tests' / 'data' / 'h5'}\n")
    base = (ROOT / "cfgs" / "dev" / "tiny_pretrain_cpu.yaml").read_text()
    cfg = tmp_path / "pre.yaml"
    cfg.write_text(base.replace("cfgs/dataset_configs/ShapeNet-55.yaml", str(tmp_path / "shapenet.yaml"))
                   .replace("cfgs/dataset_configs/ModelNet40SVM.yaml", str(tmp_path / "svm.yaml"))
                   .replace("max_epoch: 12", "max_epoch: 1"))
    probes = []
    real = svm.svm_accuracy
    monkeypatch.setattr(svm, "svm_accuracy", lambda *a, **k: probes.append(real(*a, **k))
                        or probes[-1])
    state, best = cli.main(["--config", str(cfg), "--device", "cpu", "--num_workers", "0",
                            "--exp_name", "pre"])
    exp = tmp_path / "experiments" / "pre" / "pre"
    assert state.step == 2 and len(probes) == 1 and 0.0 < probes[0] <= 100.0
    assert best.acc == probes[0]
    payload = torch.load(exp / "ckpt-best.pth", weights_only=True)
    assert payload["epoch"] == 1 and payload["metrics"]["acc"] == probes[0]
    last = torch.load(exp / "ckpt-last.pth", weights_only=True)
    assert last["epoch"] == 1 and last["step"] == 2
    assert any(k.startswith("diff_sgwt.") for k in last["base_model"])

    handed = {}
    monkeypatch.setattr(prf, "finetune_run", lambda *a, **k: handed.update(k))
    monkeypatch.setattr(cli, "build_loader", lambda *a, **k: None)  # no ModelNet tree read
    ft = tmp_path / "ft.yaml"
    ft.write_text(f"_base_: {ROOT / 'cfgs' / 'finetune_modelnet.yaml'}\n"
                  "model: {trans_dim: 48, encoder_dims: 48, depth: 3, group_size: 16, "
                  "num_group: 32, knn_graph: 8}\n")
    cli.main(["--config", str(ft), "--device", "cpu", "--finetune_model",
              str(exp / "ckpt-last.pth"), "--exp_name", "ft"])
    from si_mamba_tpu_torch.models import PointMamba, PointMambaConfig

    cls = PointMamba(PointMambaConfig(trans_dim=48, encoder_dims=48, depth=3, group_size=16,
                                      num_group=32, knn_graph=8))
    missing, unexpected, mismatched = pckpt.transfer_pretrained(cls, handed["pretrained"])
    assert missing and all(k.startswith("cls_head_finetune.") for k in missing)
    assert not mismatched
    assert {k.split(".")[0] for k in unexpected} == {"MAE_decoder", "mask_token",
                                                     "increase_dim", "diff_sgwt"}
