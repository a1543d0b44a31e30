"""Perf mode on the whole-mixer route and over tensor parallelism against the
JAX package on the CPU: bf16 activations (fp32 parameters, statistics and
scan state) with the subspace eigensolver, on ``scan_impl: fused`` and on the
tensor-parallel Mamba-1 mixer.

Held here, at small sizes with inputs from numpy seeds: the bf16 plain
versions of K10/K11 against the Pallas fused-mixer kernel in interpret mode
(values and ``jax.vjp`` of its core); the bf16 wrappers and the autograd
Function on the CPU; ``mamba_mixer_apply`` on the 'fused' routes at bf16; the
bf16 + subspace ``PointMamba`` with ``scan_impl='fused'`` (logits, one train
step), ``Predictor.from_checkpoint(perf=True)`` and the CLI on a written
fused perf config; ``mamba_mixer_tp`` and the tensor-parallel stack at bf16
on 2 ``gloo`` ranks against JAX on a 2-device CPU mesh. The CUDA kernels'
bf16 variants are held against these plain versions on the card in
tests/test_torch_port_cuda.py and chip_smoke.py.

Tolerances: where both sides round the same fp32 value to bf16 once (y of
K10, dxz of K11), one bf16 ulp at a floor of 2e-2 of the max: the port keeps
the rank-R pair unfolded where the Pallas kernel folds it into W_dt, the one
difference in rounding before the store; K11's fp32 weight gradients within
1e-3 of their max. Where bf16 rounds at many points in places the two
frameworks do not share (the in_proj and out_proj products, torch's and
XLA's bf16 elementwise ops, the LayerNorms), relative to the max as
tests/test_torch_port_perf.py does, with its direction-and-norm rule for
gradients and chip_smoke.py's ``PERF_LOGITS_TOL`` for logits. The
tensor-parallel Mamba-1 mixer promotes to fp32 on both sides, so it is held
as tests/test_torch_port_parallel.py holds it at fp32.

The rank bodies import no JAX and JAX is imported inside the JAX-side code
only: spawned ranks re-import this module.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from si_mamba_tpu_torch.models import PointMamba, PointMambaConfig
from si_mamba_tpu_torch.models import point_mamba as port_pm
from si_mamba_tpu_torch.ops import selective_scan as tss
from si_mamba_tpu_torch.ops.kernels import fused_mixer as kfm
from si_mamba_tpu_torch.serving import Predictor
from si_mamba_tpu_torch.train import cli
from si_mamba_tpu_torch.train.config import get_config
from si_mamba_tpu_torch.utils.weights import state_dict_from_jax

from tests.test_torch_port_parallel import MAMBA_MIX, STACK, VAL_TOL, _close_to_max, \
    _jax_loss, _jax_mesh, _loss, _mamba_mixer_params, _run_ranks, _stack_state_dict

ROOT = Path(__file__).resolve().parents[1]
BF = torch.bfloat16
# chip_smoke.py's bound for perf mode's logits and features against another
# route, relative to their max
PERF_LOGITS_TOL = 5e-2
# the fused route's model settings at a small size: depth 2, trans_dim 64
# (d_inner 128, which 'fused' needs), 8 groups of 16 (L = 2 * 4 * 8 = 64, one
# chunk of the Pallas kernel, four of the port's)
FUSED_PERF = dict(trans_dim=64, encoder_dims=64, depth=2, cls_dim=10, num_group=8,
                  group_size=16, drop_path=0.0, cls_head_dropout=0.0, knn_graph=4,
                  dtype="bfloat16", spectral_method="subspace")
NPTS = 128


def _jnp():
    import jax.numpy as jnp

    return jnp


def _bf16_case(L, dt_rank, seed, d_model=32):
    """K10's inputs with xz rounded to bf16: ((port), (the Pallas kernel's,
    W_dt folded))."""
    from tests.test_torch_port_fused_mixer import _core_inputs, _folded, _params

    jnp = _jnp()
    args = list(_core_inputs(_params(d_model=d_model, dt_rank=dt_rank, seed=seed), 2, L,
                             dt_rank=dt_rank, seed=seed + 1))
    xz = torch.from_numpy(args[0]).to(BF)
    args[0] = xz.float().numpy()
    jargs = [jnp.asarray(a) for a in _folded(args, dt_rank)]
    jargs[0] = jargs[0].astype(jnp.bfloat16)
    return [xz] + [torch.from_numpy(np.ascontiguousarray(a)) for a in args[1:]], jargs, args


def _ulps(got, want, floor=2e-2):
    from tests.test_torch_port_perf import _ulps as ulps

    return ulps(got, want, floor)


def _rel(got, want):
    from tests.test_torch_port_perf import _rel as rel

    return rel(got, want)


# ---------------------------------------------------------------------------
# the plain versions of K10 and K11 at bf16
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("L", [64, 50])  # one chunk of the Pallas kernel; ragged
def test_plain_k10_bf16_matches_pallas_interpret(L):
    """y (bf16) of ``fused_mixer_fwd_ref`` on bf16 xz against
    ``_fused_fwd_call`` in interpret mode (xz zero-padded to 64), within one
    bf16 ulp; h_entries fp32; the wrapper's CPU path is the plain version."""
    from si_mamba_tpu.ops.pallas import fused_mixer_kernel as jfk

    targs, jargs, _ = _bf16_case(L, 2, seed=3)
    xz_p, _ = jfk._pad_L(jargs[0], 64)
    xz_j, conv_wt, conv_b, wdt, dtb, wbc, at, d = jargs
    y_j, _ = jfk._fused_fwd_call(xz_p, conv_wt, conv_b[None], wdt, dtb[None], wbc, at, d[None],
                                 chunk=64, sub_block=8, interpret=True)
    y, hent = kfm.fused_mixer_fwd_ref(*targs, chunk=kfm.CHUNK, emit_states=True)
    assert y.dtype == BF and y_j.dtype == _jnp().bfloat16 and hent.dtype == torch.float32
    assert _ulps(y, y_j[:, :L]) <= 1, _ulps(y, y_j[:, :L])
    assert torch.equal(kfm.fused_mixer_fwd(*targs), y)
    assert torch.equal(kfm.fused_mixer_fwd_bf16(*targs), y)


@pytest.mark.parametrize("L,dt_rank", [(64, 2), (50, 8)])
def test_plain_k11_bf16_matches_jax_vjp_of_the_pallas_core(L, dt_rank):
    """dxz (bf16) and the seven fp32 weight gradients of ``fused_mixer_bwd_ref``
    for bf16 xz and g against ``jax.vjp`` of the Pallas core (its backward
    kernel in interpret mode, its fp32 dxz cast to bf16 once): dxz within one
    bf16 ulp, the weight gradients within 1e-3 of their max (through the
    chain rule of W_dt = x_proj[:, :R] @ dt_proj, in float64)."""
    import jax

    from si_mamba_tpu.ops.pallas import fused_mixer_kernel as jfk

    jnp = _jnp()
    targs, jargs, args = _bf16_case(L, dt_rank, seed=5)
    g = np.random.default_rng(7).standard_normal((2, L, 64)).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: jfk._fused_core(*a, 64, 8, True), *jargs)
    cts = vjp(jnp.asarray(g).astype(jnp.bfloat16))
    dxz_j = cts[0]
    _, dconv_wt, dconv_b, dwdt, ddtb, dwbc, dat, dd = (
        np.asarray(jnp.asarray(w).astype(jnp.float32), dtype=np.float64) for w in cts)
    x_proj, dt_proj = args[3].astype(np.float64), args[4].astype(np.float64)
    want = (dconv_wt, dconv_b, np.concatenate([dwdt @ dt_proj.T, dwbc], axis=1),
            x_proj[:, :dt_rank].T @ dwdt, ddtb, dat, dd)
    _, hent = kfm.fused_mixer_fwd_ref(*targs, chunk=kfm.CHUNK, emit_states=True)
    got = kfm.fused_mixer_bwd_ref(*targs, hent, torch.from_numpy(g).to(BF), chunk=kfm.CHUNK)
    assert got[0].dtype == BF and dxz_j.dtype == jnp.bfloat16
    assert _ulps(got[0], dxz_j) <= 1, _ulps(got[0], dxz_j)
    names = ("dconv_wt", "dconv_b", "dx_proj", "ddt_proj", "ddtb", "dat", "dd")
    for name, a, w in zip(names, got[1:], want):
        assert a.dtype == torch.float32 and a.shape == w.shape, name
        assert _rel(a, w) <= 1e-3, (name, _rel(a, w))


def test_fused_bf16_wrappers_and_function_on_the_cpu():
    """On CPU tensors each bf16 wrapper is its plain version and counts no
    launch; a ``_bf16`` wrapper refuses fp32 xz; ``kernel_inputs`` hands the
    kernels fp32 weights for bf16 xz, as JAX's ``fused_mamba_mixer`` casts
    them; ``fused_mamba_mixer`` under a gradient (``FusedMixerFn``) returns y
    and xz's gradient in bf16, every weight's in fp32, and its y equals the
    lean forward's."""
    from tests.test_torch_port_fused_mixer import _params

    targs, _, _ = _bf16_case(40, 2, seed=9)
    names = ("fused_mixer_fwd_bf16", "fused_mixer_fwd_states_bf16", "fused_mixer_bwd_bf16")
    before = {n: getattr(kfm, n).launches for n in names}
    y, hent = kfm.fused_mixer_fwd_states_bf16(*targs)
    y_ref, h_ref = kfm.fused_mixer_fwd_ref(*targs, chunk=kfm.CHUNK, emit_states=True)
    assert torch.equal(y, y_ref) and torch.equal(hent, h_ref)
    g = torch.from_numpy(np.random.default_rng(10).standard_normal((2, 40, 64)).astype(
        np.float32)).to(BF)
    for a, w in zip(kfm.fused_mixer_bwd_bf16(*targs, hent, g),
                    kfm.fused_mixer_bwd_ref(*targs, hent, g, chunk=kfm.CHUNK)):
        assert torch.equal(a, w)
    assert {n: getattr(kfm, n).launches for n in names} == before
    with pytest.raises(TypeError, match="bfloat16"):
        kfm.fused_mixer_fwd_bf16(targs[0].float(), *targs[1:])

    p = {k: torch.from_numpy(v) for k, v in _params(seed=11).items()}
    w = [p["conv_w"], p["conv_b"], p["x_proj_w"], p["dt_proj_w"], p["dt_proj_b"],
         -torch.exp(p["A_log"]), p["D"]]
    xz = targs[0].clone()
    inputs = kfm.kernel_inputs(xz, *w, dt_rank=2, d_state=4)
    assert inputs[0].dtype == BF and all(t.dtype == torch.float32 for t in inputs[1:])
    leaves = [xz.requires_grad_()] + [t.clone().requires_grad_() for t in w]
    y = kfm.fused_mamba_mixer(*leaves, dt_rank=2, d_state=4)
    assert isinstance(y.grad_fn, kfm.FusedMixerFn._backward_cls) and y.dtype == BF
    y.backward(g)
    assert leaves[0].grad.dtype == BF and all(t.grad.dtype == torch.float32 for t in leaves[1:])
    with torch.no_grad():
        assert torch.equal(kfm.fused_mamba_mixer(*leaves, dt_rank=2, d_state=4), y.detach())


# ---------------------------------------------------------------------------
# the mixer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl,d_model", [("fused_interpret", 32), ("fused", 64)])
def test_mixer_fused_bf16_matches_jax(impl, d_model):
    """``mamba_mixer_apply`` at bf16 on 'fused_interpret' (d_inner 64) and
    'fused' (d_inner 128; the plain K10/K11 on the CPU) against JAX's
    'fused_interpret' at bf16 (bf16 in_proj and out_proj on bf16-cast weights,
    the interior on fp32 weights): y bf16 within 1e-2 of its max, the bf16
    input gradient and every fp32 parameter gradient within 2e-2 of their
    max (each side rounds the in_proj product and the gradients of the two
    bf16 products to bf16 in its own order)."""
    import jax

    from si_mamba_tpu.ops.selective_scan import mamba_mixer_apply as j_mixer_apply
    from tests.test_torch_port_fused_mixer import _params

    jnp = _jnp()
    p = _params(d_model=d_model, seed=12)
    x = np.random.default_rng(13).standard_normal((2, 32, d_model)).astype(np.float32)
    r = np.random.default_rng(14).standard_normal((2, 32, d_model)).astype(np.float32)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    jx = jnp.asarray(x).astype(jnp.bfloat16)

    def j_loss(params, x_):
        y_ = j_mixer_apply(params, x_, d_state=4, dt_rank=2, impl="fused_interpret")
        return jnp.sum(y_.astype(jnp.float32) * r)

    want_y = j_mixer_apply(jp, jx, d_state=4, dt_rank=2, impl="fused_interpret")
    want_p, want_x = jax.grad(j_loss, argnums=(0, 1))(jp, jx)
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
    tx = torch.from_numpy(x).to(BF).requires_grad_()
    y = tss.mamba_mixer_apply(tp, tx, d_state=4, dt_rank=2, impl=impl)
    (y.float() * torch.from_numpy(r)).sum().backward()
    assert y.dtype == BF and want_y.dtype == jnp.bfloat16
    assert _rel(y, want_y) <= 1e-2, _rel(y, want_y)
    assert tx.grad.dtype == BF and _rel(tx.grad, want_x) <= 2e-2, _rel(tx.grad, want_x)
    for k, t in tp.items():
        assert t.grad.dtype == torch.float32, k
        assert _rel(t.grad, want_p[k]) <= 2e-2, (k, _rel(t.grad, want_p[k]))


# ---------------------------------------------------------------------------
# the model, a train step, the predictor, the CLI
# ---------------------------------------------------------------------------

def _clouds(b, seed):
    from tests.test_torch_port_perf import _clouds as clouds

    return clouds(b, NPTS, seed)


@pytest.fixture(scope="module")
def fused_jax():
    """A JAX ``PointMamba`` at the fused perf settings on its interpret route,
    its variables, 4 clouds and its eval logits and pooled features for them."""
    import jax

    from si_mamba_tpu.models import PointMamba as JPointMamba
    from si_mamba_tpu.models import PointMambaConfig as JConfig

    jnp = _jnp()
    jcfg = JConfig(**{**FUSED_PERF, "scan_impl": "fused_interpret"})
    jmodel = JPointMamba(jcfg)
    variables = jax.jit(lambda key: jmodel.init(key, jnp.zeros((2, NPTS, 3)), train=False))(
        jax.random.key(0))
    pts = _clouds(4, seed=2)
    logits, feat = jax.jit(lambda v, x: jmodel.apply(v, x, train=False, return_features=True))(
        variables, jnp.asarray(pts))
    return jcfg, jmodel, variables, pts, logits, feat


def _port_model(variables):
    """The port's classifier at the fused perf settings on 'fused', loaded
    with JAX's fp32 weights."""
    model = PointMamba(PointMambaConfig(**{**FUSED_PERF, "scan_impl": "fused"}))
    model.load_state_dict(state_dict_from_jax(variables["params"], variables["batch_stats"]),
                          strict=True)
    return model


def _align(monkeypatch, jcfg, pts):
    from tests.test_torch_port_perf import _aligned_eigvecs

    _aligned_eigvecs(monkeypatch, jcfg, pts)


def test_fused_pointmamba_bf16_logits_match_jax(fused_jax, monkeypatch):
    """The bf16 + subspace classifier on 'fused' (the plain bf16 K10 here):
    eval logits (bf16, as JAX's) and pooled features within PERF_LOGITS_TOL
    of the max of JAX's on its 'fused_interpret' route, on clouds whose
    bf16-rounded eigenvectors sort alike in both frameworks (asserted)."""
    jcfg, _, variables, pts, want, want_feat = fused_jax
    _align(monkeypatch, jcfg, pts)
    with torch.no_grad():
        got, feat = _port_model(variables).eval()(torch.from_numpy(pts), return_features=True)
    assert got.dtype == BF and want.dtype == _jnp().bfloat16
    assert _rel(got, want) <= PERF_LOGITS_TOL, _rel(got, want)
    assert _rel(feat, want_feat) <= PERF_LOGITS_TOL, _rel(feat, want_feat)


def test_fused_train_step_bf16_matches_jax(fused_jax, monkeypatch):
    """One train-mode forward and backward of the fused perf classifier
    (bf16 K10 with states and K11, plain here), drop rates 0, against JAX's
    on its 'fused_interpret' route: the loss within 1e-2 relative; every
    parameter gradient fp32 and, but for the leaves whose exact gradient is 0
    (tests/test_torch_port_perf.py's ZERO_GRADIENT), at a cosine of at least
    0.95 to JAX's with a norm within 20 % of it; the BatchNorm statistics
    moved alike (within 1e-2 of their max)."""
    import jax

    from si_mamba_tpu.models.point_mamba import cross_entropy_loss_acc as j_ce
    from tests.test_torch_port_perf import ZERO_GRADIENT

    jnp = _jnp()
    jcfg, jmodel, variables, _, _, _ = fused_jax
    model = _port_model(variables)
    pts = _clouds(8, seed=5)
    labels = np.random.default_rng(3).integers(0, FUSED_PERF["cls_dim"], 8)

    def loss_fn(params):
        logits, upd = jmodel.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                   jnp.asarray(pts), train=True, mutable=["batch_stats"])
        per, _ = j_ce(logits, jnp.asarray(labels, jnp.int32))
        return jnp.mean(per), upd["batch_stats"]

    (jloss, jstats), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])
    _align(monkeypatch, jcfg, pts)
    per, _ = port_pm.cross_entropy_loss_acc(model.train()(torch.from_numpy(pts)),
                                            torch.from_numpy(labels))
    loss = per.mean()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-2)
    want = state_dict_from_jax(jgrads, jstats)
    for k, p in model.named_parameters():
        assert p.grad.dtype == torch.float32, k
        if k in ZERO_GRADIENT:
            continue
        g, w = (np.asarray(t, np.float64).ravel() for t in (p.grad.numpy(), want[k]))
        cos = g @ w / (np.linalg.norm(g) * np.linalg.norm(w))
        assert cos >= 0.95 and 0.8 <= np.linalg.norm(g) / np.linalg.norm(w) <= 1.25, (k, cos)
    for k, v in model.state_dict().items():
        if "running" in k:
            w = np.asarray(want[k])
            assert float(np.abs(v.numpy() - w).max()) <= 1e-2 * max(np.abs(w).max(), 1e-6), k


def test_fused_perf_predictor_matches_jax(fused_jax, monkeypatch):
    """``Predictor.from_checkpoint(state dict, model_cfg with scan_impl
    'fused', perf=True)``: bf16 and subspace set, the weights unchanged, and
    its fp32 logits within PERF_LOGITS_TOL of the max of JAX's perf-mode
    logits on its 'fused_interpret' route."""
    jcfg, _, variables, pts, want, _ = fused_jax
    sd = {k: v.numpy() for k, v in state_dict_from_jax(variables["params"],
                                                       variables["batch_stats"]).items()}
    cfg = {k: v for k, v in FUSED_PERF.items() if k not in ("dtype", "spectral_method")}
    p = Predictor.from_checkpoint(sd, model_cfg={**cfg, "scan_impl": "fused"}, npoints=NPTS,
                                  max_batch=4, perf=True, device="cpu")
    c = p.model.config
    assert (c.dtype, c.spectral_method, c.scan_impl) == ("bfloat16", "subspace", "fused")
    for k, v in p.model.state_dict().items():
        assert torch.equal(v, torch.as_tensor(sd[k])), k
    _align(monkeypatch, jcfg, pts)
    got = p.logits(pts)
    assert got.dtype == np.float32
    assert _rel(got, want) <= PERF_LOGITS_TOL, _rel(got, want)


def _fused_perf_config(tmp_path, tree):
    """A config whose base is cfgs/finetune_modelnet_perf.yaml with
    ``model.scan_impl: fused``, narrowed to the small model and the tree."""
    cfg = tmp_path / "tiny_fused_perf.yaml"
    body = {k: v for k, v in FUSED_PERF.items() if k not in ("dtype", "spectral_method")}
    body.update(cls_dim=5, scan_impl="fused")
    cfg.write_text(
        f"_base_: {ROOT}/cfgs/finetune_modelnet_perf.yaml\n"
        "dataset:\n" + "".join(
            f"  {s}: {{_base_: {tree}/modelnet.yaml, others: {{subset: '{sub}'}}}}\n"
            for s, sub in (("train", "train"), ("val", "test"), ("test", "test"))) +
        "model: {" + ", ".join(f"{k}: {v}" for k, v in body.items()) + "}\n"
        "scheduler: {type: CosLR, kwargs: {epochs: 3, initial_epochs: 0}}\n"
        "total_bs: 8\nmax_epoch: 0\n")
    return cfg


@pytest.fixture(scope="module")
def modelnet_tree(tmp_path_factory):
    """A ModelNet40-format tree (5 classes, 4 train and 2 test clouds each) and
    its dataset config, as tests/test_torch_port_harness.py makes it."""
    spec = importlib.util.spec_from_file_location("prep", ROOT / "scripts" / "prepare_data.py")
    prep = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(prep)
    root = tmp_path_factory.mktemp("cli_data")
    prep.synthetic(str(root), n_train=4, n_test=2, npoints=1024, seed=0)
    (root / "modelnet.yaml").write_text(
        f"NAME: ModelNet\nDATA_PATH: {root}/ModelNet/modelnet40_normal_resampled\n"
        f"N_POINTS: 1024\nNUM_CATEGORY: 40\nUSE_NORMALS: FALSE\n")
    return root


def _scalars(exp):
    return [json.loads(line) for line in (Path(exp) / "scalars.jsonl").read_text().splitlines()]


def test_cli_trains_the_fused_perf_config_on_the_cpu(modelnet_tree, tmp_path, monkeypatch):
    """The CLI on the written fused perf config: the port reads it as the JAX
    package does (the same model config: bf16, subspace, 'fused'); one epoch
    of two steps through the bf16 K10 with states and K11 (plain here) and a
    validation, a finite epoch loss, fp32 parameters, ``--test`` of
    ckpt-last.pth equal to the last validation."""
    from si_mamba_tpu.models import PointMambaConfig as JConfig
    from si_mamba_tpu.train.config import get_config as j_get_config

    monkeypatch.chdir(tmp_path)
    cfg = _fused_perf_config(tmp_path, modelnet_tree)
    port_cfg = PointMambaConfig.from_dict(get_config(str(cfg)).model)
    assert port_cfg.__dict__ == JConfig.from_dict(j_get_config(str(cfg)).model).__dict__
    assert (port_cfg.dtype, port_cfg.spectral_method, port_cfg.scan_impl) == (
        "bfloat16", "subspace", "fused")
    args = ["--config", str(cfg), "--device", "cpu", "--num_workers", "2"]
    state, _ = cli.main(args)
    assert state.model.config == port_cfg and state.step == 2
    exp = tmp_path / "experiments" / "tiny_fused_perf" / "default"
    losses = [r["value"] for r in _scalars(exp) if r["tag"] == "Loss/Epoch/Loss"]
    assert len(losses) == 1 and np.isfinite(losses).all()
    for p in state.model.parameters():
        assert p.dtype == torch.float32
    last_acc = [r["value"] for r in _scalars(exp) if r["tag"] == "Metric/ACC"][-1]
    acc = cli.main(args + ["--test", "--ckpts", str(exp / "ckpt-last.pth"), "--exp_name", "t"])
    assert acc == last_acc


# ---------------------------------------------------------------------------
# the tensor-parallel Mamba-1 mixer at bf16 (no JAX in the rank body)
# ---------------------------------------------------------------------------

def _tp_bf16_rank(rank, world, data_path):
    from si_mamba_tpu_torch.models.layers import MixerModel
    from si_mamba_tpu_torch.parallel import make_mesh
    from si_mamba_tpu_torch.parallel.tensor_parallel import mamba_mixer_tp, shard_mixer_params
    from si_mamba_tpu_torch.utils import weights

    data = torch.load(data_path, weights_only=False)
    mesh = make_mesh(("model",), (world,))
    a, c = data["mamba_mixer"], MAMBA_MIX
    full = {k: torch.from_numpy(v) for k, v in a.items() if k != "x"}
    p = {k: v.clone().requires_grad_() for k, v in shard_mixer_params(full, rank, world).items()}
    x = torch.from_numpy(a["x"].copy()).to(BF).requires_grad_()
    y = mamba_mixer_tp(p, x, mesh=mesh, d_state=c["d_state"], dt_rank=c["dt_rank"])
    _loss(y.float()).backward()
    out = dict(mixer=dict(y=y.detach(), dx=x.grad, grads={k: v.grad for k, v in p.items()}))

    stack = MixerModel(STACK["d_model"], STACK["n_layer"], mesh=mesh, tp_axis="model")
    cfg = type("Cfg", (), {"mixer": "mamba"})()
    stack.load_state_dict(weights.shard_state_dict(data["stack_sd"], cfg, rank, world))
    seen = []
    for layer in stack.layers:
        layer.mixer.register_forward_hook(lambda m, i, o: seen.append((i[0].dtype, o.dtype)))
    xs = torch.from_numpy(data["stack_x"]).to(BF)
    with torch.no_grad():
        out["stack"] = stack(xs, torch.zeros_like(xs))
    out["stack_mixer_dtypes"] = seen
    return out


@pytest.fixture(scope="module")
def tp_bf16_ranks(tmp_path_factory):
    import jax

    from si_mamba_tpu.models.layers import MixerModel as JMixerModel

    jnp = _jnp()
    x = np.random.default_rng(4).standard_normal((STACK["b"], STACK["l"], STACK["d_model"]))
    x = jnp.asarray(x.astype(np.float32)).astype(jnp.bfloat16)
    mm = JMixerModel(d_model=STACK["d_model"], n_layer=STACK["n_layer"], scan_impl="chunked",
                     dtype=jnp.bfloat16)
    variables = mm.init(jax.random.key(1), x, jnp.zeros_like(x))
    data = dict(mamba_mixer=_mamba_mixer_params(2), stack_x=np.asarray(x.astype(jnp.float32)),
                stack_sd=_stack_state_dict(variables))
    tmp = tmp_path_factory.mktemp("tp_mamba_bf16")
    torch.save(data, tmp / "data.pt")
    return data, variables, _run_ranks(_tp_bf16_rank, 2, tmp, str(tmp / "data.pt"))


def test_mamba_mixer_tp_bf16_matches_jax(tp_bf16_ranks):
    """``mamba_mixer_tp`` on 2 ranks with bf16 x against JAX's on a 2-device
    model mesh at bf16: JAX casts no weight, so x promotes to fp32 at the
    fp32 in_proj and the mixer returns fp32 on both sides, held as at fp32
    (values 2e-5; parameter gradients within 1e-3 of their max); x's
    gradient is bf16 on both sides, each rank's rounded once and summed over
    the ranks in bf16, so within 2 bf16 ulps (floor 1e-2 of the max)."""
    import jax

    from si_mamba_tpu.parallel.tensor_parallel import mamba_mixer_tp, shard_mixer_params

    jnp = _jnp()
    data, _, ranks = tp_bf16_ranks
    a, c = data["mamba_mixer"], MAMBA_MIX
    mesh = _jax_mesh(("model",), 2)
    kw = dict(mesh=mesh, d_state=c["d_state"], dt_rank=c["dt_rank"])
    p = shard_mixer_params({k: jnp.asarray(v) for k, v in a.items() if k != "x"}, mesh)
    jx = jnp.asarray(a["x"]).astype(jnp.bfloat16)
    y = jax.jit(lambda p, x: mamba_mixer_tp(p, x, **kw))(p, jx)
    gp, gx = jax.jit(jax.grad(lambda p, x: _jax_loss(mamba_mixer_tp(p, x, **kw)),
                              argnums=(0, 1)))(p, jx)
    assert y.dtype == jnp.float32 and gx.dtype == jnp.bfloat16
    got = [r["mixer"] for r in ranks]
    for r in got:
        assert r["y"].dtype == torch.float32 and r["dx"].dtype == BF
        np.testing.assert_allclose(r["y"].numpy(), np.asarray(y), **VAL_TOL)
        assert _ulps(r["dx"], gx, 1e-2) <= 2, _ulps(r["dx"], gx, 1e-2)
    d_inner = 2 * c["d_model"]
    for k, want in gp.items():
        want = np.asarray(want)
        loc = [r["grads"][k] for r in got]
        assert all(t.dtype == torch.float32 for t in loc), k
        if k == "in_proj_w":  # (d, 2, d_inner) in JAX; [x | z] of the rank's channels here
            want = want.reshape(c["d_model"], 2 * d_inner)
            half = d_inner // 2
            gathered = torch.cat([t[:, :half] for t in loc] + [t[:, half:] for t in loc], 1)
        else:
            gathered = torch.cat(loc, dim=1 if k == "dt_proj_w" else 0)
        _close_to_max(gathered.numpy(), want, name=k)


def test_tp_mixer_model_bf16_matches_jax(tp_bf16_ranks):
    """The port's tensor-parallel ``MixerModel`` at bf16 against JAX's
    ``MixerModel(tp_axis='model', dtype=bf16)`` under its context mesh: every
    mixer sees bf16 (each norm rounds to the activation dtype) and returns
    fp32 (so the residual stream is fp32 from the first block on), as the
    JAX model's do; the output, the final norm's, bf16 within 1e-2 of the max
    of JAX's (both round each norm's fp32 output once; the fp32 residual
    sums in another order)."""
    import jax

    from si_mamba_tpu.models.layers import MixerModel as JMixerModel

    jnp = _jnp()
    data, variables, ranks = tp_bf16_ranks
    mm = JMixerModel(d_model=STACK["d_model"], n_layer=STACK["n_layer"], scan_impl="chunked",
                     tp_axis="model", dtype=jnp.bfloat16)
    x = jnp.asarray(data["stack_x"]).astype(jnp.bfloat16)
    with jax.set_mesh(_jax_mesh(("model",), 2)):
        want = jax.jit(lambda v, x: mm.apply(v, x, jnp.zeros_like(x)))(variables, x)
    assert want.dtype == jnp.bfloat16
    for r in ranks:
        assert r["stack_mixer_dtypes"] == [(BF, torch.float32)] * STACK["n_layer"]
        assert r["stack"].dtype == BF
        assert _rel(r["stack"], want) <= 1e-2, _rel(r["stack"], want)
