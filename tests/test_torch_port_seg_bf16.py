"""The part-segmentation model at bf16 activations against the JAX package's.

The JAX ``PartSegModel`` carries ``config.dtype`` through the encoder, the
pos-embed, the eigenvector cast, the stack and the head's BatchNorms, and
runs the head's linear layers (no dtype) in fp32. The port's model at
``dtype='bfloat16'`` is held against it at small sizes: the per-point eval
log-probs within 3e-2 of their max, the tolerance tests/test_torch_port_perf.py
holds the bf16 classifier's logits to (bf16 rounds at many points on both
sides, in different places), and the NLL loss within 1e-2 relative, that
file's tolerance for the bf16 classifier's loss. The BatchNorm statistics
are randomised with variances in [0.1, 0.2]: each per-point BatchNorm then
scales a bf16 rounding by 2-3, where the fp32 test's [0.02, 0.06] scales it
by 4-7 and leaves JAX's own bf16 log-probs 7 % of their max from its fp32
ones. HLT orders the tokens by the codes of the bf16-rounded eigenvectors
plus a bf16 tie-break draw; the test asserts that those codes are JAX's on
its clouds.

The tolerances above hold a port that ignored the dtype too: on these
weights JAX's own bf16 log-probs are 1.15e-2 (Mamba-1) and 1.19e-2 (SSD) of
their max from its fp32 ones, and the port at fp32 is as far from JAX's
bf16. So the port's bf16 log-probs are also held to a quarter of that own
deviation (the rounding points), and a control runs the port at fp32 on the
same weights and asserts that it fails that bound. Readings on the CPU:
the port's bf16 log-probs 7.6e-4 (Mamba-1) and 5.4e-4 (SSD) of max from
JAX's bf16, the fp32 control 1.15e-2 and 1.18e-2; with the tie-break drawn
in fp32 and rounded (not JAX's bf16 draw) the bf16 port read 1.01e-2 and
1.23e-2 and failed. Then the tiny seg configs at ``model.dtype: bfloat16``
train and evaluate through the port's CLI.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from si_mamba_tpu.models import segmentation as jseg
from si_mamba_tpu.models.point_mamba import spectral_eigvecs as j_spectral_eigvecs
from si_mamba_tpu.ops.spectral import multilevel_codes as j_multilevel_codes
from si_mamba_tpu.train import runner_seg as jrs
from si_mamba_tpu.train.train_state import TrainState as JTrainState
from si_mamba_tpu_torch.models import segmentation as pseg
from si_mamba_tpu_torch.ops.spectral import multilevel_codes
from si_mamba_tpu_torch.train import cli
from tests import torch_oracle as oracle
from tests.test_torch_port_seg import (  # noqa: F401 (seg_tree is a fixture)
    ROOT,
    SMALL,
    _clouds,
    _jax_model,
    _onehot,
    _port_model,
    seg_tree,
)

BF = torch.bfloat16
LOGP_REL = 3e-2  # of max |log-prob|: the bf16 classifier's logits tolerance
LOSS_REL = 1e-2  # the bf16 classifier's loss tolerance
ROUNDING_SHARE = 0.25  # of JAX's own bf16-vs-fp32 deviation: the rounding points' bound


def _bf16_stats(batch_stats, rng):
    """BatchNorm statistics that keep the per-point activations spread
    without amplifying bf16's roundings much: means near 0, variances in
    [0.1, 0.2]."""
    def draw(path, x):
        if path[-1].key == "mean":
            return jnp.asarray((rng.standard_normal(x.shape) * 0.01).astype(np.float32))
        return jnp.asarray(rng.uniform(0.1, 0.2, x.shape).astype(np.float32))

    return jax.tree_util.tree_map_with_path(draw, batch_stats)


def _jax_eval(kw, pts, cls):
    """JAX's eval log-probs at ``kw`` and the variables they came from."""
    jmodel, variables = _jax_model(jseg.PartSegConfig(**kw))
    variables["batch_stats"] = _bf16_stats(variables["batch_stats"], np.random.default_rng(4))
    jstate = JTrainState.create(variables["params"], variables["batch_stats"],
                                optax.sgd(0.0))
    out = jax.jit(jrs.make_seg_eval_step(jmodel))(jstate, jnp.asarray(pts), jnp.asarray(cls))
    return np.asarray(out), variables


def _aligned_bf16_eigvecs(jcfg):
    """The port's ``spectral_eigvecs`` with JAX's signs for the same centres;
    asserts that the HLT codes of the bf16-rounded vectors are JAX's."""
    real = pseg.spectral_eigvecs

    def aligned(center, cfg):
        vals, vecs = real(center, cfg)
        _, jv = j_spectral_eigvecs(jnp.asarray(center.detach().numpy()), jcfg)
        jv = np.asarray(jv)
        assert oracle.eig_cosines(vecs, jv).min() > 1 - 1e-4
        vecs = oracle.align_signs(vecs, jv)
        k = cfg.k_top_eigenvectors
        np.testing.assert_array_equal(
            multilevel_codes(vecs.to(BF), k).float().numpy(),
            np.asarray(j_multilevel_codes(jnp.asarray(jv).astype(jnp.bfloat16), k)
                       .astype(jnp.float32)))
        return vals, vecs

    return aligned


def _port_eval(kw, variables, jcfg, pts, cls, dtype):
    """The port's eval log-probs at ``dtype`` on JAX's weights (fp32 numpy)."""
    model = _port_model(dict(kw, dtype=dtype), variables).eval()
    assert model.dtype == pseg.DTYPES[dtype]
    with torch.no_grad(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(pseg, "spectral_eigvecs", _aligned_bf16_eigvecs(jcfg))
        got = model(torch.from_numpy(pts), torch.from_numpy(_onehot(cls)))
    assert got.dtype == torch.float32
    return got.numpy()


@pytest.mark.parametrize("mixer", ["mamba", "ssd"])
def test_partseg_bf16_eval_logp_and_loss_match_jax(mixer):
    """Eval log-probs (fp32 from the fp32 head, on both sides) of the bf16
    model with carried weights and randomised BatchNorm statistics against
    the JAX trainer's ``make_seg_eval_step`` at bf16; the NLL loss of the
    same log-probs. The log-probs also within ROUNDING_SHARE of JAX's own
    bf16-vs-fp32 deviation, which the port at fp32 (the control) fails."""
    kw = dict(SMALL, method="HLT", mixer=mixer, dtype="bfloat16")
    jcfg = jseg.PartSegConfig(**kw)
    pts, cls = _clouds(2, 256, seed=5), np.array([3, 12], np.int32)
    target = np.random.default_rng(6).integers(0, jcfg.cls_dim, (2, 256))
    want, variables = _jax_eval(kw, pts, cls)
    want32, _ = _jax_eval(dict(kw, dtype="float32"), pts, cls)
    assert want.dtype == np.float32 and want.std() > 0.1
    got = _port_eval(kw, variables, jcfg, pts, cls, "bfloat16")
    rel = np.abs(got - want).max() / np.abs(want).max()
    own = np.abs(want - want32).max() / np.abs(want32).max()  # bf16's own deviation
    assert rel <= LOGP_REL and rel <= ROUNDING_SHARE * own, (rel, own)
    control = _port_eval(kw, variables, jcfg, pts, cls, "float32")
    rel32 = np.abs(control - want).max() / np.abs(want).max()
    assert rel32 > ROUNDING_SHARE * own, (rel32, own)  # the bound tells fp32 from bf16
    loss = pseg.nll_loss(torch.from_numpy(got), torch.from_numpy(target)).item()
    jloss = float(jseg.nll_loss(jnp.asarray(want), jnp.asarray(target)))
    assert abs(loss - jloss) <= LOSS_REL * abs(jloss), (loss, jloss)


def test_partseg_bf16_runs_the_stack_at_bf16_and_the_head_at_fp32():
    """At bf16 the stack's taps are bf16 and the head's linear layers see fp32
    input; at fp32 nothing changes dtype."""
    seen = {}

    def record(name):
        def hook(module, args, out):
            seen.setdefault(name, (args[0].dtype, out.dtype))
        return hook

    model = pseg.PartSegModel(pseg.PartSegConfig(**SMALL, dtype="bfloat16")).eval()
    model.norm.register_forward_hook(record("norm"))
    model.prop_fc1.register_forward_hook(record("prop_fc1"))
    model.bns1.register_forward_hook(record("bns1"))
    with torch.no_grad():
        out = model(torch.from_numpy(_clouds(2, 256, seed=1)),
                    torch.from_numpy(_onehot(np.array([0, 1]))))
    assert out.dtype == torch.float32
    assert seen["norm"] == (BF, BF)
    assert seen["prop_fc1"] == (torch.float32, torch.float32)
    assert seen["bns1"] == (torch.float32, torch.float32)  # rounded to bf16 after it


@pytest.mark.parametrize("preset", ["tiny_partseg_cpu.yaml", "tiny_partseg_ssd_cpu.yaml"])
def test_cli_trains_and_evaluates_the_tiny_seg_configs_at_bf16(preset, seg_tree, tmp_path,
                                                               monkeypatch):
    """``cli.main --device cpu`` on the tiny seg configs with model.dtype
    bfloat16 at 256 points, batch 4, one epoch: two steps with finite losses,
    the evaluation and both checkpoints; the model bf16, its parameters fp32."""
    monkeypatch.chdir(tmp_path)
    cfg = tmp_path / "seg.yaml"
    cfg.write_text(f"_base_: {ROOT}/cfgs/dev/{preset}\ndata_root: {seg_tree}\n"
                   f"model: {{dtype: bfloat16}}\n"
                   f"npoints: 256\ntotal_bs: 4\nmax_epoch: 1\n"
                   f"scheduler: {{type: CosLR, kwargs: {{epochs: 1, initial_epochs: 0}}}}\n")
    state, best = cli.main(["--config", str(cfg), "--device", "cpu", "--num_workers", "0"])
    exp = tmp_path / "experiments" / "seg" / "default"
    assert state.step == 2 and state.model.dtype == BF
    assert all(p.dtype == torch.float32 and torch.isfinite(p).all()
               for p in state.model.parameters())
    assert {"ckpt-last.pth", "ckpt-best.pth"} <= set(os.listdir(exp))
    m = torch.load(exp / "ckpt-last.pth", map_location="cpu", weights_only=True)["metrics"]
    assert all(0 <= m[k] <= 1 for k in ("instance_miou", "class_miou", "accuracy"))
    assert best["instance_miou"] == m["instance_miou"]
