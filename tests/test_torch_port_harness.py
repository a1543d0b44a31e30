"""The port's finetune harness against the JAX package on the CPU, at a small
size (depth 2, width 32, 16 groups of 8, as tests/test_train_harness.py's
mini run), from JAX-initialised weights carried across by
``utils/weights.py:state_dict_from_jax``: ``test_run`` and the vote step
against JAX's, ``finetune_run``'s epochs, files, scalars and checkpoint order
against JAX's, a bitwise resume, the checkpoints, the pretrained-weight
transfer, and the CLI end to end."""

import ast
import importlib.util
import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from si_mamba_tpu.models import PointMamba as JPointMamba
from si_mamba_tpu.models import PointMambaConfig as JConfig
from si_mamba_tpu.models.point_mamba import spectral_eigvecs as j_spectral_eigvecs
from si_mamba_tpu.train import checkpoint as jckpt
from si_mamba_tpu.train import config as jconfig
from si_mamba_tpu.train import optim as joptim
from si_mamba_tpu.train import runner_finetune as jrf
from si_mamba_tpu.train.train_state import TrainState as JTrainState
from si_mamba_tpu.utils.torch_export import save_torch_checkpoint
from si_mamba_tpu_torch.data.loader import Loader
from si_mamba_tpu_torch.models import PointMamba, PointMambaConfig
from si_mamba_tpu_torch.models import point_mamba as port_pm
from si_mamba_tpu_torch.serving import Predictor
from si_mamba_tpu_torch.train import checkpoint as pckpt
from si_mamba_tpu_torch.train import cli
from si_mamba_tpu_torch.train import config as pconfig
from si_mamba_tpu_torch.train import runner_finetune as prf
from si_mamba_tpu_torch.train import yaml_subset
from si_mamba_tpu_torch.train.logging_utils import AverageMeter, DeferredMeters
from si_mamba_tpu_torch.train.optim import build_optimizer
from si_mamba_tpu_torch.train.train_state import TrainState
from si_mamba_tpu_torch.utils.weights import state_dict_from_jax

from tests import torch_oracle as oracle

ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(NAME="PointMamba", trans_dim=32, depth=2, cls_dim=4, group_size=8, num_group=16,
             encoder_dims=32, knn_graph=4, drop_path=0.0, method="SAST")
CONFIG = """
optimizer: {type: AdamW, kwargs: {lr: 0.001, weight_decay: 0.05}}
scheduler: {type: CosLR, kwargs: {epochs: 3, initial_epochs: 1}}
bnmscheduler: {type: Lambda, kwargs: {bn_momentum: 0.1, bn_decay: 0.5, decay_step: 1, lowest_decay: 0.01}}
model: {NAME: PointMamba, trans_dim: 32, depth: 2, cls_dim: 4, group_size: 8, num_group: 16,
        encoder_dims: 32, knn_graph: 4, drop_path: 0.0, method: SAST}
npoints: 1024
total_bs: 4
max_epoch: 2
grad_norm_clip: 10
"""


def _configs(text=CONFIG, **override):
    port = pconfig._to_config(yaml_subset.load(text))
    port.update(override)
    jax_cfg = jconfig._to_config(jconfig.ConfigDict(json.loads(json.dumps(port))))
    return port, jax_cfg


class Clouds:
    """Seeded clouds with labels; no per-sample draws."""

    def __init__(self, n, npoints=1024, seed=0, cls_dim=4):
        rng = np.random.default_rng(seed)
        pts = rng.standard_normal((n, npoints, 3)).astype(np.float32)
        self.pts = pts / np.abs(pts).max(axis=(1, 2), keepdims=True)
        self.labels = rng.integers(0, cls_dim, n)

    def __len__(self):
        return len(self.pts)

    def __getitem__(self, i):
        return self.pts[i], int(self.labels[i])


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The tensors here are tiny, and the suite runs one worker a core: more
    than one intra-op thread a worker only contends for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_variables():
    model = JPointMamba(JConfig.from_dict(SMALL))
    return jax.device_get(model.init(jax.random.key(0), jnp.zeros((2, 1024, 3)), train=False))


def _port_model(variables, **cfg):
    model = PointMamba(PointMambaConfig.from_dict({**SMALL, **cfg}))
    model.load_state_dict(state_dict_from_jax(variables["params"], variables["batch_stats"]),
                          strict=True)
    return model


def _jax_state(variables):
    tx, _ = joptim.build_optimizer(variables["params"])
    return JTrainState.create(variables["params"], variables["batch_stats"], tx)


@pytest.fixture
def aligned_eigvecs(monkeypatch):
    """The port's eigenvectors with the signs of JAX's for the same centres
    (each solver's signs are arbitrary)."""
    real = port_pm.spectral_eigvecs

    def aligned(center, cfg):
        vals, vecs = real(center, cfg)
        _, ref = j_spectral_eigvecs(jnp.asarray(center.numpy()), JConfig.from_dict(SMALL))
        ref = np.asarray(ref)
        assert oracle.eig_cosines(vecs, ref).min() > 1 - 1e-4
        return vals, oracle.align_signs(vecs, ref)

    monkeypatch.setattr(port_pm, "spectral_eigvecs", aligned)


def _record_eval_logits(monkeypatch, module, port: bool):
    """Patch ``module.validate`` to keep every batch's logits (numpy) of the
    eval step it is given, then run the original."""
    seen, original = [], module.validate

    def validate(eval_step, state, loader, epoch=0):
        for pts, _ in loader.epoch(0):
            out = eval_step(state, torch.from_numpy(pts) if port else pts)
            seen.append(out.numpy() if port else np.asarray(out))
        return original(eval_step, state, loader, epoch)

    monkeypatch.setattr(module, "validate", validate)
    return seen


def _close(got, want):
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=1e-3 * scale, rtol=2e-3)


# ---------------------------------------------------------------------------
# test_run and the vote step against JAX
# ---------------------------------------------------------------------------

def test_test_run_matches_jax(jax_variables, aligned_eigvecs, monkeypatch):
    port_cfg, jax_cfg = _configs()
    loader = Loader(Clouds(10, seed=1), batch_size=4)
    jax_logits = _record_eval_logits(monkeypatch, jrf, port=False)
    port_logits = _record_eval_logits(monkeypatch, prf, port=True)
    jacc = jrf.test_run(jax_cfg, loader, _jax_state(jax_variables))
    state = TrainState(step=0, model=_port_model(jax_variables), optimizer=None)
    pacc = prf.test_run(port_cfg, loader, state)
    assert len(port_logits) == len(jax_logits) == 3
    for got, want in zip(port_logits, jax_logits):
        _close(got, want)
    assert pacc == jacc


def test_vote_step_with_injected_passes_equals_jax_forwards(jax_variables, aligned_eigvecs,
                                                            monkeypatch):
    """Given the passes' clouds, the vote step sums their eval logits as
    JAX's forwards do; the FPS pool is taken once a batch."""
    times, B = 3, 2
    rng = np.random.default_rng(5)
    passes = [rng.standard_normal((B, 1024, 3)).astype(np.float32) for _ in range(times)]
    points = torch.from_numpy(rng.standard_normal((B, 1300, 3)).astype(np.float32))
    pools, fps_calls, it = [], [], iter(passes)
    real_fps = prf.fps

    def counting_fps(pts, n):
        fps_calls.append(n)
        return real_fps(pts, n)

    def injected(pool, generator, npoints, rotation):
        pools.append(pool)
        return torch.from_numpy(next(it))

    monkeypatch.setattr(prf, "fps", counting_fps)
    monkeypatch.setattr(prf, "vote_pass", injected)
    model = _port_model(jax_variables)
    step = prf.make_vote_step(model, 1024, rotation=False, times=times)
    got = step(TrainState(0, model, None), points, torch.Generator().manual_seed(0))
    assert fps_calls == [1200] and len(pools) == times
    assert all(p is pools[0] and p.shape == (B, 1200, 3) for p in pools)
    jmodel = JPointMamba(JConfig.from_dict(SMALL))
    want = sum(np.asarray(jmodel.apply(jax_variables, jnp.asarray(p), train=False), np.float32)
               for p in passes)
    assert got.dtype == torch.float32 and got.shape == (B, 4)
    _close(got.numpy(), want)


def test_validate_vote_reseeds_each_batch_and_counts(jax_variables):
    """Every batch draws from ``seed``, as JAX's every batch takes the same
    key: two equal batches give equal vote logits."""
    ds = Clouds(4, npoints=1024, seed=2)
    ds.pts[2:] = ds.pts[:2]
    model = _port_model(jax_variables)
    state = TrainState(0, model, None)
    logits = []
    real = prf.make_vote_step(model, 1024, rotation=True, times=2)

    def step(st, pts, gen):
        logits.append(real(st, pts, gen))
        return logits[-1]

    acc = prf.validate_vote(step, state, Loader(ds, batch_size=2), seed=7)
    assert len(logits) == 2 and torch.equal(logits[0], logits[1])
    labels = ds.labels
    pred = torch.cat(logits).argmax(-1).numpy()
    assert acc == pytest.approx(100.0 * (pred == labels).mean())


# ---------------------------------------------------------------------------
# finetune_run against JAX: steps, files, scalar tags, LR, BN momentum, order
# ---------------------------------------------------------------------------

# epoch 0: better and > 91, so a vote; 1: > 92.1, a vote (not a better one);
# 2: neither
ACCS = [91.5, 92.5, 92.0]
VOTES = [93.0, 92.0]


def _script(monkeypatch, module, saves):
    accs, votes = iter(ACCS), iter(VOTES)
    real_save = module.ckpt.save_checkpoint
    monkeypatch.setattr(module, "validate", lambda *a, **k: next(accs))
    monkeypatch.setattr(module, "validate_vote", lambda *a, **k: next(votes))

    def save(exp_dir, prefix, state, epoch, *args, **kwargs):
        saves.append((prefix, epoch))
        return real_save(exp_dir, prefix, state, epoch, *args, **kwargs)

    monkeypatch.setattr(module.ckpt, "save_checkpoint", save)


@pytest.fixture(scope="module")
def jax_finetune(tmp_path_factory, jax_variables):
    """One JAX finetune_run (3 epochs x 2 steps of 8 clouds, a batch its
    8-device CPU mesh divides) with scripted validation accuracies, so that
    both runners take the same best / vote decisions."""
    exp = tmp_path_factory.mktemp("jax_exp")
    saves = []
    with pytest.MonkeyPatch.context() as mp:
        _script(mp, jrf, saves)
        _, jax_cfg = _configs()
        train = Loader(Clouds(16, npoints=1100, seed=3), 8, shuffle=True, drop_last=True)
        state, best = jrf.finetune_run(jax_cfg, train, Loader(Clouds(4), 4), str(exp), vote=True)
    return {"exp": exp, "saves": saves, "step": int(state.step), "best": best.acc}


def _scalars(exp):
    return [json.loads(line) for line in (Path(exp) / "scalars.jsonl").read_text().splitlines()]


def test_finetune_run_matches_jax(jax_finetune, tmp_path, monkeypatch, jax_variables):
    saves, momenta = [], []
    _script(monkeypatch, prf, saves)
    real_set = prf.set_bn_momentum
    monkeypatch.setattr(prf, "set_bn_momentum",
                        lambda model, m: (momenta.append(m), real_set(model, m))[1])
    port_cfg, jax_cfg = _configs()
    train = Loader(Clouds(16, npoints=1100, seed=3), 8, shuffle=True, drop_last=True)
    state, best = prf.finetune_run(port_cfg, train, Loader(Clouds(4), 4), str(tmp_path),
                                   vote=True, device="cpu")
    steps = (int(port_cfg.max_epoch) + 1) * len(train)
    assert state.step == jax_finetune["step"] == steps == 6
    assert best.acc == jax_finetune["best"] == 92.5
    assert saves == jax_finetune["saves"] == [
        ("ckpt-best", 0), ("ckpt-best_vote", 0), ("ckpt-last", 0), ("ckpt-best", 1),
        ("ckpt-last", 1), ("ckpt-last", 2)]
    jax_files = {p.name for p in jax_finetune["exp"].iterdir() if not p.name.endswith(".bak")}
    port_files = {p.name[:-len(".pth")] if p.name.endswith(".pth") else p.name
                  for p in tmp_path.iterdir()}
    assert port_files == jax_files == {"ckpt-best", "ckpt-best_vote", "ckpt-last",
                                       "scalars.jsonl"}
    jrec, prec = _scalars(jax_finetune["exp"]), _scalars(tmp_path)
    assert [(r["tag"], r["step"]) for r in prec] == [(r["tag"], r["step"]) for r in jrec]
    for j, p in zip(jrec, prec):
        if p["tag"] in ("LR", "Metric/ACC", "Metric/ACC_vote"):
            assert p["value"] == pytest.approx(j["value"], rel=1e-6), p["tag"]
    # one BatchNorm momentum a step, the epoch's: bnm(max(e - 1, 0))
    jbnm = joptim.bn_momentum_schedule(bn_momentum=0.1, bn_decay=0.5, decay_step=1,
                                       lowest_decay=0.01)
    assert momenta == pytest.approx([float(jbnm(max(e - 1, 0))) for e in range(3) for _ in "ab"])
    last = torch.load(tmp_path / "ckpt-last.pth", weights_only=True)
    assert set(last) == {"base_model", "optimizer", "epoch", "metrics", "best_metrics", "step",
                         "rng"}
    assert last["epoch"] == 2 and last["step"] == 6 and last["best_metrics"] == {"acc": 92.5}
    assert last["optimizer"]["count"] == 6 and last["optimizer"]["micro"] == 0
    assert set(last["base_model"]) == set(_port_model(jax_variables).state_dict())


def test_finetune_run_refuses_tensor_parallel_configs(tmp_path):
    """A one-sided tensor parallelism raises as JAX's does; a two-sided one
    over a world of one process raises naming the world size (its ranks are
    launched with torchrun; tests/test_torch_port_dp.py runs them)."""
    loader = Loader(Clouds(4), 4)
    port_cfg, _ = _configs(tp_size=2)
    with pytest.raises(ValueError, match="BOTH"):
        prf.finetune_run(port_cfg, loader, loader, str(tmp_path), device="cpu")
    port_cfg.model.tp_axis = "model"
    with pytest.raises(ValueError, match="world size 1"):
        prf.finetune_run(port_cfg, loader, loader, str(tmp_path), device="cpu")


def _snapshot(state):
    opt = state.optimizer.torch_optimizer.state_dict()["state"]
    return (dict(state.model.state_dict()), {k: dict(v) for k, v in opt.items()},
            [state.step, state.optimizer.count, state.optimizer.micro])


@pytest.mark.parametrize("async_ckpt", [False, True])
def test_resumed_run_equals_uninterrupted_bitwise(tmp_path, async_ckpt):
    """Epochs 0-1 in one run against epoch 0, then a resume for epoch 1:
    parameters, BatchNorm statistics, optimizer state, step and the step
    generator's state bitwise equal. Drop rates above 0, so the generator
    matters."""

    def run(name, max_epoch, resume):
        port_cfg, _ = _configs(max_epoch=max_epoch, async_ckpt=async_ckpt)
        port_cfg.model.drop_path = 0.2
        train = Loader(Clouds(8, npoints=1100, seed=3), 4, shuffle=True, drop_last=True)
        state, _ = prf.finetune_run(port_cfg, train, Loader(Clouds(4), 4), str(tmp_path / name),
                                    resume=resume, device="cpu", seed=3)
        return _snapshot(state)

    sd_a, opt_a, counts_a = run("full", 1, False)
    run("split", 0, False)
    sd_b, opt_b, counts_b = run("split", 1, True)
    assert counts_a == counts_b == [4, 4, 0]
    rng = [torch.load(tmp_path / name / "ckpt-last.pth", weights_only=True)["rng"]
           for name in ("full", "split")]
    assert torch.equal(rng[0], rng[1])
    assert sd_a.keys() == sd_b.keys()
    for k in sd_a:
        assert torch.equal(sd_a[k], sd_b[k]), k
    assert opt_a.keys() == opt_b.keys()
    for i in opt_a:
        for k in opt_a[i]:
            assert torch.equal(opt_a[i][k], opt_b[i][k]), (i, k)


# ---------------------------------------------------------------------------
# checkpoints and pretrained weights
# ---------------------------------------------------------------------------

def _small_state(seed=0, step_per_update=1):
    model = PointMamba(PointMambaConfig.from_dict(SMALL), generator=torch.Generator().manual_seed(seed))
    opt, _ = build_optimizer(model, lr=1e-3, steps_per_epoch=1, step_per_update=step_per_update)
    return TrainState.create(model, opt)


def test_checkpoint_round_trips_and_async_saves_join(tmp_path, monkeypatch):
    a = _small_state(0, step_per_update=2)
    for p in a.model.parameters():  # one backward pass accumulated, no update yet
        p.grad = torch.full_like(p, 0.5)
    a.optimizer.micro, a.optimizer.count, a.step = 1, 3, 7
    gen = torch.Generator().manual_seed(11)
    torch.rand(5, generator=gen)
    pckpt.save_checkpoint(str(tmp_path), "ckpt-best", a, 4, {"acc": 50.0}, async_save=True)
    pckpt.save_checkpoint(str(tmp_path), "ckpt-last", a, 5, {"acc": 40.0}, {"acc": 61.0},
                          async_save=True, generator=gen)
    pckpt.wait_for_saves()
    assert not list(tmp_path.glob("*.tmp"))
    b = _small_state(1, step_per_update=2)
    gen_b = torch.Generator().manual_seed(0)
    b, start, best = pckpt.resume_state(str(tmp_path), b, gen_b)
    assert start == 6 and best == {"acc": 61.0} and b.step == 7
    assert (b.optimizer.count, b.optimizer.micro) == (3, 1)
    assert torch.equal(gen_b.get_state(), gen.get_state())
    for (k, va), vb in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        assert torch.equal(va, vb), k
    assert all(torch.equal(p.grad, torch.full_like(p, 0.5)) for p in b.optimizer.params)
    assert pckpt.load_checkpoint(str(tmp_path), "ckpt-best")["epoch"] == 4
    assert pckpt.resume_state(str(tmp_path / "none"), b) == (b, 0, {})

    # a save that fails mid-write leaves the previous file whole and raises
    # from the next wait
    def broken_save(obj, f):
        f.write(b"partial")
        raise OSError("disk full")

    monkeypatch.setattr(pckpt.torch, "save", broken_save)
    pckpt.save_checkpoint(str(tmp_path), "ckpt-last", a, 9, async_save=True)
    with pytest.raises(OSError, match="disk full"):
        pckpt.wait_for_saves()
    monkeypatch.undo()
    assert pckpt.load_checkpoint(str(tmp_path), "ckpt-last")["epoch"] == 5


def test_transfer_pretrained_reports_jax_keys_as_reference_names(jax_variables, capsys):
    """A pretrain-like checkpoint without the head, with one more entry and
    (second case) a head of another width: the port reports JAX's missing,
    unexpected and shape-mismatched keys under the reference's names, and
    keeps its own initialisation for them."""
    head = {"fc1": "0", "bn1": "1", "fc2": "4", "bn2": "5", "out": "8"}
    leaf = {"kernel": "weight", "scale": "weight", "bias": "bias"}

    def ref_name(flax_key):
        parts = flax_key.split(".")
        assert parts[0] == "cls_head_finetune"
        return f"cls_head_finetune.{head[parts[1]]}.{leaf[parts[2]]}"

    def jax_report():
        out = capsys.readouterr().out
        report = {}
        for line in out.splitlines():
            name, _, rest = line.partition(" ")
            report[name] = ast.literal_eval(rest[rest.index("["):rest.rindex("]") + 1])
        return report

    full = state_dict_from_jax(jax_variables["params"], jax_variables["batch_stats"])
    pre_params = {k: v for k, v in jax_variables["params"].items() if k != "cls_head_finetune"}
    pre_params["MAE_decoder"] = {"w": np.ones(3, np.float32)}
    jckpt.transfer_pretrained(jax_variables, {"params": pre_params})
    jrep = jax_report()
    pre_sd = {f"base_model.{k}": v for k, v in full.items() if not k.startswith("cls_head")}
    pre_sd["MAE_decoder.w"] = torch.ones(3)
    model = PointMamba(PointMambaConfig.from_dict(SMALL), generator=torch.Generator().manual_seed(9))
    head_before = model.cls_head_finetune.state_dict()
    missing, unexpected, mismatched = pckpt.transfer_pretrained(model, pre_sd)
    params = {k for k, _ in model.named_parameters()}
    assert sorted(k for k in missing if k in params) == sorted(map(ref_name, jrep["missing_keys"]))
    assert unexpected == ["MAE_decoder.w"] and jrep["unexpected_keys"] == ["MAE_decoder.w"]
    assert mismatched == []
    for k, v in model.state_dict().items():
        if k.startswith("cls_head"):
            assert torch.equal(v, head_before[k[len("cls_head_finetune."):]])
        else:
            assert torch.equal(v, full[k]), k

    # a head of another width: shape-mismatched, kept as initialised
    wide = dict(jax_variables["params"])
    wide["cls_head_finetune"] = dict(wide["cls_head_finetune"])
    wide["cls_head_finetune"]["out"] = {"kernel": np.ones((256, 7), np.float32),
                                        "bias": np.ones(7, np.float32)}
    jckpt.transfer_pretrained(jax_variables, {"params": wide})
    jrep = jax_report()
    wide_sd = dict(full)
    wide_sd["cls_head_finetune.8.weight"] = torch.ones(7, 256)
    wide_sd["cls_head_finetune.8.bias"] = torch.ones(7)
    model = PointMamba(PointMambaConfig.from_dict(SMALL))
    out_before = model.cls_head_finetune[8].weight.detach().clone()
    _, _, mismatched = pckpt.transfer_pretrained(model, wide_sd)
    assert mismatched == sorted(map(ref_name, jrep["shape-mismatched"]))
    assert torch.equal(model.cls_head_finetune[8].weight, out_before)


def test_deferred_meters_equal_eager_reads():
    rng = np.random.default_rng(0)
    for n in (0, 1, 2, 7):
        ms = [{"loss": torch.tensor(rng.random(), dtype=torch.float32),
               "acc": torch.tensor(rng.random() * 100, dtype=torch.float32)} for _ in range(n)]
        eager, lagged = AverageMeter(["loss", "acc"]), AverageMeter(["loss", "acc"])
        for m in ms:
            eager.update([float(m["loss"]), float(m["acc"])])
        lag = DeferredMeters(lagged, ("loss", "acc"))
        for m in ms:
            lag.push(m)
        lag.flush()
        lag.flush()
        assert lagged.avg() == eager.avg()


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def modelnet_tree(tmp_path_factory):
    """A ModelNet40-format tree (5 classes, 4 train and 2 test clouds each, 1024
    points) from scripts/prepare_data.py --synthetic, and a dataset config."""
    spec = importlib.util.spec_from_file_location("prep", ROOT / "scripts" / "prepare_data.py")
    prep = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(prep)
    root = tmp_path_factory.mktemp("cli_data")
    prep.synthetic(str(root), n_train=4, n_test=2, npoints=1024, seed=0)
    ds = root / "modelnet.yaml"
    ds.write_text(f"NAME: ModelNet\nDATA_PATH: {root}/ModelNet/modelnet40_normal_resampled\n"
                  f"N_POINTS: 1024\nNUM_CATEGORY: 40\nUSE_NORMALS: FALSE\n")
    return root


def _experiment(tmp_path, tree, **model):
    cfg = tmp_path / "tiny.yaml"
    body = {**{k: v for k, v in SMALL.items() if k != "NAME"}, **model}
    cfg.write_text(
        f"_base_: {ROOT}/cfgs/finetune_modelnet.yaml\n"
        "dataset:\n" + "".join(
            f"  {s}: {{_base_: {tree}/modelnet.yaml, others: {{subset: '{sub}'}}}}\n"
            for s, sub in (("train", "train"), ("val", "test"), ("test", "test"))) +
        "model: {" + ", ".join(f"{k}: {v}" for k, v in body.items()) + "}\n"
        "scheduler: {type: CosLR, kwargs: {epochs: 3, initial_epochs: 0}}\n"
        "total_bs: 8\nmax_epoch: 1\n")
    return cfg


def test_cli_finetunes_tests_and_resumes_on_the_cpu(modelnet_tree, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    cfg = _experiment(tmp_path, modelnet_tree, cls_dim=5)  # the tree's 5 classes
    args = ["--config", str(cfg), "--device", "cpu", "--num_workers", "2"]
    state, best = cli.main(args)
    exp = tmp_path / "experiments" / "tiny" / "default"
    assert state.step == 2 * 2  # 20 train clouds at batch 8, drop_last: 2 steps an epoch
    assert {"ckpt-last.pth", "config.yaml", "scalars.jsonl", "source_snapshot.tar.gz"} <= {
        p.name for p in exp.iterdir()}
    assert (exp / "ckpt-best.pth").exists() == (best.acc > 0)
    snapshot = pconfig.get_config(str(exp / "config.yaml"))
    assert snapshot == pconfig.get_config(str(cfg))
    last_acc = [r["value"] for r in _scalars(exp) if r["tag"] == "Metric/ACC"][-1]
    acc = cli.main(args + ["--test", "--ckpts", str(exp / "ckpt-last.pth"), "--exp_name", "t"])
    assert acc == last_acc
    # --resume re-reads the snapshot and trains nothing more
    resumed, _ = cli.main(args + ["--resume"])
    assert resumed.step == state.step
    for (k, v), w in zip(resumed.model.state_dict().items(), state.model.state_dict().values()):
        assert torch.equal(v, w), k
    auto = cli.get_args(args + ["--auto_resume"])
    assert cli._should_auto_resume(auto, str(exp / "config.yaml"))
    fresh = cli.get_args(args + ["--auto_resume", "--exp_name", "fresh"])
    assert not cli._should_auto_resume(fresh, os.path.join(fresh.experiment_path, "config.yaml"))
    # the port's checkpoint serves through Predictor.from_checkpoint
    p = Predictor.from_checkpoint(str(exp / "ckpt-last.pth"), model_cfg={**SMALL, "cls_dim": 5},
                                  device="cpu")
    clouds = np.random.default_rng(0).standard_normal((2, 1024, 3)).astype(np.float32)
    with torch.no_grad():
        want = state.model.eval()(torch.from_numpy(clouds)).numpy()
    np.testing.assert_allclose(p.logits(clouds), want, rtol=1e-5, atol=1e-5)


def test_cli_takes_a_pth_exported_from_jax(modelnet_tree, tmp_path, monkeypatch, jax_variables,
                                           aligned_eigvecs):
    """A .pth that utils/torch_export.py writes from JAX variables: --ckpts
    gives JAX's test accuracy and logits, --finetune_model hands the model
    the same weights."""
    monkeypatch.chdir(tmp_path)
    pth = tmp_path / "exported.pth"
    save_torch_checkpoint(str(pth), jax_variables["params"], jax_variables["batch_stats"])
    cfg = _experiment(tmp_path, modelnet_tree)
    port_logits = _record_eval_logits(monkeypatch, prf, port=True)
    acc = cli.main(["--config", str(cfg), "--device", "cpu", "--test", "--ckpts", str(pth)])
    from si_mamba_tpu.data.datasets import ModelNet as JModelNet
    from si_mamba_tpu.data.loader import Loader as JLoader

    jax_logits = _record_eval_logits(monkeypatch, jrf, port=False)
    jds = JModelNet(f"{modelnet_tree}/ModelNet/modelnet40_normal_resampled", subset="test",
                    npoints=1024)
    _, jax_cfg = _configs()
    jacc = jrf.test_run(jax_cfg, JLoader(jds, 8), _jax_state(jax_variables))
    assert acc == jacc and len(port_logits) == len(jax_logits) == 2
    for got, want in zip(port_logits, jax_logits):
        _close(got, want)

    handed = {}
    monkeypatch.setattr(prf, "finetune_run", lambda *a, **k: handed.update(k))
    cli.main(["--config", str(cfg), "--device", "cpu", "--finetune_model", str(pth),
              "--exp_name", "ft"])
    model = PointMamba(PointMambaConfig.from_dict(SMALL))
    assert pckpt.transfer_pretrained(model, handed["pretrained"]) == ([], [], [])
    pts = torch.from_numpy(jds.points[0][None, :, :3].copy())
    with torch.no_grad():
        got = model.eval()(pts).numpy()
    jmodel = JPointMamba(JConfig.from_dict(SMALL))
    _close(got, np.asarray(jmodel.apply(jax_variables, jnp.asarray(pts.numpy()), train=False)))


def test_cli_refuses_cuda_without_a_gpu(modelnet_tree, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    cfg = _experiment(tmp_path, modelnet_tree)
    if torch.cuda.is_available():
        assert prf.resolve_device("cuda").type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no GPU"):
        cli.main(["--config", str(cfg)])  # --device defaults to cuda
    with pytest.raises(RuntimeError, match="no GPU"):
        prf.finetune_run(pconfig.get_config(str(cfg)), None, None, str(tmp_path))


@pytest.mark.parametrize("case,match", [
    ("tsne", "M21"), ("orbax_ckpts", "export_torch"),
    ("orbax_finetune", "export_torch"), ("orbax_predictor", "export_torch")])
def test_unported_paths_raise_with_their_roadmap_item(modelnet_tree, tmp_path, monkeypatch,
                                                     case, match):
    monkeypatch.chdir(tmp_path)
    os.symlink(ROOT / "cfgs", tmp_path / "cfgs")  # the dev presets' refs are CWD-relative
    orbax_dir = tmp_path / "ckpt-best"
    orbax_dir.mkdir()
    base = ["--device", "cpu", "--num_workers", "0"]
    if case == "tsne":
        # ported since (M21): --tsne runs, on a tree whose 35 test clouds exceed
        # the t-SNE's perplexity of 30, and writes the PNG
        spec = importlib.util.spec_from_file_location("prep", ROOT / "scripts" / "prepare_data.py")
        prep = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(prep)
        prep.synthetic(str(tmp_path / "tsne_data"), n_train=1, n_test=7, npoints=1024, seed=0)
        (tmp_path / "tsne_data" / "modelnet.yaml").write_text(
            (modelnet_tree / "modelnet.yaml").read_text().replace(str(modelnet_tree),
                                                                 str(tmp_path / "tsne_data")))
        out = cli.main(["--config", str(_experiment(tmp_path, tmp_path / "tsne_data", cls_dim=5)),
                        "--tsne"] + base)
        assert out.endswith("tsne.png")
        assert (tmp_path / out).read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
        return
    cfg = str(_experiment(tmp_path, modelnet_tree))
    with pytest.raises(NotImplementedError, match=match):
        if case == "orbax_ckpts":
            cli.main(["--config", cfg, "--test", "--ckpts", str(orbax_dir)] + base)
        elif case == "orbax_finetune":
            cli.main(["--config", cfg, "--finetune_model", str(orbax_dir)] + base)
        else:
            Predictor.from_checkpoint(str(orbax_dir), model_cfg=SMALL, device="cpu")
