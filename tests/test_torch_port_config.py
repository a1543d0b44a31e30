"""The port's config layer against the JAX package and pyyaml: its reader of
the YAML subset (``si_mamba_tpu_torch/train/yaml_subset.py``) equals
``yaml.safe_load`` on every config in cfgs/ and on the scalar rules of YAML
1.1, ``get_config`` equals the JAX package's on every preset (top-level and
subtree ``_base_``) and needs no pyyaml, snapshots written by either package
re-read equal in both, and the model registry."""

import sys
from pathlib import Path

import pytest
import yaml

from si_mamba_tpu.train import config as jconfig
from si_mamba_tpu_torch.train import config as pconfig
from si_mamba_tpu_torch.train import yaml_subset
from si_mamba_tpu_torch.train.registry import build_model_from_cfg

ROOT = Path(__file__).resolve().parents[1]
ALL_CFGS = sorted((ROOT / "cfgs").glob("*.yaml")) + sorted(
    (ROOT / "cfgs" / "dataset_configs").glob("*.yaml")) + sorted((ROOT / "cfgs" / "dev").glob("*.yaml"))
PRESETS = sorted((ROOT / "cfgs").glob("*.yaml")) + sorted((ROOT / "cfgs" / "dev").glob("*.yaml"))


def _ids(p):
    return str(p.relative_to(ROOT))


def plain(o):
    if isinstance(o, dict):
        return {k: plain(v) for k, v in o.items()}
    if isinstance(o, list):
        return [plain(v) for v in o]
    return o


@pytest.mark.parametrize("path", ALL_CFGS, ids=_ids)
def test_subset_reader_equals_safe_load_on_every_config(path):
    text = path.read_text()
    assert yaml_subset.load(text) == yaml.safe_load(text)


SCALARS = [
    "a: FALSE", "a: False", "a: True", "a: yes", "a: Off", "a: 0.", "a: 100.", "a: 1e-4",
    "a: 1.0e-4", "a: -1.5E+3", "a: .5", "a: -.inf", "a: ~", "a: null", "a: NULL", "a:",
    "a: 017", "a: 09", "a: 0x1F", "a: 0b101", "a: 1:30", "a: 190:20:30.15", "a: 1_000",
    "a: +3", "a: -1", "a: 'x''y'", 'a: "q\\tb\\u00e9\\x41"', "a: it's", "a: http://x:1/y",
    "a: a#b", "a: b  # a comment", "a: 'c # not a comment'", "a: b c\n  d e\n\n  f",
    "a: 'x\n  y'", "a: {b: 1,\n  c: [2, 3]}", "1: one\n2.5: two", "'quoted key': 1",
]
STRUCTURES = [
    "optimizer: {type: AdamW, kwargs: {lr: 0.0003, weight_decay: 0.05}}",
    "train: {_base_: cfgs/x.yaml, others: {subset: 'train', npoints: 1024, whole: True}}",
    "a: [1, 2, [3, 4], {x: y}, 'q, r']\nb: []\nc: {}\nd: {e, f: 1}\ng: [h, i,]",
    "- a\n- b: 1\n  c: 2\n- - x\n  - y\n-\n  z: 3",
    "a:\n- 1\n- {b: 2}\nc: 3", "a:\n  b:\n    c: 1\n  d: 2\ne: 3",
    "# only a comment\n", "", "---\na: 1\n", "just a scalar",
]


@pytest.mark.parametrize("text", SCALARS + STRUCTURES)
def test_subset_reader_follows_yaml_1_1(text):
    assert yaml_subset.load(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text", ["a: &x 1", "a: *x", "a: !!str 1", "a: |\n  b", "a: >\n  b",
                                  "? a\n: b", "<<: {a: 1}", "a: 2001-12-14", "a: b: c",
                                  "a: -", "a: [1, 2", "a:\n\tb: 1"])
def test_subset_reader_refuses_what_it_does_not_take(text):
    with pytest.raises(yaml_subset.YAMLSubsetError):
        yaml_subset.load(text)


@pytest.mark.parametrize("value", [
    {"s": ["yes", "null", "1e-4", "0.", "017", "", "a b", "x: y", "#c", "-a", "'q'", 'd"q',
           "tab\there", "new\nline", "é", "1:30", "~", "true"]},
    {"f": [0.0003, 100.0, 1e-06, 1e16, -2.5, float("inf"), 3], "b": [True, False, None]},
    {"nested": {"a": {"b": [1, [2, {"c": "d"}]], "e": {}}, "f": []}, 7: "int key"},
])
def test_writer_reads_back_in_both_readers(value):
    text = yaml_subset.dump(value)
    assert yaml_subset.load(text) == value
    assert yaml.safe_load(text) == value


@pytest.mark.parametrize("path", PRESETS, ids=_ids)
def test_get_config_needs_no_pyyaml_and_equals_jax(path, monkeypatch):
    jax_cfg = plain(jconfig.get_config(str(path)))
    monkeypatch.setitem(sys.modules, "yaml", None)  # import yaml now raises
    with pytest.raises(ImportError):
        import yaml as _  # noqa: F401
    port_cfg = pconfig.get_config(str(path))
    assert plain(port_cfg) == jax_cfg
    assert isinstance(port_cfg, pconfig.ConfigDict) and port_cfg.model.NAME


def test_get_config_base_cases_equal_jax(tmp_path, monkeypatch):
    """A subtree _base_ relative to the file's directory, to its parent, to
    the working directory and absolute; a top-level _base_ whose keys the
    file overrides; a _base_ that is already a dict."""
    (tmp_path / "sub").mkdir()
    (tmp_path / "ds").mkdir()
    (tmp_path / "ds" / "base.yaml").write_text("NAME: ScanObjectNN\nROOT: /data/scan\n")
    (tmp_path / "sub" / "local.yaml").write_text("NAME: ModelNet\nN_POINTS: 8192\n")
    (tmp_path / "sub" / "parent.yaml").write_text(
        "optimizer: {type: AdamW, kwargs: {lr: 0.0003, weight_decay: 0.05}}\n"
        "dataset:\n"
        "  train: {_base_: ds/base.yaml, others: {subset: train}}\n"
        "  val: {_base_: local.yaml, others: {subset: test}}\n"
        f"  test: {{_base_: {tmp_path}/ds/base.yaml}}\n"
        "  svm: {_base_: {NAME: inline, X: 1}}\n"
        "model: {NAME: PointMamba, trans_dim: 384, depth: 12}\n")
    (tmp_path / "sub" / "child.yaml").write_text(
        "_base_: parent.yaml\nmodel:\n  depth: 2\n  rotation: True\nmax_epoch: 3\n")
    (tmp_path / "cwd.yaml").write_text("NAME: FromCwd\n")
    (tmp_path / "sub" / "cwd_ref.yaml").write_text("d: {_base_: cwd.yaml}\n")
    monkeypatch.chdir(tmp_path)
    for name in ("parent.yaml", "child.yaml", "cwd_ref.yaml"):
        path = str(tmp_path / "sub" / name)
        assert plain(pconfig.get_config(path)) == plain(jconfig.get_config(path)), name
    child = pconfig.get_config(str(tmp_path / "sub" / "child.yaml"))
    assert child.model.depth == 2 and child.model.trans_dim == 384 and child.max_epoch == 3
    assert child.dataset.train._base_.NAME == "ScanObjectNN"
    assert child.dataset.val._base_.N_POINTS == 8192
    assert child.dataset.svm._base_.X == 1
    assert pconfig.get_config(str(tmp_path / "sub" / "cwd_ref.yaml")).d._base_.NAME == "FromCwd"


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("preset", ["finetune_modelnet.yaml", "finetune_modelnet_ssd_fused.yaml",
                                    "pretrain.yaml", "part_segmentation.yaml"])
def test_snapshot_rereads_equal_in_both_packages(tmp_path, writer, preset):
    """The experiment's config.yaml snapshot, written by either package's
    save_experiment_config, re-reads (its dataset _base_ entries now dicts)
    to the same config through both packages' get_config."""
    cfg = pconfig.get_config(str(ROOT / "cfgs" / preset))
    cfg.model.cls_dim = 5  # a value the CLI may set before the snapshot
    out = tmp_path / "config.yaml"
    (pconfig if writer == "port" else jconfig).save_experiment_config(cfg, str(out))
    assert yaml_subset.load(out.read_text()) == yaml.safe_load(out.read_text()) == plain(cfg)
    assert plain(pconfig.get_config(str(out))) == plain(cfg)
    assert plain(jconfig.get_config(str(out))) == plain(cfg)


def test_registry_builds_pointmamba_and_names_what_is_not_ported():
    model, cfg = build_model_from_cfg({
        "NAME": "PointMamba", "trans_dim": 32, "depth": 2, "cls_dim": 4, "group_size": 8,
        "num_group": 16, "encoder_dims": 32, "knn_graph": 4, "not_a_field": 1}, "cpu")
    assert cfg.trans_dim == 32 and cfg.depth == 2 and len(model.blocks.layers) == 2
    # (the test's name is kept from when the pretraining model was not
    # ported): Point_MAE_Mamba builds from its transformer_config, and its
    # legacy 'MAMBA' path and the 'emd' loss raise with their ROADMAP item
    mae, mae_cfg = build_model_from_cfg({
        "NAME": "Point_MAE_Mamba", "group_size": 8, "num_group": 16, "loss": "cdl2",
        "transformer_config": {"trans_dim": 32, "encoder_dims": 32, "depth": 2,
                               "decoder_depth": 1, "knn_graph": 4, "k_top_eigenvectors": 2}},
        "cpu")
    assert (mae_cfg.trans_dim, mae_cfg.depth, mae_cfg.num_group) == (32, 2, 16)
    assert len(mae.MAE_encoder.blocks.layers) == 2 and len(mae.MAE_decoder.blocks.layers) == 1
    for bad in ({"method": "MAMBA"}, {"loss": "emd"}):
        with pytest.raises(NotImplementedError, match="M16b"):
            build_model_from_cfg({"NAME": "Point_MAE_Mamba", "transformer_config": bad}, "cpu")
    seg, seg_cfg = build_model_from_cfg({
        "NAME": "PartSegModel", "trans_dim": 32, "encoder_dims": 32, "depth": 4,
        "fetch_idx": [1, 2, 3], "num_group": 16, "group_size": 8, "knn_graph": 4}, "cpu")
    assert seg_cfg.fetch_idx == (1, 2, 3) and len(seg.blocks.layers) == 4
    with pytest.raises(KeyError, match="unknown NAME"):
        build_model_from_cfg({"NAME": "Nope"})


def test_registry_model_equals_the_seeded_default_build():
    import torch

    from si_mamba_tpu_torch.models import PointMamba, PointMambaConfig

    d = {"NAME": "PointMamba", "trans_dim": 32, "depth": 1, "group_size": 8, "num_group": 8,
         "encoder_dims": 32, "knn_graph": 4}
    model, cfg = build_model_from_cfg(d, "cpu")
    ref = PointMamba(PointMambaConfig.from_dict(d))
    for (k, v), (k2, v2) in zip(model.state_dict().items(), ref.state_dict().items()):
        assert k == k2 and torch.equal(v, v2)


def test_registry_builds_on_the_device_from_the_seed():
    """The one constructor of the runner and the CLI: the model on the
    device asked for, initialised from a generator of the seed given."""
    import torch

    from si_mamba_tpu_torch.models import PointMamba, PointMambaConfig

    d = {"NAME": "PointMamba", "trans_dim": 32, "depth": 1, "group_size": 8, "num_group": 8,
         "encoder_dims": 32, "knn_graph": 4}
    model, _ = build_model_from_cfg(d, torch.device("cpu"), seed=3)
    ref = PointMamba(PointMambaConfig.from_dict(d), generator=torch.Generator().manual_seed(3))
    seed0, _ = build_model_from_cfg(d, "cpu")
    assert all(p.device.type == "cpu" for p in model.parameters())
    assert any(not torch.equal(a, b) for a, b in zip(model.parameters(), seed0.parameters()))
    for (k, v), (k2, v2) in zip(model.state_dict().items(), ref.state_dict().items()):
        assert k == k2 and torch.equal(v, v2)
