"""scripts/torch_run_fewshot.py, the port's few-shot sweep, on the CPU: two
folds of cfgs/dev/tiny_fewshot_cpu.yaml at max_epoch 0 through the port's
CLI, each on its own seeded ModelNetFewshot pickle (as chip_smoke.py's
few-shot phase writes one), and the JSON summary line of
scripts/run_fewshot.py aggregated from the folds' scalars.jsonl."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

import numpy as np

from tests.test_torch_port_classifier_options import _write_fewshot

ROOT = Path(__file__).resolve().parents[1]


def _script():
    spec = importlib.util.spec_from_file_location("torch_run_fewshot",
                                                  ROOT / "scripts" / "torch_run_fewshot.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_sweep_runs_two_folds_and_aggregates_their_accuracy(tmp_path, monkeypatch, capsys):
    for fold in (0, 1):
        data = _write_fewshot(tmp_path / f"f{fold}", 5, 10, fold, 4)
        # one ModelNetFewshot tree holding both folds' pickles
        dst = tmp_path / "ModelNetFewshot" / "5way_10shot"
        dst.mkdir(parents=True, exist_ok=True)
        (dst / f"{fold}.pkl").write_bytes((data / "5way_10shot" / f"{fold}.pkl").read_bytes())
    monkeypatch.chdir(tmp_path)
    (tmp_path / "cfgs").symlink_to(ROOT / "cfgs")  # the dev presets' refs are CWD-relative
    (tmp_path / "fs_ds.yaml").write_text(
        f"NAME: ModelNetFewShot\nDATA_PATH: {tmp_path / 'ModelNetFewshot'}\n")
    cfg = tmp_path / "fs.yaml"
    cfg.write_text("_base_: cfgs/dev/tiny_fewshot_cpu.yaml\ndataset:\n" + "".join(
        f"  {s}: {{_base_: {tmp_path / 'fs_ds.yaml'}, others: {{subset: '{sub}'}}}}\n"
        for s, sub in (("train", "train"), ("val", "test"), ("test", "test"))) +
        "max_epoch: 0\n")
    summary = _script().main(["--config", str(cfg), "--way", "5", "--shot", "10",
                              "--folds", "2", "--exp_name", "sw", "--device", "cpu",
                              "--num_workers", "0"])
    assert set(summary) == {"way", "shot", "folds", "accs", "mean", "std"}
    assert (summary["way"], summary["shot"], summary["folds"]) == (5, 10, 2)
    assert len(summary["accs"]) == 2 and all(0.0 <= a <= 100.0 for a in summary["accs"])
    assert summary["mean"] == float(np.mean(summary["accs"]))
    assert summary["std"] == float(np.std(summary["accs"]))
    for fold in (0, 1):
        exp = tmp_path / "experiments" / "fs" / f"sw_w5s10_f{fold}"
        accs = [json.loads(line)["value"] for line in (exp / "scalars.jsonl").read_text()
                .splitlines() if json.loads(line).get("tag") == "Metric/ACC"]
        assert summary["accs"][fold] == max(accs)
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == summary
    assert json.loads((tmp_path / "experiments" / "fs" / "sw_w5s10.json").read_text()) == summary
