"""``scripts/torch_wide_head_grads.py`` on the CPU at two blocks: every
block's per-head figures are there, finite, and read as chip_smoke.py's
per-head rule reads them. On the card the script runs the kernels; here the
'ssd_fused' route is their plain versions."""

from __future__ import annotations

import importlib.util
import math
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """The tensors here are small, and the suite runs one worker a core: more
    than one intra-op thread a worker only contends for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def script():
    spec = importlib.util.spec_from_file_location(
        "torch_wide_head_grads", ROOT / "scripts" / "torch_wide_head_grads.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_per_block_figures_on_the_cpu(script, monkeypatch):
    monkeypatch.setattr(script.cs, "WIDE_DEPTH", 2)
    torch.manual_seed(0)
    rows = script.stack_figures(torch.device("cpu"), 128, 256, 400)
    assert [(r["block"], r["leaf"]) for r in rows] == [
        (i, k) for i in range(2) for k in ("A_log", "D", "dt_bias")]
    for r in rows:
        assert all(math.isfinite(r[k]) and 0 <= r[k] < 0.5
                   for k in ("from_truth", "plain_from_truth", "from_plain"))
    s = script.summary(rows)
    assert s["passes_rule"] and s["from_truth"]["max"] == max(r["from_truth"] for r in rows)


def test_needs_the_card(script):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit, match="no CUDA device"):
        script.main(["--seeds", "400"])
