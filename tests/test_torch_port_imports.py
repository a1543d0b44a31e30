"""The port stands alone: no file of ``si_mamba_tpu_torch/`` or
``chip_smoke.py`` imports JAX, its libraries, pyyaml or the JAX package, and
importing the port runs nothing on a device."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "yaml", "h5py", "si_mamba_tpu"}
PORT_FILES = sorted((ROOT / "si_mamba_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_nothing_of_jax(path):
    assert not _imported_roots(path) & FORBIDDEN


def test_port_package_has_its_kernel_sources():
    csrc = ROOT / "si_mamba_tpu_torch" / "csrc"
    assert {p.name for p in csrc.glob("*.cu")} >= {"causal_conv.cu", "selective_scan_fwd.cu",
                                                    "selective_scan_bwd.cu", "ssd_xbc_fwd.cu",
                                                    "ssd_xbc_bwd.cu", "fused_mixer_fwd.cu",
                                                    "fused_mixer_bwd.cu"}
    from si_mamba_tpu_torch.ops.kernels.build import SOURCES

    assert {f"{name}.cu" for name in SOURCES} == {p.name for p in csrc.glob("*.cu")}


def test_importing_the_port_loads_no_jax_module():
    code = ("import sys; before = set(sys.modules); "
            "import si_mamba_tpu_torch.serving, si_mamba_tpu_torch.ops.selective_scan, "
            "si_mamba_tpu_torch.ops.ssd, si_mamba_tpu_torch.parallel, "
            "si_mamba_tpu_torch.parallel.tensor_parallel, si_mamba_tpu_torch.parallel.seq_scan, "
            "si_mamba_tpu_torch.train.runner_finetune, si_mamba_tpu_torch.train.cli, "
            "si_mamba_tpu_torch.train.config, si_mamba_tpu_torch.train.checkpoint, "
            "si_mamba_tpu_torch.data.datasets, si_mamba_tpu_torch.data.shapenetpart, "
            "si_mamba_tpu_torch.models.segmentation, si_mamba_tpu_torch.train.runner_seg; "
            "bad = sorted(m for m in set(sys.modules) - before if m.split('.')[0] in %r); "
            "assert not bad, bad" % (FORBIDDEN,))
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


def test_predictor_without_a_device_raises_when_no_gpu():
    """Entry points default to 'cuda' and never fall back to the CPU."""
    from si_mamba_tpu_torch.models import PointMamba, PointMambaConfig
    from si_mamba_tpu_torch.serving import Predictor

    model = PointMamba(PointMambaConfig(trans_dim=32, encoder_dims=32, depth=1, num_group=8,
                                        group_size=8, knn_graph=4))
    if torch.cuda.is_available():
        assert Predictor(model, npoints=128).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no GPU"):
            Predictor(model, npoints=128)
