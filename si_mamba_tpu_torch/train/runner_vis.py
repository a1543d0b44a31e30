"""MAE reconstruction visualisation, the counterpart of
``si_mamba_tpu/train/runner_vis.py`` (the reference's tools/runner.py:14-111):
reconstruct the masked patches of test clouds with a pretrained
``PointMAEMamba`` and dump each sample's clouds as text and PNG renders
(``utils/visualization.save_reconstruction``; the JAX package renders JPEG)."""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from si_mamba_tpu_torch.models.point_mae import PointMAEConfig, PointMAEMamba
from si_mamba_tpu_torch.utils.device import resolve_device
from si_mamba_tpu_torch.utils.visualization import save_reconstruction


def _model(cfg, model_or_state, device) -> PointMAEMamba:
    """The model to reconstruct with: a ``PointMAEMamba`` as given, or a state
    dict in the pretraining checkpoint's keys
    (``MAE_encoder.*``, ``MAE_decoder.*``, ...; a ``module.`` prefix dropped)
    loaded strict into a model of ``cfg`` on ``device``."""
    if isinstance(model_or_state, PointMAEMamba):
        return model_or_state
    if not isinstance(model_or_state, Mapping):
        raise TypeError(f"expected a PointMAEMamba or a state dict, got "
                        f"{type(model_or_state).__name__}")
    cfg = cfg if isinstance(cfg, PointMAEConfig) else PointMAEConfig.from_dict(cfg)
    model = PointMAEMamba(cfg)
    model.load_state_dict({k.replace("module.", ""): torch.as_tensor(np.asarray(v))
                           if not isinstance(v, torch.Tensor) else v
                           for k, v in model_or_state.items()}, strict=True)
    return model.to(resolve_device(device))


def vis_run(cfg, model_or_state, loader, out_dir: str, max_samples: int = 16, seed: int = 0,
            device="cuda") -> list[str]:
    """The eval forward with ``vis=True`` over the loader's epoch 0, each
    batch's mask drawn from a ``torch.Generator`` on the model's device seeded
    with ``seed`` (the JAX package draws every batch's from ``key(seed)``);
    each sample's reconstruction and ground truth dumped as ``sample_NNNN``
    (as the JAX package, the rebuilt clouds go to ``_full`` and the ground
    truth to ``_vis``). ``device`` places a model built from a state dict.
    Returns the dumped tags."""
    model = _model(cfg, model_or_state, device).eval()
    dev = next(model.parameters()).device
    generator = torch.Generator(dev)
    tags: list[str] = []
    with torch.no_grad():
        for pts, _ in loader.epoch(0):
            generator.manual_seed(seed)
            _, rec = model(torch.from_numpy(np.asarray(pts)).to(dev), vis=True,
                           generator=generator)
            rebuild = rec["rebuild"].float().cpu().numpy()  # (B, T, M, 3)
            gt = rec["gt"].float().cpu().numpy()
            for b in range(rebuild.shape[0]):
                tag = f"sample_{len(tags):04d}"
                save_reconstruction(out_dir, tag, rebuild[b].reshape(-1, 3), gt[b].reshape(-1, 3))
                tags.append(tag)
                if len(tags) >= max_samples:
                    return tags
    return tags
