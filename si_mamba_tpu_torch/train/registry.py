"""Name -> constructor registry, the counterpart of
``si_mamba_tpu/train/registry.py`` (the reference's NAME dispatch,
models/build.py:5-8)."""

from __future__ import annotations

from typing import Any, Callable, Dict

import torch


class Registry:
    def __init__(self, name: str):
        self.name = name
        self._entries: Dict[str, Callable] = {}

    def register(self, name: str | None = None):
        def deco(fn):
            self._entries[name or fn.__name__] = fn
            return fn

        return deco

    def build(self, cfg: dict, **extra: Any):
        cfg = dict(cfg)
        name = cfg.pop("NAME")
        if name not in self._entries:
            raise KeyError(f"{self.name}: unknown NAME {name!r}; have "
                           f"{sorted(self._entries)}")
        return self._entries[name](**cfg, **extra)

    def __contains__(self, name):
        return name in self._entries


MODELS = Registry("models")


def build_model_from_cfg(model_cfg: dict, device="cuda", seed: int = 0):
    """NAME-dispatched model construction: (model, config dataclass) for the
    reference's NAME strings. The model is built on ``device`` (the card
    unless the caller asks for the CPU, as the CLI and ``Predictor`` default)
    from a generator on that device seeded with ``seed``."""
    if model_cfg["NAME"] not in MODELS:
        _register_builtin_models()
    return MODELS.build(dict(model_cfg), device=torch.device(device), seed=seed)


def _register_builtin_models():
    from si_mamba_tpu_torch.models import PointMamba, PointMambaConfig
    from si_mamba_tpu_torch.models.segmentation import PartSegConfig, PartSegModel

    def point_mamba(device, seed, **cfg):
        c = PointMambaConfig.from_dict({k: (tuple(v) if isinstance(v, list) else v)
                                        for k, v in cfg.items()})
        with torch.device(device):
            return PointMamba(c, generator=torch.Generator(device).manual_seed(seed)), c

    def part_seg(device, seed, **cfg):
        c = PartSegConfig.from_dict(cfg)
        with torch.device(device):
            return PartSegModel(c, generator=torch.Generator(device).manual_seed(seed)), c

    def not_ported(name: str, item: str):
        def build(**cfg):
            raise NotImplementedError(f"{name} is not ported yet (ROADMAP.md queue 1, {item})")

        return build

    MODELS.register("PointMamba")(point_mamba)
    MODELS.register("Point_MAE_Mamba")(not_ported("Point_MAE_Mamba (MAE pretraining)", "M16"))
    MODELS.register("PartSegModel")(part_seg)
