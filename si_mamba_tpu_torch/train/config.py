"""The experiment configs: YAML with recursive ``_base_`` inclusion (the
reference's utils/config.py:18-58) read into attribute-accessible dicts, the
counterpart of ``si_mamba_tpu/train/config.py``. The files are read with the
port's own reader of the YAML subset they use (``train/yaml_subset.py``), on
every host: the machine with the GPU has no pyyaml."""

from __future__ import annotations

import os
from typing import Any

from si_mamba_tpu_torch.train import yaml_subset


class ConfigDict(dict):
    """dict with attribute access (replacement for EasyDict)."""

    def __getattr__(self, k):
        try:
            v = self[k]
        except KeyError as e:
            raise AttributeError(k) from e
        return v

    def __setattr__(self, k, v):
        self[k] = v

    def get(self, k, default=None):
        return super().get(k, default)


def _to_config(obj: Any) -> Any:
    if isinstance(obj, dict):
        return ConfigDict({k: _to_config(v) for k, v in obj.items()})
    if isinstance(obj, list):
        return [_to_config(v) for v in obj]
    return obj


def _read(path: str) -> Any:
    with open(path) as f:
        return yaml_subset.load(f.read())


def merge_new_config(config: dict, new_config: dict, base_dir: str = ".") -> dict:
    """Recursive merge with ``_base_`` file inclusion: a ``_base_`` key loads
    the referenced YAML into that subtree. A ``_base_`` that is already a
    dict (in an experiment's re-read ``config.yaml`` snapshot, which holds the
    resolved subtree) merges directly. A path is tried as given when
    absolute, else relative to ``base_dir``, to its parent (the repository
    root for a config in cfgs/, where the reference's "cfgs/..." refs
    resolve), then to the working directory."""
    for key, val in new_config.items():
        if key == "_base_":
            config[key] = ConfigDict()
            if isinstance(val, dict):
                merge_new_config(config[key], val, base_dir)
                continue
            if os.path.isabs(val):
                path = val
            else:
                cands = [os.path.join(base_dir, val),
                         os.path.join(os.path.dirname(base_dir.rstrip("/")), val),
                         val]
                path = next((c for c in cands if os.path.isfile(c)), cands[0])
            merge_new_config(config[key], _read(path) or {}, base_dir)
            continue
        if isinstance(val, dict):
            if key not in config or not isinstance(config[key], dict):
                config[key] = ConfigDict()
            merge_new_config(config[key], val, base_dir)
        else:
            config[key] = val
    return config


def cfg_from_yaml_file(path: str, base_dir: str | None = None) -> ConfigDict:
    """Read one config file. A top-level ``_base_`` inherits the whole
    referenced config (tried relative to the file's directory, then as
    given), which the file's keys then override; a subtree ``_base_`` loads
    into that subtree (:func:`merge_new_config`)."""
    raw = _read(path) or {}
    bd = base_dir or os.path.dirname(os.path.abspath(path))
    cfg = ConfigDict()
    base_ref = raw.pop("_base_", None)
    if base_ref is not None:
        candidates = ([base_ref] if os.path.isabs(base_ref)
                      else [os.path.join(bd, base_ref), base_ref])
        bpath = next((c for c in candidates if os.path.isfile(c)), candidates[0])
        cfg = ConfigDict(get_config(bpath))
    merge_new_config(cfg, raw, bd)
    return _to_config(cfg)


def get_config(path: str, base_dir: str | None = None) -> ConfigDict:
    """Load an experiment config. ``base_dir`` anchors relative ``_base_``
    paths (default: the config file's directory; on a missing file the
    working directory is tried instead)."""
    try:
        return cfg_from_yaml_file(path, base_dir)
    except FileNotFoundError:
        return cfg_from_yaml_file(path, os.getcwd())


def save_experiment_config(cfg: ConfigDict, out_path: str) -> None:
    """Write the resolved config as block-style YAML, which this package's
    reader and ``yaml.safe_load`` both read back to the same dict."""
    with open(out_path, "w") as f:
        f.write(yaml_subset.dump(cfg))
