"""Weights in the reference's state-dict layout.

- :func:`state_dict_from_jax`: the JAX package's flax variables (as numpy
  arrays) -> this package's state dict. The layout rules are the same as the
  JAX package's ``utils/torch_export.py``: Dense kernels (in, out) transpose
  to Linear weights (out, in), k=1 conv kernels gain a trailing axis, the
  mixer conv (d, W) becomes (d, 1, W), BatchNorm scale/bias + batch_stats
  become weight/bias/running_mean/running_var (+ ``num_batches_tracked``).
- :func:`load_state_dict_file`: a reference-format ``.pth``
  (``{'base_model': state_dict, ...}``), with the ``module.`` /
  ``MAE_encoder.`` / ``base_model.`` prefixes stripped.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def _t(v) -> torch.Tensor:
    return torch.tensor(np.asarray(v))  # a copy: JAX hands out read-only buffers


def _dense(out, key, p) -> None:
    out[f"{key}.weight"] = _t(np.asarray(p["kernel"]).T)
    if "bias" in p:
        out[f"{key}.bias"] = _t(p["bias"])


def _conv1x1(out, key, p) -> None:
    out[f"{key}.weight"] = _t(np.asarray(p["kernel"]).T[..., None])
    out[f"{key}.bias"] = _t(p["bias"])


def _ln(out, key, p) -> None:
    out[f"{key}.weight"] = _t(p["scale"])
    out[f"{key}.bias"] = _t(p["bias"])


def _bn(out, key, p, s) -> None:
    _ln(out, key, p)
    out[f"{key}.running_mean"] = _t(s["mean"])
    out[f"{key}.running_var"] = _t(s["var"])
    out[f"{key}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)


def _mixer(out, key, m) -> None:
    out[f"{key}.in_proj.weight"] = _t(np.asarray(m["in_proj"]).T)
    out[f"{key}.conv1d.weight"] = _t(np.asarray(m["conv1d_weight"])[:, None, :])
    out[f"{key}.conv1d.bias"] = _t(m["conv1d_bias"])
    out[f"{key}.x_proj.weight"] = _t(np.asarray(m["x_proj"]).T)
    out[f"{key}.dt_proj.weight"] = _t(np.asarray(m["dt_proj"]).T)
    out[f"{key}.dt_proj.bias"] = _t(m["dt_proj_bias"])
    out[f"{key}.A_log"] = _t(m["A_log"])
    out[f"{key}.D"] = _t(m["D"])
    out[f"{key}.out_proj.weight"] = _t(np.asarray(m["out_proj"]).T)


def _ssd_mixer(out, key, m) -> None:
    out[f"{key}.in_proj.weight"] = _t(np.asarray(m["in_proj"]).T)
    out[f"{key}.conv1d.weight"] = _t(np.asarray(m["conv1d_weight"])[:, None, :])
    out[f"{key}.conv1d.bias"] = _t(m["conv1d_bias"])
    for name in ("dt_bias", "A_log", "D"):
        out[f"{key}.{name}"] = _t(m[name])
    out[f"{key}.norm.weight"] = _t(m["norm_scale"])
    out[f"{key}.out_proj.weight"] = _t(np.asarray(m["out_proj"]).T)


def state_dict_from_jax(params: Mapping[str, Any], batch_stats: Mapping[str, Any]
                        ) -> Dict[str, torch.Tensor]:
    """The JAX ``PointMamba``'s variables (``params``, ``batch_stats``, as
    nested dicts of arrays) -> a state dict that ``PointMamba`` loads with
    ``strict=True``. The depth is read from the block tree, and each mixer's
    kind from its keys (the SSD mixer has ``norm_scale``, Mamba-1 ``x_proj``)."""
    out: Dict[str, torch.Tensor] = {}
    enc, enc_s = params["encoder"], batch_stats["encoder"]
    _conv1x1(out, "encoder.first_conv.0", enc["conv1"])
    _bn(out, "encoder.first_conv.1", enc["bn1"], enc_s["bn1"])
    _conv1x1(out, "encoder.first_conv.3", enc["conv2"])
    _conv1x1(out, "encoder.second_conv.0", enc["conv3"])
    _bn(out, "encoder.second_conv.1", enc["bn2"], enc_s["bn2"])
    _conv1x1(out, "encoder.second_conv.3", enc["conv4"])
    _dense(out, "pos_embed.0", params["pos_embed"]["fc1"])
    _dense(out, "pos_embed.2", params["pos_embed"]["fc2"])
    blocks = params["blocks"]
    depth = sum(1 for k in blocks if k.startswith("layers_"))
    for i in range(depth):
        _ln(out, f"blocks.layers.{i}.norm", blocks[f"layers_{i}"]["norm"])
        mixer = blocks[f"layers_{i}"]["mixer"]
        (_ssd_mixer if "norm_scale" in mixer else _mixer)(out, f"blocks.layers.{i}.mixer", mixer)
    _ln(out, "blocks.norm_f", blocks["norm_f"])
    _ln(out, "norm", params["norm"])
    head, head_s = params["cls_head_finetune"], batch_stats["cls_head_finetune"]
    _dense(out, "cls_head_finetune.0", head["fc1"])
    _bn(out, "cls_head_finetune.1", head["bn1"], head_s["bn1"])
    _dense(out, "cls_head_finetune.4", head["fc2"])
    _bn(out, "cls_head_finetune.5", head["bn2"], head_s["bn2"])
    _dense(out, "cls_head_finetune.8", head["out"])
    return out


def _strip_prefixes(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """Drop the ``module.``, ``MAE_encoder.`` and ``base_model.`` prefixes of
    reference checkpoints."""
    out = {}
    for k, v in sd.items():
        k = k.replace("module.", "")
        for pref in ("MAE_encoder.", "base_model."):
            if k.startswith(pref):
                k = k[len(pref):]
        out[k] = v
    return out


def as_state_dict(sd: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A flat mapping of arrays or tensors -> CPU tensors, prefixes stripped."""
    return {k: v.detach().cpu() if isinstance(v, torch.Tensor) else _t(v)
            for k, v in _strip_prefixes(sd).items()}


def load_state_dict_file(path: str) -> Dict[str, torch.Tensor]:
    """Load a reference-format ``.pth`` (tensors only) as a flat state dict."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    return as_state_dict(ckpt.get("base_model", ckpt.get("model", ckpt)))
