"""Weights in the reference's state-dict layout.

- :func:`state_dict_from_jax` / :func:`partseg_state_dict_from_jax` /
  :func:`point_mae_state_dict_from_jax` / :func:`permute_policy_state_dict_from_jax`:
  the JAX package's flax variables of the classifier / the part-segmentation
  model / the pretraining model / the permutation policy (as numpy arrays)
  -> this package's state dict. The layout rules
  are the same as the JAX package's ``utils/torch_export.py``: Dense
  kernels (in, out) transpose to Linear weights (out, in), k=1 conv kernels
  gain a trailing axis, the mixer conv (d, W) becomes (d, 1, W), BatchNorm
  scale/bias + batch_stats become weight/bias/running_mean/running_var
  (+ ``num_batches_tracked``), an RMSNorm's scale its weight.
- :func:`load_state_dict_file`: a reference-format ``.pth``
  (``{'base_model': state_dict, ...}``), with the ``module.`` /
  ``MAE_encoder.`` / ``base_model.`` prefixes stripped. An orbax directory
  in its place is refused with ``ORBAX_NOT_READ``.
- :func:`shard_state_dict` / :func:`gather_state_dict`: a full state dict to
  one rank's state dict of the tensor-parallel model, and every rank's back
  to the full one.
"""

from __future__ import annotations

from collections.abc import Sequence
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
    """A LayerNorm's scale and bias, or an RMSNorm's scale alone."""
    out[f"{key}.weight"] = _t(p["scale"])
    if "bias" in p:
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


def _stack(out, blocks, key) -> None:
    """A MixerModel's (or MixerModelAdd's, which has the same tree) blocks
    and final norm under ``key``. The depth is read from the block tree, and
    each mixer's kind from its keys (the SSD mixer has ``norm_scale``,
    Mamba-1 ``x_proj``)."""
    depth = sum(1 for k in blocks if k.startswith("layers_"))
    for i in range(depth):
        _ln(out, f"{key}.layers.{i}.norm", blocks[f"layers_{i}"]["norm"])
        mixer = blocks[f"layers_{i}"]["mixer"]
        (_ssd_mixer if "norm_scale" in mixer else _mixer)(out, f"{key}.layers.{i}.mixer", mixer)
    _ln(out, f"{key}.norm_f", blocks["norm_f"])


def _backbone(out, params, batch_stats, prefix: str = "") -> None:
    """The encoder, pos-embed, block stack and final norm, which the
    classifier, the segmentation model and the pretraining model's encoder
    (under ``prefix`` 'MAE_encoder.') share."""
    enc, enc_s = params["encoder"], batch_stats["encoder"]
    _conv1x1(out, f"{prefix}encoder.first_conv.0", enc["conv1"])
    _bn(out, f"{prefix}encoder.first_conv.1", enc["bn1"], enc_s["bn1"])
    _conv1x1(out, f"{prefix}encoder.first_conv.3", enc["conv2"])
    _conv1x1(out, f"{prefix}encoder.second_conv.0", enc["conv3"])
    _bn(out, f"{prefix}encoder.second_conv.1", enc["bn2"], enc_s["bn2"])
    _conv1x1(out, f"{prefix}encoder.second_conv.3", enc["conv4"])
    _dense(out, f"{prefix}pos_embed.0", params["pos_embed"]["fc1"])
    _dense(out, f"{prefix}pos_embed.2", params["pos_embed"]["fc2"])
    _stack(out, params["blocks"], f"{prefix}blocks")
    _ln(out, f"{prefix}norm", params["norm"])


def state_dict_from_jax(params: Mapping[str, Any], batch_stats: Mapping[str, Any]
                        ) -> Dict[str, torch.Tensor]:
    """The JAX ``PointMamba``'s variables (``params``, ``batch_stats``, as
    nested dicts of arrays) -> a state dict that ``PointMamba`` loads with
    ``strict=True``; with ``rms_norm`` the stack's norms are RMSNorms, with
    ``add_after_layer`` the stack is ``MixerModelAdd``, both under the same
    ``blocks.*`` keys."""
    out: Dict[str, torch.Tensor] = {}
    _backbone(out, params, batch_stats)
    head, head_s = params["cls_head_finetune"], batch_stats["cls_head_finetune"]
    _dense(out, "cls_head_finetune.0", head["fc1"])
    _bn(out, "cls_head_finetune.1", head["bn1"], head_s["bn1"])
    _dense(out, "cls_head_finetune.4", head["fc2"])
    _bn(out, "cls_head_finetune.5", head["bn2"], head_s["bn2"])
    _dense(out, "cls_head_finetune.8", head["out"])
    return out


def partseg_state_dict_from_jax(params: Mapping[str, Any], batch_stats: Mapping[str, Any]
                                ) -> Dict[str, torch.Tensor]:
    """The JAX ``PartSegModel``'s variables -> a state dict that the port's
    ``PartSegModel`` loads with ``strict=True``: the classifier's backbone
    keys and ``label_conv``, ``label_bn``, ``prop_fc{1,2}``, ``prop_bn{1,2}``,
    ``convs{1,2,3}`` and ``bns{1,2}``, the keys of the reference's
    part-segmentation checkpoints."""
    out: Dict[str, torch.Tensor] = {}
    _backbone(out, params, batch_stats)
    _dense(out, "label_conv", params["label_conv"])
    _bn(out, "label_bn", params["label_bn"], batch_stats["label_bn"])
    for i in (1, 2):
        _dense(out, f"prop_fc{i}", params[f"prop_fc{i}"])
        _bn(out, f"prop_bn{i}", params[f"prop_bn{i}"], batch_stats[f"prop_bn{i}"])
    for i in (1, 2, 3):
        _dense(out, f"convs{i}", params[f"convs{i}"])
    for i in (1, 2):
        _bn(out, f"bns{i}", params[f"bns{i}"], batch_stats[f"bns{i}"])
    return out


def point_mae_state_dict_from_jax(params: Mapping[str, Any], batch_stats: Mapping[str, Any]
                                  ) -> Dict[str, torch.Tensor]:
    """The JAX ``PointMAEMamba``'s variables -> a state dict that the port's
    ``PointMAEMamba`` loads with ``strict=True``, in the keys of the
    reference's pretraining checkpoints (those the JAX package's
    ``utils/torch_import.import_point_mae`` reads): ``MAE_encoder.{encoder,
    pos_embed, blocks, norm}``, ``MAE_decoder.{blocks, norm}``,
    ``mask_token``, ``increase_dim.0`` (a k=1 conv) and ``diff_sgwt.pos_embed.
    {0,2}`` / ``diff_sgwt.mixer.{0,1,3,4,6}``; the legacy 'MAMBA' model has
    ``decoder_pos_embed.{0,2}`` (the reference's key) in place of
    ``diff_sgwt``. A finetune run takes the
    encoder's keys from it (``MAE_encoder.`` is one of the prefixes that
    :func:`_strip_prefixes` drops)."""
    out: Dict[str, torch.Tensor] = {}
    _backbone(out, params, batch_stats, prefix="MAE_encoder.")
    _stack(out, params["MAE_decoder"], "MAE_decoder.blocks")
    _ln(out, "MAE_decoder.norm", params["decoder_norm"])
    out["mask_token"] = _t(np.asarray(params["mask_token"]).reshape(1, 1, -1))
    _conv1x1(out, "increase_dim.0", params["increase_dim"])
    if "decoder_pos_embed" in params:
        _dense(out, "decoder_pos_embed.0", params["decoder_pos_embed"]["fc1"])
        _dense(out, "decoder_pos_embed.2", params["decoder_pos_embed"]["fc2"])
        return out
    sg = params["diff_sgwt"]
    for key, name in (("pos_embed.0", "pos_embed_fc1"), ("pos_embed.2", "pos_embed_fc2"),
                      ("mixer.0", "mixer_fc1"), ("mixer.3", "mixer_fc2"),
                      ("mixer.6", "mixer_fc3")):
        _dense(out, f"diff_sgwt.{key}", sg[name])
    _ln(out, "diff_sgwt.mixer.1", sg["mixer_ln1"])
    _ln(out, "diff_sgwt.mixer.4", sg["mixer_ln2"])
    return out


def permute_policy_state_dict_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX ``PermutePolicy``'s params -> a state dict that the port's
    ``PermutePolicy`` loads with ``strict=True``. No source the port can read
    cites the reference's torch keys for these layers, so the keys are the
    JAX names: ``eigen_fc1``, ``eigen_fc2``, ``logit_blocks.{layers.{i},
    norm_f}``, ``logit_norm``, ``logit_head_{fc1,ln,fc2}`` and
    ``logit_head2_{fc1,ln,fc2}``."""
    out: Dict[str, torch.Tensor] = {}
    _dense(out, "eigen_fc1", params["eigen_fc1"])
    _dense(out, "eigen_fc2", params["eigen_fc2"])
    _stack(out, params["logit_blocks"], "logit_blocks")
    _ln(out, "logit_norm", params["logit_norm"])
    for head in ("logit_head", "logit_head2"):
        _dense(out, f"{head}_fc1", params[f"{head}_fc1"])
        _ln(out, f"{head}_ln", params[f"{head}_ln"])
        _dense(out, f"{head}_fc2", params[f"{head}_fc2"])
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


ORBAX_NOT_READ = ("orbax checkpoint directories are not read by the PyTorch port: convert "
                  "one with `python scripts/export_torch.py --exp_dir <experiment dir> "
                  "--prefix <ckpt-best|ckpt-last|...>` and pass the .pth it writes")


def load_state_dict_file(path: str) -> Dict[str, torch.Tensor]:
    """Load a reference-format ``.pth`` (tensors only) as a flat state dict."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    return as_state_dict(ckpt.get("base_model", ckpt.get("model", ckpt)))


# ---------------------------------------------------------------------------
# tensor-parallel shards of the reference-keyed state dict
# ---------------------------------------------------------------------------
# Each mixer tensor is a concatenation of segments along one dimension; a
# sharded segment splits into contiguous blocks, one a rank (channels of
# d_inner, or whole heads), a replicated one (the SSD mixer's B|C rows) is
# whole on every rank. The layouts are those of
# ``parallel/tensor_parallel.shard_mixer_params`` and
# ``shard_ssd_mixer_params`` in the reference's (out, in) orientation.

def _mixer_segments(mixer: str, d_inner: int, d_state: int, n_heads: int) -> dict:
    """name -> (dim, [(full length, sharded), ...]) of one mixer's tensors."""
    ch = [(d_inner, True)]
    if mixer == "mamba":
        return {"in_proj.weight": (0, ch + ch), "conv1d.weight": (0, ch), "conv1d.bias": (0, ch),
                "x_proj.weight": (1, ch), "dt_proj.weight": (0, ch), "dt_proj.bias": (0, ch),
                "A_log": (0, ch), "D": (0, ch), "out_proj.weight": (1, ch)}
    if mixer == "ssd":
        bc, heads = [(2 * d_state, False)], [(n_heads, True)]
        return {"in_proj.weight": (0, ch + ch + bc + heads), "conv1d.weight": (0, ch + bc),
                "conv1d.bias": (0, ch + bc), "dt_bias": (0, heads), "A_log": (0, heads),
                "D": (0, heads), "norm.weight": (0, ch), "out_proj.weight": (1, ch)}
    raise ValueError(f"unknown mixer {mixer!r}")


def _mixer_dims(sd: Mapping[str, torch.Tensor], mixer: str, scale: int = 1):
    """(d_inner, d_state, n_heads) of a mixer's tensors, each local extent
    times ``scale`` for a shard (B|C is whole on every rank)."""
    if mixer == "mamba":
        return sd["conv1d.bias"].shape[0] * scale, 0, 0
    d_inner = sd["norm.weight"].shape[0] * scale
    n_heads = sd["dt_bias"].shape[0] * scale
    d_state = (sd["conv1d.bias"].shape[0] - sd["norm.weight"].shape[0]) // 2
    if n_heads % scale or d_inner % scale:
        raise ValueError("the mixer's heads or channels do not split evenly")
    return d_inner, d_state, n_heads


def mixer_segments(local: Mapping[str, torch.Tensor], mixer: str,
                   size: int) -> Dict[str, tuple]:
    """One rank's shard of a mixer (keys relative to the mixer) -> {name:
    (dim, [(local length, sharded), ...])}, the segments each tensor is made
    of along its split dimension."""
    d_inner, d_state, n_heads = _mixer_dims(local, mixer, scale=size)
    return {name: (dim, [(n // size if sharded else n, sharded) for n, sharded in segments])
            for name, (dim, segments) in _mixer_segments(mixer, d_inner, d_state,
                                                         n_heads).items()}


def shard_mixer_state(sd: Mapping[str, torch.Tensor], mixer: str, rank: int,
                      size: int) -> Dict[str, torch.Tensor]:
    """One mixer's full state dict (keys relative to the mixer) -> rank
    ``rank``'s shard of ``size``."""
    d_inner, d_state, n_heads = _mixer_dims(sd, mixer)
    if mixer == "ssd" and n_heads % size:
        raise ValueError(f"the tensor-parallel SSD mixer shards whole heads: n_heads={n_heads} "
                         f"must be divisible by {size}")
    out = {}
    for name, (dim, segments) in _mixer_segments(mixer, d_inner, d_state, n_heads).items():
        parts = torch.split(sd[name], [n for n, _ in segments], dim=dim)
        out[name] = torch.cat([
            p.narrow(dim, rank * (n // size), n // size) if sharded else p
            for p, (n, sharded) in zip(parts, segments)], dim=dim).clone()
    return out


def gather_mixer_state(parts: Sequence[Mapping[str, torch.Tensor]],
                       mixer: str) -> Dict[str, torch.Tensor]:
    """The reverse of :func:`shard_mixer_state`: the shards of every rank, in
    rank order -> the full mixer state dict (a replicated segment from rank
    0's shard)."""
    size = len(parts)
    d_inner, d_state, n_heads = _mixer_dims(parts[0], mixer, scale=size)
    out = {}
    for name, (dim, segments) in _mixer_segments(mixer, d_inner, d_state, n_heads).items():
        local = [n // size if sharded else n for n, sharded in segments]
        pieces = [torch.split(p[name], local, dim=dim) for p in parts]
        out[name] = torch.cat([
            torch.cat([pc[i] for pc in pieces], dim=dim) if sharded else pieces[0][i]
            for i, (_, sharded) in enumerate(segments)], dim=dim)
    return out


def _mixer_prefixes(sd: Mapping[str, Any]) -> list[str]:
    return sorted({k[:k.index(".mixer.") + len(".mixer.")] for k in sd if ".mixer." in k})


def shard_state_dict(full: Mapping[str, torch.Tensor], cfg, rank: int,
                     size: int) -> Dict[str, torch.Tensor]:
    """The reference-keyed full state dict (from :func:`state_dict_from_jax`,
    a ``.pth`` or a single-process ``PointMamba``) -> rank ``rank``'s state
    dict of the tensor-parallel model of ``cfg`` over ``size`` ranks, which
    its ``load_state_dict(strict=True)`` takes. Every mixer tensor is cut as
    ``parallel/tensor_parallel`` shards it; everything else is replicated."""
    out = dict(full)
    for prefix in _mixer_prefixes(full):
        mixer = {k[len(prefix):]: v for k, v in full.items() if k.startswith(prefix)}
        for k, v in shard_mixer_state(mixer, cfg.mixer, rank, size).items():
            out[prefix + k] = v
    return out


def gather_state_dict(parts: Sequence[Mapping[str, torch.Tensor]],
                      cfg) -> Dict[str, torch.Tensor]:
    """The reverse of :func:`shard_state_dict`: every rank's state dict (or
    gradients in its layout), in rank order -> the full state dict of the
    single-process model. Replicated entries come from rank 0."""
    out = dict(parts[0])
    for prefix in _mixer_prefixes(parts[0]):
        shards = [{k[len(prefix):]: v for k, v in p.items() if k.startswith(prefix)}
                  for p in parts]
        for k, v in gather_mixer_state(shards, cfg.mixer).items():
            out[prefix + k] = v
    return out


def stage_state_dict(full: Mapping[str, torch.Tensor], stage: int, n_stages: int,
                     depth: int, prefix: str = "blocks.") -> Dict[str, torch.Tensor]:
    """One pipeline stage's part of a whole reference-keyed state dict: the
    blocks [stage depth/n_stages, (stage + 1) depth/n_stages) of the mixer
    stack under ``prefix``, renumbered from 0, and its final norm, as the
    state dict of a ``MixerModel`` of depth/n_stages blocks
    (``parallel/pipeline.stack_mixer_params`` of it with one stage is that
    stage). Raises unless ``n_stages`` divides ``depth``."""
    if depth % n_stages:
        raise ValueError(f"pipeline stages must divide the stack depth evenly: "
                         f"n_layer={depth}, n_stages={n_stages}")
    per = depth // n_stages
    out = {}
    for j in range(per):
        head = f"{prefix}layers.{stage * per + j}."
        out.update({f"layers.{j}.{k[len(head):]}": v for k, v in full.items()
                    if k.startswith(head)})
    out.update({k[len(prefix):]: v for k, v in full.items()
                if k.startswith(prefix + "norm_f.")})
    return out
