"""flax params (and batch_stats) -> the port's ``state_dict``.

The flax trees come in as nested dicts of numpy arrays, as a msgpack
checkpoint decodes.  What changes on the way:

  * a flax ``Dense`` kernel is (in, out), a torch ``Linear`` weight
    (out, in): transposed.  The vit's ``qkv`` kernel keeps its column
    order, so the port's ``split(dim)`` yields q, k, v exactly as
    ``jnp.split``;
  * a conv kernel is HWIO, torch's OIHW: permuted;
  * flax ``LayerNorm``/``BatchNorm`` ``scale``/``bias`` ->
    ``weight``/``bias``; ``batch_stats`` ``mean``/``var`` ->
    ``running_mean``/``running_var`` (the port's BatchNorm keeps flax's
    biased variance, so they are taken as they are);
  * the vit's ``pos_embed`` (1, S, dim) f32 is taken as it is.

The vit's modules have names of their own (``params_from_jax``); the cnn,
mlp and resnet carry flax's names, so their trees convert key by key
(``cnn_params_from_jax``).  The vit's scan and pipeline layouts are not
ported yet.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..ops.conv import hwio_to_oihw


def _t(a: Any) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _dense(tree: dict, prefix: str, out: Dict[str, torch.Tensor]) -> None:
    out[f"{prefix}.weight"] = _t(tree["kernel"]).T.contiguous()
    out[f"{prefix}.bias"] = _t(tree["bias"])


def _norm(tree: dict, prefix: str, out: Dict[str, torch.Tensor]) -> None:
    out[f"{prefix}.weight"] = _t(tree["scale"])
    out[f"{prefix}.bias"] = _t(tree["bias"])


def params_from_jax(params: dict) -> Dict[str, torch.Tensor]:
    """flax ViT ``params`` tree -> ``ViT.state_dict()``-shaped dict."""
    blocks = sorted((k for k in params if re.fullmatch(r"block\d+", k)),
                    key=lambda k: int(k[5:]))
    expected = {"patch_embed", "pos_embed", "LayerNorm_0", "head", *blocks}
    if not blocks or set(params) != expected:
        raise ValueError(f"not ported yet: flax params layout with keys "
                         f"{sorted(params)} (the plain per-block vit layout "
                         f"is ported)")
    out: Dict[str, torch.Tensor] = {}
    out["patch_embed.weight"] = hwio_to_oihw(
        _t(params["patch_embed"]["kernel"])).contiguous()
    out["patch_embed.bias"] = _t(params["patch_embed"]["bias"])
    out["pos_embed"] = _t(params["pos_embed"])
    for i, name in enumerate(blocks):
        blk = params[name]
        _norm(blk["LayerNorm_0"], f"blocks.{i}.ln1", out)
        _dense(blk["qkv"], f"blocks.{i}.qkv", out)
        _dense(blk["proj"], f"blocks.{i}.proj", out)
        _norm(blk["LayerNorm_1"], f"blocks.{i}.ln2", out)
        _dense(blk["mlp_up"], f"blocks.{i}.mlp_up", out)
        _dense(blk["mlp_down"], f"blocks.{i}.mlp_down", out)
    _norm(params["LayerNorm_0"], "norm", out)
    _dense(params["head"], "head", out)
    return out


def cnn_params_from_jax(params: dict, batch_stats: Optional[dict] = None
                        ) -> Dict[str, torch.Tensor]:
    """flax ``params`` (+ ``batch_stats``) of SmallCNN, MLP or ResNet ->
    the port model's ``state_dict``, key by key: ``Conv_0/kernel`` ->
    ``Conv_0.weight`` (OIHW), ``Dense_0/kernel`` -> ``Dense_0.weight``
    (out, in), ``BatchNorm_0/{scale,bias}`` -> ``BatchNorm_0.{weight,
    bias}``, ``batch_stats`` ``BatchNorm_0/{mean,var}`` ->
    ``BatchNorm_0.running_{mean,var}``."""
    out: Dict[str, torch.Tensor] = {}

    def walk(tree: dict, stats: dict, prefix: str) -> None:
        for key, sub in tree.items():
            name = f"{prefix}{key}"
            if not isinstance(sub, dict):
                raise ValueError(f"not ported yet: flax param {name!r}")
            if "kernel" in sub:
                kernel = _t(sub["kernel"])
                if kernel.dim() == 4:
                    kernel = hwio_to_oihw(kernel)
                elif kernel.dim() == 2:
                    kernel = kernel.T
                else:
                    raise ValueError(f"not ported yet: flax kernel {name!r} "
                                     f"of shape {tuple(kernel.shape)}")
                out[f"{name}.weight"] = kernel.contiguous()
                if "bias" in sub:
                    out[f"{name}.bias"] = _t(sub["bias"])
            elif "scale" in sub:
                _norm(sub, name, out)
                st = stats.get(key)
                if st is None:
                    raise ValueError(f"batch_stats lack {name!r}")
                out[f"{name}.running_mean"] = _t(st["mean"])
                out[f"{name}.running_var"] = _t(st["var"])
            else:
                walk(sub, stats.get(key, {}), f"{name}.")

    walk(params, batch_stats or {}, "")
    return out
