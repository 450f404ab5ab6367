"""flax ViT params -> the port's ``state_dict``.

The flax tree (``distributedpytorch_tpu/models/vit.py``, plain per-block
layout) comes in as nested dicts of numpy arrays, as a msgpack checkpoint
decodes.  What changes on the way:

  * a flax ``Dense`` kernel is (in, out), a torch ``Linear`` weight
    (out, in): transposed.  The ``qkv`` kernel keeps its column order, so
    the port's ``split(dim)`` yields q, k, v exactly as ``jnp.split``;
  * the ``patch_embed`` conv kernel is HWIO, torch's OIHW: permuted;
  * flax ``LayerNorm`` ``scale``/``bias`` -> ``weight``/``bias``;
  * ``pos_embed`` (1, S, dim) f32 is taken as it is.

The scan and pipeline params layouts are not ported yet.
"""

from __future__ import annotations

import re
from typing import Any, Dict

import numpy as np
import torch


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
    out["patch_embed.weight"] = _t(
        params["patch_embed"]["kernel"]).permute(3, 2, 0, 1).contiguous()
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
