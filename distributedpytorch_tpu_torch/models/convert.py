"""flax params (and batch_stats) -> the port's ``state_dict``.

The flax trees come in as nested dicts of numpy arrays, as a msgpack
checkpoint decodes.  What changes on the way:

  * a flax ``Dense`` kernel is (in, out), a torch ``Linear`` weight
    (out, in): transposed (a stacked one, (L, in, out), per slice).  The
    vit's ``qkv`` kernel keeps its column order, so the port's
    ``split(dim)`` yields q, k, v exactly as ``jnp.split``;
  * a conv kernel is HWIO, torch's OIHW: permuted (a stacked one,
    (L, H, W, I, O), to (L, O, I, H, W));
  * flax ``LayerNorm``/``BatchNorm`` ``scale``/``bias`` ->
    ``weight``/``bias``; ``batch_stats`` ``mean``/``var`` ->
    ``running_mean``/``running_var`` (the port's BatchNorm keeps flax's
    biased variance, so they are taken as they are);
  * the vit's ``pos_embed`` (1, S, dim) f32 is taken as it is;
  * a MoE block's ``moe`` (``--moe-experts``): ``router`` is a Dense,
    and the experts' ``w_up`` (E, D, H), ``b_up``, ``w_down`` (E, H, D)
    and ``b_down`` are taken as they are.

``optimizer_state_from_jax`` converts an optax state (Adam's moments,
SGD's trace, under ``--feature-extract`` the head's) by the same rules,
for ``train -f`` on a JAX-written file.

The vit's modules have names of their own (``params_from_jax``); the cnn,
mlp and the torchvision zoo (resnet, alexnet, vgg, squeezenet, densenet,
inception) carry flax's names, nested as the flax modules nest
(``Fire_3.Conv_2``, ``InceptionC_2.BasicConv_4.Conv_0``), so their trees
convert key by key (``cnn_params_from_jax``); ``cnn_params_to_jax`` is
its inverse.  The pipelined vit's stacked blocks (``qkv_kernel`` (depth,
in, out), ...) keep their names and layout (``models/vit_pipeline.py``
converts between the two vit layouts).  The scan layouts of
``--scan-layers`` convert by the same rules, their tensors stacked on a
leading axis: the vit's ``blocks/block`` to ``blocks.block.*`` under the
port's names, and the zoo's ``ConvScan_0``, ``DenseBlockScan_*`` and
``InceptionCScan_0`` key by key (``models/scan.py`` converts between a
model's plain and scanned layouts).
"""

from __future__ import annotations

import re
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..ops.conv import hwio_to_oihw


def _t(a: Any) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _dense(tree: dict, prefix: str, out: Dict[str, torch.Tensor]) -> None:
    """A flax ``Dense`` (its kernel (in, out), or (L, in, out) stacked)
    -> ``prefix.weight`` (out, in) and ``prefix.bias``."""
    out[f"{prefix}.weight"] = _t(tree["kernel"]).transpose(-1, -2
                                                            ).contiguous()
    out[f"{prefix}.bias"] = _t(tree["bias"])


def _norm(tree: dict, prefix: str, out: Dict[str, torch.Tensor]) -> None:
    out[f"{prefix}.weight"] = _t(tree["scale"])
    out[f"{prefix}.bias"] = _t(tree["bias"])


def params_from_jax(params: dict) -> Dict[str, torch.Tensor]:
    """flax ViT or PipelinedViT ``params`` tree -> the ``state_dict`` of
    the port's ``ViT`` or ``PipelinedViT``: the stacked blocks' twelve
    tensors are taken as they are; a ``--scan-layers`` vit's
    ``blocks/block`` becomes ``blocks.block.*``, each tensor stacked on
    the blocks' axis."""
    from .vit_pipeline import STACKED

    blocks = sorted((k for k in params if re.fullmatch(r"block\d+", k)),
                    key=lambda k: int(k[5:]))
    ends = {"patch_embed", "pos_embed", "LayerNorm_0", "head"}
    stacked = set(params) == ends | set(STACKED)
    scanned = set(params) == ends | {"blocks"} \
        and set(params["blocks"]) == {"block"}
    if scanned:
        blocks = ["blocks"]
    elif not stacked and (not blocks or set(params) != ends | set(blocks)):
        raise ValueError(f"not ported yet: flax params layout with keys "
                         f"{sorted(params)} (the per-block, the scanned "
                         f"and the stacked pipeline vit layouts are "
                         f"ported)")
    out: Dict[str, torch.Tensor] = {}
    out["patch_embed.weight"] = hwio_to_oihw(
        _t(params["patch_embed"]["kernel"])).contiguous()
    out["patch_embed.bias"] = _t(params["patch_embed"]["bias"])
    out["pos_embed"] = _t(params["pos_embed"])
    if stacked:
        out.update({name: _t(params[name]) for name in STACKED})
    for i, name in enumerate(blocks):
        blk = params[name]["block"] if scanned else params[name]
        pre = "blocks.block." if scanned else f"blocks.{i}."
        _norm(blk["LayerNorm_0"], f"{pre}ln1", out)
        _dense(blk["qkv"], f"{pre}qkv", out)
        _dense(blk["proj"], f"{pre}proj", out)
        _norm(blk["LayerNorm_1"], f"{pre}ln2", out)
        if "moe" in blk:
            out.update(moe_params_from_jax(blk["moe"], f"{pre}moe."))
        else:
            _dense(blk["mlp_up"], f"{pre}mlp_up", out)
            _dense(blk["mlp_down"], f"{pre}mlp_down", out)
    _norm(params["LayerNorm_0"], "norm", out)
    _dense(params["head"], "head", out)
    return out


def moe_params_from_jax(tree: dict, prefix: str = ""
                        ) -> Dict[str, torch.Tensor]:
    """flax ``SwitchMLP`` params -> ``models.moe.SwitchMLP.state_dict()``
    entries under ``prefix``."""
    out: Dict[str, torch.Tensor] = {}
    _dense(tree["router"], f"{prefix}router", out)
    for key in ("w_up", "b_up", "w_down", "b_down"):
        out[f"{prefix}{key}"] = _t(tree[key])
    return out


def cnn_params_from_jax(params: dict, batch_stats: Optional[dict] = None
                        ) -> Dict[str, torch.Tensor]:
    """flax ``params`` (+ ``batch_stats``) of the cnn, the mlp or a zoo
    model -> the port model's ``state_dict``, key by key:
    ``Conv_0/kernel`` -> ``Conv_0.weight`` (OIHW; a stacked (L, H, W, I,
    O) one of ``--scan-layers`` -> (L, O, I, H, W)), ``Dense_0/kernel`` ->
    ``Dense_0.weight`` (out, in), ``BatchNorm_0/{scale,bias}`` ->
    ``BatchNorm_0.{weight, bias}``, ``batch_stats``
    ``BatchNorm_0/{mean,var}`` -> ``BatchNorm_0.running_{mean,var}``."""
    out: Dict[str, torch.Tensor] = {}

    def walk(tree: dict, stats: dict, prefix: str) -> None:
        for key, sub in tree.items():
            name = f"{prefix}{key}"
            if not isinstance(sub, dict):
                raise ValueError(f"not ported yet: flax param {name!r}")
            if "kernel" in sub:
                kernel = _t(sub["kernel"])
                if kernel.dim() == 5:
                    kernel = kernel.permute(0, 4, 3, 1, 2)
                elif kernel.dim() == 4:
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


def _fill_masked(tree, params, leaf):
    """``tree`` (an optax per-parameter tree, the params' shape) with the
    leaves that optax masked out (``{}``, a frozen parameter under
    ``multi_transform``) and every array replaced by ``leaf(param,
    masked)``."""
    if isinstance(params, dict):
        return {k: _fill_masked(tree.get(k, {}), v, leaf)
                for k, v in params.items()}
    masked = isinstance(tree, dict)
    return leaf(np.asarray(params) if masked else tree, masked)


def optimizer_state_from_jax(opt_state: dict, params: dict,
                             batch_stats: Optional[dict], optimizer: str,
                             is_vit: bool
                             ) -> Tuple[Dict[str, Dict[str, torch.Tensor]],
                                        int]:
    """An optax state as a msgpack checkpoint decodes it -> (the torch
    optimizer's state of every trained parameter, by its ``state_dict``
    name; the count of applied updates).  ``optimizer``: ``adam``
    (``ScaleByAdamState`` -> ``step``, ``exp_avg``, ``exp_avg_sq``) or
    ``SGD`` (``TraceState.trace`` -> ``momentum_buffer``; the schedule's
    count is the update count).  ``--feature-extract``'s
    ``multi_transform`` holds them under ``inner_states/head``; its
    ``backbone`` (``set_to_zero``) has no state, and the parameters that
    optax masked out of the head's are left out.  The moment trees go
    through the params' converter, so each takes its parameter's layout
    (HWIO -> OIHW, (in, out) -> (out, in)).  ValueError when the tree is
    not the one ``optimizer`` builds."""
    if "inner_states" in opt_state:
        try:
            opt_state = opt_state["inner_states"]["head"]["inner_state"]
        except (KeyError, TypeError):
            raise ValueError("optax multi_transform state without a 'head' "
                             "transform") from None
    keys = {"adam": ("count", "mu", "nu"), "SGD": ("trace",)}[optimizer]
    first = opt_state.get("0") if isinstance(opt_state, dict) else None
    if not isinstance(first, dict) or set(first) != set(keys) \
            or (optimizer == "SGD"
                and set(opt_state.get("1") or {}) != {"count"}):
        raise ValueError(f"the optax state {sorted(opt_state)} is not the "
                         f"{optimizer} chain's")
    count = int(np.asarray(first["count"] if optimizer == "adam"
                           else opt_state["1"]["count"]))

    def convert(tree):
        if is_vit:
            return params_from_jax(tree)
        return cnn_params_from_jax(tree, batch_stats)

    trained = convert(_fill_masked(first[keys[-1]], params,
                                   lambda p, masked: np.full(
                                       np.shape(p), 0.0 if masked else 1.0)))
    moments = {key: convert(_fill_masked(
        first[key], params,
        lambda p, masked: np.zeros(np.shape(p)) if masked else p))
        for key in keys if key != "count"}
    names = {"mu": "exp_avg", "nu": "exp_avg_sq",
             "trace": "momentum_buffer"}
    out = {}
    for name, flag in trained.items():
        if name.endswith(("running_mean", "running_var")) or not flag.any():
            continue
        if not flag.all():
            raise ValueError(f"the optax state masks part of {name!r}")
        out[name] = {names[key]: tree[name] for key, tree in moments.items()}
        if optimizer == "adam":
            out[name]["step"] = torch.tensor(float(count))
    return out, count


def cnn_params_to_jax(state_dict: Dict[str, torch.Tensor]
                      ) -> Tuple[dict, dict]:
    """The inverse of ``cnn_params_from_jax``: a port model's
    ``state_dict`` -> flax (``params``, ``batch_stats``) trees of f32
    numpy arrays (HWIO conv kernels, (L, H, W, I, O) stacked ones, (in,
    out) dense kernels).  A ``BatchNorm_*`` module's weight is flax's
    ``scale`` (a stacked one is 2-D, as a dense kernel is), in a moment's
    mapping too, which holds no running statistics."""
    params: dict = {}
    stats: dict = {}

    def put(tree: dict, path: list, leaf: str, value: np.ndarray) -> None:
        for key in path:
            tree = tree.setdefault(key, {})
        tree[leaf] = value

    for name, t in state_dict.items():
        *path, leaf = name.split(".")
        a = t.detach().cpu().float().numpy()
        if leaf == "weight" and path[-1].startswith("BatchNorm"):
            put(params, path, "scale", a)
        elif leaf == "weight" and a.ndim == 5:
            put(params, path, "kernel", a.transpose(0, 3, 4, 2, 1))
        elif leaf == "weight" and a.ndim == 4:
            put(params, path, "kernel", a.transpose(2, 3, 1, 0))
        elif leaf == "weight" and a.ndim == 2:
            put(params, path, "kernel", a.T)
        elif leaf == "weight":
            put(params, path, "scale", a)
        elif leaf == "bias":
            put(params, path, "bias", a)
        elif leaf in ("running_mean", "running_var"):
            put(stats, path, leaf[len("running_"):], a)
        else:
            raise ValueError(f"not ported yet: state_dict entry {name!r}")
    return params, stats
