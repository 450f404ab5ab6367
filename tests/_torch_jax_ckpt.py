"""A JAX-format checkpoint written from a port training state, with torch,
numpy and msgpack only (no JAX): the file the JAX package's
``checkpoint.save_checkpoint`` writes for the same state, as flax's
``msgpack_serialize`` encodes it (arrays as its ndarray extension type),
so that a machine without JAX can test ``train -f`` on a JAX-written
file.  ``write_jax_checkpoint`` is the inverse of the port's reader
(``checkpoint._decode_jax`` and ``convert.optimizer_state_from_jax``) for
the cnn, the mlp and the torchvision zoo (the vit's param layout has no
inverse converter here).  ``tests/test_torch_jax_resume.py`` holds its
tree against a JAX ``TrainState``'s and its round trip through the
reader; ``chip_smoke.py`` resumes from it on the card.
"""

from __future__ import annotations

import os
from typing import Optional

import msgpack
import numpy as np
import torch

from distributedpytorch_tpu_torch.models.convert import cnn_params_to_jax

_EXT_NDARRAY = 1        # flax.serialization's msgpack extension codes
_EXT_NPSCALAR = 3


def _pack(obj):
    if isinstance(obj, np.ndarray):
        return msgpack.ExtType(_EXT_NDARRAY, msgpack.packb(
            (obj.shape, obj.dtype.name, obj.tobytes("C")),
            use_bin_type=True))
    if isinstance(obj, np.generic):
        return msgpack.ExtType(_EXT_NPSCALAR, msgpack.packb(
            ((), obj.dtype.name, np.asarray(obj).tobytes("C")),
            use_bin_type=True))
    raise TypeError(f"cannot encode {type(obj)}")


def _masked_tree(values: dict, skeleton: dict) -> dict:
    """``skeleton`` (the params tree) with each leaf replaced by
    ``values``' leaf at the same place, or by ``{}`` (optax's masked node)
    where ``values`` has none."""
    out = {}
    for key, sub in skeleton.items():
        got = values.get(key, {}) if isinstance(values, dict) else {}
        out[key] = (_masked_tree(got, sub) if isinstance(sub, dict)
                    else (got if isinstance(got, np.ndarray) else {}))
    return out


def jax_state_tree(model: torch.nn.Module,
                   optimizer: torch.optim.Optimizer, step: int,
                   updates: int, loss_scale: Optional[dict] = None,
                   feature_extract: bool = False) -> dict:
    """The flax state dict of a JAX ``TrainState`` holding the port's
    state: params and batch_stats (``cnn_params_to_jax``), the optax state
    of ``optimizer`` (Adam: ``(ScaleByAdamState(count, mu, nu),
    EmptyState)``; SGD: ``(TraceState(trace), ScaleByScheduleState(
    count))``; under ``feature_extract`` inside ``multi_transform``'s
    ``inner_states``, the frozen parameters masked), the step and the loss
    scale (``{"scale", "good_steps"}`` or None)."""
    params, stats = cnn_params_to_jax(model.state_dict())
    names = {p: n for n, p in model.named_parameters()}
    adam = isinstance(optimizer, torch.optim.Adam)
    keys = (("mu", "exp_avg"), ("nu", "exp_avg_sq")) if adam else \
        (("trace", "momentum_buffer"),)
    trees = {}
    for jax_key, torch_key in keys:
        by_name = {names[p]: optimizer.state[p][torch_key]
                   for group in optimizer.param_groups
                   for p in group["params"]}
        trees[jax_key] = _masked_tree(cnn_params_to_jax(by_name)[0], params)
    count = np.asarray(updates, np.int32)
    base = ({"0": {"count": count, **trees}, "1": {}} if adam
            else {"0": trees, "1": {"count": count}})
    opt_state = ({"inner_states": {"backbone": {"inner_state": {}},
                                   "head": {"inner_state": base}}}
                 if feature_extract else base)
    scale = None if loss_scale is None else {
        "scale": np.asarray(loss_scale["scale"], np.float32),
        "good_steps": np.asarray(loss_scale["good_steps"], np.int32)}
    return {"step": np.asarray(step, np.int32), "params": params,
            "batch_stats": stats, "opt_state": opt_state,
            "loss_scale": scale}


def write_jax_checkpoint(path: str, model_name: str, state: dict,
                         epoch: int, best_valid_loss: float) -> None:
    """The JAX package's file (format version 1) of ``state``
    (``jax_state_tree``)."""
    payload = {"format_version": 1, "model_name": model_name,
               "epoch": int(epoch), "loss": float(best_valid_loss),
               "state": state}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(msgpack.packb(payload, default=_pack, strict_types=True))
