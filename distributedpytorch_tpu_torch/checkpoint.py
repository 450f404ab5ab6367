"""Checkpoints: the port's own file, the JAX package's msgpack file, the
sha256 lineage ledger, and the training side (rolling and best files,
rotation, resume with a loud fallback past a torn head).

Counterpart of ``distributedpytorch_tpu/checkpoint.py``: the file names
(``checkpoint_path``/``best_model_path``, :107-116), the lineage ledger in
the same schema (:135-260), ``verify_checkpoint`` and ``lineage_info``
(:229-292), ``list_checkpoints`` (:295-313),
``load_checkpoint_with_fallback`` (:332-365), the five-field file
(:368-432), ``load_checkpoint`` (:957+), ``restore_for_serving`` and
``get_checkpoint_model_name`` (:970-1064), ``rotate_checkpoint`` (:1067+).

The port's file holds the same five fields (``format_version``,
``model_name``, ``epoch``, ``loss``, ``state``) written with
``torch.save`` (a zip archive), atomically (tmp + rename), with its
sha256 recorded in ``ckpt-lineage.json`` beside it.  Format version 2:
``state`` is ``{"params": model.state_dict(), "opt_state":
optimizer.state_dict() (on the CPU, or None), "step": int}``.  Version-1
files hold ``{"params"}`` only; ``serve`` and ``test`` still read them.
BatchNorm's running statistics are buffers of the model and travel in
``params`` (``model.state_dict()``).  A file that is not a zip archive is
read as the JAX package's msgpack checkpoint of any of the nine models:
flax's ndarray extension type is decoded with the plain ``msgpack``
package and the params, with the ``batch_stats``, are converted by
``models/convert.py`` (a ``--scan-layers`` layout is refused); ``test`` and ``serve`` read it, resuming ``train``
from it is not ported yet (it would need optax -> torch optimizer state).
Orbax checkpoint directories are not ported yet.  In a world of several
ranks, rank 0 writes (the caller gates on ``runtime.is_main()``) and every
rank reads.
"""

from __future__ import annotations

import hashlib
import io
import json
import logging
import os
import re
import threading
from typing import List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from . import faults, telemetry
from .models.convert import cnn_params_from_jax, params_from_jax

FORMAT_VERSION = 2
_READABLE_VERSIONS = (1, 2)     # the port's own files
_JAX_FORMAT_VERSION = 1
_JAX_MODELS = ("vit", "cnn", "mlp", "resnet", "alexnet", "vgg",
               "squeezenet", "densenet", "inception")
_NOT_RESUMABLE_JAX = ("not ported yet: resuming a JAX-written checkpoint "
                      "(test and serve read it)")
_LINEAGE = "ckpt-lineage.json"
_ZIP_MAGIC = b"PK\x03\x04"
# msgpack extension codes of flax.serialization._MsgpackExtType
_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_READ_TRANSIENT = (PermissionError, InterruptedError, TimeoutError)


# -- lineage ledger (same schema as the JAX package) -------------------

_lineage_lock = threading.Lock()


def lineage_path(dirname: str) -> str:
    return os.path.join(dirname, _LINEAGE)


def _lineage_load(dirname: str) -> dict:
    try:
        with open(lineage_path(dirname)) as f:
            doc = json.load(f)
        if isinstance(doc, dict) and isinstance(doc.get("records"), list):
            return doc
    except (OSError, ValueError):
        pass  # absent or torn ledger: nothing recorded
    return {"records": []}


def _lineage_record(path: str, epoch: int, checksum: str,
                    nbytes: int) -> None:
    """Record one written checkpoint (atomic rewrite); entries whose file
    is gone are pruned."""
    dirname, name = os.path.split(os.path.abspath(path))
    with _lineage_lock:
        doc = _lineage_load(dirname)
        records = [r for r in doc["records"]
                   if r.get("file") != name
                   and os.path.exists(os.path.join(dirname,
                                                   str(r.get("file"))))]
        records.append({"file": name, "epoch": int(epoch),
                        "sha256": checksum, "bytes": int(nbytes)})
        _lineage_write(dirname, records)


def _lineage_forget(path: str) -> None:
    """Drop a rotated-away checkpoint's ledger entry."""
    dirname, name = os.path.split(os.path.abspath(path))
    with _lineage_lock:
        doc = _lineage_load(dirname)
        records = [r for r in doc["records"] if r.get("file") != name]
        if len(records) != len(doc["records"]):
            _lineage_write(dirname, records)


def _lineage_write(dirname: str, records: list) -> None:
    """Atomic rewrite of the ledger (caller holds ``_lineage_lock``); a
    failure is logged, never raised: the checkpoint itself is written."""
    tmp = lineage_path(dirname) + ".tmp"
    try:
        with open(tmp, "w") as f:
            json.dump({"records": records}, f, indent=1)
        os.replace(tmp, lineage_path(dirname))
    except OSError as e:
        logging.warning(f"cannot update checkpoint lineage ledger "
                        f"{lineage_path(dirname)!r}: {e}")


def _lineage_entry(path: str) -> Optional[dict]:
    dirname, name = os.path.split(os.path.abspath(path))
    with _lineage_lock:
        doc = _lineage_load(dirname)
    for r in doc["records"]:
        if r.get("file") == name:
            return r
    return None


def _refuse_dir(path: str) -> None:
    if os.path.isdir(path):
        raise ValueError(f"not ported yet: orbax checkpoint directories "
                         f"({path!r})")


def verify_checkpoint(path: str) -> Optional[str]:
    """None when the file matches its recorded checksum (or none was
    recorded); otherwise a one-line reason.  Never raises."""
    if os.path.isdir(path):
        return "not ported yet: orbax checkpoint directories"
    rec = _lineage_entry(path)
    if rec is None:
        return None
    try:
        with open(path, "rb") as f:
            got = hashlib.sha256(f.read()).hexdigest()
    except OSError as e:
        return f"cannot read ({e.strerror or e})"
    if got != rec.get("sha256"):
        return (f"content checksum mismatch (lineage records "
                f"{str(rec.get('sha256'))[:12]}…, found {got[:12]}…)")
    return None


def lineage_info(path: str) -> Optional[dict]:
    """The served-model identity ``{"file", "path", "sha256", "epoch"}``:
    the sha from the ledger when recorded, else computed.  None when the
    file is unreadable."""
    path = os.path.abspath(path)
    name = os.path.basename(path)
    rec = _lineage_entry(path)
    if rec is not None and rec.get("sha256"):
        return {"file": name, "path": path, "sha256": rec["sha256"],
                "epoch": rec.get("epoch")}
    try:
        with open(path, "rb") as f:
            sha = hashlib.sha256(f.read()).hexdigest()
    except OSError:
        return None
    return {"file": name, "path": path, "sha256": sha, "epoch": None}


# -- file names and the rolling lineage ------------------------------------

def checkpoint_path(rsl_path: str, dataset: str, model_name: str,
                    epoch: int) -> str:
    """The rolling per-epoch file: ``checkpoint-{dataset}-{model}-
    {epoch:03d}.ckpt``, the JAX package's name."""
    return os.path.join(
        rsl_path, f"checkpoint-{dataset}-{model_name}-{epoch:03d}.ckpt")


def best_model_path(rsl_path: str, dataset: str, model_name: str) -> str:
    return os.path.join(rsl_path, f"bestmodel-{dataset}-{model_name}.ckpt")


def list_checkpoints(rsl_path: str, dataset: str,
                     model_name: str) -> List[str]:
    """Rolling checkpoint paths for (dataset, model) under ``rsl_path``,
    newest epoch first — the fallback candidates."""
    pat = re.compile(rf"checkpoint-{re.escape(dataset)}-"
                     rf"{re.escape(model_name)}-(\d+)\.ckpt")
    try:
        names = os.listdir(rsl_path)
    except OSError:
        return []
    found = [(int(m.group(1)), os.path.join(rsl_path, name))
             for name in names for m in [pat.fullmatch(name)] if m]
    return [p for _, p in sorted(found, reverse=True)]


def rotate_checkpoint(rsl_path: str, dataset: str, model_name: str,
                      epoch: int, keep: int = 1) -> None:
    """Delete the rolling file ``keep`` epochs back, retaining the newest
    ``keep`` snapshots (keep=1 is the reference's delete-previous)."""
    prev = checkpoint_path(rsl_path, dataset, model_name,
                           epoch - max(1, keep))
    if not os.path.exists(prev):
        return
    os.remove(prev)
    _lineage_forget(prev)


# -- write ---------------------------------------------------------------

def _to_cpu(tree):
    """Tensors of a (nested) state dict moved to the CPU."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def save_checkpoint(path: str, model_name: str, model: nn.Module,
                    epoch: int, best_valid_loss: float,
                    optimizer: Optional[torch.optim.Optimizer] = None,
                    step: int = 0) -> None:
    """Write the port's five-field file (format version 2) atomically and
    record its sha256 in the lineage ledger.  ``optimizer`` and ``step``
    are the trainer's; a file written without them serves and tests but
    cannot resume training."""
    state = {"params": _to_cpu(model.state_dict()),
             "opt_state": (None if optimizer is None
                           else _to_cpu(optimizer.state_dict())),
             "step": int(step)}
    buf = io.BytesIO()
    torch.save({"format_version": FORMAT_VERSION, "model_name": model_name,
                "epoch": int(epoch), "loss": float(best_valid_loss),
                "state": state}, buf)
    blob = buf.getvalue()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(blob)
    os.replace(tmp, path)
    _lineage_record(path, epoch, hashlib.sha256(blob).hexdigest(), len(blob))
    logging.info(f"epoch:{int(epoch):04d}: model saved to {path}")


# -- read ----------------------------------------------------------------

def _ndarray_from_bytes(data: bytes) -> np.ndarray:
    import msgpack

    shape, dtype_name, buffer = msgpack.unpackb(data, raw=True)
    if dtype_name == b"bfloat16":
        # bf16 bits are the top half of an f32: widen exactly
        bits = np.frombuffer(buffer, dtype=np.uint16).astype(np.uint32)
        return (bits << 16).view(np.float32).reshape(shape)
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name.decode())
                         ).reshape(shape)


def _ext_hook(code: int, data: bytes):
    import msgpack

    if code == _EXT_NDARRAY:
        return _ndarray_from_bytes(data)
    if code == _EXT_NPSCALAR:
        return _ndarray_from_bytes(data)[()]
    if code == _EXT_COMPLEX:
        re_, im = msgpack.unpackb(data)
        return complex(re_, im)
    return msgpack.ExtType(code, data)


def _unchunk(tree):
    """flax's chunked-array leaves (arrays over 1 GiB) back to arrays."""
    if isinstance(tree, dict):
        if "__msgpack_chunked_array__" in tree:
            shape = tuple(tree["shape"][str(i)]
                          for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)]
                      for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def _decode_jax(path: str, blob: bytes) -> dict:
    try:
        import msgpack
    except ImportError:
        raise ValueError(f"{path}: reading a JAX-written msgpack checkpoint "
                         "needs the 'msgpack' package, which is not "
                         "importable") from None
    try:
        payload = _unchunk(msgpack.unpackb(blob, ext_hook=_ext_hook,
                                           raw=False))
    except Exception as e:  # any decode failure -> CLI-catchable ValueError
        raise ValueError(f"corrupt checkpoint file {path!r}: {e}") from e
    if not isinstance(payload, dict) or not isinstance(
            payload.get("state"), dict):
        raise ValueError(f"{path}: not a checkpoint of this framework")
    name = payload.get("model_name")
    if name not in _JAX_MODELS:
        raise ValueError(f"not ported yet: --model {name} ({path} holds a "
                         f"{name} checkpoint)")
    if payload.get("format_version") != _JAX_FORMAT_VERSION:
        raise ValueError(f"{path}: unsupported checkpoint format "
                         f"{payload.get('format_version')!r}")
    state = payload["state"]
    if name == "vit":
        params = params_from_jax(state["params"])
    else:
        params = cnn_params_from_jax(state["params"],
                                     state.get("batch_stats") or {})
    payload["state"] = {"params": params}
    return payload


def _decode_port(path: str, blob: bytes) -> dict:
    try:
        payload = torch.load(io.BytesIO(blob), map_location="cpu",
                             weights_only=True)
    except Exception as e:  # any decode failure -> CLI-catchable ValueError
        raise ValueError(f"corrupt checkpoint file {path!r}: {e}") from e
    if not isinstance(payload, dict) \
            or payload.get("format_version") not in _READABLE_VERSIONS:
        raise ValueError(f"{path}: unsupported checkpoint format"
                         + (f" {payload.get('format_version')!r}"
                            if isinstance(payload, dict) else ""))
    return payload


def _read(path: str) -> Tuple[dict, str]:
    """Read, checksum against the lineage ledger, decode either format.
    Returns (the five fields with ``state["params"]`` as a port
    ``state_dict``, the writer: "port" or "jax").  Every failure is a
    ValueError."""
    _refuse_dir(path)

    def _attempt() -> bytes:
        faults.fire("ckpt.restore", path=path)
        with open(path, "rb") as f:
            return f.read()

    try:
        blob = faults.retry(_attempt, "ckpt.restore",
                            transient=_READ_TRANSIENT)
    except OSError as e:
        raise ValueError(f"cannot read checkpoint file {path!r}: "
                         f"{e.strerror or e}") from e
    rec = _lineage_entry(path)
    if rec is not None:
        got = hashlib.sha256(blob).hexdigest()
        if got != rec.get("sha256"):
            raise ValueError(
                f"{path}: corrupt checkpoint — content checksum mismatch "
                f"(lineage records {str(rec.get('sha256'))[:12]}…, found "
                f"{got[:12]}…)")
    if blob[:4] == _ZIP_MAGIC:
        return _decode_port(path, blob), "port"
    return _decode_jax(path, blob), "jax"


def read_checkpoint(path: str) -> dict:
    """Read, checksum against the lineage ledger, decode either format.
    Returns the five fields with ``state["params"]`` as a port
    ``state_dict``.  Every failure is a ValueError."""
    return _read(path)[0]


def get_checkpoint_model_name(path: str) -> str:
    return str(read_checkpoint(path)["model_name"])


def _load_params(path: str, payload: dict, model: nn.Module) -> None:
    try:
        model.load_state_dict(payload["state"]["params"], strict=True)
    except RuntimeError as e:
        raise ValueError(f"{path}: params do not fit the model: {e}") from e


def restore_for_serving(path: str, model: nn.Module) -> int:
    """Load the checkpoint's params into ``model`` (strict: every key,
    every shape) and return the last trained epoch.  Records a
    ``serve_restore`` telemetry event."""
    payload = read_checkpoint(path)
    _load_params(path, payload, model)
    epoch = int(payload["epoch"])
    telemetry.get().event("serve_restore", file=os.path.basename(path),
                          epoch=epoch, layout="blocks")
    logging.info(f"serving checkpoint {path} (trained through epoch "
                 f"{epoch})")
    return epoch


# -- training side ---------------------------------------------------------

def load_checkpoint(path: str, model: nn.Module,
                    optimizer: Optional[torch.optim.Optimizer] = None,
                    restore_optimizer: bool = True
                    ) -> Tuple[int, float, int]:
    """Restore ``model`` (and, with ``restore_optimizer``, ``optimizer``)
    in place; returns (next_epoch, best_valid_loss, step).  Resuming needs
    a format-2 file of the port: a JAX-written file or a params-only file
    is refused for it (``test`` and ``serve`` read both)."""
    payload, writer = _read(path)
    state = payload["state"]
    if restore_optimizer:
        if writer == "jax":
            raise ValueError(_NOT_RESUMABLE_JAX)
        if state.get("opt_state") is None or optimizer is None:
            raise ValueError(
                f"{path}: holds no optimizer state (format version "
                f"{payload['format_version']}); it cannot resume training "
                f"(test and serve read it)")
    _load_params(path, payload, model)
    if restore_optimizer:
        try:
            optimizer.load_state_dict(state["opt_state"])
        except (ValueError, KeyError) as e:
            raise ValueError(f"{path}: optimizer state does not fit the "
                             f"optimizer: {e}") from e
    epoch = int(payload["epoch"]) + 1
    logging.info(f"epoch:{epoch:04d}: model loaded from {path}")
    return epoch, float(payload["loss"]), int(state.get("step", 0))


def load_checkpoint_with_fallback(path: str, model: nn.Module,
                                  optimizer: Optional[torch.optim.Optimizer],
                                  rsl_path: str, dataset: str,
                                  model_name: str
                                  ) -> Tuple[int, float, int]:
    """``load_checkpoint`` with lineage recovery: when the requested file
    is torn or corrupt, fall back — loudly (error log + ``ckpt_fallback``
    telemetry event per skipped snapshot) — to the newest rolling snapshot
    that verifies.  A JAX-written file is refused, not skipped."""
    tel = telemetry.get()
    seen = {os.path.abspath(path)}
    candidates = [path]
    for cand in list_checkpoints(rsl_path, dataset, model_name):
        if os.path.abspath(cand) not in seen:
            seen.add(os.path.abspath(cand))
            candidates.append(cand)
    errors = []
    for cand in candidates:
        reason = verify_checkpoint(cand)
        if reason is None:
            try:
                return load_checkpoint(cand, model, optimizer)
            except ValueError as e:
                if str(e) == _NOT_RESUMABLE_JAX:
                    raise
                reason = str(e)
        errors.append(f"{cand}: {reason}")
        logging.error(f"CHECKPOINT REJECTED {cand!r}: {reason}"
                      + ("; falling back to an earlier snapshot"
                         if cand != candidates[-1] else ""))
        tel.event("ckpt_fallback", skipped=os.path.basename(cand),
                  reason=reason)
    raise ValueError(
        f"no valid checkpoint to resume from under {rsl_path!r} "
        f"(tried {len(candidates)}: {'; '.join(errors)})")
