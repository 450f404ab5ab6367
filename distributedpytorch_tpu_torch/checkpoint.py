"""Checkpoints for serving: the port's own file, the JAX package's msgpack
file, and the sha256 lineage ledger.

Counterpart of ``distributedpytorch_tpu/checkpoint.py``: the lineage
ledger in the same schema (:135-260), ``verify_checkpoint`` and
``lineage_info`` (:229-292), ``restore_for_serving`` and
``get_checkpoint_model_name`` (:970-1064), and the five-field file
(:368-432).

The port's file holds the same five fields (``format_version``,
``model_name``, ``epoch``, ``loss``, ``state``) written with
``torch.save`` (a zip archive), atomically (tmp + rename), with its
sha256 recorded in ``ckpt-lineage.json`` beside it; ``state`` is
``{"params": model.state_dict()}``.  A file that is not a zip archive is
read as the JAX package's msgpack checkpoint: flax's ndarray extension
type is decoded with the plain ``msgpack`` package and the params are
converted by ``models/convert.py``.  Orbax checkpoint directories are
not ported yet.
"""

from __future__ import annotations

import hashlib
import io
import json
import logging
import os
import threading
from typing import Optional

import numpy as np
import torch
from torch import nn

from . import faults, telemetry
from .models.convert import params_from_jax

FORMAT_VERSION = 1
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


# -- write ---------------------------------------------------------------

def save_checkpoint(path: str, model_name: str, model: nn.Module,
                    epoch: int, best_valid_loss: float) -> None:
    """Write the port's five-field file atomically and record its sha256
    in the lineage ledger."""
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    buf = io.BytesIO()
    torch.save({"format_version": FORMAT_VERSION, "model_name": model_name,
                "epoch": int(epoch), "loss": float(best_valid_loss),
                "state": {"params": state}}, buf)
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
    if name != "vit":
        raise ValueError(f"not ported yet: --model {name} ({path} holds a "
                         f"{name} checkpoint)")
    payload["state"] = {"params": params_from_jax(payload["state"]["params"])}
    return payload


def _decode_port(path: str, blob: bytes) -> dict:
    try:
        return torch.load(io.BytesIO(blob), map_location="cpu",
                          weights_only=True)
    except Exception as e:  # any decode failure -> CLI-catchable ValueError
        raise ValueError(f"corrupt checkpoint file {path!r}: {e}") from e


def read_checkpoint(path: str) -> dict:
    """Read, checksum against the lineage ledger, decode either format.
    Returns the five fields with ``state["params"]`` as a port
    ``state_dict``.  Every failure is a ValueError."""
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
    payload = (_decode_port(path, blob) if blob[:4] == _ZIP_MAGIC
               else _decode_jax(path, blob))
    if not isinstance(payload, dict) \
            or payload.get("format_version") != FORMAT_VERSION:
        raise ValueError(f"{path}: unsupported checkpoint format"
                         + (f" {payload.get('format_version')!r}"
                            if isinstance(payload, dict) else ""))
    return payload


def get_checkpoint_model_name(path: str) -> str:
    return str(read_checkpoint(path)["model_name"])


def restore_for_serving(path: str, model: nn.Module) -> int:
    """Load the checkpoint's params into ``model`` (strict: every key,
    every shape) and return the last trained epoch.  Records a
    ``serve_restore`` telemetry event."""
    payload = read_checkpoint(path)
    try:
        model.load_state_dict(payload["state"]["params"], strict=True)
    except RuntimeError as e:
        raise ValueError(f"{path}: params do not fit the model: {e}") from e
    epoch = int(payload["epoch"])
    telemetry.get().event("serve_restore", file=os.path.basename(path),
                          epoch=epoch, layout="blocks")
    logging.info(f"serving checkpoint {path} (trained through epoch "
                 f"{epoch})")
    return epoch
