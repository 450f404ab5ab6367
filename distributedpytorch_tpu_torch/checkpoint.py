"""Checkpoints: the port's own file, the JAX package's msgpack file, the
sha256 lineage ledger, and the training side (rolling and best files,
rotation, resume with a loud fallback past a torn head).

Counterpart of ``distributedpytorch_tpu/checkpoint.py``: the file names
(``checkpoint_path``/``best_model_path``, :107-116), the lineage ledger in
the same schema (:135-260), ``verify_checkpoint`` and ``lineage_info``
(:229-292), ``list_checkpoints`` (:295-313),
``load_checkpoint_with_fallback`` (:332-365), the five-field file
(:368-432), ``AsyncSaver`` and ``save_checkpoint_async`` (:433-613),
``load_checkpoint`` (:957+, with the loss-scale rule of :1012-1024),
``restore_for_serving`` and ``get_checkpoint_model_name`` (:970-1064),
``rotate_checkpoint`` (:1067+), ``newest_checkpoint`` (:314-330).

The port's file holds the same five fields (``format_version``,
``model_name``, ``epoch``, ``loss``, ``state``) written with
``torch.save`` (a zip archive), atomically (tmp + rename), with its
sha256 recorded in ``ckpt-lineage.json`` beside it.  Format version 3:
``state`` is ``{"params": model.state_dict(), "opt_state":
optimizer.state_dict() (on the CPU, or None), "step": int, "updates": int
(the applied optimizer updates, which set the SGD learning rate), "loss_scale":
{"scale", "good_steps"} (f16) or None}``.  Version-2 files have no
``updates`` (it is their ``step``: no step of theirs was skipped) and no
``loss_scale``; version-1 files hold ``{"params"}`` only, which ``serve``
and ``test`` still read.  The loss scale follows the JAX rule: an f16 file
restored into a run that scales no loss drops its scale, and a file
without one restored into an f16 run keeps the run's fresh 2^15.
``--ckpt-async`` (``AsyncSaver``, ``save_checkpoint_async``): the caller
takes the snapshot (every tensor copied to the CPU, before the next step
moves the parameters in place) and a background thread serializes and
writes it, FIFO with the rotation deletes; the file is byte-identical to
the synchronous save's.
BatchNorm's running statistics are buffers of the model and travel in
``params`` (``model.state_dict()``), and a MoE vit's experts under their
module names (``blocks.{i}.moe.{router.weight, router.bias, w_up, b_up,
w_down, b_down}``); a file whose expert count differs from the model's
(``--moe-experts``, 0 for dense MLPs) is refused with one line naming
the flag.  A file that is not a zip archive is
read as the JAX package's msgpack checkpoint of any of the nine models:
flax's ndarray extension type is decoded with the plain ``msgpack``
package and the params, with the ``batch_stats``, are converted by
``models/convert.py`` (the ``--scan-layers`` layouts too); ``test``
and ``serve`` read it, and ``train -f`` resumes from it: the optax state
(Adam's or SGD's, ``--feature-extract``'s head) becomes the torch
optimizer's (``convert.optimizer_state_from_jax``), the optax count the
applied updates, and ``step``, the epoch, the best loss and the f16 loss
scale are taken by the rules of the port's own files.
A file of any of the eight layouts of ``models/scan.py`` (the vit's
pipelined ``stacked``, per-block ``blocks`` and ``--scan-layers`` ``scan``;
vgg, densenet and inception plain or scanned; the port's or JAX's) loads
into a model of its family's other layout: the params with the running
statistics, and the optimizer moments, are converted at load, as JAX's
``_load_checkpoint_inner`` converts them (:1025-1045,
``scan.convert_layout``), and ``serve_restore`` records the model's
layout (``unknown`` for a model of none).
Orbax checkpoint directories are not ported yet.  In a world of several
ranks, rank 0 writes (the caller gates on ``runtime.is_main()``) and every
rank reads.  A model placed over a model group (``parallel.place``) is
written whole: every rank gathers its slices first
(``parallel.full_state``, a collective made before the gate; with
``--ckpt-async`` on the caller's thread too) and the file is the one a
replicated run writes; a placed model takes its slices of the full
tensors it restores, so one file (the port's or the JAX package's, which
writes full arrays) loads at any ``--model-parallel``.
"""

from __future__ import annotations

import hashlib
import io
import json
import logging
import os
import re
import queue as queue_mod
import threading
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from . import faults, parallel, telemetry
from .models import scan
from .models.convert import (cnn_params_from_jax, optimizer_state_from_jax,
                             params_from_jax)
from .precision import LossScaleState

FORMAT_VERSION = 3
_READABLE_VERSIONS = (1, 2, 3)  # the port's own files
_JAX_FORMAT_VERSION = 1
_JAX_MODELS = ("vit", "cnn", "mlp", "resnet", "alexnet", "vgg",
               "squeezenet", "densenet", "inception")
_LINEAGE = "ckpt-lineage.json"
_ZIP_MAGIC = b"PK\x03\x04"
# msgpack extension codes of flax.serialization._MsgpackExtType
_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_READ_TRANSIENT = (PermissionError, InterruptedError, TimeoutError,
                   faults.InjectedIOError)


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


def newest_checkpoint(rsl_path: str, dataset: str,
                      model_name: str) -> Optional[str]:
    """The newest rolling snapshot, or None when there is none: the
    elastic resume's file (JAX checkpoint.py:314-330).  A file written by
    a world of N ranks restores into any other world (every rank holds
    the whole state); verification happens downstream, in
    ``load_checkpoint_with_fallback``."""
    ckpts = list_checkpoints(rsl_path, dataset, model_name)
    return ckpts[0] if ckpts else None


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
    """Tensors of a (nested) state dict copied to the CPU (a copy even
    where they already are: the snapshot must not move with the next
    step's in-place update)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def _payload(model_name: str, model: nn.Module, epoch: int,
             best_valid_loss: float,
             optimizer: Optional[torch.optim.Optimizer], step: int,
             updates: Optional[int],
             loss_scale: Optional[LossScaleState],
             full: Optional[tuple] = None) -> dict:
    """The file's five fields, every tensor copied to the CPU; ``full``:
    the (params, optimizer state) of a placed model, gathered by every
    rank (``parallel.full_state``), which a placed model needs."""
    if full is None:
        if parallel.placement_of(model) is not None:
            raise ValueError("a placed model's checkpoint needs its state "
                             "gathered first (parallel.full_state)")
        full = (_to_cpu(model.state_dict()),
                None if optimizer is None
                else _to_cpu(optimizer.state_dict()))
    state = {"params": full[0],
             "opt_state": None if optimizer is None else full[1],
             "step": int(step),
             "updates": int(step if updates is None else updates),
             "loss_scale": (None if loss_scale is None
                            else loss_scale.to_dict())}
    return {"format_version": FORMAT_VERSION, "model_name": model_name,
            "epoch": int(epoch), "loss": float(best_valid_loss),
            "state": state}


def _write(path: str, payload: dict) -> None:
    """Serialize, write atomically (tmp + rename) and record the sha256
    in the lineage ledger: host and file work only, safe on a background
    thread; a crash at any point leaves the previous file at ``path``.
    The write is retried under the process retry policy (fault site
    ``ckpt.save``); ``ckpt.finalize`` fires on the final path after the
    rename, before the ledger records it, as in the JAX ``_write_msgpack``
    (checkpoint.py:394-402): a ``torn`` fault there leaves a file whose
    checksum no longer verifies."""
    buf = io.BytesIO()
    torch.save(payload, buf)
    blob = buf.getvalue()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"

    def _attempt():
        faults.fire("ckpt.save", path=path)
        with open(tmp, "wb") as f:
            f.write(blob)
        os.replace(tmp, path)

    faults.retry(_attempt, "ckpt.save")
    faults.fire("ckpt.finalize", path=path)
    epoch = payload["epoch"]
    _lineage_record(path, epoch, hashlib.sha256(blob).hexdigest(), len(blob))
    logging.info(f"epoch:{epoch:04d}: model saved to {path}")


def save_checkpoint(path: str, model_name: str, model: nn.Module,
                    epoch: int, best_valid_loss: float,
                    optimizer: Optional[torch.optim.Optimizer] = None,
                    step: int = 0, updates: Optional[int] = None,
                    loss_scale: Optional[LossScaleState] = None,
                    full: Optional[tuple] = None) -> None:
    """Write the port's five-field file (format version 3) atomically and
    record its sha256 in the lineage ledger.  ``optimizer``, ``step``,
    ``updates`` (``step`` when None) and ``loss_scale`` are the trainer's;
    a file written without an optimizer serves and tests but cannot
    resume training.  ``full``: a placed model's gathered state."""
    _write(path, _payload(model_name, model, epoch, best_valid_loss,
                          optimizer, step, updates, loss_scale, full))


_SAVER_SHUTDOWN = object()


class AsyncSaver:
    """Ordered background checkpoint I/O (``--ckpt-async``), the JAX
    package's class.

    One daemon worker thread drains a FIFO job queue, so every submitted
    job (rolling write, best-model write, rotation delete) runs in the
    order the caller issued it: a newer save never races an older one onto
    the same path, and a rotation never deletes a file whose earlier write
    is still pending.  ``submit`` returns at once.

    A background exception is kept and re-raised from the next
    ``submit``/``wait``/``close`` on the caller's thread, so a failing write
    cannot pass silently.  The caller calls ``wait()`` (or ``close()``)
    before it exits, and before telemetry closes, so the background spans
    land in the JSONL.

    ``on_error='degrade'`` (what ``train`` passes): instead of
    re-raising, the first background failure is logged and emitted as a
    ``ckpt_async_degraded`` telemetry event, and every later job runs
    synchronously on the caller's thread (a persistent failure then
    surfaces from the synchronous write itself).  The default, 'raise',
    keeps the must-not-pass-silently contract for library callers.
    """

    def __init__(self, on_error: str = "raise"):
        if on_error not in ("raise", "degrade"):
            raise ValueError(
                f"AsyncSaver on_error must be 'raise' or 'degrade', "
                f"got {on_error!r}")
        self.on_error = on_error
        self.degraded = False
        self._queue = queue_mod.Queue()
        # set by the worker before task_done(); read by the caller after a
        # join (ordered by Queue.join) or before one (a miss is re-raised
        # by the next call)
        self._exc: Optional[BaseException] = None
        self._thread: Optional[threading.Thread] = None

    def _worker(self) -> None:
        while True:
            fn = self._queue.get()
            try:
                if fn is _SAVER_SHUTDOWN:
                    return
                fn()
            except BaseException as e:  # kept for the caller: the next
                # submit()/wait()/close() re-raises it there
                self._exc = e
            finally:
                self._queue.task_done()

    def _raise_pending(self) -> None:
        if self._exc is None:
            return
        exc, self._exc = self._exc, None
        if self.on_error != "degrade":
            raise exc
        if not self.degraded:
            self.degraded = True
            logging.error(
                f"async checkpoint writer FAILED ({exc!r}); degrading "
                "to synchronous saves for the rest of the run")
            telemetry.get().event("ckpt_async_degraded", error=str(exc))

    @property
    def in_flight(self) -> bool:
        return self._thread is not None \
            and self._queue.unfinished_tasks > 0

    def submit(self, fn: Callable[[], None]) -> None:
        self._raise_pending()
        if self.degraded:
            fn()  # synchronous: the order holds, the run goes on
            return
        if self._thread is None:
            self._thread = threading.Thread(target=self._worker,
                                            name="dpt-ckpt-writer",
                                            daemon=True)
            self._thread.start()
        self._queue.put(fn)

    def wait(self) -> None:
        """Block until every submitted job finished; re-raise a
        failure."""
        if self._thread is not None:
            self._queue.join()
        self._raise_pending()

    def close(self) -> None:
        """``wait()`` and retire the worker thread."""
        if self._thread is not None:
            self._queue.put(_SAVER_SHUTDOWN)
            self._queue.join()
            self._thread.join()
            self._thread = None
        self._raise_pending()


def save_checkpoint_async(saver: AsyncSaver, path: str, model_name: str,
                          model: nn.Module, epoch: int,
                          best_valid_loss: float,
                          optimizer: Optional[torch.optim.Optimizer] = None,
                          step: int = 0, updates: Optional[int] = None,
                          loss_scale: Optional[LossScaleState] = None,
                          full: Optional[tuple] = None) -> None:
    """``save_checkpoint`` with only the snapshot on the caller's path:
    the state dicts copied to the CPU (a ``ckpt_save_blocking`` span),
    done before the next step's in-place update; the serialization, the
    tmp + rename and the lineage record run on ``saver``'s thread (a
    ``ckpt_save_background`` span).  The same bytes as the synchronous
    save, and the same crash safety."""
    tel = telemetry.get()
    attrs = dict(fmt="torch", epoch=int(epoch), file=os.path.basename(path))
    with tel.span("ckpt_save_blocking", **attrs):
        payload = _payload(model_name, model, epoch, best_valid_loss,
                           optimizer, step, updates, loss_scale, full)

    def write():
        with telemetry.get().span("ckpt_save_background", **attrs):
            _write(path, payload)

    saver.submit(write)


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
    # the optax state, the counters and the loss scale stay as decoded,
    # for a resume (load_checkpoint) to convert against its optimizer
    payload["state"] = {"params": params, "jax": state}
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


def _experts(params) -> int:
    """Experts a block of a MoE vit's params (0: dense MLPs)."""
    router = params.get("blocks.0.moe.router.weight")
    return 0 if router is None else int(router.shape[0])


def _model_layout(model: nn.Module) -> Optional[str]:
    """The layout of ``model``'s parameters (``scan.params_layout``), or
    None for a model of none."""
    return scan.params_layout(
        dict.fromkeys(n for n, _ in model.named_parameters()))


def _load_params(path: str, payload: dict, model: nn.Module
                 ) -> Optional[tuple]:
    """Strict load of the file's params; a file and a model that differ
    in ``--moe-experts`` fail with one line naming it, as JAX's layout
    check does (``checkpoint.py:735-752``).  A file of the other layout
    of the model's family is converted first, as JAX converts at load
    (:1025-1045).  Returns (the model's layout, the file's vit depth or
    None) when it converted, else None."""
    saved, wanted = _experts(payload["state"]["params"]), _experts(
        model.state_dict())
    if saved != wanted:
        def side(e: int) -> str:
            return (f"{e}-expert mixture-of-experts blocks" if e
                    else "dense MLPs")

        raise ValueError(
            f"checkpoint at {path} holds {side(saved)}, the requested "
            f"model {side(wanted)} — load with a matching --moe-experts "
            f"(--moe-experts {saved})")
    params = payload["state"]["params"]
    src, dst = scan.params_layout(params), _model_layout(model)
    converted = None
    if src is not None and dst is not None and src != dst:
        depth = scan.layout_depth(params, src)
        try:
            params = scan.convert_layout(params, dst)
        except ValueError as e:
            raise ValueError(f"{path}: {e}") from e
        converted = (dst, depth)
        logging.info(f"checkpoint params converted: {src} -> {dst} block "
                     f"layout")
    placement = parallel.placement_of(model)
    if placement is not None:
        params = placement.local_state_dict(params)
    try:
        model.load_state_dict(params, strict=True)
    except RuntimeError as e:
        raise ValueError(f"{path}: params do not fit the model: {e}") from e
    return converted


def _convert_moments(by_name: dict, converted: tuple) -> dict:
    """{parameter name: {moment: tensor}} of the file's layout -> of the
    model's (``_load_params``'s ``converted``)."""
    dst, depth = converted
    # in the file's order, the same on every rank (full_state's gathers
    # follow it)
    keys = list(dict.fromkeys(k for st in by_name.values() for k in st))
    moved = {k: scan.convert_layout(
        {n: st[k] for n, st in by_name.items()}, dst, depth) for k in keys}
    names = next(iter(moved.values())) if moved else {}
    return {n: {k: moved[k][n] for k in keys} for n in names}


def _convert_optimizer_state(opt_state: dict, file_names: list,
                             model: nn.Module,
                             optimizer: torch.optim.Optimizer,
                             converted: tuple) -> dict:
    """A port file's ``optimizer.state_dict()`` of the other layout -> the
    run's: its moments named by the file's parameter order (its
    ``state_dict``'s names but the running statistics), converted, and
    indexed by the run's optimizer.  A state of fewer
    parameters than the file holds (``--feature-extract``: the head's,
    named alike in both layouts) is taken as it is."""
    groups = opt_state["param_groups"]
    if sum(len(g["params"]) for g in groups) != len(file_names) \
            or len(groups) != 1:
        return opt_state
    by_name = _convert_moments({file_names[i]: st for i, st in
                                opt_state["state"].items()}, converted)
    names = parallel.optimizer_names(model, optimizer)
    return {"state": {i: by_name[n] for i, n in names.items()
                      if n in by_name},
            "param_groups": [dict(groups[0], params=sorted(names))]}


def restore_for_serving(path: str, model: nn.Module) -> int:
    """Load the checkpoint's params into ``model`` (strict: every key,
    every shape) and return the last trained epoch.  Records a
    ``serve_restore`` telemetry event."""
    payload = read_checkpoint(path)
    _load_params(path, payload, model)
    epoch = int(payload["epoch"])
    # the restored model's layout, a file of the other converted to it
    layout = _model_layout(model) or "unknown"
    telemetry.get().event("serve_restore", file=os.path.basename(path),
                          epoch=epoch, layout=layout)
    logging.info(f"serving checkpoint {path} (trained through epoch "
                 f"{epoch}, layout {layout})")
    return epoch


# -- training side ---------------------------------------------------------

def load_checkpoint(path: str, model: nn.Module,
                    optimizer: Optional[torch.optim.Optimizer] = None,
                    restore_optimizer: bool = True, train_state=None
                    ) -> Tuple[int, float, int]:
    """Restore ``model`` (and, with ``restore_optimizer``, ``optimizer``)
    in place; returns (next_epoch, best_valid_loss, step).  Resuming needs
    a format-2 or -3 file of the port or a JAX-written file with its
    optimizer state: a params-only file is refused for it (``test`` and
    ``serve`` read it).  Given the
    trainer's ``train_state`` (``updates``, ``loss_scale``), its update
    count and loss scale are restored too, by the JAX rule of the module
    docstring."""
    payload, writer = _read(path)
    state = payload["state"]
    if writer == "jax" and restore_optimizer:
        state = _resume_state_from_jax(path, payload, optimizer)
    if restore_optimizer:
        if state.get("opt_state") is None or optimizer is None:
            raise ValueError(
                f"{path}: holds no optimizer state (format version "
                f"{payload['format_version']}); it cannot resume training "
                f"(test and serve read it)")
    converted = _load_params(path, payload, model)
    if restore_optimizer and writer == "jax":
        by_name = state["opt_state"]
        if converted is not None:
            by_name = _convert_moments(by_name, converted)
        _load_jax_optimizer(path, by_name, model, optimizer)
    elif restore_optimizer:
        capturable = [g.get("capturable") for g in optimizer.param_groups]
        opt_state = state["opt_state"]
        if converted is not None:
            opt_state = _convert_optimizer_state(
                opt_state, [n for n in payload["state"]["params"]
                            if not n.endswith(("running_mean",
                                               "running_var"))],
                model, optimizer, converted)
        placement = parallel.placement_of(model)
        try:
            if placement is not None:
                opt_state = placement.local_optimizer_state(
                    parallel.optimizer_names(model, optimizer), opt_state)
            optimizer.load_state_dict(opt_state)
        except (ValueError, KeyError) as e:
            raise ValueError(f"{path}: optimizer state does not fit the "
                             f"optimizer: {e}") from e
        _keep_capturable(optimizer, capturable)
    step = int(state.get("step", 0))
    if train_state is not None:
        train_state.step.fill_(step)
        train_state.updates.fill_(int(state.get("updates", step)))
        saved = state.get("loss_scale")
        if train_state.loss_scale is not None and saved is not None:
            train_state.loss_scale.assign(LossScaleState.from_dict(saved))
    epoch = int(payload["epoch"]) + 1
    logging.info(f"epoch:{epoch:04d}: model loaded from {path}")
    return epoch, float(payload["loss"]), step


def _keep_capturable(optimizer: torch.optim.Optimizer,
                     capturable: list) -> None:
    """The run's own ``capturable`` setting of each group (Adam's: on the
    card, its step count on the device), whatever device wrote the file;
    the step counts follow it."""
    for group, cap in zip(optimizer.param_groups, capturable):
        if cap is None:
            continue
        group["capturable"] = cap
        for p in group["params"]:
            st = optimizer.state.get(p, {})
            if "step" in st:
                st["step"] = st["step"].to(
                    device=p.device if cap else "cpu", dtype=torch.float32)


def _resume_state_from_jax(path: str, payload: dict,
                           optimizer: Optional[torch.optim.Optimizer]
                           ) -> dict:
    """A JAX file's state as the port's format 3 holds it: ``params``,
    ``opt_state`` (the torch optimizer's state by parameter name, from
    ``convert.optimizer_state_from_jax``; None when the file has none),
    ``step``, ``updates`` (the optax count) and ``loss_scale``."""
    jax_state = payload["state"]["jax"]
    opt_state = jax_state.get("opt_state")
    name = type(optimizer).__name__
    out = {"params": payload["state"]["params"], "opt_state": None,
           "step": int(np.asarray(jax_state.get("step", 0)))}
    if opt_state and optimizer is not None:
        try:
            out["opt_state"], out["updates"] = optimizer_state_from_jax(
                opt_state, jax_state["params"],
                jax_state.get("batch_stats") or {},
                "adam" if name == "Adam" else name,
                payload["model_name"] == "vit")
        except (KeyError, ValueError) as e:
            raise ValueError(f"{path}: optimizer state does not fit the "
                             f"optimizer: {e}") from e
    scale = jax_state.get("loss_scale")
    if scale:
        out["loss_scale"] = {"scale": float(np.asarray(scale["scale"])),
                             "good_steps": int(np.asarray(
                                 scale["good_steps"]))}
    return out


def _load_jax_optimizer(path: str, by_name: dict, model: nn.Module,
                        optimizer: torch.optim.Optimizer) -> None:
    """Set ``optimizer``'s state from ``_resume_state_from_jax``'s: every
    parameter it trains must have one, in its dtype and on its device
    (Adam's step on the device when ``capturable``)."""
    names = {p: n for n, p in model.named_parameters()}
    trained = sorted(names[p] for group in optimizer.param_groups
                     for p in group["params"])
    if trained != sorted(by_name):
        raise ValueError(
            f"{path}: optimizer state does not fit the optimizer: the file "
            f"trains {sorted(by_name)}, the run {trained} "
            f"(--feature-extract must match)")
    placement = parallel.placement_of(model)
    for group in optimizer.param_groups:
        for p in group["params"]:
            st = {}
            for key, t in by_name[names[p]].items():
                if key == "step":
                    st[key] = t.to(p.device if group.get("capturable")
                                   else "cpu")
                else:
                    if placement is not None:
                        t = placement.take(names[p], t)
                    st[key] = t.to(device=p.device, dtype=p.dtype)
            optimizer.state[p] = st


def load_checkpoint_with_fallback(path: str, model: nn.Module,
                                  optimizer: Optional[torch.optim.Optimizer],
                                  rsl_path: str, dataset: str,
                                  model_name: str, train_state=None
                                  ) -> Tuple[int, float, int]:
    """``load_checkpoint`` with lineage recovery: when the requested file
    is torn or corrupt, fall back — loudly (error log + ``ckpt_fallback``
    telemetry event per skipped snapshot) — to the newest rolling snapshot
    that verifies."""
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
                return load_checkpoint(cand, model, optimizer,
                                       train_state=train_state)
            except ValueError as e:
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
