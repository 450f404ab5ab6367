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
In a world of several ranks, rank 0 writes a file (the caller gates on
``runtime.is_main()``) and every rank reads.  A model placed over a model
group (``parallel.place``) is written whole: every rank gathers its slices
first (``parallel.full_state``, a collective made before the gate; with
``--ckpt-async`` on the caller's thread too) and the file is the one a
replicated run writes; a placed model takes its slices of the full
tensors it restores, so one file (the port's or the JAX package's, which
writes full arrays) loads at any ``--model-parallel``.

``--ckpt-format orbax`` writes a checkpoint DIRECTORY at the same path
instead (JAX :616-917), on ``torch.distributed.checkpoint`` (DCP; the port
has no orbax): ``meta.json`` holds JAX's fields (``model_name``,
``epoch``, ``loss``, ``params_layout``, ``moe``, the structural
``checksum`` of ``_orbax_checksum``) with the port's ``format_version``,
and ``state/`` the five-field state as DCP entries: ``params.<name>``,
``opt_state.<parameter name>.<moment>`` (by name, so that it reshards)
with ``opt_state.param_groups``, ``step``, ``updates`` and
``loss_scale``.  Every rank calls ``save_directory`` and writes its own
slices as chunks of the full tensor (a ``Shard(groups=3)`` tensor, the
tensor-parallel qkv, through its ``(groups, -1)`` view, recorded in
``meta.json``'s ``views``); a replicated tensor is written once (DCP's
dedup), nothing is gathered, and rank 0 finalizes under ``<path>.tmp``
then swaps it in (JAX ``_orbax_finalize``).  A load reads, on each rank
alone, the chunks that overlap its own slices, at any
``--model-parallel`` and into an unplaced model; a directory of another
block layout is read whole, converted and sliced, as the file is.  A
directory the JAX package's orbax wrote (a tensorstore payload) is
refused in one line.
"""

from __future__ import annotations

import hashlib
import io
import json
import logging
import os
import re
import queue as queue_mod
import shutil
import threading
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from . import faults, parallel, runtime, telemetry
from .models import scan
from .models.convert import (cnn_params_from_jax, optimizer_state_from_jax,
                             params_from_jax)
from .precision import LossScaleState
# JAX's _orbax_checksum: the structural checksum of a directory
from .serving.rollout import DIR_META as _ORBAX_META
from .serving.rollout import dir_checksum as _orbax_checksum

FORMAT_VERSION = 3
_READABLE_VERSIONS = (1, 2, 3)  # the port's own files
_JAX_FORMAT_VERSION = 1
_JAX_MODELS = ("vit", "cnn", "mlp", "resnet", "alexnet", "vgg",
               "squeezenet", "densenet", "inception")
_LINEAGE = "ckpt-lineage.json"
_STATE_DIR = "state"
_DCP_METADATA = ".metadata"
# what the JAX package's orbax leaves in state/ (its tensorstore payload)
_ORBAX_PAYLOAD = ("_METADATA", "manifest.ocdbt")
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


def verify_checkpoint(path: str) -> Optional[str]:
    """None when the checkpoint matches its recorded checksum (or none was
    recorded; a directory's is in its meta.json); otherwise a one-line
    reason.  Never raises."""
    if os.path.isdir(path):
        try:
            with open(os.path.join(path, _ORBAX_META)) as f:
                meta = json.load(f)
        except (OSError, ValueError) as e:
            return f"unreadable {_ORBAX_META} ({e})"
        want = meta.get("checksum") if isinstance(meta, dict) else None
        if want is None:
            return None
        got = _orbax_checksum(os.path.abspath(path))
        if got != want:
            return (f"content checksum mismatch (recorded "
                    f"{want[:12]}…, found {got[:12]}…)")
        return None
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
    the sha from the ledger when recorded, else computed; a directory's
    is its meta.json checksum.  None when the file is unreadable."""
    path = os.path.abspath(path)
    name = os.path.basename(path.rstrip(os.sep))
    if os.path.isdir(path):
        try:
            with open(os.path.join(path, _ORBAX_META)) as f:
                meta = json.load(f)
        except (OSError, ValueError):
            return None
        if not isinstance(meta, dict):
            return None
        sha = meta.get("checksum") or _orbax_checksum(path)
        return {"file": name, "path": path, "sha256": sha,
                "epoch": meta.get("epoch")}
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
    """Delete the rolling file or directory ``keep`` epochs back,
    retaining the newest ``keep`` snapshots (keep=1 is the reference's
    delete-previous)."""
    prev = checkpoint_path(rsl_path, dataset, model_name,
                           epoch - max(1, keep))
    if os.path.isdir(prev):
        shutil.rmtree(prev)
    elif os.path.exists(prev):
        os.remove(prev)
    else:
        return
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


# -- directories (--ckpt-format orbax) -------------------------------------

_warned_async_world = False


def _dir_state(model: nn.Module, optimizer: Optional[torch.optim.Optimizer],
               step: int, updates: Optional[int],
               loss_scale: Optional[LossScaleState]) -> tuple:
    """What this rank writes into ``state/``: ({fqn: (its chunk, the
    chunk's offsets, the full shape)}, {fqn: a picklable value}, {fqn:
    the full shape, dim and groups of an entry stored through its
    ``(groups, -1)`` view}).  Read from the parameters themselves, never
    from a ZeRO forward's gathered tensors."""
    placement = parallel.placement_of(model)
    chunks, views = {}, {}

    def put(fqn: str, name: str, t: torch.Tensor) -> None:
        t = t.detach()
        if placement is None:
            chunks[fqn] = (t, (0,) * t.dim(), tuple(t.shape))
            return
        chunks[fqn] = placement.chunk(name, t)
        shard = placement.shards.get(name) if t.dim() else None
        if shard is not None and shard.groups > 1:
            views[fqn] = {"shape": list(placement.full_shape(name, t.shape)),
                          "dim": shard.dim, "groups": shard.groups}

    for name, t in model.state_dict().items():
        put("params." + name, name, t)
    values = {"step": int(step),
              "updates": int(step if updates is None else updates),
              "loss_scale": (None if loss_scale is None
                             else loss_scale.to_dict())}
    if optimizer is not None:
        osd = optimizer.state_dict()
        names = parallel.optimizer_names(model, optimizer)
        for idx, st in osd["state"].items():
            for key, v in st.items():
                fqn = f"opt_state.{names[idx]}.{key}"
                if isinstance(v, torch.Tensor):
                    put(fqn, names[idx], v)
                else:
                    values[fqn] = v
        values["opt_state.param_groups"] = [
            dict(g, params=[names[i] for i in g["params"]])
            for g in osd["param_groups"]]
    return chunks, values, views


def _dir_meta(model_name: str, model: nn.Module, epoch: int,
              best_valid_loss: float, views: dict) -> dict:
    """meta.json's fields but the checksum (JAX ``_orbax_meta``, with the
    port's format version and the grouped entries' ``views``)."""
    params = model.state_dict()
    return {"format_version": FORMAT_VERSION, "model_name": model_name,
            "epoch": int(epoch), "loss": float(best_valid_loss),
            "params_layout": scan.params_layout(dict.fromkeys(params)),
            "moe": _experts(params) > 0, "views": views}


def _dir_finalize(path: str, tmp: str, meta: dict) -> None:
    """meta.json write and the tmp -> dir swap (one writer; JAX
    ``_orbax_finalize``): the whole checkpoint is under ``tmp`` before
    this runs, so a crash before or inside it leaves the previous one at
    ``path``.  The structural checksum goes into meta.json; the swap is
    retried at fault site ``ckpt.finalize``, which then fires on the
    final directory."""
    meta = dict(meta, checksum=_orbax_checksum(tmp))

    def _attempt():
        with open(os.path.join(tmp, _ORBAX_META), "w") as f:
            json.dump(meta, f)
        if os.path.exists(path):
            shutil.rmtree(path)
        os.replace(tmp, path)

    faults.retry(_attempt, "ckpt.finalize")
    faults.fire("ckpt.finalize", path=path)
    total = sum(os.path.getsize(os.path.join(dp, fn))
                for dp, _, fns in os.walk(path) for fn in fns)
    _lineage_record(path, meta["epoch"], meta["checksum"], total)
    logging.info(f"epoch:{meta['epoch']:04d}: model saved to {path}")


def _dir_write(path: str, chunks: dict, values: dict, meta: dict,
               world: int) -> None:
    """Every rank of a world of ``world``: the DCP save under
    ``<path>.tmp``, then rank 0's finalize, between barriers (JAX
    ``_save_orbax``); a world of one runs no collective."""
    from . import dcp_io

    tmp = path + ".tmp"
    if runtime.is_main() and os.path.exists(tmp):
        shutil.rmtree(tmp)
    if world > 1:
        runtime.barrier()   # nobody writes into .tmp before the cleanup
    faults.fire("ckpt.save", path=path)
    try:
        dcp_io.write(os.path.join(tmp, _STATE_DIR), chunks, values,
                     no_dist=world == 1)
    except dcp_io.CheckpointException as e:
        # a BaseException: kept in the cause chain (a peer lost inside it
        # stays visible to elastic.is_peer_loss)
        raise RuntimeError(f"checkpoint directory {path!r} not written: "
                           f"{e}") from e
    err = None
    if runtime.is_main():
        try:
            _dir_finalize(path, tmp, meta)
        except Exception as e:  # raised after the barrier, on rank 0
            err = e
    if world > 1:
        runtime.barrier()   # no rank goes on before the swap is visible
    if err is not None:
        raise err


def save_directory(path: str, model_name: str, model: nn.Module,
                   epoch: int, best_valid_loss: float,
                   optimizer: Optional[torch.optim.Optimizer] = None,
                   step: int = 0, updates: Optional[int] = None,
                   loss_scale: Optional[LossScaleState] = None) -> None:
    """Write the checkpoint directory at ``path`` (``--ckpt-format
    orbax``) in a ``ckpt_save`` span, as JAX's ``save_checkpoint``.
    EVERY rank calls it: each writes its own slices and nothing is
    gathered; the arguments are ``save_checkpoint``'s."""
    with telemetry.get().span("ckpt_save", fmt="orbax", epoch=int(epoch),
                              file=os.path.basename(path)):
        chunks, values, views = _dir_state(model, optimizer, step, updates,
                                           loss_scale)
        _dir_write(os.path.abspath(path), chunks, values,
                   _dir_meta(model_name, model, epoch, best_valid_loss,
                             views), runtime.process_count())


def save_directory_async(saver: AsyncSaver, path: str, model_name: str,
                         model: nn.Module, epoch: int,
                         best_valid_loss: float,
                         optimizer: Optional[torch.optim.Optimizer] = None,
                         step: int = 0, updates: Optional[int] = None,
                         loss_scale: Optional[LossScaleState] = None
                         ) -> None:
    """``save_directory`` with only the snapshot on the caller's path (a
    ``ckpt_save_blocking`` span: the rank's chunks copied to the CPU);
    the DCP save and the finalize run on ``saver``'s thread (a
    ``ckpt_save_background`` span), after every earlier job, so two saves
    never share ``<path>.tmp`` at once.  In a world of several ranks the
    finalize's barriers are collectives that must not run beside the
    step's: it saves synchronously and warns once (JAX
    ``save_checkpoint_async``)."""
    global _warned_async_world
    world = runtime.process_count()
    if world > 1:
        if not _warned_async_world:
            logging.warning(
                "--ckpt-async with --ckpt-format orbax on a multi-host "
                "mesh falls back to synchronous saves (the finalize "
                "barrier is collective and cannot run on a background "
                "thread)")
            _warned_async_world = True
        if saver is not None:
            saver.wait()    # ordering with any earlier async save
        save_directory(path, model_name, model, epoch, best_valid_loss,
                       optimizer, step, updates, loss_scale)
        return
    path = os.path.abspath(path)
    attrs = dict(fmt="orbax", epoch=int(epoch), file=os.path.basename(path))
    with telemetry.get().span("ckpt_save_blocking", **attrs):
        chunks, values, views = _dir_state(model, optimizer, step, updates,
                                           loss_scale)
        chunks = {k: (_to_cpu(t), off, shape)
                  for k, (t, off, shape) in chunks.items()}
        values = _to_cpu(values)
        meta = _dir_meta(model_name, model, epoch, best_valid_loss, views)

    def write():
        with telemetry.get().span("ckpt_save_background", **attrs):
            _dir_write(path, chunks, values, meta, 1)

    saver.submit(write)


def _read_orbax_meta(path: str) -> dict:
    """Read and check ``meta.json``; a failure is JAX's one-line
    ValueError naming the path (``_read_orbax_meta``)."""
    meta_path = os.path.join(path, _ORBAX_META)
    if not os.path.exists(meta_path):
        raise ValueError(
            f"{path}: missing {_ORBAX_META} — not an orbax checkpoint "
            f"directory; expected one produced by this framework's "
            f"--ckpt-format orbax save (or pass a .ckpt msgpack file)")

    def _attempt():
        faults.fire("ckpt.restore", path=path)
        with open(meta_path) as f:
            return f.read()

    try:
        raw = faults.retry(_attempt, "ckpt.restore",
                           transient=_READ_TRANSIENT)
    except OSError as e:
        raise ValueError(
            f"{path}: cannot read {_ORBAX_META} ({e.strerror or e}) — "
            f"expected the metadata written by this framework's "
            f"--ckpt-format orbax save") from e
    try:
        meta = json.loads(raw)
        if not isinstance(meta, dict):
            raise ValueError("not a JSON object")
    except ValueError as e:
        raise ValueError(
            f"{path}: garbage {_ORBAX_META} ({e}) — expected the JSON "
            f"metadata written by this framework's --ckpt-format orbax "
            f"save; the directory is corrupt or foreign, restore from "
            f"an earlier snapshot") from e
    return meta


def _open_dir(path: str) -> Tuple[dict, dict]:
    """(meta.json, the DCP entries of ``state/``) of a verified directory
    the port wrote; a JAX-written one is refused in one line."""
    from . import dcp_io

    meta = _read_orbax_meta(path)
    state_dir = os.path.join(path, _STATE_DIR)
    if meta.get("format_version") == _JAX_FORMAT_VERSION or (
            not os.path.exists(os.path.join(state_dir, _DCP_METADATA))
            and any(os.path.exists(os.path.join(state_dir, n))
                    for n in _ORBAX_PAYLOAD)):
        raise ValueError(
            f"{path}: written by the JAX package's orbax (tensorstore "
            f"payload); the port reads directories it wrote and the JAX "
            f"package's msgpack files; re-save it with --ckpt-format "
            f"msgpack")
    if meta.get("format_version") != FORMAT_VERSION:
        raise ValueError(f"{path}: unsupported checkpoint format "
                         f"{meta.get('format_version')!r}")
    reason = verify_checkpoint(path)
    if reason is not None:
        raise ValueError(f"{path}: corrupt checkpoint — {reason}")
    try:
        return meta, dcp_io.entries(state_dir)
    except Exception as e:  # any DCP failure -> CLI-catchable ValueError
        raise ValueError(f"cannot restore checkpoint directory {path!r}: "
                         f"{e}") from e


def _dir_read(path: str, boxes: dict, values: list) -> dict:
    from . import dcp_io

    try:
        return dcp_io.read(os.path.join(path, _STATE_DIR), boxes, values)
    except (Exception, dcp_io.CheckpointException) as e:
        raise ValueError(f"cannot restore checkpoint directory {path!r}: "
                         f"{e}") from e


def _grouped(view: dict, t: torch.Tensor, offsets: list) -> list:
    """The boxes of the saved tensor that a view ``t`` at ``offsets`` of
    the full tensor covers: itself, or, for an entry stored through its
    ``(groups, -1)`` view, one box a group it crosses."""
    if not view:
        return [(t, list(offsets))]
    d = view["dim"]
    n = view["shape"][d] // view["groups"]
    a, b = offsets[d], offsets[d] + t.shape[d]
    return [(t.narrow(d, lo - a, hi - lo).unsqueeze(d),
             list(offsets[:d]) + [j, lo - j * n] + list(offsets[d + 1:]))
            for j in range(a // n, -(-b // n))
            for lo, hi in [(max(a, j * n), min(b, (j + 1) * n))]]


def _saved_shape(view: dict, full: tuple) -> tuple:
    if not view:
        return tuple(full)
    d, g = view["dim"], view["groups"]
    return tuple(full[:d]) + (g, full[d] // g) + tuple(full[d + 1:])


def _dir_payload(path: str, meta: dict, entries: dict,
                 restore_optimizer: bool) -> dict:
    """The directory read whole on the CPU as a port file's five fields
    (its ``opt_state`` an ``optimizer.state_dict()`` indexed as a file's
    parameters are): what a layout conversion and ``read_checkpoint``
    take."""
    from . import dcp_io

    wanted = [k for k in entries
              if restore_optimizer or not k.startswith("opt_state.")]
    boxes = {k: [(torch.empty(entries[k].size,
                              dtype=entries[k].properties.dtype),
                  [0] * len(entries[k].size))]
             for k in wanted if dcp_io.is_tensor(entries[k])}
    values = _dir_read(path, boxes, [k for k in wanted if k not in boxes])
    views = meta.get("views") or {}
    full = {k: (b[0][0].flatten(views[k]["dim"], views[k]["dim"] + 1)
                if k in views else b[0][0]) for k, b in boxes.items()}
    params = {k[len("params."):]: v for k, v in full.items()
              if k.startswith("params.")}
    opt_state = None
    groups = values.get("opt_state.param_groups")
    if groups is not None:
        names = [n for n in params
                 if not n.endswith(("running_mean", "running_var"))]
        pos = {n: i for i, n in enumerate(names)}
        state: dict = {}
        for k, v in list(full.items()) + list(values.items()):
            if k.startswith("opt_state.") and k != "opt_state.param_groups":
                name, key = k[len("opt_state."):].rsplit(".", 1)
                state.setdefault(pos[name], {})[key] = v
        opt_state = {"state": state, "param_groups": [
            dict(g, params=[pos[n] for n in g["params"]]) for g in groups]}
    return {"format_version": meta["format_version"],
            "model_name": meta.get("model_name"), "epoch": meta["epoch"],
            "loss": meta["loss"],
            "state": {"params": params, "opt_state": opt_state,
                      "step": values.get("step", 0),
                      "updates": values.get("updates", 0),
                      "loss_scale": values.get("loss_scale")}}


def _load_dir(path: str, model: nn.Module,
              optimizer: Optional[torch.optim.Optimizer],
              restore_optimizer: bool, train_state
              ) -> Tuple[int, float, int]:
    """``load_checkpoint`` of a directory: each rank reads the chunks
    that overlap its own slices (its placement's ``pieces``) straight
    into them, no full tensor and no gather; a directory of another
    block layout goes through ``_dir_payload`` and the file's path."""
    from . import dcp_io

    path = os.path.abspath(path)
    meta, entries = _open_dir(path)
    saved = {k[len("params."):]: torch.empty(e.size, device="meta")
             for k, e in entries.items()
             if k.startswith("params.") and dcp_io.is_tensor(e)}
    _check_experts(path, saved, model)
    if restore_optimizer and (optimizer is None or "opt_state.param_groups"
                              not in entries):
        raise ValueError(
            f"{path}: holds no optimizer state; it cannot resume training "
            f"(test and serve read it)")
    src, dst = meta.get("params_layout"), _model_layout(model)
    if src in scan.KNOWN_LAYOUTS and dst is not None and src != dst:
        return _restore(path, _dir_payload(path, meta, entries,
                                           restore_optimizer),
                        "port", model, optimizer, restore_optimizer,
                        train_state)
    placement = parallel.placement_of(model)
    views = meta.get("views") or {}
    boxes: dict = {}

    def want(fqn: str, name: str, shape, dtype) -> torch.Tensor:
        t = torch.empty(shape, dtype=dtype)
        pieces = ([(t, [0] * t.dim())] if placement is None
                  else placement.pieces(name, t))
        full = (tuple(t.shape) if placement is None
                else placement.full_shape(name, t.shape))
        view = views.get(fqn)
        if (view and tuple(view["shape"]) != full) or tuple(
                entries[fqn].size) != _saved_shape(view, full):
            raise ValueError(
                f"{path}: params do not fit the model: {fqn} is "
                f"{tuple(entries[fqn].size)} in the checkpoint, {full} in "
                f"the model")
        boxes[fqn] = [b for v, off in pieces for b in _grouped(view, v, off)]
        return t

    local = model.state_dict()
    missing = sorted(k for k in local if "params." + k not in entries)
    unexpected = sorted(set(saved) - set(local))
    if missing or unexpected:
        raise ValueError(f"{path}: params do not fit the model: missing "
                         f"{missing}, unexpected {unexpected}")
    params = {k: want("params." + k, k, t.shape, t.dtype)
              for k, t in local.items()}
    values = [k for k, e in entries.items() if not dcp_io.is_tensor(e)
              and (restore_optimizer or not k.startswith("opt_state."))]
    got = _dir_read(path, {}, values)
    opt_state = None
    if restore_optimizer:
        names = parallel.optimizer_names(model, optimizer)
        run_groups, i = [], 0
        for g in optimizer.param_groups:
            run_groups.append(list(range(i, i + len(g["params"]))))
            i += len(g["params"])
        saved_groups = got["opt_state.param_groups"]
        if len(saved_groups) != len(run_groups) or any(
                set(s["params"]) != {names[i] for i in r}
                for s, r in zip(saved_groups, run_groups)):
            raise ValueError(
                f"{path}: optimizer state does not fit the optimizer: the "
                f"checkpoint trains "
                f"{sorted(n for s in saved_groups for n in s['params'])}, "
                f"the run {sorted(names.values())} (--feature-extract must "
                f"match)")
        by_name = dict(model.named_parameters())
        state: dict = {}
        for idx, name in names.items():
            prefix = f"opt_state.{name}."
            for k, e in entries.items():
                key = k[len(prefix):]
                if not k.startswith(prefix) or "." in key:
                    continue
                if not dcp_io.is_tensor(e):
                    state.setdefault(idx, {})[key] = got[k]
                    continue
                shape = by_name[name].shape if len(e.size) else ()
                state.setdefault(idx, {})[key] = want(
                    k, name, shape, e.properties.dtype)
        opt_state = {"state": state, "param_groups": [
            dict(s, params=r) for s, r in zip(saved_groups, run_groups)]}
    _dir_read(path, boxes, [])
    try:
        model.load_state_dict(params, strict=True)
    except RuntimeError as e:
        raise ValueError(f"{path}: params do not fit the model: {e}") from e
    if opt_state is not None:
        _set_optimizer_state(path, optimizer, opt_state)
    step = int(got.get("step", 0))
    _restore_counters(train_state, step, got)
    epoch = int(meta["epoch"]) + 1
    logging.info(f"epoch:{epoch:04d}: model loaded from {path}")
    return epoch, float(meta["loss"]), step


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
    """Read, checksum against the lineage ledger (a directory: against
    its meta.json), decode any format.  Returns the five fields with
    ``state["params"]`` as a port ``state_dict`` (a directory's read
    whole on the CPU).  Every failure is a ValueError."""
    if os.path.isdir(path):
        path = os.path.abspath(path)
        return _dir_payload(path, *_open_dir(path), restore_optimizer=True)
    return _read(path)[0]


def get_checkpoint_model_name(path: str) -> str:
    """The checkpoint's ``model_name``; a directory's from its meta.json
    alone (JAX ``get_checkpoint_model_name``)."""
    if os.path.isdir(path):
        meta = _read_orbax_meta(os.path.abspath(path))
        if "model_name" not in meta:
            raise ValueError(
                f"{path}: {_ORBAX_META} has no model_name — expected "
                f"the metadata written by this framework's --ckpt-format "
                f"orbax save")
        return str(meta["model_name"])
    return str(_read(path)[0]["model_name"])


def _experts(params) -> int:
    """Experts a block of a MoE vit's params (0: dense MLPs)."""
    router = params.get("blocks.0.moe.router.weight")
    return 0 if router is None else int(router.shape[0])


def _model_layout(model: nn.Module) -> Optional[str]:
    """The layout of ``model``'s parameters (``scan.params_layout``), or
    None for a model of none."""
    return scan.params_layout(
        dict.fromkeys(n for n, _ in model.named_parameters()))


def _check_experts(path: str, params: dict, model: nn.Module) -> None:
    """A checkpoint and a model that differ in ``--moe-experts`` fail with
    one line naming it; ``params`` may hold meta tensors (a directory's
    shapes, before any tensor is read)."""
    saved, wanted = _experts(params), _experts(model.state_dict())
    if saved != wanted:
        def side(e: int) -> str:
            return (f"{e}-expert mixture-of-experts blocks" if e
                    else "dense MLPs")

        raise ValueError(
            f"checkpoint at {path} holds {side(saved)}, the requested "
            f"model {side(wanted)} — load with a matching --moe-experts "
            f"(--moe-experts {saved})")


def _load_params(path: str, payload: dict, model: nn.Module
                 ) -> Optional[tuple]:
    """Strict load of the file's params; a file and a model that differ
    in ``--moe-experts`` fail with one line naming it, as JAX's layout
    check does (``checkpoint.py:735-752``).  A file of the other layout
    of the model's family is converted first, as JAX converts at load
    (:1025-1045).  Returns (the model's layout, the file's vit depth or
    None) when it converted, else None."""
    _check_experts(path, payload["state"]["params"], model)
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
    if os.path.isdir(path):
        epoch = load_checkpoint(path, model, restore_optimizer=False)[0] - 1
    else:
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
    docstring.  A directory (``--ckpt-format orbax``) restores each
    rank's slices from the chunks that hold them."""
    if os.path.isdir(path):
        return _load_dir(path, model, optimizer, restore_optimizer,
                         train_state)
    payload, writer = _read(path)
    return _restore(path, payload, writer, model, optimizer,
                    restore_optimizer, train_state)


def _restore_counters(train_state, step: int, state: dict) -> None:
    """The trainer's step, applied updates and loss scale from a
    checkpoint's (the rule of the module docstring)."""
    if train_state is None:
        return
    train_state.step.fill_(step)
    train_state.updates.fill_(int(state.get("updates", step)))
    saved = state.get("loss_scale")
    if train_state.loss_scale is not None and saved is not None:
        train_state.loss_scale.assign(LossScaleState.from_dict(saved))


def _restore(path: str, payload: dict, writer: str, model: nn.Module,
             optimizer: Optional[torch.optim.Optimizer],
             restore_optimizer: bool, train_state
             ) -> Tuple[int, float, int]:
    """``load_checkpoint`` of a decoded payload (a file's, or a directory
    read whole)."""
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
        opt_state = state["opt_state"]
        if converted is not None:
            opt_state = _convert_optimizer_state(
                opt_state, [n for n in payload["state"]["params"]
                            if not n.endswith(("running_mean",
                                               "running_var"))],
                model, optimizer, converted)
        placement = parallel.placement_of(model)
        if placement is not None:
            try:
                opt_state = placement.local_optimizer_state(
                    parallel.optimizer_names(model, optimizer), opt_state)
            except KeyError as e:
                raise ValueError(f"{path}: optimizer state does not fit the "
                                 f"optimizer: {e}") from e
        _set_optimizer_state(path, optimizer, opt_state)
    step = int(state.get("step", 0))
    _restore_counters(train_state, step, state)
    epoch = int(payload["epoch"]) + 1
    logging.info(f"epoch:{epoch:04d}: model loaded from {path}")
    return epoch, float(payload["loss"]), step


def _set_optimizer_state(path: str, optimizer: torch.optim.Optimizer,
                         opt_state: dict) -> None:
    """``optimizer.load_state_dict`` with the run's ``capturable`` kept;
    a state that does not fit fails with one line."""
    capturable = [g.get("capturable") for g in optimizer.param_groups]
    try:
        optimizer.load_state_dict(opt_state)
    except (ValueError, KeyError) as e:
        raise ValueError(f"{path}: optimizer state does not fit the "
                         f"optimizer: {e}") from e
    _keep_capturable(optimizer, capturable)


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
