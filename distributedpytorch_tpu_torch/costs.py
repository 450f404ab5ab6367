"""One provenance-stamped cost registry: ``RSL_PATH/costs.json``.

Counterpart of ``distributedpytorch_tpu/costs.py`` (``reset``, ``record``,
``record_analytic``, ``record_mfu_denominator``, ``registry``, ``save``,
``load``) in the same JSON schema: ``{"device_kind", "saved_at",
"programs": {name: entry}}``, each entry stamped with ``ts``, ``mono``
and ``device_kind``; the JAX version's ``jax_version`` stamp is
``torch_version`` here.

* ``record(name, flops=...)`` registers a program's FLOPs per invocation:
  the port's programs are the eager ``train_step`` and ``eval_step`` (or,
  with ``--epochs-per-dispatch`` > 1, the chunk's two CUDA Graphs
  ``train_graph`` and ``eval_graph``), counted by ``ops/flops.py``
  (``source="flop_counter"``).
* ``record_kernel`` registers the analytic FLOPs and bytes of one of the
  port's CUDA kernels at its launch shape, under its CUDA symbol (both
  routes' symbols, ``:pos`` appended for the ring's positional
  instances), by the formulas of PERF.md's bound column: each input read
  once and each output written once, and 2 x D operations per (q, k)
  pair and head for each product (K1 and K4: 2 products, K2 and K2p: 3,
  K3 and K3p: 4), 2 x 9 Ci Co per output pixel for K5.  The wrappers
  call ``note_kernel`` at each launch; it records only inside
  ``recording_kernels()`` (the AOT warmup and the ``--profile`` epoch),
  the first shape of each kernel kept.  The roofline (``roofline.py``)
  joins the kernels of a Kineto trace to these entries by symbol.
* The JAX module's HLO parsers (``hlo_op_costs``,
  ``hlo_instruction_count``, :265-437) and the ``compile/hlo_instructions``
  gauge have no counterpart: the port compiles no XLA program.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Dict, Optional

import torch

from . import telemetry

_lock = threading.Lock()
_registry: Dict[str, dict] = {}
_device_kind: Optional[str] = None
_recording = False

# the port's kernel -> its CUDA symbols (tensor-core route, scalar route)
KERNEL_SYMBOLS = {
    "flash_fwd": ("flash_fwd_mma_kernel", "flash_fwd_kernel"),
    "flash_dq": ("flash_dq_mma_kernel", "flash_dq_kernel"),
    "flash_dkv": ("flash_dkv_mma_kernel", "flash_dkv_kernel"),
    "flash_fwd_pos": ("flash_fwd_mma_kernel:pos", "flash_fwd_kernel:pos"),
    "flash_dq_pos": ("flash_dq_mma_kernel:pos", "flash_dq_kernel:pos"),
    "flash_dkv_pos": ("flash_dkv_mma_kernel:pos", "flash_dkv_kernel:pos"),
    "conv_dw": ("conv_dw_mma_kernel", "conv_dw_partial_kernel"),
}


def reset(device_kind: Optional[str] = None) -> None:
    """Drop all entries (start of each run; tests) and set the device the
    stamps name (``torch.cuda.get_device_name``; None on the CPU)."""
    global _device_kind
    with _lock:
        _registry.clear()
        _device_kind = device_kind


def _stamp(entry: dict) -> dict:
    entry["ts"] = time.time()
    entry["mono"] = time.monotonic()
    entry["device_kind"] = _device_kind
    entry["torch_version"] = torch.__version__
    return entry


def _put(name: str, entry: dict) -> dict:
    with _lock:
        _registry[name] = entry
    return entry


def record(name: str, flops: Optional[float],
           bytes_accessed: Optional[float] = None,
           note: Optional[str] = None) -> dict:
    """A program's FLOPs (and bytes, when known) per invocation; None is
    an explicit "not counted", never a zero."""
    entry = _stamp({"source": "flop_counter",
                    "flops": None if flops is None else float(flops),
                    "bytes_accessed": (None if bytes_accessed is None
                                       else float(bytes_accessed))})
    if note:
        entry["note"] = note
    _put(name, entry)
    telemetry.get().event("cost_analysis", program=name,
                          source=entry["source"], flops=entry["flops"],
                          bytes_accessed=entry["bytes_accessed"])
    return entry


def record_analytic(name: str, *, flops: Optional[float] = None,
                    flops_per_sample: Optional[float] = None,
                    note: Optional[str] = None) -> dict:
    """An analytically derived count, tagged ``source="analytic"``."""
    entry = _stamp({
        "source": "analytic",
        "flops": float(flops) if flops is not None else None,
        "flops_per_sample": (float(flops_per_sample)
                             if flops_per_sample is not None else None),
    })
    if note:
        entry["note"] = note
    _put(name, entry)
    telemetry.get().event("cost_analysis", program=name,
                          source=entry["source"], flops=entry["flops"],
                          flops_per_sample=entry.get("flops_per_sample"))
    return entry


def record_mfu_denominator(peak: float, dtype: str,
                           device_kind: Optional[str] = None) -> dict:
    """Which peak this run's MFU divides by, and its type."""
    entry = _stamp({
        "source": "peak_table",
        "peak_flops_per_chip": float(peak),
        "peak_dtype": str(dtype),
    })
    if device_kind:
        entry["device_kind"] = device_kind
    _put("mfu_denominator", entry)
    telemetry.get().event("cost_analysis", program="mfu_denominator",
                          source=entry["source"],
                          peak_flops_per_chip=entry["peak_flops_per_chip"],
                          peak_dtype=entry["peak_dtype"])
    return entry


def kernel_cost(kernel: str, q_shape, k_shape=None, dtype=torch.bfloat16,
                causal: bool = False, tensor_core: bool = True) -> tuple:
    """(FLOPs, bytes) of one launch of the port's ``kernel`` at its
    shapes: the attention kernels at q (B, Sq, H, D) and k/v (B, Sk, H,
    D) (Sk = Sq when not given), K5 (``conv_dw``) at x (B, H, W, Ci) and
    dy (B, H, W, Co) given as ``q_shape`` and ``k_shape``."""
    item = torch.empty((), dtype=dtype).element_size()
    if kernel == "conv_dw":
        b, h, w, ci = q_shape
        co = k_shape[3]
        return (2.0 * b * h * w * 9 * ci * co,
                float(b * h * w * (ci + co) * item + 9 * ci * co * 4))
    b, sq, h, d = q_shape
    sk = sq if k_shape is None else k_shape[1]
    pairs = sq * (sq + 1) / 2 if causal and sq == sk else sq * sk
    tq, tk = b * sq * h * d, b * sk * h * d
    rows = b * h * sq * 4
    pos = (sq + sk) * 4
    products = {"flash_fwd": 2, "flash_dq": 3, "flash_dkv": 4,
                "flash_fwd_pos": 2, "flash_dq_pos": 3, "flash_dkv_pos": 4}
    nbytes = {
        # q, k, v read; O and lse written
        "flash_fwd": (tq + 2 * tk) * item + tq * item + rows,
        # q, k, v, dO, O, lse read; dq, delta written
        "flash_dq": (3 * tq + 2 * tk) * item + tq * item + 2 * rows,
        # q, k, v, dO, lse, delta read; dk, dv written
        "flash_dkv": (2 * tq + 2 * tk) * item + 2 * tk * item + 2 * rows,
        # q, k, v, the positions read; f32 O and lse written
        "flash_fwd_pos": (tq + 2 * tk) * item + pos + 4 * tq + rows,
        # q, k, v, f32 dO and O, lse, dlse, positions read; dq, delta
        # (and the 16-bit dO on the tensor cores) written
        "flash_dq_pos": ((tq + 2 * tk) * item + 8 * tq + 3 * rows + pos
                         + tq * item + (2 * tq if tensor_core else 0)),
        # q, k, v, dO (16-bit on the tensor cores), lse, delta, positions
        # read; dk, dv written
        "flash_dkv_pos": ((tq + 2 * tk) * item
                          + (2 if tensor_core else 4) * tq + 2 * rows
                          + pos + 2 * tk * item),
    }[kernel]
    return products[kernel] * 2.0 * b * h * pairs * d, float(nbytes)


def record_kernel(kernel: str, q_shape, k_shape=None, dtype=torch.bfloat16,
                  causal: bool = False) -> None:
    """The analytic entry of ``kernel`` at this launch shape, under each
    of its CUDA symbols."""
    from .ops.flops import dtype_label

    flops, nbytes = kernel_cost(kernel, q_shape, k_shape, dtype, causal)
    for symbol in KERNEL_SYMBOLS[kernel]:
        _put(symbol, _stamp({
            "source": "analytic_kernel", "kernel": kernel,
            "flops": flops, "bytes_accessed": nbytes,
            "dtype": dtype_label(dtype), "shape": list(q_shape),
            "note": "one launch; PERF.md's bound formula"}))


def note_kernel(kernel: str, q: torch.Tensor, k: Optional[torch.Tensor]
                = None, causal: bool = False) -> None:
    """Called by the kernels' wrappers at each launch: records the
    kernel's entry (first shape wins) inside ``recording_kernels``, does
    nothing otherwise."""
    if not _recording:
        return
    if KERNEL_SYMBOLS[kernel][0] in _registry:
        return
    record_kernel(kernel, tuple(q.shape),
                  None if k is None else tuple(k.shape), q.dtype, causal)


@contextlib.contextmanager
def recording_kernels():
    """The launches inside record their kernels' analytic entries."""
    global _recording
    was, _recording = _recording, True
    try:
        yield
    finally:
        _recording = was


def registry() -> Dict[str, dict]:
    """Snapshot copy of the registry (program name -> entry)."""
    with _lock:
        return {k: dict(v) for k, v in _registry.items()}


def save(rsl_path: str) -> Optional[str]:
    """Write ``RSL_PATH/costs.json`` atomically; the path, or None when
    empty.  The caller gates on rank 0."""
    progs = registry()
    if not progs:
        return None
    doc = {
        "device_kind": _device_kind,
        "torch_version": torch.__version__,
        "saved_at": {"ts": time.time(), "mono": time.monotonic()},
        "programs": progs,
    }
    os.makedirs(rsl_path, exist_ok=True)
    path = os.path.join(rsl_path, "costs.json")
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
    os.replace(tmp, path)
    return path


def load(rsl_path: str) -> Optional[dict]:
    """A saved ``costs.json`` (None if absent or unreadable)."""
    try:
        with open(os.path.join(rsl_path, "costs.json")) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None
