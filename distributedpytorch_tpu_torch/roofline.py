"""Per-op roofline attribution from Kineto (``torch.profiler``) traces.

Counterpart of ``distributedpytorch_tpu/roofline.py``: parse a trace
directory (``RSL_PATH/trace`` from ``--profile``, or an anomaly capture),
attribute the step's time to ops, join each op with its FLOPs and bytes,
classify it compute- or memory-bound against the card's ridge
(``ops/flops.py``; a generic ridge when the device is unknown) and write
``RSL_PATH/roofline.json``.  ``bound_class``, ``classify``'s rows,
``analyze``, ``save_report``, ``emit_telemetry``, ``render_report`` and
``anomaly_capture_dirs`` are the JAX ones.

Parsing (``parse_trace_dir``) reads PyTorch's Chrome trace (Kineto)
instead of XLA's:

* on the card, the ops are the device events (``kernel``, ``gpu_memcpy``,
  ``gpu_memset``), each one its own time (a stream runs one at a time),
  and the step time is the union of their intervals across streams;
* without device events (``--device cpu``), the ops are the aten
  ``cpu_op`` events' self times (nested ops attribute each microsecond to
  the innermost, the JAX CPU fallback's sweep), and the step time is the
  union of the ``cpu_op`` and ``user_annotation`` (``train_step``)
  intervals, so the host's gaps between ops stay in the residual.

FLOPs and bytes come from, in order: ``costs.json``'s analytic entries
of the port's kernels, keyed by CUDA symbol (``costs.record_kernel``;
``:pos`` for the ring's positional instances); the aten op that launched
a kernel (its ``External id``, or its launch's correlation id), counted
from the op's recorded input shapes for matmuls and convolutions (the
trace carries no ``flops`` field; the first kernel of an op takes the
op's count); and otherwise the JAX name heuristics.  A kernel replayed
from a CUDA Graph (``--epochs-per-dispatch`` > 1) was launched by
``cudaGraphLaunch``, not by an aten op, so only the port's kernels are
costed there, and the report says so in ``warnings`` (and that the graph
left no kernel in the trace, when that happens).
"""

from __future__ import annotations

import glob
import gzip
import json
import logging
import math
import os
import re
import time
from typing import Any, Dict, List, Optional, Tuple

from . import costs
from .ops.flops import dtype_label, peak_flops, peak_membw

SCHEMA = 1

# Ridge point (FLOPs/byte) used when the device peaks are unknown (the
# CPU): the report labels the source "generic".
DEFAULT_RIDGE = 10.0

# Substrings that mark an op as matmul work when no analytic costs exist.
_COMPUTE_NAME_HINTS = ("dot", "conv", "gemm", "matmul", "einsum")

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_GRAPH_LAUNCH = "cudaGraphLaunch"
_ITEM_BYTES = {"float": 4, "double": 8, "c10::BFloat16": 2, "c10::Half": 2,
               "long int": 8, "int": 4, "bool": 1, "unsigned char": 1}
_MATMULS = {"aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm"}
# the convolution ops that run the work (their callers carry no FLOPs,
# so the flops of a chain land once, on its innermost op)
_CONVS = {"aten::cudnn_convolution", "aten::mkldnn_convolution",
          "aten::_slow_conv2d_forward", "aten::thnn_conv2d",
          "aten::_nnpack_spatial_convolution"}
_CONV_BACKWARD = "aten::convolution_backward"


def find_trace_files(trace_dir: str) -> List[str]:
    """Every ``*.trace.json[.gz]`` under ``trace_dir``, recursively.

    Callers pass the directory the profiler wrote into and this finds
    whatever landed underneath.
    """
    hits: List[str] = []
    for pat in ("**/*.trace.json.gz", "**/*.trace.json"):
        hits.extend(glob.glob(os.path.join(glob.escape(trace_dir), pat),
                              recursive=True))
    return sorted(hits)


def _load_trace(path: str) -> Optional[dict]:
    """One trace file -> parsed JSON; None (caller warns) when torn."""
    try:
        if path.endswith(".gz"):
            with gzip.open(path, "rt", encoding="utf-8",
                           errors="replace") as f:
                return json.load(f)
        with open(path, encoding="utf-8", errors="replace") as f:
            return json.load(f)
    except (OSError, ValueError, EOFError):
        return None


def _union_us(intervals: List[Tuple[float, float]]) -> float:
    """Total length of the union of [start, end) intervals."""
    if not intervals:
        return 0.0
    intervals.sort()
    total = 0.0
    cur_s, cur_e = intervals[0]
    for s, e in intervals[1:]:
        if s > cur_e:
            total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + (cur_e - cur_s)


def _self_times(hlo_events: List[tuple]) -> List[tuple]:
    """Exclusive (self) time of each nested slice on one thread.

    Profiler op slices NEST: a ``while`` op's event covers every body
    op executed inside it, so summing durations would double-count the
    whole loop.  The standard flame-graph sweep attributes each
    microsecond to the innermost op: self = dur - sum(direct children).
    Input: ``(ts, end, dur, opkey)`` tuples; output: ``(opkey,
    self_us)`` per event.
    """
    evs = sorted(hlo_events, key=lambda e: (e[0], -e[1]))
    out: List[tuple] = []
    stack: List[list] = []  # [end, child_us, opkey, dur]
    eps = 1e-6
    for ts, end, dur, opkey in evs:
        while stack and ts >= stack[-1][0] - eps:
            top = stack.pop()
            out.append((top[2], max(0.0, top[3] - top[1])))
        if stack:
            stack[-1][1] += dur
        stack.append([end, 0.0, opkey, dur])
    while stack:
        top = stack.pop()
        out.append((top[2], max(0.0, top[3] - top[1])))
    return out


_ANON = "(anonymous namespace)::"


def kernel_symbol(name: str) -> str:
    """A Kineto kernel name -> the CUDA symbol ``costs.py`` keys on: the
    function's name without its namespace, template arguments and
    parameters, and ``:pos`` for a ``flash_*`` kernel instantiated with
    kPos true (the port's kernels live in an anonymous namespace)."""
    base = _short_name(name)
    args = ""
    if "<" in base:
        base, args = base.split("<", 1)
    base = base.rsplit("::", 1)[-1].strip()
    if base.startswith("flash_") and args.rstrip(">").rstrip().endswith(
            "true"):
        return base + ":pos"
    return base


def _short_name(name: str) -> str:
    """A kernel's name without ``void ``, the anonymous namespace and its
    parameter list."""
    name = name[5:] if name.startswith("void ") else name
    name = name.replace(_ANON, "")
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            return name[:i]
    return name


def _concrete_ints(text) -> Optional[List[int]]:
    try:
        vals = json.loads(text) if isinstance(text, str) else text
    except ValueError:
        return None
    if isinstance(vals, int):
        return [vals]
    if isinstance(vals, list) and all(isinstance(v, int) for v in vals):
        return vals
    return None


def op_cost(name: str, args: Dict[str, Any]
            ) -> Optional[Tuple[float, float, Optional[str]]]:
    """(FLOPs, bytes, dtype label) of one aten op from its recorded input
    shapes (``record_shapes``): the matmuls and the convolutions that do
    the work, 2 x multiply-adds, each input read once and the output
    written once; None for any other op or a shape it cannot read."""
    dims = args.get("Input Dims") or []
    types = args.get("Input type") or []
    try:
        item = _ITEM_BYTES.get(next(t for t in types if t), 4)
        label = dtype_label({"float": "f32", "double": "f64",
                             "c10::BFloat16": "bf16",
                             "c10::Half": "f16"}.get(types[0], "f32"))
        if name in _MATMULS:
            first = 1 if name in ("aten::addmm", "aten::baddbmm") else 0
            a, b = dims[first], dims[first + 1]
            batch = a[0] if len(a) == 3 else 1
            m, k, n = a[-2], a[-1], b[-1]
            extra = math.prod(dims[0]) if first else 0
            return (2.0 * batch * m * k * n,
                    float((batch * (m * k + k * n + m * n) + extra) * item),
                    label)
        if name in _CONVS or name == _CONV_BACKWARD:
            concrete = args.get("Concrete Inputs") or []
            if name == _CONV_BACKWARD:
                grad_out, x, w = dims[0], dims[1], dims[2]
                flops = 2.0 * math.prod(grad_out) * math.prod(w[1:])
                nbytes = (2 * math.prod(grad_out) + 2 * math.prod(x)
                          + 2 * math.prod(w)) * item
                return 2.0 * flops, float(nbytes), label
            x, w = dims[0], dims[1]
            padding, stride, dilation = (_concrete_ints(c) for c in
                                         concrete[3:6])
            if not (padding and stride and dilation):
                return None
            spatial = len(x) - 2
            pad = padding * spatial if len(padding) == 1 else padding
            st = stride * spatial if len(stride) == 1 else stride
            dil = dilation * spatial if len(dilation) == 1 else dilation
            out_sp = [(x[2 + i] + 2 * pad[i] - dil[i] * (w[2 + i] - 1) - 1)
                      // st[i] + 1 for i in range(spatial)]
            out = x[0] * w[0] * math.prod(out_sp)
            return (2.0 * out * math.prod(w[1:]),
                    float((math.prod(x) + math.prod(w) + out) * item),
                    label)
    except (IndexError, TypeError, ValueError, StopIteration):
        return None
    return None


def _new_agg() -> Dict[str, Any]:
    return {"time_us": 0.0, "count": 0, "flops_total": 0.0,
            "bytes_total": 0.0, "n_costed": 0, "dtype": None,
            "launched_by": None}


def _charge(agg: Dict[str, Any], cost) -> None:
    if cost is None:
        return
    agg["flops_total"] += cost[0]
    agg["bytes_total"] += cost[1]
    agg["n_costed"] += 1
    agg["dtype"] = agg["dtype"] or cost[2]


def _device_ops(events: list, ops: Dict[Tuple[str, str], Dict[str, Any]],
                notes: Dict[str, int]) -> Tuple[list, list]:
    """One trace's device events into ``ops``; returns (the device
    intervals, the same) for the step time and the attribution."""
    by_ext: Dict[Any, dict] = {}
    runtime: Dict[Any, dict] = {}
    for ev in events:
        cat = ev.get("cat")
        args = ev.get("args") if isinstance(ev.get("args"), dict) else {}
        if cat == "cpu_op" and "External id" in args:
            by_ext[args["External id"]] = ev
        elif cat in ("cuda_runtime", "cuda_driver") and \
                "correlation" in args:
            runtime[args["correlation"]] = ev
    costed_ext = set()
    intervals = []
    for ev in events:
        if ev.get("cat") not in _DEVICE_CATS:
            continue
        try:
            ts, dur = float(ev["ts"]), float(ev.get("dur", 0.0))
        except (KeyError, TypeError, ValueError):
            continue
        if dur < 0:
            continue
        args = ev.get("args") if isinstance(ev.get("args"), dict) else {}
        launch = runtime.get(args.get("correlation"))
        ext = args.get("External id")
        if ext not in by_ext and launch is not None:
            ext = (launch.get("args") or {}).get("External id")
        op = by_ext.get(ext)
        if launch is not None and launch.get("name") == _GRAPH_LAUNCH:
            notes["graph_kernels"] += 1
        intervals.append((ts, ts + dur))
        name = str(ev.get("name", "?"))
        key = ("gpu", _short_name(name) if ev.get("cat") == "kernel"
               else name)
        agg = ops.setdefault(key, _new_agg())
        agg["time_us"] += dur
        agg["count"] += 1
        if agg["launched_by"] is None:
            agg["launched_by"] = (op.get("name") if op is not None
                                  else launch.get("name") if launch
                                  else None)
        if op is not None and ext not in costed_ext:
            costed_ext.add(ext)
            _charge(agg, op_cost(str(op.get("name")), op.get("args") or {}))
    return intervals, list(intervals)


def _cpu_ops(events: list, ops: Dict[Tuple[str, str], Dict[str, Any]]
             ) -> Tuple[list, list]:
    """One trace's aten ops (self times, per thread) into ``ops``; returns
    (the step intervals: ops and user annotations, the op intervals)."""
    threads: Dict[Any, Tuple[list, list]] = {}
    for ev in events:
        cat = ev.get("cat")
        if cat not in ("cpu_op", "user_annotation"):
            continue
        try:
            ts, dur = float(ev["ts"]), float(ev.get("dur", 0.0))
        except (KeyError, TypeError, ValueError):
            continue
        if dur < 0:
            continue
        allx, opx = threads.setdefault((ev.get("pid"), ev.get("tid")),
                                       ([], []))
        allx.append((ts, ts + dur))
        if cat == "cpu_op":
            args = ev.get("args") if isinstance(ev.get("args"), dict) \
                else {}
            name = str(ev.get("name", "?"))
            opx.append((ts, ts + dur, dur,
                        (("cpu", name), op_cost(name, args))))
    step_iv: list = []
    attr_iv: list = []
    for allx, opx in threads.values():
        if not opx:
            continue
        step_iv.extend(allx)
        attr_iv.extend(iv[:2] for iv in opx)
        for (key, cost), self_us in _self_times(opx):
            agg = ops.setdefault(key, _new_agg())
            agg["time_us"] += self_us
            agg["count"] += 1
            _charge(agg, cost)
    return step_iv, attr_iv


def parse_trace_dir(trace_dir: str) -> Dict[str, Any]:
    """Aggregate a trace directory into per-op time attribution.

    Returns ``{ops, step_time_us, attributed_us, residual_us, coverage,
    n_trace_files, n_events, warnings}`` (the JAX keys) where ``ops``
    maps ``("gpu", kernel)`` or ``("cpu", aten op)`` to ``{time_us,
    count}`` plus the FLOPs and bytes counted from the launching ops
    (``flops_total``, ``bytes_total`` over ``n_costed`` instances) and
    the op that launched the first instance (``launched_by``)."""
    files = find_trace_files(trace_dir)
    if not files:
        raise ValueError(
            f"no profiler trace files (*.trace.json[.gz]) under "
            f"{trace_dir!r}; run with --profile or point --trace-dir at "
            f"a torch.profiler capture")
    warnings: List[str] = []
    n_events = n_parsed = 0
    ops: Dict[Tuple[str, str], Dict[str, Any]] = {}
    notes = {"graph_kernels": 0, "graph_launches": 0}
    step_us = attr_us = 0.0
    parsed_files = []
    for path in files:
        data = _load_trace(path)
        if not isinstance(data, dict) or not isinstance(
                data.get("traceEvents"), list):
            warnings.append(f"torn or unparseable trace file skipped: "
                            f"{os.path.basename(path)}")
            continue
        n_parsed += 1
        events = [ev for ev in data["traceEvents"]
                  if isinstance(ev, dict) and ev.get("ph") == "X"]
        n_events += len(events)
        parsed_files.append(events)
        notes["graph_launches"] += sum(1 for ev in events
                                       if ev.get("name") == _GRAPH_LAUNCH)
    if n_parsed == 0:
        raise ValueError(
            f"all {len(files)} trace file(s) under {trace_dir!r} were "
            f"torn or unparseable")
    on_device = any(ev.get("cat") in _DEVICE_CATS
                    for events in parsed_files for ev in events)
    for events in parsed_files:
        step_iv, attr_iv = (_device_ops(events, ops, notes) if on_device
                            else _cpu_ops(events, ops))
        step_us += _union_us(step_iv)
        attr_us += _union_us(attr_iv)
    if notes["graph_launches"]:
        if notes["graph_kernels"]:
            warnings.append(
                f"{notes['graph_kernels']} kernels were replayed from CUDA "
                f"Graphs ({notes['graph_launches']} cudaGraphLaunch): no "
                f"aten op launched them, so only the port's kernels among "
                f"them are costed (costs.json)")
        else:
            warnings.append(
                f"the trace holds {notes['graph_launches']} "
                f"cudaGraphLaunch calls but no kernel linked to them: "
                f"Kineto did not record the replayed graphs' kernels, and "
                f"their time is missing from this report")
    if not ops:
        raise ValueError(
            f"trace under {trace_dir!r} has no device kernel and no aten "
            f"op event — nothing executed while tracing")
    residual_us = max(0.0, step_us - attr_us)
    coverage = attr_us / step_us if step_us > 0 else 0.0
    return {"ops": ops, "step_time_us": step_us, "attributed_us": attr_us,
            "residual_us": residual_us, "coverage": coverage,
            "n_trace_files": n_parsed, "n_events": n_events,
            "warnings": warnings}


# -- cost join + classification ----------------------------------------


def _kernel_entries(costs_data: Optional[dict]) -> Dict[str, dict]:
    """costs.json -> {CUDA symbol: the port kernel's analytic entry}."""
    progs = (costs_data or {}).get("programs") or {}
    return {name: e for name, e in progs.items()
            if isinstance(e, dict) and e.get("source") == "analytic_kernel"}


def bound_class(flops: Optional[float], bytes_: Optional[float],
                device_kind: Optional[str] = None,
                dtype: Optional[str] = None,
                name: str = "") -> Dict[str, Any]:
    """The shared classifier primitive: compute- vs memory-bound from
    arithmetic intensity against the device ridge (generic ridge when
    the device peaks are unknown), degrading to a name heuristic when
    no analytic FLOPs/bytes exist."""
    peak_b = peak_membw(device_kind)
    peak_f = peak_flops(device_kind, dtype) if device_kind and dtype \
        else None
    if peak_f and peak_b:
        ridge, ridge_source = peak_f / peak_b, "device"
    else:
        ridge, ridge_source = DEFAULT_RIDGE, "generic"
    ai = (flops / bytes_) if flops is not None and bytes_ else None
    if ai is not None:
        bound = "compute" if ai >= ridge else "memory"
        class_source = "analytic"
    else:
        lname = name.lower()
        bound = "compute" if any(h in lname for h in
                                 _COMPUTE_NAME_HINTS) else "memory"
        class_source = "heuristic"
    return {"arithmetic_intensity": ai, "bound": bound,
            "class_source": class_source,
            "ridge_flops_per_byte": ridge, "ridge_source": ridge_source,
            "_peak_f": peak_f, "_peak_b": peak_b}


def classify(parsed: Dict[str, Any], device_kind: Optional[str],
             costs_data: Optional[dict]) -> Dict[str, Any]:
    """Join parsed op times against costs and classify each op against
    the roofline.  Pure data-in/data-out; returns the full report dict
    (sans persistence stamps), rows in the JAX schema."""
    kernels = _kernel_entries(costs_data)
    step_us = parsed["step_time_us"]
    rows: List[Dict[str, Any]] = []
    for (module, name), agg in parsed["ops"].items():
        flops = bytes_ = dtype = opcode = None
        entry = kernels.get(kernel_symbol(name)) if module == "gpu" \
            else None
        if entry is not None:
            flops = entry.get("flops")
            bytes_ = entry.get("bytes_accessed")
            dtype = entry.get("dtype")
            opcode = entry.get("kernel")
        elif agg.get("n_costed"):
            flops = agg["flops_total"] / agg["n_costed"]
            bytes_ = agg["bytes_total"] / agg["n_costed"]
            dtype = agg.get("dtype")
            opcode = agg.get("launched_by") if module == "gpu" else name
        cls = bound_class(flops, bytes_, device_kind, dtype, name)
        ai = cls["arithmetic_intensity"]
        peak_f, peak_b = cls.pop("_peak_f"), cls.pop("_peak_b")
        time_s = agg["time_us"] * 1e-6
        achieved = (flops * agg["count"] / time_s) \
            if flops and time_s > 0 else None
        ceiling = ceiling_source = None
        if ai is not None and peak_f and peak_b:
            ceiling = min(peak_f, ai * peak_b)
            ceiling_source = "device"
        rows.append({
            "name": name, "module": module, "opcode": opcode,
            "time_us": agg["time_us"],
            "time_share": agg["time_us"] / step_us if step_us else 0.0,
            "count": agg["count"], "flops": flops, "bytes": bytes_,
            "dtype": dtype, **cls,
            "achieved_flops_per_s": achieved,
            "roofline_ceiling_flops_per_s": ceiling,
            "ceiling_source": ceiling_source, "utilization": None,
        })
    # Device peaks unknown (CPU): the best observed FLOP rate in THIS
    # trace becomes the ceiling, so utilization still ranks ops by
    # headroom — labeled "empirical" to keep it honest.
    empirical = max((r["achieved_flops_per_s"] for r in rows
                     if r["achieved_flops_per_s"]), default=None)
    for r in rows:
        if r["achieved_flops_per_s"] is None:
            continue
        if r["roofline_ceiling_flops_per_s"] is None and empirical:
            r["roofline_ceiling_flops_per_s"] = empirical
            r["ceiling_source"] = "empirical"
        if r["roofline_ceiling_flops_per_s"]:
            r["utilization"] = (r["achieved_flops_per_s"]
                                / r["roofline_ceiling_flops_per_s"])
    rows.sort(key=lambda r: -r["time_us"])
    return {
        "schema": SCHEMA,
        "device_kind": device_kind,
        "step_time_us": step_us,
        "attributed_us": parsed["attributed_us"],
        "residual_us": parsed["residual_us"],
        "coverage": parsed["coverage"],
        "n_trace_files": parsed["n_trace_files"],
        "n_events": parsed["n_events"],
        "n_ops": len(rows),
        "warnings": parsed["warnings"],
        "ops": rows,
    }


def analyze(trace_dir: str, rsl_path: Optional[str] = None,
            costs_data: Optional[dict] = None,
            device_kind: Optional[str] = None) -> Dict[str, Any]:
    """Parse + join + classify one trace directory.

    ``costs_data`` defaults to ``RSL_PATH/costs.json`` when an rsl_path
    is given; ``device_kind`` defaults to what that file recorded at
    save time (the card the trace ran on, unlike the machine this
    analysis runs on).
    """
    parsed = parse_trace_dir(trace_dir)
    if costs_data is None and rsl_path:
        costs_data = costs.load(rsl_path)
    if device_kind is None and costs_data:
        device_kind = costs_data.get("device_kind")
    report = classify(parsed, device_kind, costs_data)
    report["trace_dir"] = trace_dir
    report["generated_at"] = time.time()
    if costs_data is None:
        report["warnings"] = report["warnings"] + [
            "no costs.json found: the port's kernels are classed by name "
            "heuristics"]
    return report


# -- persistence + rendering -------------------------------------------


def save_report(report: Dict[str, Any], rsl_path: str) -> str:
    """Atomic write to ``RSL_PATH/roofline.json``; returns the path."""
    os.makedirs(rsl_path, exist_ok=True)
    path = os.path.join(rsl_path, "roofline.json")
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(report, f, indent=2, sort_keys=True, default=float)
        f.write("\n")
    os.replace(tmp, path)
    return path


def emit_telemetry(report: Dict[str, Any], tel: Any, top: int = 3) -> None:
    """Record a ``roofline`` telemetry event summarizing the analysis —
    the hook the timeline merge reads for per-rank annotations."""
    tel.event(
        "roofline",
        coverage=round(report["coverage"], 4),
        step_time_us=round(report["step_time_us"], 1),
        residual_us=round(report["residual_us"], 1),
        n_ops=report["n_ops"],
        device_kind=report.get("device_kind"),
        top_ops=top_ops(report, top),
    )


def top_ops(report: Dict[str, Any], k: int = 3) -> List[Dict[str, Any]]:
    """Compact top-k rows (name/share/bound/utilization) for embedding
    in bench rows, telemetry events, and timeline annotations."""
    out = []
    for r in report["ops"][:k]:
        out.append({"name": r["name"],
                    "time_share": round(r["time_share"], 4),
                    "bound": r["bound"],
                    "utilization": (round(r["utilization"], 4)
                                    if r["utilization"] is not None
                                    else None)})
    return out


def _fmt_rate(v: Optional[float]) -> str:
    if not v:
        return "-"
    for exp, unit in ((12, "T"), (9, "G"), (6, "M"), (3, "K")):
        if v >= 10 ** exp:
            return f"{v / 10 ** exp:.1f}{unit}"
    return f"{v:.0f}"


def render_report(report: Dict[str, Any], top: int = 20) -> str:
    """Human-readable ranked table + the unattributed-residual line."""
    lines = ["== roofline attribution =="]
    dk = report.get("device_kind") or "unknown device"
    lines.append(
        f"trace: {report.get('trace_dir', '?')} "
        f"({report['n_trace_files']} file(s), {report['n_events']} events)")
    ridge = report["ops"][0]["ridge_flops_per_byte"] if report["ops"] \
        else DEFAULT_RIDGE
    src = report["ops"][0]["ridge_source"] if report["ops"] else "generic"
    lines.append(f"device: {dk}  ridge: {ridge:.1f} FLOPs/byte ({src})")
    anom = report.get("anomaly")
    if isinstance(anom, dict):
        trig = (anom.get("trigger") or {}).get("trigger", "?")
        lines.append(f"anomaly capture {anom.get('capture', '?')}: "
                     f"trigger {trig} at epoch {anom.get('epoch', '?')} "
                     f"step {anom.get('step', '?')}")
    lines.append(
        f"step time {report['step_time_us'] / 1e3:.2f} ms — "
        f"{report['coverage'] * 100:.1f}% attributed to "
        f"{report['n_ops']} named ops")
    header = (f"  {'op':<40} {'time':>9} {'share':>6} {'count':>6} "
              f"{'bound':>7} {'AI':>8} {'FLOP/s':>8} {'util':>6}")
    lines.append(header)
    for r in report["ops"][:top]:
        ai = f"{r['arithmetic_intensity']:.2f}" \
            if r["arithmetic_intensity"] is not None else "-"
        util = f"{r['utilization'] * 100:.1f}%" \
            if r["utilization"] is not None else "-"
        mark = "" if r["class_source"] == "analytic" else "?"
        name = r["name"] if len(r["name"]) <= 40 else r["name"][:37] + "..."
        lines.append(
            f"  {name:<40} {r['time_us'] / 1e3:>7.2f}ms "
            f"{r['time_share'] * 100:>5.1f}% {r['count']:>6} "
            f"{r['bound'] + mark:>7} {ai:>8} "
            f"{_fmt_rate(r['achieved_flops_per_s']):>8} {util:>6}")
    if len(report["ops"]) > top:
        rest = report["ops"][top:]
        rest_us = sum(r["time_us"] for r in rest)
        lines.append(f"  ... {len(rest)} more ops, "
                     f"{rest_us / 1e3:.2f} ms combined")
    lines.append(
        f"  unattributed residual: {report['residual_us'] / 1e3:.2f} ms "
        f"({(1 - report['coverage']) * 100:.1f}% of step time) — "
        f"runtime gaps between op executions")
    if any(r["class_source"] == "heuristic" for r in report["ops"]):
        lines.append("  (? = bound class from op-name heuristic; no "
                     "analytic FLOPs/bytes for that op)")
    for w in report["warnings"]:
        lines.append(f"  warning: {w}")
    return "\n".join(lines)


# -- anomaly-capture integration ---------------------------------------


def anomaly_capture_dirs(rsl_path: str) -> List[str]:
    """Anomaly capture directories (flightrec's ``capture-<n>``) that
    actually contain trace files, newest capture number last."""
    root = os.path.join(rsl_path, "anomaly_traces")
    out = []
    try:
        names = os.listdir(root)
    except OSError:
        return []
    def _num(n: str) -> int:
        try:
            return int(n.rsplit("-", 1)[1])
        except (IndexError, ValueError):
            return -1
    for name in sorted(names, key=_num):
        path = os.path.join(root, name)
        if name.startswith("capture-") and os.path.isdir(path) \
                and find_trace_files(path):
            out.append(path)
    return out


# -- CLI ---------------------------------------------------------------


def run_cli(rsl_path: str, trace_dir: Optional[str] = None,
            from_anomaly: bool = False, top: int = 20,
            as_json: bool = False, emit_events: bool = True) -> str:
    """The ``roofline`` subcommand: analyze, persist, report.

    Default trace source is ``RSL_PATH/trace`` (what ``--profile``
    writes); ``--from-anomaly`` analyzes the newest anomaly capture
    instead; an explicit ``--trace-dir`` wins over both.  Raises
    ValueError with an actionable message when there is nothing to
    analyze (CLI prints it and exits 1, repo convention).
    """
    if trace_dir is None:
        if from_anomaly:
            dirs = anomaly_capture_dirs(rsl_path)
            if not dirs:
                raise ValueError(
                    f"no anomaly captures with trace files under "
                    f"{os.path.join(rsl_path, 'anomaly_traces')!r}; "
                    f"run with --anomaly-capture first")
            trace_dir = dirs[-1]
        else:
            trace_dir = os.path.join(rsl_path, "trace")
    report = analyze(trace_dir, rsl_path=rsl_path)
    # Anomaly captures are self-describing (flightrec writes a
    # manifest.json with the trigger verdict beside the raw trace):
    # carry the why next to the op-level blame.
    try:
        with open(os.path.join(trace_dir, "manifest.json")) as f:
            report["anomaly"] = json.load(f)
    except (OSError, ValueError):
        pass
    path = save_report(report, rsl_path)
    if emit_events:
        from . import telemetry
        tel = telemetry.Telemetry(enabled=True, rsl_path=rsl_path, rank=0)
        try:
            emit_telemetry(report, tel)
        finally:
            tel.close()
    if as_json:
        return json.dumps(report, indent=2, sort_keys=True, default=float)
    return render_report(report, top=top) + f"\n(saved to {path})"
