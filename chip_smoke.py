#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It needs one CUDA card and the CUDA toolkit (``nvcc``); without a card,
or without the port's package beside it, it exits non-zero and prints no
result.  Phases, each printing its lines before the last:

  1. environment: the card's name and power limit (nvidia-smi), torch,
     CUDA, Triton and nvcc versions, and the time to build the kernels
     from ``distributedpytorch_tpu_torch/csrc``;
  2. kernel K1 (flash-attention forward) against its plain PyTorch version
     on the card, at the vit's shapes and at causal, wider-head and longer
     sequences: max abs error of O and lse against the stated tolerance,
     kernel / plain / SDPA (yardstick only) times — device time from
     torch.profiler, and call time from CUDA events under its own name —
     and the bound;
  3. the main path: a full-width vit (dim 128, depth 4, 4 heads, S = 49,
     random weights from a seed) saved as a port checkpoint and served by
     ``python -m distributedpytorch_tpu_torch serve --attention flash`` in
     a subprocess; a burst of HTTP requests large enough to fill bucket 64;
     every answer held against the in-process predict step at the bucket
     that served it (label, and confidence to 1e-4); the server's
     K1 launch count held against 4 x (batches + warm-up buckets); and the
     model's flash logits held against its full-attention logits;
  4. one ``{"kernels": [...]}`` JSON line, then the last line
     ``{"ok": true, "device": {...}}``.

Any failed check exits non-zero before the last line is printed.  Work
files go to ``build/chip_smoke/`` in the checkout.
"""

from __future__ import annotations

import json
import math
import os
import re
import shutil
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")
SEED = 1234
BUCKETS = (1, 4, 16, 64)
DEPTH = 4                       # vit blocks: one K1 launch each per forward
BURST_THREADS = 64              # concurrent clients: fills bucket 64
BURST_WAVES = 3                 # requests per client
HBM_BYTES_PER_S = 3.35e12       # H100 SXM, NVIDIA data sheet
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}  # dense, 700 W
TOL_O = {"bfloat16": 2e-2, "float32": 2e-5}   # bf16: one output rounding
TOL_LSE = 1e-4                                # f32 in both
# Served answers against the in-process predict step at the same bucket:
# the same program on the same card, so the only difference expected is
# the server's rounding of the confidence to 6 decimals (5e-7).
TOL_CONF = 1e-4
TOL_LOGITS = {"float32": 1e-4, "bfloat16": 5e-2}
KERNEL_SOURCE = "distributedpytorch_tpu_torch/csrc/flash_fwd.cu"
KERNEL_REPLACES = "distributedpytorch_tpu/ops/flash_attention.py:79"


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


# -- phase 1: environment ------------------------------------------------

def phase_environment():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    say(card)
    say(f"env: python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, device {torch.cuda.get_device_name(0)}, "
        f"count {torch.cuda.device_count()}")
    try:
        import triton

        say(f"env: triton {triton.__version__}")
    except ImportError:
        say("env: triton not installed")
    from distributedpytorch_tpu_torch.ops import build

    try:
        nvcc = build.nvcc_path()
    except RuntimeError as e:
        fail(str(e))
    ver = subprocess.run([nvcc, "--version"], capture_output=True, text=True)
    say("env: nvcc " + (ver.stdout.strip().splitlines() or ["?"])[-1])
    t0 = time.perf_counter()
    lib, compile_s = build.build("flash_fwd")
    say(f"build: flash_fwd in {time.perf_counter() - t0:.1f}s "
        f"(nvcc {compile_s:.1f}s) -> {os.path.relpath(lib, ROOT)}")
    with open(lib + ".log") as f:
        for line in f:
            if "registers" in line or "spill" in line:
                say("build: " + line.strip())
    return card


# -- phase 2: K1 against its plain version --------------------------------

def time_ms(fn, reps: int = 50) -> float:
    """Mean ms per call over ``reps`` back-to-back calls, CUDA events,
    after warm-up.  Inputs stay in L2 between calls, as in the vit, where
    the qkv projection has just written them."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int = 50, tries: int = 3):
    """Mean device time per call: the summed duration of the CUDA work
    ``fn`` launches, from torch.profiler over ``reps`` calls after
    warm-up.  A trace with no device events is taken again, up to
    ``tries`` times in all; None if every trace came back empty."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA)
        if total > 0:
            return total / 1e3 / reps
    return None


def fmt_ms(x) -> str:
    return "not measured" if x is None else f"{x:.5f}"


def bound_ms(b: int, s: int, h: int, d: int, dtype_name: str,
             causal: bool):
    """Least time for the work: each input read once and each output
    written once over HBM, or the two products' operations at the card's
    peak for the input type, whichever is larger."""
    item = 2 if dtype_name == "bfloat16" else 4
    nbytes = 4 * b * s * h * d * item + b * h * s * 4     # q, k, v, o, lse
    pairs = s * (s + 1) / 2 if causal else s * s
    ops = 4 * b * h * pairs * d                           # QK^T and PV
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernel():
    import torch
    import torch.nn.functional as F

    from distributedpytorch_tpu_torch.ops.flash_attention import (
        flash_attention_fwd, flash_attention_plain)

    cases = [(1, 49, 4, 32, dt, False) for dt in ("bfloat16", "float32")]
    cases += [(b, 49, 4, 32, "bfloat16", False) for b in (4, 16)]
    cases += [(64, 49, 4, 32, dt, False) for dt in ("bfloat16", "float32")]
    cases += [(64, 49, 4, 32, "bfloat16", True)]
    for s, d in ((128, 64), (128, 128), (1000, 64), (1000, 128)):
        for dt in ("bfloat16", "float32"):
            for causal in (False, True):
                cases.append((8 if s == 128 else 2, s, 4, d, dt, causal))
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = {}
    for (b, s, h, d, dt, causal) in cases:
        dtype = getattr(torch, dt)
        # q, k, v as views into one (B, S, 3*H*D) projection, as in the vit
        qkv = torch.randn((b, s, 3 * h * d), generator=gen,
                          device="cuda").to(dtype)
        q, k, v = (t.reshape(b, s, h, d) for t in qkv.split(h * d, dim=-1))
        before = flash_attention_fwd.launches
        o, lse = flash_attention_fwd(q, k, v, causal)
        torch.cuda.synchronize()
        if flash_attention_fwd.launches != before + 1:
            fail(f"K1 wrapper did not count its launch at {(b, s, h, d)}")
        po, plse = flash_attention_plain(q, k, v, causal)
        err_o = (o.float() - po.float()).abs().max().item()
        err_lse = (lse - plse).abs().max().item()
        if not (math.isfinite(err_o) and err_o <= TOL_O[dt]
                and err_lse <= TOL_LSE):
            fail(f"K1 disagrees with its plain version at {(b, s, h, d)} "
                 f"{dt} causal={causal}: err_o {err_o} (tol {TOL_O[dt]}), "
                 f"err_lse {err_lse} (tol {TOL_LSE})")
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        reps = 50 if s < 1000 else 20
        fns = {"kernel": lambda: flash_attention_fwd(q, k, v, causal),
               "plain": lambda: flash_attention_plain(q, k, v, causal),
               "sdpa": lambda: F.scaled_dot_product_attention(
                   qt, kt, vt, is_causal=causal)}
        call = {n: time_ms(f, reps) for n, f in fns.items()}
        dev = {n: device_ms(f, reps) for n, f in fns.items()}
        b_ms, b_by = bound_ms(b, s, h, d, dt, causal)
        say(f"K1 {(b, s, h, d)} {dt} causal={causal}: err_o={err_o:.3g} "
            f"(tol {TOL_O[dt]:g}) err_lse={err_lse:.3g} (tol {TOL_LSE:g}) "
            f"device_ms kernel={fmt_ms(dev['kernel'])} "
            f"plain={fmt_ms(dev['plain'])} sdpa={fmt_ms(dev['sdpa'])}; "
            f"call_ms kernel={call['kernel']:.5f} "
            f"plain={call['plain']:.5f} sdpa={call['sdpa']:.5f}; "
            f"bound_us={b_ms * 1e3:.3f} ({b_by}) "
            f"launches={flash_attention_fwd.launches}")
        rows[(b, s, h, d, dt, causal)] = dict(
            max_abs_err=err_o, ms=dev["kernel"], plain_ms=dev["plain"],
            library_ms=dev["sdpa"], bound_ms=b_ms, bound_by=b_by,
            call_ms=call["kernel"], plain_call_ms=call["plain"],
            library_call_ms=call["sdpa"])
    return rows


# -- phase 3: the main path ----------------------------------------------

def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def build_checkpoint(path: str) -> None:
    """The registry's full-width vit with random weights from SEED, saved
    in the port's checkpoint format."""
    import torch

    from distributedpytorch_tpu_torch import checkpoint as ckpt
    from distributedpytorch_tpu_torch.models import get_model
    from distributedpytorch_tpu_torch.precision import PRESETS

    model = get_model("vit", 10, PRESETS["bf16"], attention="flash",
                      device="cpu")
    model.init_weights(torch.Generator().manual_seed(SEED))
    ckpt.save_checkpoint(path, "vit", model, epoch=0, best_valid_loss=0.0)


def post(port: int, body: bytes, timeout: float = 60.0):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/predict",
                                 data=body)
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read()), time.perf_counter() - t0
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), time.perf_counter() - t0


def burst(port: int, images) -> list:
    """BURST_THREADS clients, each sending BURST_WAVES requests; every
    wave starts on a barrier so a full bucket of 64 queues at once.
    Returns (row, status, body, client_s) per request."""
    bodies = [json.dumps({"image": img.tolist()}).encode() for img in images]
    barrier = threading.Barrier(BURST_THREADS)
    out = [None] * len(bodies)

    def client(t):
        for w in range(BURST_WAVES):
            i = w * BURST_THREADS + t
            barrier.wait(timeout=120)
            try:
                out[i] = (i,) + post(port, bodies[i])
            except OSError as e:  # reported with the failed answers below
                out[i] = (i, None, {"error": repr(e)}, 0.0)

    threads = [threading.Thread(target=client, args=(t,))
               for t in range(BURST_THREADS)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    if any(th.is_alive() for th in threads) or any(o is None for o in out):
        fail("the HTTP burst did not complete")
    return out


def reference_predictions(ckpt_path: str, images, served_bucket,
                          device: str):
    """The in-process predict step on the same rows, each row in a batch
    of the bucket the server answered it from (zero-padded, as the server
    pads), plus each row's softmax (to tell a tie from a wrong label)."""
    import numpy as np
    import torch

    from distributedpytorch_tpu_torch import checkpoint as ckpt
    from distributedpytorch_tpu_torch.data import augment
    from distributedpytorch_tpu_torch.data.datasets import load_dataset
    from distributedpytorch_tpu_torch.models import get_model
    from distributedpytorch_tpu_torch.precision import PRESETS
    from distributedpytorch_tpu_torch.train.engine import Predictor

    ds = load_dataset("mnist", os.path.join(WORK, "data"), SEED,
                      synthetic_fallback=True)
    policy = PRESETS["bf16"]
    model = get_model("vit", ds.nb_classes, policy, attention="flash",
                      device=device)
    ckpt.restore_for_serving(ckpt_path, model)
    pred = Predictor(model, ds.mean, ds.std, 28, policy, device)
    n = len(images)
    labels = np.zeros(n, np.int64)
    confs = np.zeros(n, np.float64)
    probs = np.zeros((n, ds.nb_classes), np.float64)
    for bucket in sorted(set(served_bucket.tolist())):
        rows = np.flatnonzero(served_bucket == bucket)
        for i in range(0, len(rows), bucket):
            idx = rows[i:i + bucket]
            padded = np.zeros((bucket,) + images.shape[1:], images.dtype)
            padded[:len(idx)] = images[idx]
            lab, conf = pred.predict_step(padded)
            labels[idx] = lab[:len(idx)].cpu().numpy()
            confs[idx] = conf[:len(idx)].float().cpu().numpy()
            with torch.inference_mode():
                x = augment.eval_transform(
                    torch.from_numpy(padded).to(device), ds.mean, ds.std,
                    28, out_dtype=policy.compute_dtype)
                probs[idx] = torch.softmax(model(x).float(), dim=-1)[
                    :len(idx)].cpu().numpy()
    return labels, confs, probs


def check_logits(ckpt_path: str, images, device: str) -> None:
    """The served model with the flash kernel against the same model with
    full attention (plain PyTorch), f32 (TF32 off) and bf16."""
    import torch

    from distributedpytorch_tpu_torch import checkpoint as ckpt
    from distributedpytorch_tpu_torch.data import augment
    from distributedpytorch_tpu_torch.models import get_model
    from distributedpytorch_tpu_torch.precision import PRESETS

    x_u8 = torch.from_numpy(images[:8]).to(device)
    for name in ("float32", "bfloat16"):
        policy = PRESETS["f32" if name == "float32" else "bf16"]
        logits = {}
        for att in ("flash", "full"):
            model = get_model("vit", 10, policy, attention=att,
                              device=device)
            ckpt.restore_for_serving(ckpt_path, model)
            with torch.inference_mode():
                x = augment.eval_transform(x_u8, 0.5, 0.25, 28,
                                           out_dtype=policy.compute_dtype)
                logits[att] = model(x)
        err = (logits["flash"] - logits["full"]).abs().max().item()
        ok = (bool(torch.isfinite(logits["flash"]).all())
              and tuple(logits["flash"].shape) == (8, 10)
              and err <= TOL_LOGITS[name])
        say(f"main: vit logits flash vs full attention, {name}: max abs "
            f"err {err:.3g} (tol {TOL_LOGITS[name]:g})")
        if not ok:
            fail(f"vit logits with K1 disagree with full attention in "
                 f"{name}: {err}")


def phase_main_path(device: str = "cuda"):
    import numpy as np

    from distributedpytorch_tpu_torch.data.datasets import load_dataset

    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    ckpt_path = os.path.join(WORK, "rsl", "bestmodel-mnist-vit.ckpt")
    build_checkpoint(ckpt_path)
    n = BURST_THREADS * BURST_WAVES
    port = free_port()
    cmd = [sys.executable, "-m", "distributedpytorch_tpu_torch", "serve",
           "-d", os.path.join(WORK, "data"),
           "--rsl_path", os.path.join(WORK, "rsl"), "-f", ckpt_path,
           "--attention", "flash", "--synthetic-fallback",
           "--serve-buckets", ",".join(str(b) for b in BUCKETS),
           "--serve-max-requests", str(n), "--serve-port", str(port),
           "--serve-max-latency-ms", "100", "--device", device]
    say("main: " + " ".join(os.path.relpath(c, ROOT) if c.startswith(ROOT)
                            else c for c in cmd[1:]))
    # The server is a fresh process: its K1 count starts at 0 right before
    # the main path and is read from its log right after.
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    lines = []
    listening = threading.Event()

    def reader():
        for line in proc.stdout:
            lines.append(line.rstrip())
            if "serve: listening on" in line:
                listening.set()

    rd = threading.Thread(target=reader, daemon=True)
    rd.start()
    try:
        t0 = time.perf_counter()
        while not listening.wait(0.5):
            if proc.poll() is not None or time.perf_counter() - t0 > 600:
                fail("the server did not start:\n" + "\n".join(lines[-40:]))
        say(f"main: server listening after {time.perf_counter() - t0:.1f}s")
        ds = load_dataset("mnist", os.path.join(WORK, "data"), SEED,
                          synthetic_fallback=True)
        images = ds.splits["test"].images[:n]
        t_burst = time.perf_counter()
        answers = burst(port, images)
        burst_s = time.perf_counter() - t_burst
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    rd.join(timeout=10)
    if rc != 0:
        fail(f"the server exited with {rc}:\n" + "\n".join(lines[-40:]))
    for line in lines:
        if line.startswith("serve:"):
            say("server| " + line)

    bad = [a for a in answers if a[1] != 200]
    if bad:
        fail(f"{len(bad)} of {n} requests failed, e.g. {bad[0][1:3]}")
    buckets_seen = sorted({a[2]["bucket"] for a in answers})
    if max(BUCKETS) not in buckets_seen:
        fail(f"the burst never filled bucket {max(BUCKETS)} "
             f"(buckets used: {buckets_seen})")
    server_ms = np.array([a[2]["latency_ms"] for a in answers])
    client_ms = np.array([a[3] * 1e3 for a in answers])
    say(f"main: {n} answers in {burst_s:.3f}s, buckets used {buckets_seen}; "
        f"server latency p50 {np.percentile(server_ms, 50):.3f} ms "
        f"p99 {np.percentile(server_ms, 99):.3f} ms; client latency p50 "
        f"{np.percentile(client_ms, 50):.3f} ms p99 "
        f"{np.percentile(client_ms, 99):.3f} ms")

    got_labels = np.array([a[2]["label"] for a in answers])
    got_confs = np.array([a[2]["confidence"] for a in answers])
    served_bucket = np.array([a[2]["bucket"] for a in answers])
    labels, confs, probs = reference_predictions(ckpt_path, images,
                                                 served_bucket, device)
    top2 = np.sort(probs, axis=-1)[:, -2:]
    tie = (top2[:, 1] - top2[:, 0]) <= TOL_CONF
    mismatch = (got_labels != labels) & ~tie
    conf_err = float(np.abs(got_confs - confs).max())
    # The check's power: how many rows it would fail if every answer were
    # handed to the next request (a batcher mix-up).
    shifted = ((np.roll(labels, -1) != labels) & ~tie) \
        | (np.abs(np.roll(confs, -1) - confs) > TOL_CONF)
    say(f"main: answers vs in-process predict step at the served bucket: "
        f"{int((got_labels == labels).sum())}/{n} labels equal "
        f"({int(tie.sum())} rows within {TOL_CONF:g} of a tie), max conf "
        f"err {conf_err:.3g} (tol {TOL_CONF:g}); "
        f"{len(set(labels.tolist()))} distinct labels, confidences "
        f"{confs.min():.6f}..{confs.max():.6f}; a one-row shift of the "
        f"answers would fail {int(shifted.sum())}/{n} rows")
    if mismatch.any() or conf_err > TOL_CONF:
        fail("served answers disagree with the in-process predict step")
    if shifted.sum() < n // 2:
        fail("the answer check could not tell one row's answer from "
             "another's: the reference answers are too alike")
    check_logits(ckpt_path, images, device)

    served = stopped = None
    for line in lines:
        m = re.search(r"flash_fwd launches (\d+) \((\d+) in warm-up\)", line)
        if m:
            served = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"answering (\d+) requests in (\d+) batches", line)
        if m:
            stopped = (int(m.group(1)), int(m.group(2)))
    if served is None or stopped is None:
        fail("the server did not report its K1 launches and batches")
    launches, warm = served
    answered, batches = stopped
    want = DEPTH * (batches + len(BUCKETS))
    say(f"main: K1 launches {launches} = {DEPTH} x ({batches} batches + "
        f"{len(BUCKETS)} warm-up forwards) -> expected {want}")
    if answered != n or launches <= 0 or launches != want \
            or warm != DEPTH * len(BUCKETS):
        fail(f"K1 launch count {launches} (warm-up {warm}) does not match "
             f"the {batches} batches served")
    return launches


def phase_profile(ckpt_path: str, device: str = "cuda") -> None:
    """Where the time goes in the served model's forward: wall time per
    predict step (host clock, synchronized, profiler off) at buckets 1
    and 64, then, from a second run under torch.profiler, the device time
    by kernel, K1's share of it, and the device's idle share of the
    unprofiled wall time.  Prints only; the checks are done above."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from distributedpytorch_tpu_torch import checkpoint as ckpt
    from distributedpytorch_tpu_torch.models import get_model
    from distributedpytorch_tpu_torch.precision import PRESETS
    from distributedpytorch_tpu_torch.train.engine import Predictor

    policy = PRESETS["bf16"]
    reps = 20
    for att in ("flash", "full"):
        model = get_model("vit", 10, policy, attention=att, device=device)
        ckpt.restore_for_serving(ckpt_path, model)
        pred = Predictor(model, 0.5, 0.25, 28, policy, device)
        for bucket in (1, 64):
            x = np.zeros((bucket, 28, 28), np.uint8)
            for _ in range(5):
                pred.predict_step(x)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                pred.predict_step(x)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / reps
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    pred.predict_step(x)
                torch.cuda.synchronize()
            kernels = [e for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA]
            dev_ms = sum(e.self_device_time_total for e in kernels) \
                / 1e3 / reps
            n_kern = sum(e.count for e in kernels) / reps
            k1_ms = sum(e.self_device_time_total for e in kernels
                        if "flash_fwd_kernel" in e.key) / 1e3 / reps
            if dev_ms <= 0:
                say(f"profile: {att} bucket {bucket}: wall {wall_ms:.3f} "
                    f"ms/forward; device time not measured (no device "
                    f"events from torch.profiler)")
                continue
            top = sorted(kernels, key=lambda e: -e.self_device_time_total)
            say(f"profile: {att} bucket {bucket}: wall {wall_ms:.3f} "
                f"ms/forward, device {dev_ms:.3f} ms in {n_kern:.0f} "
                f"kernels (idle {100 * (1 - dev_ms / wall_ms):.1f}%), K1 "
                f"{k1_ms * 1e3:.2f} us/forward "
                f"({100 * k1_ms / dev_ms:.1f}% of device time)")
            say("profile:   top: " + "; ".join(
                f"{e.key[:48]} {e.self_device_time_total / reps:.1f}us"
                f"x{e.count // reps}" for e in top[:5]))


def main() -> int:
    try:
        import torch
    except ImportError as e:
        fail(f"torch is not importable: {e}")
    if not torch.cuda.is_available():
        fail("no CUDA device: torch.cuda.is_available() is false")
    sys.path.insert(0, ROOT)
    try:
        import distributedpytorch_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"the port's package is not beside chip_smoke.py: {e}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    phase_environment()
    rows = phase_kernel()
    main_row = rows[(64, 49, 4, 32, "bfloat16", False)]
    missing = [k for k in ("ms", "plain_ms", "library_ms")
               if main_row[k] is None]
    if missing:
        fail(f"torch.profiler returned no device events for {missing} at "
             f"the main path's K1 shape (64, 49, 4, 32) bf16")
    launches = phase_main_path("cuda")
    phase_profile(os.path.join(WORK, "rsl", "bestmodel-mnist-vit.ckpt"))
    kernels = [{"name": "flash_fwd", "route": "cuda",
                "source": KERNEL_SOURCE, "replaces": KERNEL_REPLACES,
                "launches": launches, **main_row}]
    say(f"chip_smoke: all phases passed in {time.perf_counter() - t0:.1f}s")
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
