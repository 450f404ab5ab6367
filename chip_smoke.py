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
  4. kernels K2 and K3 (flash-attention backward: dq, and dk/dv) against
     their plain PyTorch version on the card, at the vit's training shapes
     and at causal, wider-head and longer sequences: max error of dq, dk
     and dv relative to the plain version's largest value, against the
     stated tolerance, with device / call / plain / SDPA-backward
     (yardstick only) times and the bound;
  5. one full-width f32 train step (TF32 off) on the card against the
     same step on the CPU: same weights, batch and affine draws through
     ``Engine.train_step_affine``; every parameter's gradient compared,
     relative to its largest value; the step's K1/K2/K3 launches must be
     exactly 4 each;
  6. the main path of the training slice: ``python -m
     distributedpytorch_tpu_torch train --model vit --attention flash
     --dataset mnist --synthetic-fallback -e 1`` in a subprocess (844
     steps of 64, then validation); validation accuracy at least twice
     chance, the mean train loss of the last 10% of steps below that of
     the first 10%, and the logged K1/K2/K3 launches equal to 4 per train
     step (K2, K3) and 4 per train step plus 4 per eval batch (K1);
  7. resume: ``train --debug -e 2`` uninterrupted, and again resumed from
     its epoch-1 rolling file; the final params and optimizer state must
     be bit-identical;
  8. ``test -f`` on the best model of phase 6 in a subprocess; its
     accuracy must equal an in-process eval of the same checkpoint;
  9. a profile of the train step at batch 64, bf16: wall and device ms
     per step, kernels per step, the device's idle share, K1/K2/K3 time;
 10. one ``{"kernels": [...]}`` JSON line, then the last line
     ``{"ok": true, "device": {...}}``.

Any failed check exits non-zero before the last line is printed.  Work
files go to ``build/chip_smoke/`` in the checkout.
"""

from __future__ import annotations

import itertools
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
from concurrent.futures import ThreadPoolExecutor

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
SOURCES = ("flash_fwd", "flash_bwd")      # csrc/<name>.cu, built together
CSRC = "distributedpytorch_tpu_torch/csrc"
TPU_KERNELS = "distributedpytorch_tpu/ops/flash_attention.py"
KERNELS = (  # name, source, the TPU kernel it replaces
    ("flash_fwd", f"{CSRC}/flash_fwd.cu", f"{TPU_KERNELS}:79"),
    ("flash_dq", f"{CSRC}/flash_bwd.cu", f"{TPU_KERNELS}:189"),
    ("flash_dkv", f"{CSRC}/flash_bwd.cu", f"{TPU_KERNELS}:236"),
)
# K2/K3 against their plain version: max error relative to the plain
# version's largest value.  f32: the same f32 math in another summation
# order.  bf16: one rounding of the output.
TOL_GRAD = {"bfloat16": 2e-2, "float32": 1e-5}
# One full-width f32 train step on the card against the CPU, each
# parameter's gradient relative to its largest value: f32 sums in other
# orders through four blocks (cuBLAS and cuDNN against the CPU's kernels,
# TF32 off), measured at 1e-6..1e-5.
TOL_STEP_GRAD = 1e-4
TRAIN_BATCH = 64


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
    # one nvcc per source, all started together
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        built = list(pool.map(build.build, SOURCES))
    say(f"build: {', '.join(SOURCES)} in {time.perf_counter() - t0:.1f}s")
    for name, (lib, compile_s) in zip(SOURCES, built):
        say(f"build: {name} nvcc {compile_s:.1f}s -> "
            f"{os.path.relpath(lib, ROOT)}")
        with open(lib + ".log") as f:
            for line in f:
                if "registers" in line or "spill" in line:
                    say(f"build: {name}: " + line.strip())
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
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total = sum(e.self_device_time_total for e in device_kernels(prof))
        if total > 0:
            return total / 1e3 / reps
    return None


def fmt_ms(x) -> str:
    return "not measured" if x is None else f"{x:.5f}"


def device_kernels(prof) -> list:
    """The profiler's device-side averages, kernels and copies only: a
    user annotation's GPU range (``Optimizer.step#Adam.step``) spans
    kernels already counted and is left out."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


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
            kernels = device_kernels(prof)
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


# -- phase 4: K2 and K3 against their plain version -----------------------

def bwd_bound_ms(b: int, s: int, h: int, d: int, dtype_name: str,
                 causal: bool, kernel: str):
    """Least time for K2 ("dq") or K3 ("dkv"): each input read once and
    each output written once (K2 reads q, k, v, dO, lse, delta and writes
    dq; K3 also writes dv), or its products' operations (K2: 3, K3: 4) at
    the card's peak for the input type, whichever is larger."""
    item = 2 if dtype_name == "bfloat16" else 4
    tensor = b * s * h * d * item
    rows = b * h * s * 4
    pairs = s * (s + 1) / 2 if causal else s * s
    outputs, products = (1, 3) if kernel == "dq" else (2, 4)
    nbytes = (4 + outputs) * tensor + 2 * rows
    ops = products * 2 * b * h * pairs * d
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rel_err(got, ref) -> tuple:
    """(max abs error, max abs error / max abs of the reference)."""
    err = (got.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    return err, err / max(scale, 1e-30)


def phase_bwd_kernels():
    import torch
    import torch.nn.functional as F

    from distributedpytorch_tpu_torch.ops import flash_attention as tfa

    cases = [(b, 49, 4, 32, dt, False) for b in (1, 16, 64)
             for dt in ("bfloat16", "float32")]
    cases += [(64, 49, 4, 32, "bfloat16", True)]
    for s, d in ((128, 64), (128, 128), (1000, 64), (1000, 128)):
        for dt in ("bfloat16", "float32"):
            for causal in (False, True):
                cases.append((8 if s == 128 else 2, s, 4, d, dt, causal))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    rows = {}
    for (b, s, h, d, dt, causal) in cases:
        dtype = getattr(torch, dt)
        qkv = torch.randn((b, s, 3 * h * d), generator=gen,
                          device="cuda").to(dtype)
        q, k, v = (t.reshape(b, s, h, d) for t in qkv.split(h * d, dim=-1))
        do = torch.randn((b, s, h, d), generator=gen, device="cuda").to(dtype)
        o, lse = tfa.flash_attention_fwd(q, k, v, causal)
        delta = tfa.attention_delta(o, do)
        n_dq, n_dkv = (tfa.flash_attention_dq.launches,
                       tfa.flash_attention_dkv.launches)
        dq = tfa.flash_attention_dq(q, k, v, do, lse, delta, causal)
        dk, dv = tfa.flash_attention_dkv(q, k, v, do, lse, delta, causal)
        torch.cuda.synchronize()
        if (tfa.flash_attention_dq.launches != n_dq + 1
                or tfa.flash_attention_dkv.launches != n_dkv + 1):
            fail(f"K2/K3 wrappers did not count their launches at "
                 f"{(b, s, h, d)}")
        pdq, pdk, pdv = tfa.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                                      causal)
        errs = {"dq": rel_err(dq, pdq), "dk": rel_err(dk, pdk),
                "dv": rel_err(dv, pdv)}
        tol = TOL_GRAD[dt]
        if not all(math.isfinite(e[1]) and e[1] <= tol
                   for e in errs.values()):
            fail(f"K2/K3 disagree with their plain version at "
                 f"{(b, s, h, d)} {dt} causal={causal}: "
                 f"{ {n: e[1] for n, e in errs.items()} } (tol {tol})")
        # SDPA's backward (yardstick only): dq, dk and dv in one call
        qt, kt, vt = (t.detach().transpose(1, 2).contiguous()
                      .requires_grad_() for t in (q, k, v))
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
        dot = do.transpose(1, 2).contiguous()
        reps = 50 if s < 1000 else 20
        fns = {"dq": lambda: tfa.flash_attention_dq(q, k, v, do, lse, delta,
                                                    causal),
               "dkv": lambda: tfa.flash_attention_dkv(q, k, v, do, lse,
                                                      delta, causal),
               "plain": lambda: tfa.flash_attention_bwd_plain(
                   q, k, v, o, lse, do, causal),
               "sdpa": lambda: torch.autograd.grad(
                   out, (qt, kt, vt), dot, retain_graph=True)}
        call = {n: time_ms(f, reps) for n, f in fns.items()}
        dev = {n: device_ms(f, reps) for n, f in fns.items()}
        bounds = {n: bwd_bound_ms(b, s, h, d, dt, causal, n)
                  for n in ("dq", "dkv")}
        say(f"K2/K3 {(b, s, h, d)} {dt} causal={causal}: rel err "
            f"dq={errs['dq'][1]:.3g} dk={errs['dk'][1]:.3g} "
            f"dv={errs['dv'][1]:.3g} (tol {tol:g}); device_ms "
            f"K2={fmt_ms(dev['dq'])} K3={fmt_ms(dev['dkv'])} "
            f"plain={fmt_ms(dev['plain'])} sdpa_bwd={fmt_ms(dev['sdpa'])}; "
            f"call_ms K2={call['dq']:.5f} K3={call['dkv']:.5f} "
            f"plain={call['plain']:.5f} sdpa_bwd={call['sdpa']:.5f}; "
            f"bound_us K2={bounds['dq'][0] * 1e3:.3f} ({bounds['dq'][1]}) "
            f"K3={bounds['dkv'][0] * 1e3:.3f} ({bounds['dkv'][1]}); "
            f"launches K2={tfa.flash_attention_dq.launches} "
            f"K3={tfa.flash_attention_dkv.launches}")
        for name, key, err in (("flash_dq", "dq", errs["dq"]),
                               ("flash_dkv", "dkv",
                                max(errs["dk"], errs["dv"],
                                    key=lambda e: e[1]))):
            rows[(name, b, s, h, d, dt, causal)] = dict(
                max_abs_err=err[0], rel_err=err[1], ms=dev[key],
                plain_ms=dev["plain"], library_ms=dev["sdpa"],
                bound_ms=bounds[key][0], bound_by=bounds[key][1],
                call_ms=call[key], plain_call_ms=call["plain"],
                library_call_ms=call["sdpa"])
    return rows


# -- phase 5: one train step on the card against the CPU -------------------

def phase_train_step_parity() -> None:
    import numpy as np
    import torch

    from distributedpytorch_tpu_torch.cli import kernel_launches
    from distributedpytorch_tpu_torch.data import augment
    from distributedpytorch_tpu_torch.data.datasets import load_dataset
    from distributedpytorch_tpu_torch.models import get_model
    from distributedpytorch_tpu_torch.ops.losses import cross_entropy
    from distributedpytorch_tpu_torch.precision import PRESETS
    from distributedpytorch_tpu_torch.train.engine import Engine

    policy = PRESETS["f32"]
    ds = load_dataset("mnist", os.path.join(WORK, "data"), SEED,
                      synthetic_fallback=True)
    images = ds.splits["train"].images[:TRAIN_BATCH]
    labels = ds.splits["train"].labels[:TRAIN_BATCH].astype(np.int64)
    u = np.random.default_rng(SEED).random((TRAIN_BATCH, 5),
                                           dtype=np.float32)
    grads, losses = {}, {}
    for device in ("cuda", "cpu"):
        model = get_model("vit", ds.nb_classes, policy, attention="flash",
                          device=device)
        engine = Engine(model, cross_entropy, ds.mean, ds.std, 28, policy,
                        device)
        state = engine.init_state(torch.Generator().manual_seed(SEED))
        affine = augment.affine_from_uniform(
            torch.from_numpy(u).to(device), 28, 28)
        before = kernel_launches()
        _, m = engine.train_step_affine(
            state, torch.from_numpy(images).to(device),
            torch.from_numpy(labels).to(device),
            torch.ones(TRAIN_BATCH, dtype=torch.bool, device=device), affine)
        if device == "cuda":
            torch.cuda.synchronize()
            got = {k: v - before[k] for k, v in kernel_launches().items()}
            say(f"step: one f32 train step on the card launched {got}")
            if got != {"flash_fwd": DEPTH, "flash_dq": DEPTH,
                       "flash_dkv": DEPTH}:
                fail(f"a train step must launch {DEPTH} K1, {DEPTH} K2 and "
                     f"{DEPTH} K3 exactly, got {got}")
        losses[device] = m["loss"].item()
        grads[device] = {n: p.grad.detach().cpu()
                         for n, p in model.named_parameters()}
    worst = max(((n, rel_err(grads["cuda"][n], g)) for n, g in
                 grads["cpu"].items()), key=lambda t: t[1][1])
    say(f"step: full-width f32 train step, card vs CPU: loss "
        f"{losses['cuda']:.7f} vs {losses['cpu']:.7f}; worst gradient "
        f"{worst[0]}: rel err {worst[1][1]:.3g} (abs {worst[1][0]:.3g}; "
        f"tol {TOL_STEP_GRAD:g}) over {len(grads['cpu'])} parameters")
    if not (math.isfinite(worst[1][1]) and worst[1][1] <= TOL_STEP_GRAD):
        fail(f"the train step's gradients on the card disagree with the "
             f"CPU's: {worst[0]} rel err {worst[1][1]}")


# -- phase 6: the training slice's main path -------------------------------

def run_cli(args, rsl: str, timeout: float = 900.0):
    """``python -m distributedpytorch_tpu_torch ARGS`` in a subprocess
    (a fresh process: its kernel counters start at 0); returns (wall s,
    the text of RSL/test.log)."""
    cmd = [sys.executable, "-m", "distributedpytorch_tpu_torch", *args,
           "-d", os.path.join(WORK, "data"), "--rsl_path", rsl,
           "--dataset", "mnist", "--synthetic-fallback", "--device", "cuda"]
    say("run: " + " ".join(os.path.relpath(c, ROOT) if c.startswith(ROOT)
                           else c for c in cmd[1:]))
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=timeout)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"{args[0]} exited with {proc.returncode}:\n"
             + (proc.stdout + proc.stderr)[-4000:])
    with open(os.path.join(rsl, "test.log")) as f:
        return wall, f.read()


def parse_launches(log: str, action: str):
    m = re.search(rf"{action}: kernel launches flash_fwd (\d+), flash_dq "
                  rf"(\d+), flash_dkv (\d+) over (?:(\d+) train steps and )?"
                  rf"(\d+) eval batches", log)
    if m is None:
        fail(f"{action} did not log its kernel launches")
    fwd, dq, dkv, steps, evals = (int(x) if x is not None else 0
                                  for x in m.groups())
    return {"flash_fwd": fwd, "flash_dq": dq, "flash_dkv": dkv}, steps, evals


def phase_train():
    rsl = os.path.join(WORK, "train_rsl")
    wall, log = run_cli(["train", "--model", "vit", "--attention", "flash",
                         "-e", "1"], rsl)
    launches, steps, evals = parse_launches(log, "train")
    want_steps = math.ceil(54000 / TRAIN_BATCH)
    want_evals = math.ceil(6000 / TRAIN_BATCH)
    want = {"flash_fwd": DEPTH * (steps + evals), "flash_dq": DEPTH * steps,
            "flash_dkv": DEPTH * steps}
    say(f"train: launches {launches} over {steps} steps and {evals} eval "
        f"batches; formula {want}")
    if (steps, evals) != (want_steps, want_evals) or launches != want:
        fail(f"train launches {launches} over {steps} steps / {evals} "
             f"eval batches do not match the formula {want} at "
             f"{want_steps} steps / {want_evals} eval batches")
    valid_acc = float(re.search(r"Validation  \| Loss: [\d.]+ +\| Acc: "
                                r"([\d.]+)%", log).group(1))
    train_loss = float(re.search(r"Train       \| Loss: ([\d.]+)",
                                 log).group(1))
    sps = float(re.search(r"Throughput  \| ([\d,]+) samples/s/chip",
                          log).group(1).replace(",", ""))
    progress = [(int(a), float(b)) for a, b in re.findall(
        r"epoch:000 nb batches:(\d+) mean train loss:([\d.]+)", log)]
    (k_first, m_first) = progress[0]
    (k_last, m_last) = [p for p in progress if p[0] < steps][-1]
    # the lines are running means: the last 10% is what follows the last
    last_mean = (steps * train_loss - k_last * m_last) / (steps - k_last)
    say(f"train: one epoch of {steps} steps in {wall:.1f}s of process "
        f"wall; train pass {sps:,.0f} samples/s/chip, "
        f"{sps / TRAIN_BATCH:.1f} steps/s; validation acc {valid_acc:.2f}% "
        f"(chance 10%); mean train loss first {k_first} steps "
        f"{m_first:.5f}, last {steps - k_last} steps {last_mean:.5f}")
    if valid_acc < 20.0:
        fail(f"validation accuracy {valid_acc}% is under twice chance")
    if not last_mean < m_first:
        fail(f"the train loss did not fall: first 10% {m_first}, last 10% "
             f"{last_mean}")
    return launches, os.path.join(rsl, "bestmodel-mnist-vit.ckpt")


# -- phase 7: resume reproduces an uninterrupted run -----------------------

def phase_resume() -> None:
    import torch

    base = ["train", "--model", "vit", "--attention", "flash", "--debug",
            "--keep-ckpts", "2", "-e", "2"]
    rsl_a = os.path.join(WORK, "resume_a")
    rsl_b = os.path.join(WORK, "resume_b")
    run_cli(base, rsl_a)
    os.makedirs(rsl_b, exist_ok=True)
    first = "checkpoint-mnist-vit-000.ckpt"
    shutil.copy(os.path.join(rsl_a, first), os.path.join(rsl_b, first))
    _, log_b = run_cli(base + ["-f", os.path.join(rsl_b, first)], rsl_b)
    launches, steps, evals = parse_launches(log_b, "train")
    last = "checkpoint-mnist-vit-001.ckpt"
    a, b = (torch.load(os.path.join(r, last), map_location="cpu",
                       weights_only=True)["state"] for r in (rsl_a, rsl_b))

    def tensors(tree, prefix=""):
        if isinstance(tree, torch.Tensor):
            yield prefix, tree
        elif isinstance(tree, dict):
            for k in sorted(tree, key=str):
                yield from tensors(tree[k], f"{prefix}/{k}")

    pairs = list(zip(tensors(a), tensors(b)))
    differ = [na for (na, ta), (nb, tb) in pairs
              if na != nb or not torch.equal(ta, tb)]
    say(f"resume: resumed run ({steps} steps, launches {launches}) vs "
        f"uninterrupted: {len(pairs)} tensors of params and optimizer "
        f"state, {len(differ)} differ; step {a['step']} vs {b['step']}")
    if differ or a["step"] != b["step"] or not pairs:
        fail(f"the resumed run does not reproduce the uninterrupted one: "
             f"{differ[:5]}")


# -- phase 8: test on the trained model -----------------------------------

def phase_test(ckpt_path: str) -> None:

    from distributedpytorch_tpu_torch import checkpoint as ckpt
    from distributedpytorch_tpu_torch.data.datasets import load_dataset
    from distributedpytorch_tpu_torch.data.pipeline import ResidentLoader
    from distributedpytorch_tpu_torch.models import get_model
    from distributedpytorch_tpu_torch.ops.losses import cross_entropy
    from distributedpytorch_tpu_torch.precision import PRESETS
    from distributedpytorch_tpu_torch.train.engine import Engine, TrainState

    _, log = run_cli(["test", "-f", ckpt_path, "--attention", "flash"],
                     os.path.join(WORK, "test_rsl"))
    acc_cli = re.search(r"Time: \d+m \d+s, Acc: ([\d.]+)%", log).group(1)
    launches, _, evals = parse_launches(log, "test")
    ds = load_dataset("mnist", os.path.join(WORK, "data"), SEED,
                      synthetic_fallback=True)
    policy = PRESETS["bf16"]
    model = get_model("vit", ds.nb_classes, policy, attention="flash",
                      device="cuda")
    ckpt.restore_for_serving(ckpt_path, model)
    engine = Engine(model, cross_entropy, ds.mean, ds.std, 28, policy,
                    "cuda")
    loader = ResidentLoader(ds.splits["test"], TRAIN_BATCH, False, SEED,
                            "cuda")
    correct = n = 0.0
    for images, labels, valid in loader.epoch(0):
        m = engine.eval_step(TrainState(model, None), images, labels, valid)
        correct += m["correct"].item()
        n += m["valid"].item()
    acc_here = f"{correct / n * 100:.2f}"
    say(f"test: `test -f` accuracy {acc_cli}% ({evals} eval batches, "
        f"launches {launches}); in-process eval {acc_here}% "
        f"({int(correct)}/{int(n)})")
    if acc_cli != acc_here or launches["flash_fwd"] != DEPTH * evals \
            or launches["flash_dq"] or launches["flash_dkv"]:
        fail("test's accuracy or launches disagree with the in-process "
             "eval")


# -- phase 9: profile of the train step -------------------------------------

def phase_train_profile() -> None:
    """Where the time goes in one train step at batch 64, bf16: wall time
    per step (host clock, synchronized, profiler off), then from a second
    run under torch.profiler the device time by kernel, K1/K2/K3 shares
    and the device's idle share of the unprofiled wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from distributedpytorch_tpu_torch import utils
    from distributedpytorch_tpu_torch.data.datasets import load_dataset
    from distributedpytorch_tpu_torch.data.pipeline import ResidentLoader
    from distributedpytorch_tpu_torch.models import get_model
    from distributedpytorch_tpu_torch.ops.losses import cross_entropy
    from distributedpytorch_tpu_torch.precision import PRESETS
    from distributedpytorch_tpu_torch.train.engine import Engine

    ds = load_dataset("mnist", os.path.join(WORK, "data"), SEED,
                      synthetic_fallback=True)
    loader = ResidentLoader(ds.splits["train"], TRAIN_BATCH, True, SEED,
                            "cuda")
    reps = 20
    batches = list(itertools.islice(loader.epoch(0), 5 + 2 * reps))
    for att in ("flash", "full"):
        policy = PRESETS["bf16"]
        model = get_model("vit", ds.nb_classes, policy, attention=att,
                          device="cuda")
        engine = Engine(model, cross_entropy, ds.mean, ds.std, 28, policy,
                        "cuda")
        state = engine.init_state(torch.Generator().manual_seed(SEED))

        def step(i):
            gen = utils.step_generator(SEED, 0, i, "cuda")
            engine.train_step(state, *batches[i], gen)

        for i in range(5):
            step(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(reps):
            step(5 + i)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for i in range(reps):
                step(5 + reps + i)
            torch.cuda.synchronize()
        kernels = device_kernels(prof)
        dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / reps
        n_kern = sum(e.count for e in kernels) / reps
        if dev_ms <= 0:
            say(f"profile: train step, {att}: wall {wall_ms:.3f} ms/step; "
                f"device time not measured (no device events)")
            continue

        def us(tag):
            return sum(e.self_device_time_total for e in kernels
                       if tag in e.key) / reps

        parts = "; ".join(
            f"{n} {us(tag):.2f} us/step ({100 * us(tag) / 1e3 / dev_ms:.1f}%)"
            for n, tag in (("K1", "flash_fwd_kernel"),
                           ("K2", "flash_dq_kernel"),
                           ("K3", "flash_dkv_kernel")))
        say(f"profile: train step, {att}, batch {TRAIN_BATCH} bf16: wall "
            f"{wall_ms:.3f} ms/step, device {dev_ms:.3f} ms in "
            f"{n_kern:.0f} kernels (idle {100 * (1 - dev_ms / wall_ms):.1f}"
            f"%); {parts}")
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)
        say("profile:   top: " + "; ".join(
            f"{e.key[:48]} {e.self_device_time_total / reps:.1f}us"
            f"x{e.count // reps}" for e in top[:6]))


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
    bwd_rows = phase_bwd_kernels()
    main_rows = {"flash_fwd": main_row}
    for name in ("flash_dq", "flash_dkv"):
        main_rows[name] = bwd_rows[(name, 64, 49, 4, 32, "bfloat16", False)]
    for name, row in main_rows.items():
        missing = [k for k in ("ms", "plain_ms", "library_ms")
                   if row[k] is None]
        if missing:
            fail(f"torch.profiler returned no device events for {missing} "
                 f"of {name} at the main path's shape (64, 49, 4, 32) bf16")
    serve_launches = phase_main_path("cuda")
    phase_profile(os.path.join(WORK, "rsl", "bestmodel-mnist-vit.ckpt"))
    phase_train_step_parity()
    launches, best = phase_train()
    for name, n in launches.items():
        if n <= 0:
            fail(f"kernel {name} was not launched on the train path")
    phase_resume()
    phase_test(best)
    phase_train_profile()
    kernels = [{"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[name],
                **main_rows[name]} for name, source, replaces in KERNELS]
    kernels[0]["serve_launches"] = serve_launches
    say(f"chip_smoke: all phases passed in {time.perf_counter() - t0:.1f}s")
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
