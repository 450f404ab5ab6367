#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

or, to run some phases only (numbers of the list below; phase 1 always
runs, and phases 7 and 8 bring in phase 6, whose model they test), for
example the zoo's:

    python3 chip_smoke.py --phases 21,22,23

or the K5 slice's:

    python3 chip_smoke.py --phases 10,12,15

A partial run skips no check within a phase it runs, ends with a line
naming the skipped phases, and never prints the last line of a full run.
It needs one CUDA card and the CUDA toolkit (``nvcc``); without a card,
or without the port's package beside it, it exits non-zero and prints no
result.  Phases, each printing its lines before the last:

  1. environment: the card's name and power limit (nvidia-smi), torch,
     CUDA, Triton and nvcc versions, and the time to build the kernels
     from ``distributedpytorch_tpu_torch/csrc``;
  2. kernel K1 (flash-attention forward) against its plain PyTorch version
     on the card, at the vit's shapes and at causal, wider-head and longer
     sequences: each case's route, and at a tensor-core case the scalar
     route too (forced); max abs error of O and lse against the stated
     tolerance, two calls bit-identical; kernel / scalar route / plain /
     SDPA (yardstick only) times — call time from CUDA events, and device
     time from torch.profiler, the median of 3 traces at the main shape
     and one trace elsewhere, where the plain version is not timed — and
     the bound;
  3. the main path: a full-width vit (dim 128, depth 4, 4 heads, S = 49,
     random weights from a seed) saved as a port checkpoint and served by
     ``python -m distributedpytorch_tpu_torch serve --attention flash`` in
     two subprocesses: three waves of 64 concurrent HTTP requests at a
     100 ms flush deadline (partial buckets served), and one wave of 64 at
     a 5 s deadline that must come back as one batch of bucket 64; every
     answer held against the in-process predict step at the bucket that
     served it (label, and confidence to 1e-4); each server's K1 launch
     count held against 4 x (batches + warm-up buckets), every one on the
     tensor cores; and the model's flash logits held against its
     full-attention logits;
  4. kernels K2 and K3 (flash-attention backward: delta and dq, and
     dk/dv) against their plain PyTorch version on the card, at the vit's
     training shapes and at causal, wider-head and longer sequences: each
     case's route, and at a tensor-core case the scalar route too
     (forced); max error of dq, dk and dv relative to the plain version's
     largest value against the stated tolerance, K2's delta against
     ``attention_delta``, two calls bit-identical; device / call / plain /
     SDPA-backward (yardstick only) times of K2, K3, the backward as the
     step runs it (K2 then K3) and the unfused backward
     (``attention_delta``, then the scalar K2 and K3), timed as in phase
     2, and the bounds;
  5. one full-width f32 train step (TF32 off) on the card against the
     same step on the CPU: same weights, batch and affine draws through
     ``Engine.train_step_affine``; every parameter's gradient compared,
     relative to its largest value; the step's K1/K2/K3 launches must be
     exactly 4 each;
  6. the main path of the training slice: ``python -m
     distributedpytorch_tpu_torch train --model vit --attention flash
     --dataset mnist -e 1`` in a subprocess, on the first 16,000 train and
     2,000 test rows of the synthetic corpus written as MNIST files (225
     steps of 64, then 25 validation batches; the run's time limit);
     validation accuracy at least twice chance, the mean train loss of
     the last 10% of steps below that of the first 10%, and the logged
     K1/K2/K3 launches equal to 4 per train step (K2, K3) and 4 per train
     step plus 4 per eval batch (K1), every one on the tensor cores;
  7. resume: ``train --debug -e 2`` uninterrupted, and again resumed from
     its epoch-1 rolling file; the final params and optimizer state must
     be bit-identical; beside the uninterrupted run,
  8. ``test -f`` on the best model of phase 6 in a subprocess; its
     accuracy must equal an in-process eval of the same checkpoint;
  9. a profile of the train step at batch 64, bf16: wall and device ms
     per step, kernels per step, the device's idle share, K1/K2/K3 time a
     step and a launch, and their launches a step (and how many on the
     tensor cores);
 10. kernel K5 (the conv weight gradient) against its plain PyTorch
     version at the cnn's three conv shapes at batch 1, 16 and 64 and a
     ragged shape, bf16 and f32, plus a bf16 shape that the route rule
     sends to the scalar kernel and a bf16 tensor-core shape with a ragged
     last chunk: each case's route, and at a tensor-core case the scalar
     route too (forced); error relative to the plain version's largest
     value, two calls bit-identical, device time (median, least and most
     of 3 traces at batch 64 bf16, one trace elsewhere) / call / plain
     (at batch 64 bf16 only) / ``conv2d_weight`` (cuDNN, yardstick only)
     times and the bound;
 11. one f32 train step (TF32 off) of the cnn with K5 and of resnet18 on
     the card against the CPU: gradients and BatchNorm statistics, and
     exactly 3 K5 launches for the cnn; the max pools' tie routing on the
     card against the CPU's;
 12. the slice's kernel main path: one epoch (844 steps of 64) of
     Engine-driven cnn training with K5, its counts set to 0 before and
     read after (3 per step, every one on the tensor cores), validation
     accuracy at least twice chance,
     the loss falling, and the same epoch with the stock dW within the
     stated spread;
 13. the reference's job: ``torchrun --standalone --nproc_per_node 1 -m
     distributedpytorch_tpu_torch train`` with the default model (resnet
     at 224) on NCCL for one epoch of phase 22's corpus (18 steps), with
     ``train --debug`` of mlp and cnn beside it, then ``test -f`` on its
     best model (equal to an in-process eval);
 14. two ranks on the one card (gloo over CUDA tensors): three f32 steps
     of the cnn with K5 and of a resnet at reduced depth (and the resnet's
     in f64), held against one rank fed the same global batch and draws
     (all six worlds at once, each rank a ``tests/_torch_ddp_child.py``
     process, the child that ``tests/test_torch_ddp.py`` runs on the CPU);
 15. profiles of the cnn and resnet train steps (batch 64, bf16), with
     K5's time a step and a launch inside the cnn's;
 16. kernels K4 (the ring's positional forward, f32 O and lse) and K2p/K3p
     (its backward, dO in f32, the lse cotangent folded into delta)
     against their plain PyTorch versions, bf16 and f32: the vit's ring
     shard at M = 2 (rank 1's queries against rank 0's and its own K/V,
     kv_valid 49), a block of padded keys only, causal blocks with rotated
     positions (one all masked), D = 128 and a 500-row shard; on each
     kernel's route and at a tensor-core case on the scalar route too
     (forced), errors of O and lse (rows with no key: O = 0 and lse =
     -1e30) and of dq/dk/dv with a nonzero dlse, K2p's delta against
     ``partial_delta``, two calls bit-identical; device / call / plain /
     SDPA with the same boolean mask (yardstick only; it returns no lse)
     times of K4 (both routes), K2p, K3p, the backward as the ring step
     runs it (K2p, which computes delta and rounds dO to bf16, then K3p)
     and the old line (``partial_delta``, then the scalar K2p and K3p),
     timed as in phase 2, and the bounds;
 17. the ring op on two ranks sharing the card (gloo over CUDA tensors,
     ``tests/_torch_ring_child.py``), ``ring`` and ``ring_flash``, against
     one process's ``full_attention`` and ``flash_attention`` on the
     gathered tensors: outputs and q/k/v gradients at the vit's S = 49 and
     at a causal S = 1000;
 18. the ring slice's main path: ``torchrun --nproc_per_node 2 ... train
     --model vit --attention ring_flash --model-parallel 2 -e 1`` on phase
     6's corpus (113 steps, 13 validation batches a rank); validation at
     least twice chance, the loss falling, K4 launches 8 per step and eval
     batch, K2p and K3p 8 per step, every one on the tensor cores, K1-K3
     none; then, at once, ``test -f`` under the same launch and ``test -f
     --attention flash`` in one process (equal to an in-process flash eval
     of the file); the bf16 logits of every test row from ``ring_flash``
     on two ranks against flash's, within TOL_RING_OP's bf16 share of the
     largest logit, every row whose labels differ within that noise of a
     tie, and the ring's ``test`` within two rows more than those of
     flash's;
 19. three f32 SGD steps (TF32 off) of the full-width vit, the 2-rank
     ``ring_flash`` and ``ring`` worlds against one process with
     ``--attention flash`` on the same global batch and draws: every
     parameter, the loss and the counts;
 20. a profile of the ring_flash train step (two ranks, bf16, 128 rows a
     rank): wall and device ms per step, kernels per step, the idle
     share, K4/K2p/K3p time a step and a launch, their launches a step
     (and how many on the tensor cores), and the host copies of the gloo
     transport;
 21. the rest of the torchvision zoo on the card against the CPU:
     alexnet, vgg11_bn, squeezenet1_0, densenet121 and inception_v3 at
     full width and their canonical sizes (224; 299 for inception),
     batch 4, SEED's weights, the same augmented batch and dropout masks
     (those ``Engine.train_step`` draws), TF32 off: the f32 train-mode
     logits (and inception's aux logits), the gradients of one step in
     f64 compute (and in f32, held for alexnet and squeezenet and
     printed for the BatchNorm models, whose f32 backward amplifies the
     devices' last-bit differences) and the BatchNorm statistics;
 22. the zoo's main path: ``train --model X -e 1`` of the five on the
     first 1,280 train and 128 test rows of the synthetic corpus as
     MNIST files (18 steps of 64, 2 validation batches), with ``train
     --model resnet --use-pretrained --pretrained-path F
     --feature-extract`` (F a torchvision-layout resnet18 state_dict from
     ``tests/_torch_zoo.py``) beside them, six processes at once: every
     logged loss finite, the parameters moved, no kernel of the port
     launched, the pretrained backbone bit-identical to the file's and
     the head moved; then ``test -f`` on each best file (equal to an
     in-process eval) beside ``serve`` of inception's and vgg's, one wave
     of 16 concurrent requests each, every answer held against the
     in-process predict step at its bucket as in phase 3;
 23. profiles of the five train steps (batch 64, bf16, cuDNN
     deterministic as ``train`` sets it, 5 steps under torch.profiler):
     wall and device ms per step, kernels per step, the idle share and
     the top device operations;
 24. the card's name and power limit again, one ``{"kernels": [...]}``
     JSON line, then the last line ``{"ok": true, "device": {...}}``.

Each phase prints its wall time.  Any failed check exits non-zero before
the last line is printed.  Work files go to ``build/chip_smoke/`` in the
checkout, and the bytecode of the modules that the run's processes import
to ``build/pycache/``.
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
BURST_THREADS = 64              # concurrent clients: one wave fills bucket 64
BURST_WAVES = 3                 # requests per client in the main burst
# The flush deadline of the main burst's server: partial buckets are
# served, and every answer is held against the predict step at its bucket.
FLUSH_MS = 100
# A second server answers one wave of 64 at this deadline, which must come
# back as one batch of bucket 64.  A wave's 64 requests reach the batcher
# one connection at a time, and at 100 ms one run of three waves served
# none of them in bucket 64 (27 batches; ROADMAP queue 3): the deadline
# has to outlast a wave's spread.  A full bucket dispatches at once.
FILL_FLUSH_MS = 5000
HBM_BYTES_PER_S = 3.35e12       # H100 SXM, NVIDIA data sheet
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}  # dense, 700 W
TOL_O = {"bfloat16": 2e-2, "float32": 2e-5}   # bf16: one output rounding
TOL_LSE = 1e-4                                # f32 in both
# Served answers against the in-process predict step at the same bucket:
# the same program on the same card, so the only difference expected is
# the server's rounding of the confidence to 6 decimals (5e-7).
TOL_CONF = 1e-4
TOL_LOGITS = {"float32": 1e-4, "bfloat16": 5e-2}
SOURCES = ("flash_fwd", "flash_bwd", "conv_dw")  # csrc/<name>.cu, together
CSRC = "distributedpytorch_tpu_torch/csrc"
TPU_KERNELS = "distributedpytorch_tpu/ops/flash_attention.py"
KERNELS = (  # name, source, the TPU kernel it replaces
    ("flash_fwd", f"{CSRC}/flash_fwd.cu", f"{TPU_KERNELS}:79"),
    ("flash_dq", f"{CSRC}/flash_bwd.cu", f"{TPU_KERNELS}:189"),
    ("flash_dkv", f"{CSRC}/flash_bwd.cu", f"{TPU_KERNELS}:236"),
    ("conv_dw", f"{CSRC}/conv_dw.cu", "distributedpytorch_tpu/ops/conv.py:92"),
    # the same three Pallas kernels with use_pos=True, reached through
    # flash_attention_partial (:373) and its backward (:400)
    ("flash_fwd_pos", f"{CSRC}/flash_fwd.cu", f"{TPU_KERNELS}:79"),
    ("flash_dq_pos", f"{CSRC}/flash_bwd.cu", f"{TPU_KERNELS}:189"),
    ("flash_dkv_pos", f"{CSRC}/flash_bwd.cu", f"{TPU_KERNELS}:236"),
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
MAIN_ATTN = (64, 49, 4, 32, "bfloat16", False)   # the vit's attention call


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
        f"count {torch.cuda.device_count()}; bytecode cache "
        f"{os.path.relpath(sys.pycache_prefix, ROOT)}")
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
            report = f.read().splitlines()
        names = kernel_names(report)
        kernel = ""
        for line in report:
            m = re.search(r"Function properties for (\S+)", line)
            if m:
                kernel = names.get(m.group(1), m.group(1))
            if "registers" in line or "spill" in line:
                say(f"build: {name}: {kernel}: " + line.strip())
    return card


def kernel_names(report: list) -> dict:
    """The mangled kernel names of ptxas' report -> short demangled ones
    (``flash_dq_mma_kernel<32>``), by ``c++filt`` where it exists."""
    mangled = sorted({m.group(1) for line in report for m in
                      [re.search(r"Function properties for (\S+)", line)]
                      if m})
    filt = shutil.which("c++filt")
    if not mangled or filt is None:
        return {}
    out = subprocess.run([filt], input="\n".join(mangled),
                         capture_output=True, text=True).stdout.splitlines()
    if len(out) != len(mangled):
        return {}
    short = [re.sub(r"^void |\(anonymous namespace\)::", "", n)
             for n in out]
    return {m: n[:n.index("(")] if "(" in n else n
            for m, n in zip(mangled, short)}


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


# Small kernels that open every trace of _device_trace, ahead of a marker.
# A trace taken after other torch.profiler sessions in the process can come
# back without its first device events, which were the first function's:
# on an H100 SXM at 700 W a full run (after phases 3, 9, 10 and 15) read
# K4's tensor-core route at 3.9 us at the ring shard and 3.1 us at the
# 500-row shard, partial runs 6.0 and 30.5 (about 18 of 50 and 18 of 20
# launches missing); the scalar K4, the first function until then, read
# 19.6 against 36.4.  The lead-in takes the loss.
LEAD_IN = 64


def _device_trace(fns: dict, reps: int):
    """One torch.profiler session over ``reps`` back-to-back calls of each
    function of ``fns`` (name -> callable), after LEAD_IN small kernels, a
    ``torch.cuda._sleep`` kernel marking the boundary before each
    function: the mean device time per call of each (the summed duration
    of the CUDA work it launches, the device events in start order on the
    one stream split at the markers), or None when the trace lacks a
    marker or a function's events.  Says how many lead-in events the
    trace lost, when it lost any."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    lead = torch.zeros(1, device="cuda")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(LEAD_IN):
            lead.add_(1.0)
        for fn in fns.values():
            torch.cuda._sleep(1000)
            for _ in range(reps):
                fn()
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events()
                     if e.device_type == DeviceType.CUDA
                     and not getattr(e, "is_user_annotation", False)),
                    key=lambda e: e.time_range.start)
    groups = [[]]
    for e in events:
        if "spin_kernel" in e.name:
            groups.append([])
        else:
            groups[-1].append(e.time_range.elapsed_us())
    lost, groups = LEAD_IN - len(groups[0]), groups[1:]
    if lost:
        say(f"trace: {lost} of {LEAD_IN} lead-in events missing")
    if len(groups) == len(fns) and all(groups):
        return {n: sum(g) / 1e3 / reps for n, g in zip(fns, groups)}
    return None


def device_ms_tries(fns: dict, reps: int = 50, tries: int = 3) -> dict:
    """The device time per call of each function of ``fns`` in each of
    ``tries`` traces, after warm-up: name -> the list of the traces that
    had every function's events (empty when none had); ``spread`` gives
    their median, least and most."""
    import torch

    for fn in fns.values():
        for _ in range(3):
            fn()
    torch.cuda.synchronize()
    got = [t for t in (_device_trace(fns, reps) for _ in range(tries)) if t]
    return {n: [t[n] for t in got] for n in fns}


def timing_tries(main: bool) -> int:
    """Traces a time is taken from: the median of 3 at a kernel's main
    shape, one at a side shape."""
    return 3 if main else 1


def timing_note(main: bool) -> str:
    return ("main shape, device_ms median of 3 traces" if main
            else "side shape, device_ms of 1 trace, plain not timed")


def times_text(dev: dict, call: dict) -> str:
    """``device_ms a=.. b=..; call_ms a=.. b=..`` of one case's functions
    (a space in a name becomes _)."""
    return ("device_ms " + " ".join(f"{n.replace(' ', '_')}={fmt_ms(t)}"
                                    for n, t in dev.items())
            + "; call_ms " + " ".join(f"{n.replace(' ', '_')}={t:.5f}"
                                      for n, t in call.items()))


def spread(times: list) -> tuple:
    """(median, least, most) of a list of times; Nones when empty."""
    if not times:
        return None, None, None
    t = sorted(times)
    return t[len(t) // 2], t[0], t[-1]


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
    """K1 against its plain version: each case on the route the rule
    picks and, at a tensor-core case, on the scalar route too (forced),
    both held to TOL_O / TOL_LSE; two calls bit-identical; device / call
    times of both routes beside SDPA's (and the plain version's at the
    main shape) and the bound."""
    import torch
    import torch.nn.functional as F

    from distributedpytorch_tpu_torch.ops import flash_attention as tfa
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
        tc = tfa._pick_route(None, (q, k, v), kernel="K1")
        route = "tensor_core" if tc else "scalar"
        before = (flash_attention_fwd.launches,
                  flash_attention_fwd.tensor_core_launches)
        o, lse = flash_attention_fwd(q, k, v, causal)
        o2, lse2 = flash_attention_fwd(q, k, v, causal)
        torch.cuda.synchronize()
        if (flash_attention_fwd.launches,
                flash_attention_fwd.tensor_core_launches) != (
                before[0] + 2, before[1] + 2 * tc):
            fail(f"K1 wrapper did not count its {route} launches at "
                 f"{(b, s, h, d)} {dt}")
        if not (torch.equal(o, o2) and torch.equal(lse, lse2)):
            fail(f"K1's {route} route is not deterministic at "
                 f"{(b, s, h, d)} {dt} causal={causal}")
        checked = {route: (o, lse)}
        if tc:
            checked["scalar"] = tfa._launch(q, k, v, causal,
                                            tensor_core=False)
        po, plse = flash_attention_plain(q, k, v, causal)
        errs = {}
        for r, (x_o, x_lse) in checked.items():
            errs[r] = ((x_o.float() - po.float()).abs().max().item(),
                       (x_lse - plse).abs().max().item())
            if not (math.isfinite(errs[r][0]) and errs[r][0] <= TOL_O[dt]
                    and errs[r][1] <= TOL_LSE):
                fail(f"K1's {r} route disagrees with its plain version at "
                     f"{(b, s, h, d)} {dt} causal={causal}: err_o "
                     f"{errs[r][0]} (tol {TOL_O[dt]}), err_lse {errs[r][1]} "
                     f"(tol {TOL_LSE})")
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        reps = 50 if s < 1000 else 20
        main = (b, s, h, d, dt, causal) == MAIN_ATTN
        fns = {"kernel": lambda: flash_attention_fwd(q, k, v, causal),
               "sdpa": lambda: F.scaled_dot_product_attention(
                   qt, kt, vt, is_causal=causal)}
        if tc:
            fns["scalar"] = lambda: tfa._launch(q, k, v, causal,
                                                tensor_core=False)
        if main:
            fns["plain"] = lambda: flash_attention_plain(q, k, v, causal)
        call = {n: time_ms(f, reps) for n, f in fns.items()}
        dev = {n: spread(t)[0] for n, t in
               device_ms_tries(fns, reps, timing_tries(main)).items()}
        b_ms, b_by = bound_ms(b, s, h, d, dt, causal)
        say(f"K1 {(b, s, h, d)} {dt} causal={causal}, {route} route: "
            + "; ".join(f"{r} err_o={e[0]:.3g} err_lse={e[1]:.3g}"
                        for r, e in errs.items())
            + f" (tol {TOL_O[dt]:g}, {TOL_LSE:g}), bit-identical; "
            f"{timing_note(main)}: " + times_text(dev, call)
            + f"; bound_us={b_ms * 1e3:.3f} ({b_by}) launches="
            f"{flash_attention_fwd.launches} (tensor-core "
            f"{flash_attention_fwd.tensor_core_launches})")
        rows[(b, s, h, d, dt, causal)] = dict(
            max_abs_err=errs[route][0], ms=dev["kernel"],
            plain_ms=dev.get("plain"), library_ms=dev["sdpa"],
            bound_ms=b_ms, bound_by=b_by, call_ms=call["kernel"],
            plain_call_ms=call.get("plain"), library_call_ms=call["sdpa"],
            tc_route=route, scalar_ms=dev.get("scalar"),
            scalar_max_abs_err=errs["scalar"][0] if tc else None)
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


def burst(port: int, images, waves: int,
          threads: int = BURST_THREADS) -> list:
    """``threads`` clients, each sending ``waves`` requests; every wave
    starts on a barrier so a full bucket of 64 queues at once.  Returns
    (row, status, body, client_s) per request."""
    bodies = [json.dumps({"image": img.tolist()}).encode() for img in images]
    barrier = threading.Barrier(threads)
    out = [None] * len(bodies)

    def client(t):
        for w in range(waves):
            i = w * threads + t
            barrier.wait(timeout=120)
            try:
                out[i] = (i,) + post(port, bodies[i])
            except OSError as e:  # reported with the failed answers below
                out[i] = (i, None, {"error": repr(e)}, 0.0)

    clients = [threading.Thread(target=client, args=(t,))
               for t in range(threads)]
    for th in clients:
        th.start()
    for th in clients:
        th.join(timeout=300)
    if any(th.is_alive() for th in clients) or any(o is None for o in out):
        fail("the HTTP burst did not complete")
    return out


def reference_predictions(ckpt_path: str, images, served_bucket,
                          device: str, name: str = "vit"):
    """The in-process predict step of the ``name`` checkpoint on the same
    rows, each row in a batch of the bucket the server answered it from
    (zero-padded, as the server pads), plus each row's softmax (to tell a
    tie from a wrong label)."""
    import numpy as np
    import torch

    from distributedpytorch_tpu_torch import checkpoint as ckpt
    from distributedpytorch_tpu_torch.data import augment
    from distributedpytorch_tpu_torch.data.datasets import load_dataset
    from distributedpytorch_tpu_torch.models import (get_model,
                                                     get_model_input_size)
    from distributedpytorch_tpu_torch.precision import PRESETS
    from distributedpytorch_tpu_torch.train.engine import Predictor

    ds = load_dataset("mnist", os.path.join(WORK, "data"), SEED,
                      synthetic_fallback=True)
    policy = PRESETS["bf16"]
    size = get_model_input_size(name)
    model = get_model(name, ds.nb_classes, policy,
                      attention="flash" if name == "vit" else "full",
                      device=device)
    ckpt.restore_for_serving(ckpt_path, model)
    pred = Predictor(model, ds.mean, ds.std, size, policy, device)
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
                    size, out_dtype=policy.compute_dtype)
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


def start_server(ckpt_path: str, n: int, flush_ms: int, device: str,
                 attention: str = "flash"):
    """A ``serve`` subprocess that stops after ``n`` answers (a fresh
    process: its K1 count starts at 0 right before the main path and is
    read from its log right after); returns (port, proc, lines, the
    listening event)."""
    port = free_port()
    cmd = [sys.executable, "-m", "distributedpytorch_tpu_torch", "serve",
           "-d", os.path.join(WORK, "data"),
           "--rsl_path", os.path.join(WORK, "rsl"), "-f", ckpt_path,
           "--attention", attention, "--synthetic-fallback",
           "--serve-buckets", ",".join(str(b) for b in BUCKETS),
           "--serve-max-requests", str(n), "--serve-port", str(port),
           "--serve-max-latency-ms", str(flush_ms), "--device", device]
    say("main: " + " ".join(os.path.relpath(c, ROOT) if c.startswith(ROOT)
                            else c for c in cmd[1:]))
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    lines = []
    listening = threading.Event()

    def reader():
        for line in proc.stdout:
            lines.append(line.rstrip())
            if "serve: listening on" in line:
                listening.set()

    threading.Thread(target=reader, daemon=True).start()
    return port, proc, lines, listening


def serve_burst(server, images, waves: int,
                threads: int = BURST_THREADS) -> tuple:
    """Waits for ``server`` to listen, sends ``waves`` waves of ``threads``
    requests, waits for it to exit; returns (answers, burst seconds)."""
    port, proc, lines, listening = server
    t0 = time.perf_counter()
    while not listening.wait(0.5):
        if proc.poll() is not None or time.perf_counter() - t0 > 600:
            fail("the server did not start:\n" + "\n".join(lines[-40:]))
    t_burst = time.perf_counter()
    answers = burst(port, images, waves, threads)
    burst_s = time.perf_counter() - t_burst
    try:
        rc = proc.wait(timeout=120)
    except subprocess.TimeoutExpired:
        rc = None
    if rc != 0:
        fail(f"the server exited with {rc}:\n" + "\n".join(lines[-40:]))
    time.sleep(0.2)         # the reader thread takes the last lines
    for line in lines:
        if line.startswith("serve:"):
            say("server| " + line)
    bad = [a for a in answers if a[1] != 200]
    if bad:
        fail(f"{len(bad)} of {len(answers)} requests failed, e.g. "
             f"{bad[0][1:3]}")
    return answers, burst_s


def check_server_launches(lines, n: int) -> tuple:
    """The server's K1 count against 4 x (batches + warm-up buckets), every
    launch on the tensor cores; returns (launches, batches)."""
    served = stopped = None
    for line in lines:
        m = re.search(r"flash_fwd launches (\d+) \((\d+) in warm-up\), "
                      r"(\d+) on the tensor cores", line)
        if m:
            served = tuple(int(x) for x in m.groups())
        m = re.search(r"answering (\d+) requests in (\d+) batches", line)
        if m:
            stopped = (int(m.group(1)), int(m.group(2)))
    if served is None or stopped is None:
        fail("the server did not report its K1 launches and batches")
    launches, warm, tensor_core = served
    answered, batches = stopped
    want = DEPTH * (batches + len(BUCKETS))
    say(f"main: K1 launches {launches} = {DEPTH} x ({batches} batches + "
        f"{len(BUCKETS)} warm-up forwards) -> expected {want}; "
        f"{tensor_core} on the tensor cores (expected all)")
    if answered != n or launches <= 0 or launches != want \
            or warm != DEPTH * len(BUCKETS) or tensor_core != launches:
        fail(f"K1 launch count {launches} (warm-up {warm}, tensor-core "
             f"{tensor_core}) does not match the {batches} batches served, "
             f"every one on the tensor cores")
    return launches, batches


def phase_main_path(device: str = "cuda"):
    import numpy as np

    from distributedpytorch_tpu_torch.data.datasets import load_dataset

    ckpt_path = os.path.join(WORK, "rsl", "bestmodel-mnist-vit.ckpt")
    build_checkpoint(ckpt_path)
    n_main = BURST_THREADS * BURST_WAVES
    n = n_main + BURST_THREADS
    # both servers start together; the bursts run one after the other
    servers = [start_server(ckpt_path, n_main, FLUSH_MS, device),
               start_server(ckpt_path, BURST_THREADS, FILL_FLUSH_MS, device)]
    try:
        ds = load_dataset("mnist", os.path.join(WORK, "data"), SEED,
                          synthetic_fallback=True)
        images = ds.splits["test"].images[:n]
        main_answers, burst_s = serve_burst(servers[0], images[:n_main],
                                            BURST_WAVES)
        fill_answers, fill_s = serve_burst(servers[1], images[n_main:], 1)
    finally:
        for _, proc, _, _ in servers:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for what, answers, secs, flush in (
            ("main burst", main_answers, burst_s, FLUSH_MS),
            ("fill wave", fill_answers, fill_s, FILL_FLUSH_MS)):
        server_ms = np.array([a[2]["latency_ms"] for a in answers])
        client_ms = np.array([a[3] * 1e3 for a in answers])
        say(f"main: {what} (flush {flush} ms): {len(answers)} answers in "
            f"{secs:.3f}s, buckets used "
            f"{sorted({a[2]['bucket'] for a in answers})}; server latency "
            f"p50 {np.percentile(server_ms, 50):.3f} ms p99 "
            f"{np.percentile(server_ms, 99):.3f} ms; client latency p50 "
            f"{np.percentile(client_ms, 50):.3f} ms p99 "
            f"{np.percentile(client_ms, 99):.3f} ms")
    if {a[2]["bucket"] for a in fill_answers} != {max(BUCKETS)}:
        fail(f"the fill wave was not served in bucket {max(BUCKETS)}: "
             f"{sorted({a[2]['bucket'] for a in fill_answers})}")
    answers = main_answers + [(n_main + a[0],) + a[1:] for a in fill_answers]

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

    launches, _ = check_server_launches(servers[0][2], n_main)
    fill_launches, fill_batches = check_server_launches(servers[1][2],
                                                        BURST_THREADS)
    if fill_batches != 1:
        fail(f"the fill wave took {fill_batches} batches, not one")
    return launches + fill_launches


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
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    pred.predict_step(x)
                torch.cuda.synchronize()
            kernels = device_kernels(prof)
            dev_ms = sum(e.self_device_time_total for e in kernels) \
                / 1e3 / reps
            n_kern = sum(e.count for e in kernels) / reps
            k1_ms = sum(e.self_device_time_total for e in kernels
                        if "flash_fwd_" in e.key) / 1e3 / reps
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
    """Least time for K2 ("dq"), K3 ("dkv") or the whole backward
    ("bwd"): each input read once and each output written once (K2 reads
    q, k, v, dO, O and lse and writes dq and delta; K3 reads q, k, v, dO,
    lse and delta and writes dk and dv; the backward reads q, k, v, dO, O
    and lse and writes dq, dk and dv), or its products' operations (K2: 3,
    K3: 4, the backward: 5) at the card's peak for the input type,
    whichever is larger."""
    item = 2 if dtype_name == "bfloat16" else 4
    tensor = b * s * h * d * item
    rows = b * h * s * 4
    pairs = s * (s + 1) / 2 if causal else s * s
    tensors, row_vectors, products = {"dq": (6, 2, 3), "dkv": (6, 2, 4),
                                      "bwd": (8, 1, 5)}[kernel]
    nbytes = tensors * tensor + row_vectors * rows
    ops = products * 2 * b * h * pairs * d
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rel_err(got, ref) -> tuple:
    """(max abs error, max abs error / max abs of the reference)."""
    err = (got.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    return err, err / max(scale, 1e-30)


# K2's delta against attention_delta, relative to its largest value: the
# same f32 sum of the same exact products in another order.
TOL_DELTA = 1e-5


def phase_bwd_kernels():
    """K2 and K3 against their plain version: each case on the route the
    rule picks and, at a tensor-core case, on the scalar route too
    (forced), both held to TOL_GRAD; K2's delta against
    ``attention_delta``; two calls bit-identical; times of the backward
    as the step runs it (K2, which computes delta, then K3) beside the
    unfused backward (``attention_delta``, then the scalar K2 and K3)
    and SDPA's backward."""
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
    counters = (tfa.flash_attention_dq, tfa.flash_attention_dkv)
    rows = {}
    for (b, s, h, d, dt, causal) in cases:
        shape = (b, s, h, d)
        dtype = getattr(torch, dt)
        qkv = torch.randn((b, s, 3 * h * d), generator=gen,
                          device="cuda").to(dtype)
        q, k, v = (t.reshape(b, s, h, d) for t in qkv.split(h * d, dim=-1))
        do = torch.randn((b, s, h, d), generator=gen, device="cuda").to(dtype)
        o, lse = tfa.flash_attention_fwd(q, k, v, causal)
        tc = tfa._pick_route(None, (q, k, v, do, o))
        route = "tensor_core" if tc else "scalar"
        before = [(w.launches, w.tensor_core_launches) for w in counters]
        dq, delta = tfa.flash_attention_dq(q, k, v, o, do, lse, causal)
        dk, dv = tfa.flash_attention_dkv(q, k, v, do, lse, delta, causal)
        again = tfa.flash_attention_bwd(q, k, v, o, lse, do, causal)
        torch.cuda.synchronize()
        if [(w.launches, w.tensor_core_launches) for w in counters] != [
                (n + 2, c + 2 * tc) for n, c in before]:
            fail(f"K2/K3 wrappers did not count their {route} launches at "
                 f"{shape} {dt}")
        if not all(torch.equal(x, y) for x, y in zip((dq, dk, dv), again)):
            fail(f"K2/K3's {route} route is not deterministic at {shape} "
                 f"{dt} causal={causal}")
        checked = {route: (delta, dq, dk, dv)}
        if tc:
            sdq, sdelta = tfa._dq_launch(q, k, v, o, do, lse, causal,
                                         tensor_core=False)
            sdk, sdv = tfa._dkv_launch(q, k, v, do, lse, sdelta, causal,
                                       tensor_core=False)
            checked["scalar"] = (sdelta, sdq, sdk, sdv)
        want_delta = tfa.attention_delta(o, do)
        pdq, pdk, pdv = tfa.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                                      causal)
        tol = TOL_GRAD[dt]
        errs = {}
        for r, (x_delta, x_dq, x_dk, x_dv) in checked.items():
            errs[r] = {"delta": rel_err(x_delta, want_delta),
                       "dq": rel_err(x_dq, pdq), "dk": rel_err(x_dk, pdk),
                       "dv": rel_err(x_dv, pdv)}
            bad = {n: e[1] for n, e in errs[r].items()
                   if not (math.isfinite(e[1])
                           and e[1] <= (TOL_DELTA if n == "delta" else tol))}
            if bad:
                fail(f"K2/K3's {r} route disagrees with the plain version "
                     f"at {shape} {dt} causal={causal}: {bad} (tol {tol}, "
                     f"delta {TOL_DELTA})")
        # SDPA's backward (yardstick only): dq, dk and dv in one call
        qt, kt, vt = (t.detach().transpose(1, 2).contiguous()
                      .requires_grad_() for t in (q, k, v))
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
        dot = do.transpose(1, 2).contiguous()
        reps = 50 if s < 1000 else 20
        main = (b, s, h, d, dt, causal) == MAIN_ATTN

        def unfused_bwd():
            x_delta = tfa.attention_delta(o, do)
            tfa._dq_launch(q, k, v, o, do, lse, causal, tensor_core=False)
            tfa._dkv_launch(q, k, v, do, lse, x_delta, causal,
                            tensor_core=False)

        fns = {"K2": lambda: tfa.flash_attention_dq(q, k, v, o, do, lse,
                                                    causal),
               "K3": lambda: tfa.flash_attention_dkv(q, k, v, do, lse, delta,
                                                     causal),
               "bwd": lambda: tfa.flash_attention_bwd(q, k, v, o, lse, do,
                                                      causal)}
        if tc:
            fns["scalar K2"] = lambda: tfa._dq_launch(
                q, k, v, o, do, lse, causal, tensor_core=False)
            fns["scalar K3"] = lambda: tfa._dkv_launch(
                q, k, v, do, lse, delta, causal, tensor_core=False)
            fns["unfused bwd"] = unfused_bwd
        if main:
            fns["plain"] = lambda: tfa.flash_attention_bwd_plain(
                q, k, v, o, lse, do, causal)
        fns["sdpa bwd"] = lambda: torch.autograd.grad(
            out, (qt, kt, vt), dot, retain_graph=True)
        call = {n: time_ms(f, reps) for n, f in fns.items()}
        dev = {n: spread(t)[0] for n, t in
               device_ms_tries(fns, reps, timing_tries(main)).items()}
        bounds = {n: bwd_bound_ms(b, s, h, d, dt, causal, n)
                  for n in ("dq", "dkv", "bwd")}
        say(f"K2/K3 {shape} {dt} causal={causal}, {route} route: rel err "
            + "; ".join(f"{r} " + " ".join(f"{n}={e[1]:.3g}"
                                           for n, e in es.items())
                        for r, es in errs.items())
            + f" (tol {tol:g}, delta {TOL_DELTA:g}), bit-identical; "
            f"{timing_note(main)}: " + times_text(dev, call)
            + "; bound_us " + " ".join(f"{n}={t * 1e3:.3f} ({by})"
                                       for n, (t, by) in bounds.items())
            + f"; launches K2={tfa.flash_attention_dq.launches} "
            f"(tensor-core {tfa.flash_attention_dq.tensor_core_launches}) "
            f"K3={tfa.flash_attention_dkv.launches} (tensor-core "
            f"{tfa.flash_attention_dkv.tensor_core_launches})")
        for name, key, parts in (("flash_dq", "K2", ("delta", "dq")),
                                 ("flash_dkv", "K3", ("dk", "dv"))):
            err = max((errs[route][n] for n in parts), key=lambda e: e[1])
            rows[(name, b, s, h, d, dt, causal)] = dict(
                max_abs_err=err[0], rel_err=err[1], ms=dev[key],
                plain_ms=dev.get("plain"), library_ms=dev["sdpa bwd"],
                bound_ms=bounds[name[6:]][0], bound_by=bounds[name[6:]][1],
                call_ms=call[key], plain_call_ms=call.get("plain"),
                library_call_ms=call["sdpa bwd"], tc_route=route,
                scalar_ms=dev.get("scalar " + key),
                scalar_rel_err=(max(errs["scalar"][n][1] for n in parts)
                                if tc else None),
                delta_rel_err=errs[route]["delta"][1],
                bwd_ms=dev["bwd"], unfused_bwd_ms=dev.get("unfused bwd"),
                bwd_bound_ms=bounds["bwd"][0])
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
                       "flash_dkv": DEPTH, "conv_dw": 0, "flash_fwd_pos": 0,
                       "flash_dq_pos": 0, "flash_dkv_pos": 0}:
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

TORCHRUN = ("-m", "torch.distributed.run", "--standalone",
            "--nproc_per_node", "1")


def start_cli(args, rsl: str, launcher=(), data: str = "") -> tuple:
    """Starts ``python [LAUNCHER] -m distributedpytorch_tpu_torch ARGS`` (a
    fresh process: its kernel counters start at 0) on the data in ``data``
    (WORK/data by default), its output going to a file in WORK;
    ``finish_cli`` waits for it."""
    cmd = [sys.executable, *launcher, "-m", "distributedpytorch_tpu_torch",
           *args, "-d", data or os.path.join(WORK, "data"), "--rsl_path", rsl,
           "--dataset", "mnist", "--synthetic-fallback", "--device", "cuda"]
    say("run: " + " ".join(os.path.relpath(c, ROOT) if c.startswith(ROOT)
                           else c for c in cmd[1:]))
    out = os.path.join(WORK, os.path.basename(rsl) + ".out")
    with open(out, "w") as f:
        proc = subprocess.Popen(cmd, cwd=ROOT, stdout=f,
                                stderr=subprocess.STDOUT)
    return args[0], rsl, out, proc, time.perf_counter()


def finish_cli(run: tuple, timeout: float = 900.0) -> tuple:
    """Waits for a ``start_cli`` process (killing it at ``timeout``
    seconds); returns (wall s, the text of RSL/test.log)."""
    action, rsl, out, proc, t0 = run
    try:
        rc = proc.wait(timeout=max(1.0, t0 + timeout - time.perf_counter()))
    except subprocess.TimeoutExpired:
        rc = None
    wall = time.perf_counter() - t0
    if rc != 0:
        with open(out) as f:
            fail(f"{action} exited with {rc}:\n{f.read()[-4000:]}")
    with open(os.path.join(rsl, "test.log")) as f:
        return wall, f.read()


def finish_all(runs: list) -> list:
    """``finish_cli`` of every run in order; no process outlives it."""
    try:
        return [finish_cli(run) for run in runs]
    finally:
        for *_, proc, _ in runs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def run_cli(args, rsl: str, launcher=(), data: str = "") -> tuple:
    """One CLI process, start to end: (wall s, the text of RSL/test.log)."""
    return finish_all([start_cli(args, rsl, launcher, data)])[0]


def parse_launches(log: str, action: str):
    m = re.search(rf"{action}: kernel launches flash_fwd (\d+), flash_dq "
                  rf"(\d+), flash_dkv (\d+), conv_dw (\d+) over "
                  rf"(?:(\d+) train steps and )?(\d+) eval batches", log)
    if m is None:
        fail(f"{action} did not log its kernel launches")
    fwd, dq, dkv, dw, steps, evals = (int(x) if x is not None else 0
                                      for x in m.groups())
    return ({"flash_fwd": fwd, "flash_dq": dq, "flash_dkv": dkv,
             "conv_dw": dw}, steps, evals)


def parse_tensor_core_launches(log: str, action: str) -> dict:
    """The ``ACTION: tensor-core launches ...`` line: of K1, K2, K3 and
    K5, the launches on the tensor cores."""
    m = re.search(rf"{action}: tensor-core launches flash_fwd (\d+), "
                  rf"flash_dq (\d+), flash_dkv (\d+), conv_dw (\d+) over",
                  log)
    if m is None:
        fail(f"{action} did not log its tensor-core launches")
    return dict(zip(("flash_fwd", "flash_dq", "flash_dkv", "conv_dw"),
                    map(int, m.groups())))


# Phase 6's corpus: the first rows of the synthetic one, as MNIST files.
# 90% of the train rows train: 225 steps of 64, and 25 validation batches.
VIT_TRAIN_ROWS = 16000
VIT_TEST_ROWS = 2000
VIT_DATA = os.path.join(WORK, "vit_data")


def write_vit_data() -> None:
    write_corpus(VIT_DATA, VIT_TRAIN_ROWS, VIT_TEST_ROWS)


# Phases 13 and 22's corpus: 1,152 train rows (18 steps of 64), 128
# validation rows (2 batches) and 128 test rows (2 batches), cut from
# phase 6's for the run's time limit.
ZOO_TRAIN_ROWS = 1280
ZOO_TEST_ROWS = 128
ZOO_DATA = os.path.join(WORK, "zoo_data")


def write_zoo_data() -> None:
    if not os.path.isdir(ZOO_DATA):
        write_corpus(ZOO_DATA, ZOO_TRAIN_ROWS, ZOO_TEST_ROWS)


def write_corpus(root: str, train_rows: int, test_rows: int) -> None:
    """``train_rows`` train and ``test_rows`` test rows of the synthetic
    corpus written to ROOT/MNIST/raw in the IDX format, so that ``train``
    reads a smaller MNIST."""
    import struct

    import numpy as np

    from distributedpytorch_tpu_torch.data import io

    raw = os.path.join(root, "MNIST", "raw")
    os.makedirs(raw, exist_ok=True)
    tr_x, tr_y, te_x, te_y = io.make_synthetic()
    for name, a in (("train-images-idx3-ubyte", tr_x[:train_rows]),
                    ("train-labels-idx1-ubyte", tr_y[:train_rows]),
                    ("t10k-images-idx3-ubyte", te_x[:test_rows]),
                    ("t10k-labels-idx1-ubyte", te_y[:test_rows])):
        with open(os.path.join(raw, name), "wb") as f:
            f.write(struct.pack(">HBB", 0, 0x08, a.ndim))
            f.write(struct.pack(">" + "I" * a.ndim, *a.shape))
            f.write(np.ascontiguousarray(a, np.uint8).tobytes())


def phase_train():
    write_vit_data()
    rsl = os.path.join(WORK, "train_rsl")
    wall, log = run_cli(["train", "--model", "vit", "--attention", "flash",
                         "-e", "1"], rsl, data=VIT_DATA)
    launches, steps, evals = parse_launches(log, "train")
    tensor_core = parse_tensor_core_launches(log, "train")
    n_train = int(VIT_TRAIN_ROWS * 0.9)
    want_steps = math.ceil(n_train / TRAIN_BATCH)
    want_evals = math.ceil((VIT_TRAIN_ROWS - n_train) / TRAIN_BATCH)
    want = {"flash_fwd": DEPTH * (steps + evals), "flash_dq": DEPTH * steps,
            "flash_dkv": DEPTH * steps, "conv_dw": 0}
    # the vit's bf16 K1, K2 and K3 all take the tensor cores
    want_tc = dict(want)
    say(f"train: launches {launches} over {steps} steps and {evals} eval "
        f"batches; formula {want}; on the tensor cores {tensor_core}, "
        f"formula {want_tc}")
    if (steps, evals) != (want_steps, want_evals) or launches != want \
            or tensor_core != want_tc:
        fail(f"train launches {launches} (tensor-core {tensor_core}) over "
             f"{steps} steps / {evals} eval batches do not match the "
             f"formula {want} (tensor-core {want_tc}) at {want_steps} "
             f"steps / {want_evals} eval batches")
    check_epoch_log("train", log, steps, wall)
    return launches, tensor_core, os.path.join(rsl,
                                               "bestmodel-mnist-vit.ckpt")


def check_epoch_log(tag: str, log: str, steps: int, wall: float) -> None:
    """Prints one epoch's throughput, validation accuracy and the mean
    train loss of its first and last 10% of steps from its test.log; fails
    unless the accuracy is at least twice chance and the loss fell.
    samples/s/chip is the global batch (TRAIN_BATCH per rank) a second
    over the ranks, so over TRAIN_BATCH it is steps/s."""
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
    say(f"{tag}: one epoch of {steps} steps in {wall:.1f}s of process "
        f"wall; train pass {sps:,.0f} samples/s/chip, "
        f"{sps / TRAIN_BATCH:.1f} steps/s; validation acc {valid_acc:.2f}% "
        f"(chance 10%); mean train loss first {k_first} steps "
        f"{m_first:.5f}, last {steps - k_last} steps {last_mean:.5f}")
    if valid_acc < 20.0:
        fail(f"{tag}: validation accuracy {valid_acc}% is under twice "
             f"chance")
    if not last_mean < m_first:
        fail(f"{tag}: the train loss did not fall: first 10% {m_first}, "
             f"last 10% {last_mean}")


# -- phases 7 and 8: resume, and test on the trained model -----------------

def phase_resume_and_test(ckpt_path: str) -> None:
    """The uninterrupted run of phase 7 and the ``test`` of phase 8 run at
    once (neither is timed), then the resumed run."""
    import torch

    base = ["train", "--model", "vit", "--attention", "flash", "--debug",
            "--keep-ckpts", "2", "-e", "2"]
    rsl_a = os.path.join(WORK, "resume_a")
    rsl_b = os.path.join(WORK, "resume_b")
    _, (_, log) = finish_all([
        start_cli(base, rsl_a),
        start_cli(["test", "-f", ckpt_path, "--attention", "flash"],
                  os.path.join(WORK, "test_rsl"), data=VIT_DATA)])
    os.makedirs(rsl_b, exist_ok=True)
    first = "checkpoint-mnist-vit-000.ckpt"
    shutil.copy(os.path.join(rsl_a, first), os.path.join(rsl_b, first))
    _, log_b = run_cli(base + ["-f", os.path.join(rsl_b, first)], rsl_b)

    acc_cli = re.search(r"Time: \d+m \d+s, Acc: ([\d.]+)%", log).group(1)
    launches, _, evals = parse_launches(log, "test")
    acc_here, correct, n = eval_accuracy(ckpt_path, "vit", VIT_DATA)
    say(f"test: `test -f` accuracy {acc_cli}% ({evals} eval batches, "
        f"launches {launches}); in-process eval {acc_here}% "
        f"({correct}/{n})")
    if acc_cli != acc_here or launches["flash_fwd"] != DEPTH * evals \
            or launches["flash_dq"] or launches["flash_dkv"] \
            or launches["conv_dw"] or n != VIT_TEST_ROWS:
        fail("test's accuracy or launches disagree with the in-process "
             "eval")

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
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
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

        def us(tags):
            return sum(e.self_device_time_total for e in kernels
                       if any(t in e.key for t in tags)) / reps

        def count(tags):
            return sum(e.count for e in kernels
                       if any(t in e.key for t in tags)) / reps

        # K1, K2 and K3 on either route (the tensor-core kernels are
        # *_mma_*), their time a launch and their tensor-core launches
        parts = "; ".join(
            f"{n} {us(tags):.2f} us/step in {count(tags):.0f} launches "
            f"({count((tags[1],)):.0f} tensor-core), "
            f"{us(tags) / max(count(tags), 1):.2f} us a launch "
            f"({100 * us(tags) / 1e3 / dev_ms:.1f}%)"
            for n, tags in (("K1", ("flash_fwd_kernel", "flash_fwd_mma")),
                            ("K2", ("flash_dq_kernel", "flash_dq_mma")),
                            ("K3", ("flash_dkv_kernel", "flash_dkv_mma"))))
        say(f"profile: train step, {att}, batch {TRAIN_BATCH} bf16: wall "
            f"{wall_ms:.3f} ms/step, device {dev_ms:.3f} ms in "
            f"{n_kern:.0f} kernels a step (idle "
            f"{100 * (1 - dev_ms / wall_ms):.1f}%); {parts}")
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)
        say("profile:   top: " + "; ".join(
            f"{e.key[:48]} {e.self_device_time_total / reps:.1f}us"
            f"x{e.count // reps}" for e in top[:6]))



# -- phase 10: K5 against its plain version ---------------------------------

# The cnn's convs with K5 (Conv_1..Conv_3): (H, W, Ci, Co) at batch B.
CNN_CONVS = ((28, 28, 32, 32), (14, 14, 32, 64), (14, 14, 64, 64))
# K5 against its plain version, relative to the plain version's largest
# value, in both dtypes: both sum the same f32 products of the same
# inputs, in other orders.
TOL_DW = 1e-5


def dw_bound_ms(b: int, h: int, w: int, ci: int, co: int, dtype_name: str):
    """Least time for K5: x and dy read once, the f32 dW written once, or
    its 2 * B*H*W * 9*Ci*Co operations at the card's peak for the input
    type, whichever is larger."""
    item = 2 if dtype_name == "bfloat16" else 4
    nbytes = b * h * w * (ci + co) * item + 9 * ci * co * 4
    ops = 2 * b * h * w * 9 * ci * co
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_conv_dw():
    """K5's routes against the plain version: each bf16 case that the rule
    sends to the tensor cores runs both routes (the scalar one forced)."""
    import torch
    from torch.nn.grad import conv2d_weight

    from distributedpytorch_tpu_torch.ops import conv

    cases = [(b,) + shape + (dt,) for shape in CNN_CONVS for b in (1, 16, 64)
             for dt in ("bfloat16", "float32")]
    cases += [(3, 9, 7, 32, 48, dt) for dt in ("bfloat16", "float32")]
    # bf16 that the rule sends to the scalar kernel (channels not multiples
    # of 8), and a tensor-core case whose last split ends in a ragged
    # chunk (715 = 11 x 64 + 11 rows) with tiles wider than the channels
    cases += [(2, 9, 7, 36, 20, "bfloat16"), (5, 13, 11, 40, 24, "bfloat16")]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    rows = {}
    for (b, h, w, ci, co, dt) in cases:
        dtype = getattr(torch, dt)
        shape = (b, h, w, ci, co)
        # channels_last NCHW activations and gradients, as the cnn holds
        # them; K5 reads their NHWC views without a copy
        x = torch.randn((b, ci, h, w), generator=gen, device="cuda").to(
            dtype).contiguous(memory_format=torch.channels_last)
        dy = torch.randn((b, co, h, w), generator=gen, device="cuda").to(
            dtype).contiguous(memory_format=torch.channels_last)
        xn, dyn = x.permute(0, 2, 3, 1), dy.permute(0, 2, 3, 1)
        tc = conv.tensor_core_route(dtype, ci, co, xn.stride(), dyn.stride(),
                                    xn.data_ptr(), dyn.data_ptr())
        route = "tensor_core" if tc else "scalar"
        ref = conv.conv3x3_dw_plain(xn, dyn)
        before = (conv.conv3x3_dw.launches,
                  conv.conv3x3_dw.tensor_core_launches)
        got = conv.conv3x3_dw(xn, dyn)
        again = conv.conv3x3_dw(xn, dyn)
        torch.cuda.synchronize()
        if (conv.conv3x3_dw.launches,
                conv.conv3x3_dw.tensor_core_launches) != (
                before[0] + 2, before[1] + 2 * tc):
            fail(f"K5 wrapper did not count its {route} launches at "
                 f"{shape}")
        checked = {route: (got, again)}
        if tc:
            checked["scalar"] = (conv._launch(xn, dyn, tensor_core=False),
                                 conv._launch(xn, dyn, tensor_core=False))
        errs = {}
        for r, (a, a2) in checked.items():
            torch.cuda.synchronize()
            if not torch.equal(a, a2):
                fail(f"K5's {r} route is not deterministic at {shape} {dt}")
            errs[r] = rel_err(a, ref)
            if not (math.isfinite(errs[r][1]) and errs[r][1] <= TOL_DW):
                fail(f"K5's {r} route disagrees with its plain version at "
                     f"{shape} {dt}: rel err {errs[r][1]} (tol {TOL_DW})")
        main = (b, dt) == (TRAIN_BATCH, "bfloat16") and \
            (h, w, ci, co) in CNN_CONVS
        fns = {"kernel": lambda: conv.conv3x3_dw(xn, dyn)}
        if tc:
            fns["scalar"] = lambda: conv._launch(xn, dyn, tensor_core=False)
        if main:
            fns["plain"] = lambda: conv.conv3x3_dw_plain(xn, dyn)
        fns["cudnn"] = lambda: conv2d_weight(x, (co, ci, 3, 3), dy,
                                             padding=1)
        call = {n: time_ms(f) for n, f in fns.items()}
        dev = {n: spread(t) for n, t in
               device_ms_tries(fns, tries=timing_tries(main)).items()}
        b_ms, b_by = dw_bound_ms(b, h, w, ci, co, dt)
        plan = (conv.mma_plan(b * h * w, ci, co) if tc
                else conv.split_plan(b * h * w, 9 * ci, co))
        say(f"K5 {shape} {dt}, {route} route: rel err "
            + ", ".join(f"{r} {e[1]:.3g} (abs {e[0]:.3g})"
                        for r, e in errs.items())
            + f" (tol {TOL_DW:g}), deterministic; device_ms median "
            f"[least, most of {timing_tries(main)} tries] "
            + " ".join(f"{n}={fmt_ms(d[0])} [{fmt_ms(d[1])}, {fmt_ms(d[2])}]"
                       for n, d in dev.items())
            + "; call_ms " + " ".join(f"{n}={c:.5f}" for n, c in call.items())
            + f"; bound_us={b_ms * 1e3:.3f} ({b_by}); plan {plan}")
        rows[(b, h, w, ci, co, dt)] = dict(
            route=route, max_abs_err=errs[route][0], rel_err=errs[route][1],
            ms=dev["kernel"][0], ms_least=dev["kernel"][1],
            ms_most=dev["kernel"][2],
            scalar_ms=dev["scalar"][0] if tc else None,
            plain_ms=dev["plain"][0] if main else None,
            library_ms=dev["cudnn"][0], bound_ms=b_ms, bound_by=b_by,
            call_ms=call["kernel"], plain_call_ms=call.get("plain"),
            library_call_ms=call["cudnn"])
    return rows


def conv_dw_main_row(rows) -> dict:
    """K5's entry of the kernels line: one train step's three launches at
    batch 64 bf16, summed (times, bounds; each time the median of 3
    traces), the worst error, the route, and the shapes one by one."""
    parts = [rows[(TRAIN_BATCH,) + shape + ("bfloat16",)]
             for shape in CNN_CONVS]
    for key in ("ms", "plain_ms", "library_ms"):
        if any(p[key] is None for p in parts):
            fail(f"torch.profiler returned no device events for K5's "
                 f"{key} at the cnn's shapes")
    total = {k: sum(p[k] for p in parts) for k in
             ("ms", "plain_ms", "library_ms", "bound_ms", "call_ms",
              "plain_call_ms", "library_call_ms")}
    return dict(max_abs_err=max(p["max_abs_err"] for p in parts),
                rel_err=max(p["rel_err"] for p in parts),
                bound_by="bytes" if all(p["bound_by"] == "bytes"
                                        for p in parts) else "operations",
                k5_route="+".join(sorted({p["route"] for p in parts})),
                per_step_of=[list((TRAIN_BATCH,) + s) for s in CNN_CONVS],
                per_shape_ms=[p["ms"] for p in parts],
                per_shape_ms_least=[p["ms_least"] for p in parts],
                per_shape_ms_most=[p["ms_most"] for p in parts],
                per_shape_scalar_ms=[p["scalar_ms"] for p in parts],
                per_shape_library_ms=[p["library_ms"] for p in parts],
                **total)


# -- phase 11: cnn and resnet train steps on the card against the CPU -------

# f32, card against CPU, each gradient relative to its largest value.  The
# two devices' forwards differ in the last bits, and a ReLU or max-pool
# decision at a value within that rounding of a tie flips between them:
# one pixel's rank-1 term of a dW moves, against sums of as few as 16*7*7
# = 784 terms in resnet18's last stage.  Measured on the card: 3e-3 (cnn,
# batch 64) and 4.4e-2 (resnet18, batch 16), the same with and without
# K5.  So f32 is held to these, and two tight checks carry the weight:
# the same step in f64 on an identity affine (inputs bit-identical on both
# devices, so no decision can flip), and on the card the cnn's K5 step
# against its stock-dW step (the same forward, bit for bit).
TOL_STEP_F32 = {"cnn": 1e-2, "resnet": 1e-1}
# f64 graph: the loss head still runs in f32 (the logits are f32), where
# the two devices' softmax differs by an ulp: 2.2e-6 seen on head.weight
TOL_STEP_F64 = 1e-5
TOL_K5_STEP = 1e-5      # K5 against cuDNN's wgrad under one forward
TOL_STATS = 1e-4        # BatchNorm running statistics, f32 and f64
PARITY_BATCH = {"cnn": TRAIN_BATCH, "resnet": 16}


def identity_affine(b: int, device):
    """No rotation, the whole 28x28 image as the crop: the warp's weights
    are multiples of 1/16, so with an f64 output the augmented input is
    the same on both devices."""
    import torch

    zeros = torch.zeros(b, device=device)
    return (zeros, zeros, zeros, zeros + 28.0, zeros + 28.0)


def f64_policy():
    import torch

    from distributedpytorch_tpu_torch.precision import PrecisionPolicy

    return PrecisionPolicy(name="f64", param_dtype=torch.float32,
                           compute_dtype=torch.float64,
                           accum_dtype=torch.float64)


def one_step(name: str, device: str, policy, k5: bool, affine_u) -> tuple:
    """One train step of the registry's ``name`` from SEED's weights on
    the first PARITY_BATCH rows of the synthetic train split: (loss,
    {param: grad}, {buffer: value}, K5 launches).  ``affine_u`` is a
    (B, 5) uniform draw, or None for the identity affine."""
    import numpy as np
    import torch

    from distributedpytorch_tpu_torch.data import augment
    from distributedpytorch_tpu_torch.data.datasets import load_dataset
    from distributedpytorch_tpu_torch.models import (get_model,
                                                     get_model_input_size)
    from distributedpytorch_tpu_torch.ops import conv
    from distributedpytorch_tpu_torch.ops.losses import cross_entropy
    from distributedpytorch_tpu_torch.train.engine import Engine

    batch = PARITY_BATCH[name]
    ds = load_dataset("mnist", os.path.join(WORK, "data"), SEED,
                      synthetic_fallback=True)
    images = ds.splits["train"].images[:batch]
    labels = ds.splits["train"].labels[:batch].astype(np.int64)
    model = get_model(name, ds.nb_classes, policy, device=device,
                      pallas_dw=k5)
    engine = Engine(model, cross_entropy, ds.mean, ds.std,
                    get_model_input_size(name), policy, device)
    state = engine.init_state(torch.Generator().manual_seed(SEED))
    affine = (identity_affine(batch, device) if affine_u is None
              else augment.affine_from_uniform(
                  torch.from_numpy(affine_u).to(device), 28, 28))
    before = conv.conv3x3_dw.launches
    _, m = engine.train_step_affine(
        state, torch.from_numpy(images).to(device),
        torch.from_numpy(labels).to(device),
        torch.ones(batch, dtype=torch.bool, device=device), affine)
    if device == "cuda":
        torch.cuda.synchronize()
    return (m["loss"].item(),
            {n: p.grad.detach().cpu() for n, p in model.named_parameters()},
            {n: b.detach().cpu() for n, b in model.named_buffers()},
            conv.conv3x3_dw.launches - before)


def worst(a: dict, b: dict) -> tuple:
    """(name, relative error) of the tensor of ``a`` furthest from ``b``'s,
    relative to ``b``'s largest value; ("none", 0.0) for no tensors."""
    return max(((n, rel_err(a[n], t)[1]) for n, t in b.items()),
               key=lambda t: t[1], default=("none", 0.0))


def phase_cnn_step_parity() -> None:
    import numpy as np

    from distributedpytorch_tpu_torch.precision import PRESETS

    for name in ("cnn", "resnet"):
        k5 = name == "cnn"
        u = np.random.default_rng(SEED).random((PARITY_BATCH[name], 5),
                                               dtype=np.float32)
        checks = []
        for label, policy, draws, tol in (
                ("f32", PRESETS["f32"], u, TOL_STEP_F32[name]),
                ("f64", f64_policy(), None, TOL_STEP_F64)):
            card = one_step(name, "cuda", policy, k5 and label == "f32",
                            draws)
            cpu = one_step(name, "cpu", policy, k5 and label == "f32",
                           draws)
            g, st = worst(card[1], cpu[1]), worst(card[2], cpu[2])
            checks.append((label, g, st, tol, card, cpu))
        if k5:
            stock = one_step(name, "cuda", PRESETS["f32"], False, u)
            g = worst(checks[0][4][1], stock[1])
            say(f"step: cnn f32 on the card, K5 vs cuDNN's wgrad under the "
                f"same forward: worst gradient {g[0]} rel err {g[1]:.3g} "
                f"(tol {TOL_K5_STEP:g}); K5 launches "
                f"{checks[0][4][3]} and {stock[3]}")
            if not g[1] <= TOL_K5_STEP or checks[0][4][3] != 3 \
                    or stock[3] != 0:
                fail(f"the cnn step with K5 disagrees with the stock dW on "
                     f"the card ({g}) or launched K5 "
                     f"{checks[0][4][3]} times (want 3)")
        for label, g, st, tol, card, cpu in checks:
            say(f"step: {name} {label} train step (batch "
                f"{PARITY_BATCH[name]}"
                f"{', identity affine' if label == 'f64' else ''}), card vs "
                f"CPU: loss {card[0]:.9f} vs {cpu[0]:.9f}; worst gradient "
                f"{g[0]}: rel err {g[1]:.3g} (tol {tol:g}) over "
                f"{len(cpu[1])} parameters; worst BN statistic {st[0]}: rel "
                f"err {st[1]:.3g} (tol {TOL_STATS:g}) over {len(cpu[2])} "
                f"buffers")
            if not (math.isfinite(g[1]) and g[1] <= tol
                    and st[1] <= TOL_STATS
                    and abs(card[0] - cpu[0]) <= 1e-5 * abs(cpu[0])):
                fail(f"the {name} {label} train step on the card disagrees "
                     f"with the CPU's: {g}, {st}")
        if name == "resnet" and not checks[0][5][2]:
            fail("the resnet step has no BatchNorm statistics to compare")
    check_pool_ties()


def check_pool_ties() -> None:
    """The max pools' routing on the card equals the CPU's (which
    tests/test_torch_cnn.py pins to the JAX op), ties included: the 2x2/2
    pool of the cnn and the 3x3/2 (-inf padded) pool of the resnet, on
    channels_last inputs, bf16 and f32.  The argmax indices must be equal
    and the input gradients equal, except that the 3x3/2 pool's
    overlapping windows sum their gradients at another precision in bf16
    (one bf16 rounding, 1e-2 of the largest value)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    rng = np.random.default_rng(SEED)
    x = np.maximum(rng.standard_normal((4, 8, 12, 12)), 0.0)
    x[:, :, ::3, :] = 1.0                # rows of equal values
    g = rng.standard_normal((4, 8, 6, 6))
    for dt in ("bfloat16", "float32"):
        for k, pad in ((2, 0), (3, 1)):
            got = []
            for device in ("cuda", "cpu"):
                t = torch.from_numpy(x).to(device, getattr(torch, dt)) \
                    .contiguous(memory_format=torch.channels_last) \
                    .requires_grad_()
                y, idx = F.max_pool2d_with_indices(t, k, 2, pad)
                y.backward(torch.from_numpy(g).to(device, y.dtype))
                got.append((y.detach().cpu(), idx.cpu(), t.grad.cpu()))
            (y0, i0, g0), (y1, i1, g1) = got
            tol = 1e-2 if (k, dt) == (3, "bfloat16") else 0.0
            ok = torch.equal(y0, y1) and torch.equal(i0, i1) \
                and rel_err(g0, g1)[1] <= tol \
                and torch.equal(g0 != 0, g1 != 0)
            if not ok:
                fail(f"the {k}x{k}/2 max pool differs on the card in {dt}: "
                     f"indices equal {torch.equal(i0, i1)}, gradient rel "
                     f"err {rel_err(g0, g1)[1]}")
    say(f"step: max pools 2x2/2 and 3x3/2 on the card route as the CPU's "
        f"(indices and gradient support equal; {int((x == 0).sum())} zeros "
        f"and rows of equal ones in the input)")


# -- phase 12: the cnn path with K5 (the slice's kernel main path) ----------

# Validation accuracy of the K5 epoch against the stock conv's epoch from
# the same seed: within 2.0 percentage points (the spread used; the stock
# path's seed-to-seed difference is printed beside it).
ACC_SPREAD = 2.0


def cnn_epoch(pallas_dw: bool, seed: int) -> dict:
    """One epoch of Engine-driven cnn training (844 steps of 64, bf16),
    as bench.py drives the JAX one, then validation.  K5's count is set
    to 0 just before and read just after."""
    import torch

    from distributedpytorch_tpu_torch import utils
    from distributedpytorch_tpu_torch.data.datasets import load_dataset
    from distributedpytorch_tpu_torch.data.pipeline import ResidentLoader
    from distributedpytorch_tpu_torch.models import get_model
    from distributedpytorch_tpu_torch.ops import conv
    from distributedpytorch_tpu_torch.ops.losses import cross_entropy
    from distributedpytorch_tpu_torch.precision import PRESETS
    from distributedpytorch_tpu_torch.train.engine import Engine

    ds = load_dataset("mnist", os.path.join(WORK, "data"), seed,
                      synthetic_fallback=True)
    policy = PRESETS["bf16"]
    train = ResidentLoader(ds.splits["train"], TRAIN_BATCH, True, seed,
                           "cuda")
    valid = ResidentLoader(ds.splits["valid"], TRAIN_BATCH, False, seed,
                           "cuda")
    model = get_model("cnn", ds.nb_classes, policy, device="cuda",
                      pallas_dw=pallas_dw)
    engine = Engine(model, cross_entropy, ds.mean, ds.std, 28, policy,
                    "cuda", steps_per_epoch=len(train))
    state = engine.init_state(torch.Generator().manual_seed(seed))
    torch.cuda.synchronize()
    conv.conv3x3_dw.launches = 0
    conv.conv3x3_dw.tensor_core_launches = 0
    t0 = time.perf_counter()
    hist = []
    for i, (images, labels, v) in enumerate(train.epoch(0)):
        gen = utils.step_generator(seed, 0, i, "cuda")
        _, m = engine.train_step(state, images, labels, v, gen)
        hist.append(m["loss"])
    losses = torch.stack(hist).cpu().numpy()
    wall = time.perf_counter() - t0
    correct = n = 0.0
    for images, labels, v in valid.epoch(0):
        m = engine.eval_step(state, images, labels, v)
        correct += m["correct"].item()
        n += m["valid"].item()
    launches = conv.conv3x3_dw.launches
    tc_launches = conv.conv3x3_dw.tensor_core_launches
    k = max(1, len(losses) // 10)
    return dict(steps=len(losses), launches=launches,
                tc_launches=tc_launches, wall=wall,
                acc=100.0 * correct / n, first=float(losses[:k].mean()),
                last=float(losses[-k:].mean()))


def phase_cnn_epoch() -> int:
    runs = {("k5", SEED): cnn_epoch(True, SEED),
            ("stock", SEED): cnn_epoch(False, SEED),
            ("stock", SEED + 1): cnn_epoch(False, SEED + 1)}
    for (path, seed), r in runs.items():
        say(f"cnn: epoch, {path} dW, seed {seed}: {r['steps']} steps in "
            f"{r['wall']:.2f}s ({r['steps'] / r['wall']:.1f} steps/s, "
            f"{r['steps'] * TRAIN_BATCH / r['wall']:,.0f} samples/s), "
            f"validation acc {r['acc']:.2f}% (chance 10%), mean train loss "
            f"first 10% {r['first']:.5f} last 10% {r['last']:.5f}, K5 "
            f"launches {r['launches']} ({r['tc_launches']} on the tensor "
            f"cores)")
    k5, stock = runs[("k5", SEED)], runs[("stock", SEED)]
    seed_diff = abs(stock["acc"] - runs[("stock", SEED + 1)]["acc"])
    say(f"cnn: K5 vs stock dW accuracy {k5['acc']:.2f}% vs "
        f"{stock['acc']:.2f}% (spread used {ACC_SPREAD} points; the stock "
        f"path's seed-to-seed difference {seed_diff:.2f} points)")
    if k5["launches"] != 3 * k5["steps"] or k5["steps"] != math.ceil(
            54000 / TRAIN_BATCH):
        fail(f"K5 launches {k5['launches']} over {k5['steps']} steps: "
             f"expected 3 per step")
    if k5["tc_launches"] != k5["launches"]:
        fail(f"only {k5['tc_launches']} of the cnn's {k5['launches']} K5 "
             f"launches took the tensor-core route")
    if stock["launches"]:
        fail("the stock cnn launched K5")
    if k5["acc"] < 20.0 or not k5["last"] < k5["first"]:
        fail(f"the cnn with K5 did not learn: acc {k5['acc']}%, loss "
             f"{k5['first']} -> {k5['last']}")
    if abs(k5["acc"] - stock["acc"]) > ACC_SPREAD:
        fail(f"the cnn with K5 reaches {k5['acc']}% against the stock "
             f"conv's {stock['acc']}%")
    return k5["launches"]


# -- phase 13: the reference's job under torchrun ---------------------------

def eval_accuracy(ckpt_path: str, name: str, data: str = "") -> tuple:
    """In-process eval of a checkpoint on the test split of ``data``
    (WORK/data by default), batch 64 bf16: (accuracy to 2 decimals as
    `test` logs it, correct, rows)."""
    from distributedpytorch_tpu_torch import checkpoint as ckpt
    from distributedpytorch_tpu_torch.data.datasets import load_dataset
    from distributedpytorch_tpu_torch.data.pipeline import ResidentLoader
    from distributedpytorch_tpu_torch.models import (get_model,
                                                     get_model_input_size)
    from distributedpytorch_tpu_torch.ops.losses import cross_entropy
    from distributedpytorch_tpu_torch.precision import PRESETS
    from distributedpytorch_tpu_torch.train.engine import Engine, TrainState

    ds = load_dataset("mnist", data or os.path.join(WORK, "data"), SEED,
                      synthetic_fallback=True)
    policy = PRESETS["bf16"]
    model = get_model(name, ds.nb_classes, policy,
                      attention="flash" if name == "vit" else "full",
                      device="cuda")
    ckpt.restore_for_serving(ckpt_path, model)
    engine = Engine(model, cross_entropy, ds.mean, ds.std,
                    get_model_input_size(name), policy, "cuda")
    loader = ResidentLoader(ds.splits["test"], TRAIN_BATCH, False, SEED,
                            "cuda")
    correct = n = 0.0
    for images, labels, valid in loader.epoch(0):
        m = engine.eval_step(TrainState(model, None), images, labels, valid)
        correct += m["correct"].item()
        n += m["valid"].item()
    return f"{correct / n * 100:.2f}", int(correct), int(n)


def phase_reference_job() -> None:
    """On phase 22's corpus (cut from the whole synthetic one for the
    run's time limit: 18 steps instead of 844).  The two short trainings
    run beside the resnet's (none of the three is timed here), and `test`
    after it."""
    write_zoo_data()
    rsl = os.path.join(WORK, "resnet_rsl")
    (wall, log), *debug = finish_all(
        [start_cli(["train", "-e", "1"], rsl, launcher=TORCHRUN,
                   data=ZOO_DATA)]
        + [start_cli(["train", "--model", name, "--debug", "-e", "1"],
                     os.path.join(WORK, f"{name}_debug"))
           for name in ("mlp", "cnn")])
    if "process: 0/1, world size: 1, backend: nccl" not in log:
        fail("the torchrun launch did not join an NCCL process group")
    launches, steps, evals = parse_launches(log, "train")
    valid_acc = float(re.search(r"Validation  \| Loss: [\d.]+ +\| Acc: "
                                r"([\d.]+)%", log).group(1))
    train_loss = float(re.search(r"Train       \| Loss: ([\d.]+)",
                                 log).group(1))
    sps = float(re.search(r"Throughput  \| ([\d,]+) samples/s/chip",
                          log).group(1).replace(",", ""))
    say(f"resnet: `torchrun train` (default model, 224, NCCL): {steps} "
        f"steps and {evals} eval batches in {wall:.1f}s of process wall; "
        f"train pass {sps:,.0f} samples/s/chip ({sps / TRAIN_BATCH:.1f} "
        f"steps/s); mean train loss {train_loss:.5f}, validation acc "
        f"{valid_acc:.2f}%; launches {launches}")
    if steps != math.ceil(int(ZOO_TRAIN_ROWS * 0.9) / TRAIN_BATCH) \
            or any(launches.values()):
        fail(f"resnet train ran {steps} steps with launches {launches}")
    best = os.path.join(rsl, "bestmodel-mnist-resnet.ckpt")
    _, tlog = run_cli(["test", "-f", best], os.path.join(WORK, "resnet_test"),
                      launcher=TORCHRUN, data=ZOO_DATA)
    acc_cli = re.search(r"Time: \d+m \d+s, Acc: ([\d.]+)%", tlog).group(1)
    acc_here, correct, n = eval_accuracy(best, "resnet", ZOO_DATA)
    say(f"resnet: `torchrun test -f` accuracy {acc_cli}%; in-process eval "
        f"{acc_here}% ({correct}/{n})")
    if acc_cli != acc_here:
        fail("resnet test's accuracy disagrees with the in-process eval")
    for name, (wall, log) in zip(("mlp", "cnn"), debug):
        acc = re.search(r"Validation  \| Loss: [\d.]+ +\| Acc: ([\d.]+)%",
                        log).group(1)
        say(f"{name}: `train --debug -e 1` finished in {wall:.1f}s (run "
            f"beside the resnet's and the other), validation acc {acc}%")


# -- phase 14: two ranks on the one card -------------------------------------

# Two ranks (gloo over CUDA tensors) against one rank fed the same global
# batch and draws, TF32 off, each tensor relative to its largest value.
# f32: the sums run in other orders (per rank then across ranks, cuDNN at
# half the batch per call), 1e-4 for the cnn; the resnet's ReLU decisions
# after BatchNorm flip at f32 rounding as in phase 11 (5.7e-3 seen), so
# it is held to 5e-2 in f32 and, on an identity affine in f64, to 1e-6
# (the gradients are still cast to the f32 parameters per rank).
TOL_DDP = {("cnn", "f32"): 1e-4, ("resnet_shallow", "f32"): 5e-2,
           ("resnet_shallow", "f64"): 1e-6}
DDP_CASES = tuple(TOL_DDP)
DDP_GLOBAL_BATCH = 16
# one rank of a world: three SGD steps, shared with tests/test_torch_ddp.py
DDP_CHILD = os.path.join(ROOT, "tests", "_torch_ddp_child.py")


def run_worlds(worlds: list) -> list:
    """Starts every world of ``worlds`` at once, each (name, world size,
    child script, arguments before OUT, arguments after it): every rank a
    ``python SCRIPT ... OUT.pt ... --device cuda`` process on the card
    (several ranks run gloo over CUDA tensors), each world on its own
    rendezvous port.  Returns each world's per-rank results (the OUT.pt
    files, which the children write) once all ranks have exited."""
    import torch

    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT", "LOCAL_WORLD_SIZE")}
    procs, outs, ports = [], [], set()
    try:
        for name, world, script, head, tail in worlds:
            port = free_port()
            while port in ports:
                port = free_port()
            ports.add(port)
            outs.append([])
            for rank in range(world):
                extra = {} if world == 1 else dict(
                    WORLD_SIZE=str(world), RANK=str(rank),
                    LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                    MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
                out = os.path.join(WORK, f"{name}-r{rank}.pt")
                outs[-1].append(out)
                with open(out[:-3] + ".log", "w") as f:
                    procs.append((name, out, subprocess.Popen(
                        [sys.executable, script, *head, out, "--device",
                         "cuda", *tail], cwd=ROOT, env={**env, **extra},
                        stdout=f, stderr=subprocess.STDOUT)))
        deadline = time.monotonic() + 300
        for name, out, proc in procs:
            try:
                rc = proc.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                rc = None
            if rc != 0:
                with open(out[:-3] + ".log") as f:
                    fail(f"child {name} exited with {rc}:\n"
                         f"{f.read()[-3000:]}")
    finally:
        for *_, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return [[torch.load(o, weights_only=False) for o in world_outs]
            for world_outs in outs]


def phase_ddp_one_card() -> None:
    import torch

    keys = [(name, label, world) for name, label in DDP_CASES
            for world in (1, 2)]
    worlds = dict(zip(keys, run_worlds([
        (f"ddp-{name}-{label}-w{world}", world, DDP_CHILD, [name],
         ["--global-batch", str(DDP_GLOBAL_BATCH), "--precision", label])
        for name, label, world in keys])))
    for name, label in DDP_CASES:
        one = worlds[(name, label, 1)][0]
        two = worlds[(name, label, 2)]
        if [r["backend"] for r in two] != ["gloo", "gloo"] \
                or one["backend"] is not None:
            fail(f"backends {[r['backend'] for r in two]}: two ranks on one "
                 f"card must run gloo, one rank no process group")
        a = two[0]
        same = all(torch.equal(v, a["state"][k])
                   for k, v in two[1]["state"].items())
        if not same or two[1]["metrics"] != a["metrics"]:
            fail(f"the two ranks of {name} disagree in {label}")
        w = worst(a["state"], one["state"])
        loss_err = max(abs(x[0] - y[0]) for x, y in
                       zip(a["metrics"], one["metrics"]))
        counts_equal = [x[1:] for x in a["metrics"]] == \
            [y[1:] for y in one["metrics"]]
        k5 = [r["k5"] for r in two] + [one["k5"]]
        n_stats = sum("running" in k for k in one["state"])
        tol = TOL_DDP[(name, label)]
        say(f"ddp: {name}, 2 ranks on one card (gloo) vs 1 rank, 3 {label} "
            f"steps on a global batch of {DDP_GLOBAL_BATCH}: worst tensor "
            f"{w[0]} rel err {w[1]:.3g} (tol {tol:g}) over "
            f"{len(one['state'])} tensors ({n_stats} BN statistics); loss "
            f"err {loss_err:.3g}; correct/valid counts equal: "
            f"{counts_equal}; K5 launches per rank {k5}")
        want_k5 = 9 if name == "cnn" else 0
        if not (math.isfinite(w[1]) and w[1] <= tol) \
                or loss_err > 1e-5 or not counts_equal \
                or k5 != [want_k5] * 3:
            fail(f"the 2-rank {name} world does not equal 1 rank in "
                 f"{label}")


# -- phase 15: profiles of the cnn and resnet train steps -------------------

def phase_cnn_profile() -> None:
    """One cnn (K5) and one resnet train step at batch 64 bf16: wall ms
    per step (host clock, synchronized, profiler off), then from a second
    run under torch.profiler the device time, kernels per step, the idle
    share, and K5's share of device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from distributedpytorch_tpu_torch import utils
    from distributedpytorch_tpu_torch.data.datasets import load_dataset
    from distributedpytorch_tpu_torch.data.pipeline import ResidentLoader
    from distributedpytorch_tpu_torch.models import (get_model,
                                                     get_model_input_size)
    from distributedpytorch_tpu_torch.ops import conv
    from distributedpytorch_tpu_torch.ops.losses import cross_entropy
    from distributedpytorch_tpu_torch.precision import PRESETS
    from distributedpytorch_tpu_torch.train.engine import Engine

    ds = load_dataset("mnist", os.path.join(WORK, "data"), SEED,
                      synthetic_fallback=True)
    loader = ResidentLoader(ds.splits["train"], TRAIN_BATCH, True, SEED,
                            "cuda")
    reps = 20
    batches = list(itertools.islice(loader.epoch(0), 5 + 2 * reps))
    for name in ("cnn", "resnet"):
        policy = PRESETS["bf16"]
        model = get_model(name, ds.nb_classes, policy, device="cuda",
                          pallas_dw=name == "cnn")
        engine = Engine(model, cross_entropy, ds.mean, ds.std,
                        get_model_input_size(name), policy, "cuda")
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
        k5_before = conv.conv3x3_dw.launches
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(reps):
                step(5 + reps + i)
            torch.cuda.synchronize()
        k5_launches = (conv.conv3x3_dw.launches - k5_before) / reps
        kernels = device_kernels(prof)
        dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / reps
        n_kern = sum(e.count for e in kernels) / reps
        if dev_ms <= 0:
            say(f"profile: {name} train step: wall {wall_ms:.3f} ms/step; "
                f"device time not measured (no device events)")
            continue
        k5_us = sum(e.self_device_time_total for e in kernels
                    if "conv_dw" in e.key) / reps
        say(f"profile: {name} train step, batch {TRAIN_BATCH} bf16: wall "
            f"{wall_ms:.3f} ms/step, device {dev_ms:.3f} ms in "
            f"{n_kern:.0f} kernels (idle {100 * (1 - dev_ms / wall_ms):.1f}"
            f"%); K5 {k5_us:.2f} us/step "
            f"({100 * k5_us / 1e3 / dev_ms:.1f}% of device time) in "
            f"{k5_launches:g} launches"
            + (f", {k5_us / k5_launches:.2f} us a launch" if k5_launches
               else ""))
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)
        say("profile:   top: " + "; ".join(
            f"{e.key[:48]} {e.self_device_time_total / reps:.1f}us"
            f"x{e.count // reps}" for e in top[:6]))


# -- phase 16: K4, K2p and K3p against their plain versions ------------------

# (label, B, S, H, D, causal, q block, k block, kv_valid, timed): q's
# positions are q_block * S + 0..S-1, k's k_block * S + 0..S-1, as on the
# ring, where the rank of model index m holds block m and sees block
# (m - t) mod M at step t.  The vit's shard on a ring of two is S = 25 of
# its 49 tokens padded to 50 (kv_valid 49), at B = 128 (the data shard's
# 2 x 64 rows).
RING_CASES = (
    ("vit rank-1 q vs rank-0 K/V", 128, 25, 4, 32, False, 1, 0, 49, True),
    ("vit rank-1 q vs its own K/V", 128, 25, 4, 32, False, 1, 1, 49, False),
    ("vit keys all padding", 128, 25, 4, 32, False, 0, 2, 50, False),
    ("causal future block (all masked)", 8, 128, 4, 64, True, 0, 1, None,
     False),
    ("causal past block", 8, 128, 4, 64, True, 1, 0, None, False),
    ("causal diagonal block", 8, 128, 4, 64, True, 1, 1, None, True),
    ("wide heads D=128", 8, 128, 4, 128, False, 1, 0, None, True),
    ("long shard", 2, 500, 4, 64, True, 1, 1, None, True),
)
RING_MAIN = ("vit rank-1 q vs rank-0 K/V", "bfloat16")
# K4's O and lse against the plain version: both f32 from the same f32
# (or exactly widened bf16) inputs, sums in other orders.  K2p/K3p: as
# K2/K3 (TOL_GRAD), relative to the plain version's largest value; K2p's
# delta against partial_delta as K2's (TOL_DELTA).
TOL_O_POS = 2e-5
# K4's f32 O on its bf16 tensor-core route against the plain version: that
# route rounds p to bf16 before the P V product (as FlashAttention-2 and
# SDPA do), which moves O by up to about 2^-9 max|v|; the ring casts its
# merged O to bf16 anyway (ops/attention.py, _ring_local_flash), so the
# error is one bf16 rounding, as for K1's bf16 O (TOL_O).  The scalar route
# and every f32 case stay at TOL_O_POS; lse at TOL_LSE on both routes.
TOL_O_POS_TC = TOL_O["bfloat16"]


def ring_bounds(b, s, h, d, dtype_name, pairs, tensor_core):
    """Least times of K4, K2p, K3p and the backward as the ring step runs
    it ("bwd": K2p then K3p, as one function) (ms, "bytes" or
    "operations"): each input read once and each output written once, or
    the products on the ``pairs`` (q, k) pairs that the masks keep (K4: 2,
    K2p: 3, K3p: 4, the backward: 5 products of 2 * D operations a pair
    and head) at the card's peak for the input type.  K4 reads q, k, v
    and two (S,) int32 position vectors and writes the f32 O and lse.  K2p
    reads q, k, v, the f32 dO and O, lse, dlse and the positions, and
    writes dq and delta, and on the ``tensor_core`` route the bf16 dO;
    K3p reads q, k, v, that dO (else the f32 one), lse, delta and the
    positions, and writes dk and dv.  The backward reads q, k, v, the f32
    dO and O, lse, dlse and the positions and writes dq, dk and dv."""
    item = 2 if dtype_name == "bfloat16" else 4
    t = b * s * h * d
    rows = b * h * s * 4
    pos = 2 * s * 4
    do_k3 = 2 if tensor_core else 4
    nbytes = {"flash_fwd_pos": 3 * t * item + pos + 4 * t + rows,
              "flash_dq_pos": 4 * t * item + 8 * t + 3 * rows + pos
              + (2 * t if tensor_core else 0),
              "flash_dkv_pos": 5 * t * item + do_k3 * t + 2 * rows + pos,
              "bwd": 6 * t * item + 8 * t + 2 * rows + pos}
    products = {"flash_fwd_pos": 2, "flash_dq_pos": 3, "flash_dkv_pos": 4,
                "bwd": 5}
    out = {}
    for name, nb in nbytes.items():
        t_bytes = nb / HBM_BYTES_PER_S * 1e3
        t_ops = (products[name] * 2 * b * h * pairs * d
                 / PEAK_OPS_PER_S[dtype_name] * 1e3)
        out[name] = ((t_bytes, "bytes") if t_bytes >= t_ops
                     else (t_ops, "operations"))
    return out


def phase_ring_kernels():
    """K4 against its plain version, and K2p/K3p against theirs: each case
    on the route the rule picks and, at a tensor-core case, on the scalar
    route too (forced), K4 held to TOL_O_POS_TC on the tensor cores and
    TOL_O_POS on the scalar route (rows with no key kept: O exactly 0 and
    lse -1e30 on both), K2p/K3p to TOL_GRAD; K2p's delta against
    ``partial_delta``; two calls bit-identical; at the timed cases times
    of K4, K2p, K3p and the backward as the ring step runs it (K2p, which
    computes delta and rounds dO, then K3p) beside the old line
    (``partial_delta``, then the scalar K2p and K3p) and SDPA's."""
    import torch
    import torch.nn.functional as F

    from distributedpytorch_tpu_torch.ops import flash_attention as tfa

    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    rows = {}
    wrappers = {"flash_fwd_pos": tfa.flash_attention_partial_fwd,
                "flash_dq_pos": tfa.flash_attention_partial_dq,
                "flash_dkv_pos": tfa.flash_attention_partial_dkv}

    def counts():
        return {n: (w.launches, w.tensor_core_launches)
                for n, w in wrappers.items()}

    for (label, b, s, h, d, causal, qb, kb, kv_valid, timed) in RING_CASES:
        for dt in ("bfloat16", "float32"):
            dtype = getattr(torch, dt)
            qkv = torch.randn((b, s, 3 * h * d), generator=gen,
                              device="cuda").to(dtype)
            q, k, v = (t.reshape(b, s, h, d)
                       for t in qkv.split(h * d, dim=-1))
            base = torch.arange(s, dtype=torch.int32, device="cuda")
            qp, kp = base + qb * s, base + kb * s
            do = torch.randn((b, s, h, d), generator=gen, device="cuda")
            dlse = torch.randn((b * h, s), generator=gen, device="cuda")
            fwd_tc = tfa._pick_route(None, (q, k, v), kernel="K4")
            fwd_route = "tensor_core" if fwd_tc else "scalar"
            before = counts()
            o, lse = tfa.flash_attention_partial_fwd(q, k, v, qp, kp, causal,
                                                     kv_valid)
            tc = tfa._pick_route(None, (q, k, v, do, o), positional=True)
            route = "tensor_core" if tc else "scalar"
            dq, delta, do_k3 = tfa.flash_attention_partial_dq(
                q, k, v, o, do, lse, dlse, qp, kp, causal, kv_valid)
            dk, dv = tfa.flash_attention_partial_dkv(
                q, k, v, do_k3, lse, delta, qp, kp, causal, kv_valid)
            again = tfa.flash_attention_partial_bwd(
                q, k, v, o, lse, do, dlse, qp, kp, causal, kv_valid)
            torch.cuda.synchronize()
            want = {"flash_fwd_pos": (1, fwd_tc), "flash_dq_pos": (2, 2 * tc),
                    "flash_dkv_pos": (2, 2 * tc)}
            now = counts()
            if any((now[n][0] - before[n][0], now[n][1] - before[n][1])
                   != want[n] for n in wrappers):
                fail(f"K4/K2p/K3p wrappers did not count their {route} "
                     f"launches at {label} {dt}: {before} -> {now}")
            if not all(torch.equal(x, y) for x, y in zip((dq, dk, dv),
                                                         again)):
                fail(f"K2p/K3p's {route} route is not deterministic at "
                     f"{label} {dt}")
            fwd = {fwd_route: (o, lse)}
            if fwd_tc:
                fwd["scalar"] = tfa._launch(
                    q, k, v, causal, (qp, kp, kv_valid),
                    tfa.flash_attention_partial_fwd, tensor_core=False)
            o2, lse2 = tfa.flash_attention_partial_fwd(q, k, v, qp, kp,
                                                       causal, kv_valid)
            if not (torch.equal(o, o2) and torch.equal(lse, lse2)):
                fail(f"K4's {fwd_route} route is not deterministic at "
                     f"{label} {dt}")
            checked = {route: (delta, dq, dk, dv)}
            if tc:
                sdq, sdelta, sdo = tfa._dq_pos_launch(
                    q, k, v, o, do, lse, dlse, qp, kp, causal, kv_valid,
                    tensor_core=False)
                sdk, sdv = tfa.flash_attention_partial_dkv(
                    q, k, v, sdo, lse, sdelta, qp, kp, causal, kv_valid)
                checked["scalar"] = (sdelta, sdq, sdk, sdv)
            po, plse = tfa.flash_attention_partial_plain(q, k, v, qp, kp,
                                                         causal, kv_valid)
            want_delta = tfa.partial_delta(o, do, dlse)
            pdq, pdk, pdv = tfa.flash_attention_partial_bwd_plain(
                q, k, v, o, lse, do, dlse, qp, kp, causal, kv_valid)
            keep = torch.ones((s, s), dtype=torch.bool, device="cuda")
            if causal:
                keep &= qp[:, None] >= kp[None, :]
            if kv_valid is not None:
                keep &= (kp < kv_valid)[None, :]
            dead = ~keep.any(dim=1)      # query rows with no key kept
            tol = TOL_GRAD[dt]
            finite = all(torch.isfinite(x).all().item()
                         for x in (o, lse, dq, dk, dv, delta))
            fwd_errs = {}
            for r, (x_o, x_lse) in fwd.items():
                tol_o = TOL_O_POS_TC if r == "tensor_core" else TOL_O_POS
                fwd_errs[r] = ((x_o - po).abs().max().item(),
                               (x_lse - plse).abs().max().item(), tol_o)
                empty = (not x_o[:, dead].any().item() and bool(
                    (x_lse.reshape(b, h, s)[:, :, dead] == -1e30).all()))
                if not (finite and fwd_errs[r][0] <= tol_o
                        and fwd_errs[r][1] <= TOL_LSE and empty):
                    fail(f"K4's {r} route disagrees with its plain version "
                         f"at {label} {dt}: err_o {fwd_errs[r][0]} (tol "
                         f"{tol_o}), err_lse {fwd_errs[r][1]} (tol "
                         f"{TOL_LSE}), finite {finite}, rows with no key: "
                         f"O = 0 and lse = -1e30 {empty}")
            err_o = fwd_errs[fwd_route][0]
            errs = {}
            for r, (x_delta, x_dq, x_dk, x_dv) in checked.items():
                errs[r] = {"delta": rel_err(x_delta, want_delta),
                           "dq": rel_err(x_dq, pdq), "dk": rel_err(x_dk, pdk),
                           "dv": rel_err(x_dv, pdv)}
                bad = {n: e[1] for n, e in errs[r].items()
                       if not (math.isfinite(e[1]) and e[1] <= (
                           TOL_DELTA if n == "delta" else tol))}
                if bad:
                    fail(f"K2p/K3p's {r} route disagrees with the plain "
                         f"version at {label} {dt}: {bad} (tol {tol}, "
                         f"delta {TOL_DELTA})")
            pairs = int(keep.sum().item())
            bounds = ring_bounds(b, s, h, d, dt, pairs, tc)
            line = (f"ring kernels {label} {(b, s, h, d)} {dt} causal="
                    f"{causal} kv_valid={kv_valid} ({pairs} of {s * s} "
                    f"pairs kept, {int(dead.sum())} rows with none), K4 "
                    f"{fwd_route} route, K2p/K3p {route} route: K4 "
                    + "; ".join(f"{r} err_o={e[0]:.3g} (tol {e[2]:g}) "
                                f"err_lse={e[1]:.3g}"
                                for r, e in fwd_errs.items())
                    + f" (tol {TOL_LSE:g}); rel err "
                    + "; ".join(f"{r} " + " ".join(f"{n}={e[1]:.3g}"
                                                   for n, e in es.items())
                                for r, es in errs.items())
                    + f" (tol {tol:g}, delta {TOL_DELTA:g}, dlse nonzero), "
                    "bit-identical; bound_us "
                    + " ".join(f"{n}={t * 1e3:.3f} ({by})"
                               for n, (t, by) in bounds.items()))
            if not timed:
                say(line)
                continue
            # yardstick only: SDPA with the same boolean mask (it returns
            # no lse), and its backward for dq, dk and dv in one call
            qt, kt, vt = (t.detach().transpose(1, 2).contiguous()
                          .requires_grad_() for t in (q, k, v))
            out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=keep)
            dot = do.to(dtype).transpose(1, 2).contiguous()
            reps = 50 if s < 500 else 20
            main = (label, dt) == RING_MAIN

            def old_bwd():
                x_delta = tfa.partial_delta(o, do, dlse)
                _, _, x_do = tfa._dq_pos_launch(
                    q, k, v, o, do, lse, dlse, qp, kp, causal, kv_valid,
                    tensor_core=False)
                tfa.flash_attention_partial_dkv(q, k, v, x_do, lse, x_delta,
                                                qp, kp, causal, kv_valid)

            fns = {
                "K4": lambda: tfa.flash_attention_partial_fwd(
                    q, k, v, qp, kp, causal, kv_valid),
                "sdpa": lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=keep),
                "K2p": lambda: tfa.flash_attention_partial_dq(
                    q, k, v, o, do, lse, dlse, qp, kp, causal, kv_valid),
                "K3p": lambda: tfa.flash_attention_partial_dkv(
                    q, k, v, do_k3, lse, delta, qp, kp, causal, kv_valid),
                "bwd": lambda: tfa.flash_attention_partial_bwd(
                    q, k, v, o, lse, do, dlse, qp, kp, causal, kv_valid),
                "sdpa bwd": lambda: torch.autograd.grad(
                    out, (qt, kt, vt), dot, retain_graph=True)}
            if fwd_tc:
                fns["scalar K4"] = lambda: tfa._launch(
                    q, k, v, causal, (qp, kp, kv_valid),
                    tfa.flash_attention_partial_fwd, tensor_core=False)
            if tc:
                fns["scalar K2p"] = lambda: tfa._dq_pos_launch(
                    q, k, v, o, do, lse, dlse, qp, kp, causal, kv_valid,
                    tensor_core=False)
                fns["scalar K3p"] = lambda: tfa.flash_attention_partial_dkv(
                    q, k, v, do, lse, delta, qp, kp, causal, kv_valid)
                fns["old bwd"] = old_bwd
            if main:
                fns["K4 plain"] = lambda: tfa.flash_attention_partial_plain(
                    q, k, v, qp, kp, causal, kv_valid)
                fns["bwd plain"] = \
                    lambda: tfa.flash_attention_partial_bwd_plain(
                        q, k, v, o, lse, do, dlse, qp, kp, causal, kv_valid)
            call = {n: time_ms(f, reps) for n, f in fns.items()}
            dev = {n: spread(t)[0] for n, t in
                   device_ms_tries(fns, reps, timing_tries(main)).items()}
            say(line + f"; {timing_note(main)}; " + times_text(dev, call)
                + "; launches " + " ".join(
                    f"{n}={w.launches} (tensor-core "
                    f"{w.tensor_core_launches})" for n, w in (
                        ("K4", tfa.flash_attention_partial_fwd),
                        ("K2p", tfa.flash_attention_partial_dq),
                        ("K3p", tfa.flash_attention_partial_dkv))))
            for name, key, plain, lib, err in (
                    ("flash_fwd_pos", "K4", "K4 plain", "sdpa",
                     (err_o, err_o)),
                    ("flash_dq_pos", "K2p", "bwd plain", "sdpa bwd",
                     max(errs[route]["delta"], errs[route]["dq"],
                         key=lambda e: e[1])),
                    ("flash_dkv_pos", "K3p", "bwd plain", "sdpa bwd",
                     max(errs[route]["dk"], errs[route]["dv"],
                         key=lambda e: e[1]))):
                row = dict(
                    max_abs_err=err[0], ms=dev[key], plain_ms=dev.get(plain),
                    library_ms=dev[lib], bound_ms=bounds[name][0],
                    bound_by=bounds[name][1], call_ms=call[key],
                    plain_call_ms=call.get(plain), library_call_ms=call[lib])
                if name == "flash_fwd_pos":
                    row.update(
                        tc_route=fwd_route, scalar_ms=dev.get("scalar K4"),
                        scalar_max_abs_err=(fwd_errs["scalar"][0]
                                            if fwd_tc else None))
                else:
                    parts = ("delta", "dq") if key == "K2p" else ("dk", "dv")
                    row.update(
                        tc_route=route, scalar_ms=dev.get("scalar " + key),
                        scalar_rel_err=(max(errs["scalar"][n][1]
                                            for n in parts) if tc else None),
                        delta_rel_err=errs[route]["delta"][1],
                        bwd_ms=dev["bwd"], old_bwd_ms=dev.get("old bwd"),
                        bwd_bound_ms=bounds["bwd"][0])
                rows[(name, label, dt)] = row
    return rows


# -- phase 17: the ring op on two ranks sharing the card ----------------------

RING_CHILD = os.path.join(ROOT, "tests", "_torch_ring_child.py")
# (label, B, S, H, D, dtype, causal): S = 49 is the vit's (padded to 50,
# the padded key masked); the causal long shape gives each rank 500 rows.
RING_OP_CASES = (("vit", 128, 49, 4, 32, "float32", False),
                 ("vit", 128, 49, 4, 32, "bfloat16", False),
                 ("causal long", 2, 1000, 4, 64, "float32", True))
# The ring against one process's full_attention (ring) or flash_attention
# (ring_flash), absolute: f32 outputs 2e-5 and gradients 5e-5 (the JAX
# package's ring-test tolerances: the same f32 math in other orders);
# bf16: 2e-2 of the largest value (one rounding of the output, and of
# each ring step's gradient).
TOL_RING_OP = {"float32": (2e-5, 5e-5), "bfloat16": (2e-2, 2e-2)}


def ring_world(mode: str, spec, world: int, name: str, *args) -> tuple:
    """A ``run_worlds`` entry of ``tests/_torch_ring_child.py MODE`` on
    ``spec`` (saved to WORK/NAME-in.pt) in ``world`` ranks."""
    import torch

    inp = os.path.join(WORK, f"{name}-in.pt")
    torch.save(spec, inp)
    return name, world, RING_CHILD, [mode, inp], list(args)


def phase_ring_op() -> None:
    import numpy as np
    import torch

    from distributedpytorch_tpu_torch.ops.attention import full_attention
    from distributedpytorch_tpu_torch.ops.flash_attention import (
        flash_attention)

    rng = np.random.default_rng(SEED + 5)
    spec, refs = [], []
    for (label, b, s, h, d, dt, causal) in RING_OP_CASES:
        q, k, v, w = (rng.standard_normal((b, s, h, d)).astype(np.float32)
                      for _ in range(4))
        for flash in (False, True):
            if dt == "bfloat16" and not flash:
                continue        # the einsum ring computes in f32 anyway
            spec.append(dict(q=q, k=k, v=v, w=w, causal=causal,
                             use_flash=flash, ragged=s % 2 != 0, dtype=dt))
            ts = [torch.from_numpy(x).cuda().to(getattr(torch, dt))
                  .requires_grad_() for x in (q, k, v)]
            fn = flash_attention if flash else full_attention
            o = fn(*ts, causal)
            (o.float() * torch.from_numpy(w).cuda()).sum().backward()
            refs.append((label, dt, causal, flash,
                         [x.detach().float().cpu() for x in
                          (o, *(t.grad for t in ts))]))
    t0 = time.perf_counter()
    got, = run_worlds([ring_world("attn", spec, 2, "ring_op")])
    wall = time.perf_counter() - t0
    if [r["backend"] for r in got] != ["gloo", "gloo"]:
        fail(f"two ranks on one card must run gloo, got "
             f"{[r['backend'] for r in got]}")
    for i, (label, dt, causal, flash, ref) in enumerate(refs):
        tol_o, tol_g = TOL_RING_OP[dt]
        for r in got:
            res = [torch.from_numpy(r["cases"][i][n])
                   for n in ("o", "dq", "dk", "dv")]
            if dt == "float32":
                errs = [(a - e).abs().max().item() for a, e in zip(res, ref)]
            else:
                errs = [rel_err(a, e)[1] for a, e in zip(res, ref)]
            ok = all(math.isfinite(e) for e in errs) and errs[0] <= tol_o \
                and max(errs[1:]) <= tol_g
            if r["rank"] == 0 or not ok:
                say(f"ring op {label} {dt} causal={causal} "
                    f"{'ring_flash vs flash' if flash else 'ring vs full'} "
                    f"(rank {r['rank']} of 2, gloo): "
                    f"{'rel ' if dt == 'bfloat16' else ''}err o={errs[0]:.3g} "
                    f"(tol {tol_o:g}) dq={errs[1]:.3g} dk={errs[2]:.3g} "
                    f"dv={errs[3]:.3g} (tol {tol_g:g})")
            if not ok:
                fail(f"the 2-rank ring disagrees at {label} {dt}")
    say(f"ring op: {len(refs)} cases on 2 ranks in {wall:.1f}s of process "
        f"wall (start-up included)")


# -- phase 18: the ring slice's main path -------------------------------------

TORCHRUN2 = ("-m", "torch.distributed.run", "--standalone",
             "--nproc_per_node", "2")
MODEL_PARALLEL = 2


def parse_ring_launches(log: str, action: str) -> dict:
    m = re.search(rf"{action}: ring kernel launches flash_fwd_pos (\d+), "
                  rf"flash_dq_pos (\d+), flash_dkv_pos (\d+) over", log)
    if m is None:
        fail(f"{action} did not log its ring kernel launches")
    return dict(zip(("flash_fwd_pos", "flash_dq_pos", "flash_dkv_pos"),
                    (int(x) for x in m.groups())))


def parse_ring_tensor_core_launches(log: str, action: str) -> dict:
    """The ``ACTION: ring tensor-core launches ...`` line: K4's, K2p's and
    K3p's launches on the tensor cores."""
    m = re.search(rf"{action}: ring tensor-core launches flash_fwd_pos "
                  rf"(\d+), flash_dq_pos (\d+), flash_dkv_pos (\d+) over",
                  log)
    if m is None:
        fail(f"{action} did not log its ring tensor-core launches")
    return dict(zip(("flash_fwd_pos", "flash_dq_pos", "flash_dkv_pos"),
                    (int(x) for x in m.groups())))


def phase_ring_train() -> dict:
    """``train --attention ring_flash --model-parallel 2`` on two ranks
    sharing the card, on phase 6's corpus; then ``test -f`` under the same
    launch and ``test -f --attention flash`` in one process, at once."""
    ring = ["--attention", "ring_flash", "--model-parallel",
            str(MODEL_PARALLEL)]
    rsl = os.path.join(WORK, "ring_rsl")
    wall, log = run_cli(["train", "--model", "vit", *ring, "-e", "1"], rsl,
                        launcher=TORCHRUN2, data=VIT_DATA)
    for line in ("process: 0/2, world size: 2, backend: gloo",
                 "mesh: data 1 x model 2, ring over the model group on gloo",
                 "batch size: 64/replica (128 global)"):
        if line not in log:
            fail(f"the ring train did not log {line!r}")
    say("ring train: " + re.search(r"mesh: .*", log).group(0))
    launches, steps, evals = parse_launches(log, "train")
    ring_launches = parse_ring_launches(log, "train")
    ring_tc = parse_ring_tensor_core_launches(log, "train")
    n_train = int(VIT_TRAIN_ROWS * 0.9)
    world = 2
    want_steps = math.ceil(n_train / world / TRAIN_BATCH)
    want_evals = math.ceil((VIT_TRAIN_ROWS - n_train) / world / TRAIN_BATCH)
    per = DEPTH * MODEL_PARALLEL
    want = {"flash_fwd_pos": per * (steps + evals),
            "flash_dq_pos": per * steps, "flash_dkv_pos": per * steps}
    want_tc = dict(want)                # every K4, K2p and K3p
    say(f"ring train: launches {ring_launches} and {launches} over {steps} "
        f"steps and {evals} eval batches, on the tensor cores {ring_tc}; "
        f"formula {want}, all K4/K2p/K3p on the tensor cores, K1-K3 and K5 "
        f"0")
    if (steps, evals) != (want_steps, want_evals) or ring_launches != want \
            or ring_tc != want_tc or any(launches.values()):
        fail(f"ring train launches {ring_launches} (tensor-core {ring_tc}), "
             f"{launches} over {steps} steps / {evals} eval batches do not "
             f"match the formula {want} at {want_steps} steps / "
             f"{want_evals} eval batches, every K4, K2p and K3p on the "
             f"tensor cores")
    check_epoch_log("ring train", log, steps, wall)
    best = os.path.join(rsl, "bestmodel-mnist-vit.ckpt")
    (_, ring_log), (_, flash_log) = finish_all([
        start_cli(["test", "-f", best, *ring], os.path.join(WORK,
                                                           "ring_test"),
                  launcher=TORCHRUN2, data=VIT_DATA),
        start_cli(["test", "-f", best, "--attention", "flash"],
                  os.path.join(WORK, "ring_test_flash"), data=VIT_DATA)])
    acc_here, correct, n = eval_accuracy(best, "vit", VIT_DATA)
    acc_ring = re.search(r"Time: \d+m \d+s, Acc: ([\d.]+)%",
                         ring_log).group(1)
    acc_flash = re.search(r"Time: \d+m \d+s, Acc: ([\d.]+)%",
                          flash_log).group(1)
    test_ring = parse_ring_launches(ring_log, "test")
    _, _, test_evals = parse_launches(ring_log, "test")
    rows_apart = abs(round(float(acc_ring) * n / 100) - correct)
    differ = ring_vs_flash_rows(best)
    allowed = differ + RING_TEST_ROWS
    say(f"ring test: `test -f` on 2 ranks (ring_flash) {acc_ring}% "
        f"({test_evals} eval batches, launches {test_ring}); `test -f "
        f"--attention flash` on 1 process {acc_flash}%; in-process flash "
        f"eval {acc_here}% ({correct}/{n}); ring vs flash {rows_apart} rows "
        f"apart (allowed {allowed}: the {differ} rows whose labels differ "
        f"above, plus {RING_TEST_ROWS})")
    if acc_flash != acc_here or rows_apart > allowed \
            or test_ring != {"flash_fwd_pos": per * test_evals,
                             "flash_dq_pos": 0, "flash_dkv_pos": 0}:
        fail("the ring-trained model's test disagrees with the in-process "
             "eval, or its launches with the formula")
    return ring_launches, ring_tc


def ring_vs_flash_rows(ckpt_path: str) -> int:
    """The ring's test against the one-process flash eval of the same
    file, row by row.  The two attentions round at other points (each
    rounds p to bf16 on the tensor cores, relative to its own running max;
    the ring merges its f32 partials, then casts once), so the argmax of a
    row whose two best logits lie within that noise may flip.  Takes the
    bf16 logits of every test row of phase 6's corpus from ``ring_flash``
    on two ranks (``tests/_torch_ring_child.py logits``) and from
    ``flash`` in this process, TRAIN_BATCH rows at a time; fails when
    they differ by more than TOL_RING_OP's bf16 share of the largest
    logit, or when a row's labels differ though its flash top-two margin
    exceeds twice their largest difference.  Returns the number of rows
    whose labels differ."""
    import numpy as np
    import torch

    from distributedpytorch_tpu_torch import checkpoint as ckpt
    from distributedpytorch_tpu_torch.data import augment
    from distributedpytorch_tpu_torch.data.datasets import load_dataset
    from distributedpytorch_tpu_torch.models import get_model
    from distributedpytorch_tpu_torch.precision import PRESETS

    ds = load_dataset("mnist", VIT_DATA, SEED, synthetic_fallback=True)
    images = ds.splits["test"].images
    policy = PRESETS["bf16"]
    model = get_model("vit", ds.nb_classes, policy, attention="flash",
                      device="cuda")
    ckpt.restore_for_serving(ckpt_path, model)
    flash = []
    with torch.inference_mode():
        for i in range(0, len(images), TRAIN_BATCH):
            x = augment.eval_transform(
                torch.from_numpy(images[i:i + TRAIN_BATCH]).cuda(), ds.mean,
                ds.std, 28, out_dtype=policy.compute_dtype)
            flash.append(model(x).float().cpu().numpy())
    flash = np.concatenate(flash)
    spec = dict(arch={}, attention="ring_flash", precision="bf16",
                params={k: v.detach().cpu()
                        for k, v in model.state_dict().items()},
                images=images, mean=ds.mean, std=ds.std, batch=TRAIN_BATCH)
    ranks, = run_worlds([ring_world("logits", spec, MODEL_PARALLEL,
                                    "ring_logits", "--model-parallel",
                                    str(MODEL_PARALLEL))])
    ring = ranks[0]["logits"]
    noise = float(np.abs(ring - flash).max())
    scale = float(np.abs(flash).max())
    top2 = np.sort(flash, axis=-1)[:, -2:]
    margin = top2[:, 1] - top2[:, 0]
    differ = ring.argmax(-1) != flash.argmax(-1)
    near = margin <= 2 * noise
    tol = TOL_RING_OP["bfloat16"][0]
    say(f"ring test: bf16 logits of {len(images)} rows, ring_flash on 2 "
        f"ranks vs flash: max abs diff {noise:.3g} ({noise / scale:.3g} of "
        f"the largest logit, tol {tol:g}); labels differ on "
        f"{int(differ.sum())} rows, {int(near.sum())} rows have a flash "
        f"top-two margin within twice that diff; K4 launches "
        f"{ranks[0]['launches']['flash_fwd_pos']}")
    if not (noise <= tol * scale and (near | ~differ).all()
            and ranks[0]["launches"]["flash_fwd_pos"] > 0):
        fail(f"the ring's logits disagree with flash's beyond its rounding: "
             f"max diff {noise} of {scale}; rows whose labels differ "
             f"outside the noise: {np.flatnonzero(differ & ~near)[:10]}")
    return int(differ.sum())


# The ring's `test` against flash's, beyond the rows whose labels differ in
# ring_vs_flash_rows: the two CLI runs batch the rows otherwise (128 a step
# on the ring, 64 in flash), which may flip the argmax of a row whose two
# best logits are within a rounding of a tie.
RING_TEST_ROWS = 2


# -- phase 19: three f32 steps, 2-rank rings against 1-process flash ----------

RING_STEP_BATCH = 16
TOL_RING_STEP = 1e-5


def phase_ring_steps() -> None:
    import numpy as np
    import torch

    from distributedpytorch_tpu_torch.data import augment

    rng = np.random.default_rng(SEED + 6)
    steps = []
    for i in range(3):
        gb = RING_STEP_BATCH
        valid = np.ones(gb, bool)
        if i == 0:
            valid[gb // 2:gb - 1] = False
        u = torch.from_numpy(rng.random((gb, 5), dtype=np.float32))
        steps.append((rng.integers(0, 256, (gb, 28, 28), dtype=np.uint8),
                      rng.integers(0, 10, gb), valid,
                      [t.numpy() for t in augment.affine_from_uniform(
                          u, 28, 28)]))
    kinds = (("flash", 1), ("ring_flash", 2), ("ring", 2))
    worlds = dict(zip((a for a, _ in kinds), run_worlds([
        ring_world("vit", dict(arch={}, attention=attention, seed=SEED,
                               params=None, steps=steps), world,
                   f"ring_step_{attention}", "--model-parallel", str(world))
        for attention, world in kinds])))
    one = worlds["flash"][0]
    for attention in ("ring_flash", "ring"):
        ranks = worlds[attention]
        same = all(torch.equal(v, ranks[0]["state"][k])
                   for r in ranks for k, v in r["state"].items())
        w = worst(ranks[0]["state"], one["state"])
        loss_err = max(abs(a[0] - b[0]) for a, b in
                       zip(ranks[0]["metrics"], one["metrics"]))
        counts = [m[1:] for m in ranks[0]["metrics"]] == \
            [m[1:] for m in one["metrics"]]
        launches = ranks[0]["launches"]
        say(f"ring steps: {attention} on 2 ranks (gloo) vs flash on 1, 3 "
            f"f32 SGD steps of the full-width vit on a global batch of "
            f"{RING_STEP_BATCH}: worst tensor {w[0]} rel err {w[1]:.3g} "
            f"(tol {TOL_RING_STEP:g}) over {len(one['state'])} tensors; "
            f"loss err {loss_err:.3g}; correct/valid equal: {counts}; ranks "
            f"equal: {same}; rank 0 launches {launches}")
        want = (DEPTH * MODEL_PARALLEL * 3 if attention == "ring_flash"
                else 0)
        if not (same and counts and math.isfinite(w[1])
                and w[1] <= TOL_RING_STEP and loss_err <= TOL_RING_STEP) \
                or launches["flash_fwd_pos"] != want \
                or launches["flash_dq_pos"] != want:
            fail(f"the 2-rank {attention} steps disagree with 1-process "
                 f"flash")


# -- phase 20: where the time goes in a ring train step -----------------------

RING_PROFILE_STEPS = 10


def phase_ring_profile() -> None:
    """One ring_flash train step of the full-width vit on two ranks sharing
    the card, bf16, 64 rows a replica (the data shard's 128 rows on each
    rank), as in phase 18 but SGD: wall ms per step (host clock,
    synchronized), then from RING_PROFILE_STEPS steps under torch.profiler
    the device time, kernels per step, the idle share, K4/K2p/K3p and the
    host copies of the gloo transport.  Both ranks run it; each reports."""
    import numpy as np
    import torch

    from distributedpytorch_tpu_torch.data import augment

    gb = TRAIN_BATCH * 2
    rng = np.random.default_rng(SEED + 7)
    u = torch.from_numpy(rng.random((gb, 5), dtype=np.float32))
    step = (rng.integers(0, 256, (gb, 28, 28), dtype=np.uint8),
            rng.integers(0, 10, gb), np.ones(gb, bool),
            [t.numpy() for t in augment.affine_from_uniform(u, 28, 28)])
    spec = dict(arch={}, attention="ring_flash", seed=SEED, params=None,
                steps=[step], precision="bf16", profile=RING_PROFILE_STEPS)
    ranks, = run_worlds([ring_world("vit", spec, 2, "ring_profile",
                                    "--model-parallel", "2")])
    for r in ranks:
        p = r["profile"]
        dev = p["device_ms"]
        if dev <= 0:
            say(f"profile: ring_flash train step, rank {r['rank']}: wall "
                f"{p['wall_ms']:.3f} ms/step; device time not measured (no "
                f"device events)")
            continue
        parts = "; ".join(
            f"{n} {p[k]:.2f} us/step ({100 * p[k] / 1e3 / dev:.1f}%)"
            for n, k in (("K4", "k4_us"), ("K2p", "k2p_us"),
                         ("K3p", "k3p_us"), ("host copies", "memcpy_us")))
        parts += "; " + ", ".join(
            f"{n} {p[k + '_launches']:.0f} launches a step "
            f"({p[k + '_mma_launches']:.0f} tensor-core), "
            f"{p[k + '_us'] / max(p[k + '_launches'], 1):.2f} us a launch"
            for n, k in (("K4", "k4"), ("K2p", "k2p"), ("K3p", "k3p")))
        say(f"profile: ring_flash train step, rank {r['rank']} of 2 (gloo, "
            f"M = 2), {gb} rows a rank, bf16: wall {p['wall_ms']:.3f} "
            f"ms/step, device {dev:.3f} ms in {p['kernels']:.0f} kernels "
            f"(idle {100 * (1 - dev / p['wall_ms']):.1f}%); {parts}")
        say("profile:   top: " + "; ".join(
            f"{k} {us:.1f}us x{c}" for k, us, c in p["top"]))


# Phases that use another phase's output pull it in: 7 and 8 (one
# function) test phase 6's model.
# -- phases 21-23: the rest of the torchvision zoo -------------------------

ZOO = ("alexnet", "vgg", "squeezenet", "densenet", "inception")
ZOO_PARITY_BATCH = 4
# Phase 21, the card against the CPU on the same weights, batch, affine
# draws and dropout masks, TF32 off, each tensor relative to its largest
# value.  f32 train-mode logits (and aux logits): TOL_ZOO_LOGITS.  The
# gradients of sum(logits * w) (+ sum(aux * w'), w a fixed ramp, so that
# both devices back-propagate the same exact cotangent): in f64 compute
# (f32 parameters, whose gradients round to f32) TOL_ZOO_GRAD_F64 for all
# five; in f32 TOL_ZOO_GRAD_F32 for alexnet and squeezenet, which have no
# BatchNorm (a ReLU or max-pool decision within rounding of a tie can
# flip between the devices, as in phase 11: 6.6e-3 seen on alexnet).
# The f32 backward of the three BatchNorm models at this batch amplifies
# the devices' last-bit differences of the forward (on the CPU alone
# densenet's and inception's f32 gradients lie 2-3% from their f64 ones
# at the median and up to 37% at the worst parameter; vgg's card vs CPU
# 4.8e-2; ROADMAP queue 3 entry 8), so their f32 gradient error is
# printed and not held.  vgg's conv biases feed a train-mode BatchNorm,
# which cancels them: their gradient is zero up to rounding and is held
# at the scale of its conv's weight gradient.
TOL_ZOO_LOGITS = 1e-4
TOL_ZOO_GRAD_F64 = 1e-6
TOL_ZOO_GRAD_F32 = 1e-2
ZOO_F32_GRADS_HELD = ("alexnet", "squeezenet")
TOL_ZOO_STATS = 1e-4


def zoo_rel(name: str, got: dict, want: dict) -> dict:
    """{key: error relative to the largest wanted value}; vgg's conv
    biases relative to their conv weight's."""
    out = {}
    for key, w in want.items():
        scale = w
        if name == "vgg" and re.fullmatch(r"Conv_\d+\.bias", key):
            scale = want[key.replace(".bias", ".weight")]
        out[key] = ((got[key].double() - w.double()).abs().max()
                    / max(scale.double().abs().max().item(), 1e-30)).item()
    return out


def zoo_step(name: str, device: str, policy, x, masks) -> dict:
    """The registry's ``name`` from SEED's weights (drawn on the CPU): one
    train-mode forward of the augmented batch ``x`` with the keep
    ``masks``, and the backward of sum(logits * w) (+ sum(aux * w')).
    Returns the logits, aux logits, gradients and BatchNorm statistics,
    on the CPU."""
    import torch

    from distributedpytorch_tpu_torch.models import get_model
    from distributedpytorch_tpu_torch.models.layers import set_dropout_masks

    model = get_model(name, 10, policy, device=device)
    model.init_weights(torch.Generator().manual_seed(SEED))
    model.train()
    set_dropout_masks(model, [m.to(device) for m in masks] or None)
    out = model(x.to(device))
    logits, aux = out if isinstance(out, tuple) else (out, None)
    w = torch.linspace(-1.0, 1.0, logits.shape[1], device=device)
    loss = (logits * w).sum()
    if aux is not None:
        loss = loss + (aux * w.flip(0)).sum()
    loss.backward()
    if device == "cuda":
        torch.cuda.synchronize()
    got = {"logits": logits.detach().cpu()}
    if aux is not None:
        got["aux"] = aux.detach().cpu()
    return {"out": got,
            "grads": {n: p.grad.cpu() for n, p in model.named_parameters()},
            "stats": {n: b.cpu() for n, b in model.named_buffers()}}


def phase_zoo_parity() -> None:
    import numpy as np
    import torch

    from distributedpytorch_tpu_torch.data import augment
    from distributedpytorch_tpu_torch.data.datasets import load_dataset
    from distributedpytorch_tpu_torch.models import (get_model,
                                                     get_model_input_size)
    from distributedpytorch_tpu_torch.ops.losses import cross_entropy
    from distributedpytorch_tpu_torch.precision import PRESETS
    from distributedpytorch_tpu_torch.train.engine import Engine

    b = ZOO_PARITY_BATCH
    ds = load_dataset("mnist", os.path.join(WORK, "data"), SEED,
                      synthetic_fallback=True)
    images = torch.from_numpy(ds.splits["train"].images[:b])
    u = torch.from_numpy(np.random.default_rng(SEED).random(
        (b, 5), dtype=np.float32))
    for name in ZOO:
        size = get_model_input_size(name)
        # the masks of Engine.train_step, drawn once on the CPU
        engine = Engine(get_model(name, 10, PRESETS["f32"], device="cpu"),
                        cross_entropy, ds.mean, ds.std, size,
                        PRESETS["f32"], "cpu")
        masks = engine.draw_dropout_masks(
            torch.Generator().manual_seed(SEED), b)
        worst = {}
        for label, policy in (("f32", PRESETS["f32"]), ("f64", f64_policy())):
            x = augment.train_transform(
                images, ds.mean, ds.std, size,
                augment.affine_from_uniform(u, 28, 28),
                out_dtype=policy.compute_dtype)
            card = zoo_step(name, "cuda", policy, x, masks)
            cpu = zoo_step(name, "cpu", policy, x, masks)
            errs = {k: zoo_rel(name, card[k], cpu[k])
                    for k in ("out", "grads", "stats")}
            worst[label] = {k: max(e.items(), key=lambda t: t[1],
                                   default=("none", 0.0))
                            for k, e in errs.items()}
            worst[label]["finite"] = all(
                bool(torch.isfinite(t).all()) for k in ("out", "grads")
                for t in card[k].values())
        f32, f64 = worst["f32"], worst["f64"]
        held = name in ZOO_F32_GRADS_HELD
        say(f"zoo: {name} at {size} px, batch {b}, card vs CPU: f32 "
            f"logits worst {f32['out'][0]} {f32['out'][1]:.3g} (tol "
            f"{TOL_ZOO_LOGITS:g}); f32 gradient worst {f32['grads'][0]} "
            f"{f32['grads'][1]:.3g} "
            + (f"(tol {TOL_ZOO_GRAD_F32:g})" if held else "(printed only)")
            + f"; f64 gradient worst {f64['grads'][0]} "
            f"{f64['grads'][1]:.3g} (tol {TOL_ZOO_GRAD_F64:g}); BatchNorm "
            f"statistic worst {f32['stats'][0]} {f32['stats'][1]:.3g} (tol "
            f"{TOL_ZOO_STATS:g}); {len(masks)} dropout masks")
        if not (f32["finite"] and f64["finite"]
                and f32["out"][1] <= TOL_ZOO_LOGITS
                and f64["grads"][1] <= TOL_ZOO_GRAD_F64
                and f32["stats"][1] <= TOL_ZOO_STATS
                and f64["stats"][1] <= TOL_ZOO_STATS
                and (not held or f32["grads"][1] <= TOL_ZOO_GRAD_F32)):
            fail(f"{name}'s step on the card disagrees with the CPU's: "
                 f"{worst}")
        if ("aux" in card["out"]) != (name == "inception"):
            fail(f"{name}'s train-mode forward returned aux logits "
                 f"{'aux' in card['out']}")


ZOO_SERVED = ("inception", "vgg")   # the 299 path, and dropout in eval
ZOO_WAVE = 16                       # concurrent requests a served model


def zoo_log_losses(log: str) -> list:
    return [float(x) for x in re.findall(
        r"(?:mean train loss:|Loss: )(\S+)", log)]


def moved_params(ckpt_path: str, name: str) -> tuple:
    """(parameters that moved from SEED's init, parameters, all finite)
    of a checkpoint of ``name``."""
    import torch

    from distributedpytorch_tpu_torch import checkpoint as ckpt
    from distributedpytorch_tpu_torch.models import get_model
    from distributedpytorch_tpu_torch.precision import PRESETS

    got = ckpt.read_checkpoint(ckpt_path)["state"]["params"]
    init = get_model(name, 10, PRESETS["bf16"], device="cpu")
    init.init_weights(torch.Generator().manual_seed(SEED))
    params = dict(init.named_parameters())
    moved = sum(not torch.equal(got[n], p.detach())
                for n, p in params.items())
    finite = all(bool(torch.isfinite(t).all()) for t in got.values())
    return moved, len(params), finite


def serve_zoo(ckpt_path: str, name: str, server, images) -> int:
    """One wave of ZOO_WAVE concurrent requests to ``server``; every
    answer held against the in-process predict step at its bucket, as
    phase 3 holds the vit's.  Returns the batches served."""
    import numpy as np

    answers, secs = serve_burst(server, images, 1, ZOO_WAVE)
    labels = np.array([a[2]["label"] for a in answers])
    confs = np.array([a[2]["confidence"] for a in answers])
    served_bucket = np.array([a[2]["bucket"] for a in answers])
    want, want_conf, probs = reference_predictions(
        ckpt_path, images, served_bucket, "cuda", name)
    top2 = np.sort(probs, axis=-1)[:, -2:]
    tie = (top2[:, 1] - top2[:, 0]) <= TOL_CONF
    conf_err = float(np.abs(confs - want_conf).max())
    launches = batches = None
    for line in server[2]:
        m = re.search(r"flash_fwd launches (\d+) \(", line)
        if m:
            launches = int(m.group(1))
        m = re.search(r"answering \d+ requests in (\d+) batches", line)
        if m:
            batches = int(m.group(1))
    say(f"zoo: serve {name}: {len(answers)} answers in {secs:.3f}s, "
        f"buckets {sorted(set(served_bucket.tolist()))}, {batches} batches; "
        f"vs in-process predict step at the served bucket: "
        f"{int((labels == want).sum())}/{len(answers)} labels equal "
        f"({int(tie.sum())} within {TOL_CONF:g} of a tie), max conf err "
        f"{conf_err:.3g} (tol {TOL_CONF:g}); K1 launches {launches}")
    if ((labels != want) & ~tie).any() or conf_err > TOL_CONF \
            or launches != 0:
        fail(f"served {name} answers disagree with the in-process predict "
             f"step, or the server launched K1 ({launches})")
    return batches


def phase_zoo_main_path() -> None:
    """The five zoo models trained one epoch each by ``train`` (and resnet
    fine-tuned from a torchvision-layout file with ``--use-pretrained
    --feature-extract``), all six processes at once; then ``test -f`` on
    each best file beside ``serve`` of inception's and vgg's."""
    import torch

    from distributedpytorch_tpu_torch import checkpoint as ckpt
    from distributedpytorch_tpu_torch.data.datasets import load_dataset
    from distributedpytorch_tpu_torch.models import get_model, pretrained
    from distributedpytorch_tpu_torch.precision import PRESETS

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from _torch_zoo import TorchResNet18

    write_zoo_data()
    weights = os.path.join(WORK, "resnet18-torchvision-layout.pth")
    torch.manual_seed(SEED)
    torch.save(TorchResNet18(num_classes=10).state_dict(), weights)
    rsl = {name: os.path.join(WORK, f"zoo_{name}") for name in ZOO}
    rsl["pretrained"] = os.path.join(WORK, "zoo_pretrained")
    runs = [start_cli(["train", "--model", name, "-e", "1"], rsl[name],
                      data=ZOO_DATA) for name in ZOO]
    runs.append(start_cli(
        ["train", "--model", "resnet", "-e", "1", "--use-pretrained",
         "--pretrained-path", weights, "--feature-extract"],
        rsl["pretrained"], data=ZOO_DATA))
    results = dict(zip(ZOO + ("pretrained",), finish_all(runs)))
    want_steps = math.ceil(int(ZOO_TRAIN_ROWS * 0.9) / TRAIN_BATCH)
    best = {}
    for name in ZOO:
        wall, log = results[name]
        launches, steps, evals = parse_launches(log, "train")
        losses = zoo_log_losses(log)
        best[name] = os.path.join(rsl[name], f"bestmodel-mnist-{name}.ckpt")
        moved, n_params, finite = moved_params(best[name], name)
        say(f"zoo: `train --model {name}` ({wall:.1f}s of process wall, "
            f"six trainings at once): {steps} steps, {evals} eval batches, "
            f"{len(losses)} logged losses, last train loss "
            f"{losses[-2] if len(losses) > 1 else None}, validation loss "
            f"{losses[-1] if losses else None}; {moved}/{n_params} "
            f"parameters moved; launches {launches}")
        if steps != want_steps or not losses or not all(
                map(math.isfinite, losses)) or not finite or moved == 0 \
                or any(launches.values()):
            fail(f"{name}'s train run: {steps} steps, losses {losses}, "
                 f"{moved} parameters moved, finite {finite}, launches "
                 f"{launches}")

    # --use-pretrained --feature-extract: the backbone as loaded, the head
    # moved
    _, log = results["pretrained"]
    if f"pretrained backbone loaded from {weights}" not in log:
        fail("train --use-pretrained did not log its backbone")
    loaded = get_model("resnet", 10, PRESETS["bf16"], device="cpu")
    loaded.init_weights(torch.Generator().manual_seed(SEED))
    pretrained.load_pretrained("resnet", weights, loaded)
    tuned = ckpt.read_checkpoint(os.path.join(
        rsl["pretrained"], "bestmodel-mnist-resnet.ckpt"))["state"]["params"]
    same = [n for n, p in loaded.named_parameters()
            if torch.equal(tuned[n], p.detach())]
    backbone = [n for n, _ in loaded.named_parameters()
                if not n.startswith("head.")]
    say(f"zoo: `train --model resnet --use-pretrained --feature-extract`: "
        f"{len(set(backbone) & set(same))}/{len(backbone)} backbone "
        f"parameters bit-identical to the loaded file, head moved: "
        f"{'head.weight' not in same}")
    if set(backbone) - set(same) or "head.weight" in same:
        fail("feature extraction changed the pretrained backbone or left "
             "the head")

    # test -f on every best file, beside the two servers
    ds = load_dataset("mnist", os.path.join(WORK, "data"), SEED,
                      synthetic_fallback=True)
    images = ds.splits["test"].images[:ZOO_WAVE]
    servers = {name: start_server(best[name], ZOO_WAVE, FLUSH_MS, "cuda",
                                  attention="full") for name in ZOO_SERVED}
    tests = [start_cli(["test", "-f", best[name]],
                       os.path.join(WORK, f"zoo_test_{name}"),
                       data=ZOO_DATA) for name in ZOO]
    try:
        for name in ZOO_SERVED:
            serve_zoo(best[name], name, servers[name], images)
    finally:
        for _, proc, _, _ in servers.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for name, (_, tlog) in zip(ZOO, finish_all(tests)):
        acc_cli = re.search(r"Time: \d+m \d+s, Acc: ([\d.]+)%",
                            tlog).group(1)
        acc_here, correct, n = eval_accuracy(best[name], name, ZOO_DATA)
        say(f"zoo: `test -f` {name}: {acc_cli}%; in-process eval "
            f"{acc_here}% ({correct}/{n})")
        if acc_cli != acc_here:
            fail(f"{name} test's accuracy disagrees with the in-process "
                 f"eval")


# Steps timed on the host clock and then under the profiler, after two
# of warm-up.  The profiler records the device only: the host-side events
# of densenet's and inception's 9-11 thousand kernels a step made their
# traces' processing the phase's largest cost.
ZOO_PROFILE_STEPS = 5


def phase_zoo_profile() -> None:
    """The five train steps at batch 64, bf16, cuDNN deterministic as in
    ``train``: wall ms per step (host clock, synchronized, profiler off),
    then from ZOO_PROFILE_STEPS steps under torch.profiler (device
    activity only) the device time per step, kernels per step, the idle
    share, and the top device operations."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from distributedpytorch_tpu_torch import utils
    from distributedpytorch_tpu_torch.data.datasets import load_dataset
    from distributedpytorch_tpu_torch.data.pipeline import ResidentLoader
    from distributedpytorch_tpu_torch.models import (get_model,
                                                     get_model_input_size)
    from distributedpytorch_tpu_torch.ops.losses import cross_entropy
    from distributedpytorch_tpu_torch.precision import PRESETS
    from distributedpytorch_tpu_torch.train.engine import Engine

    write_zoo_data()
    ds = load_dataset("mnist", ZOO_DATA, SEED)
    loader = ResidentLoader(ds.splits["train"], TRAIN_BATCH, True, SEED,
                            "cuda")
    reps = ZOO_PROFILE_STEPS
    batches = list(loader.epoch(0))     # 18, taken in turn
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for name in ZOO:
            policy = PRESETS["bf16"]
            model = get_model(name, ds.nb_classes, policy, device="cuda")
            engine = Engine(model, cross_entropy, ds.mean, ds.std,
                            get_model_input_size(name), policy, "cuda")
            state = engine.init_state(torch.Generator().manual_seed(SEED))

            def step(i):
                gen = utils.step_generator(SEED, 0, i, "cuda")
                engine.train_step(state, *batches[i % len(batches)], gen)

            for i in range(2):
                step(i)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(reps):
                step(2 + i)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / reps
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for i in range(reps):
                    step(2 + reps + i)
                torch.cuda.synchronize()
            kernels = device_kernels(prof)
            dev_ms = sum(e.self_device_time_total for e in kernels) \
                / 1e3 / reps
            n_kern = sum(e.count for e in kernels) / reps
            if dev_ms <= 0:
                say(f"profile: {name} train step: wall {wall_ms:.3f} "
                    f"ms/step; device time not measured (no device events)")
                continue
            say(f"profile: {name} train step, batch {TRAIN_BATCH} bf16 at "
                f"{get_model_input_size(name)} px: wall {wall_ms:.3f} "
                f"ms/step, device {dev_ms:.3f} ms in {n_kern:.0f} kernels "
                f"(idle {100 * (1 - dev_ms / wall_ms):.1f}%)")
            top = sorted(kernels, key=lambda e: -e.self_device_time_total)
            say("profile:   top: " + "; ".join(
                f"{e.key[:48]} {e.self_device_time_total / reps:.1f}us"
                f"x{e.count // reps}" for e in top[:5]))
            del model, engine, state
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = deterministic


# a phase's checks that need another phase's output (phase 23 writes
# phase 22's corpus itself when 22 does not run)
PHASE_NEEDS = {7: {6, 8}, 8: {6, 7}}
LAST_PHASE = 24                 # the closing lines; only a full run has it


def parse_phases(argv) -> set:
    """The phases to run: every one (None) with no argument, else those
    of ``--phases 10,12`` plus phase 1 and the phases they need."""
    import argparse

    ap = argparse.ArgumentParser(
        description="Smoke test of the PyTorch/CUDA port on one GPU. With "
                    "no argument every phase runs and the last line is the "
                    "ok line; --phases runs a subset and never prints it.")
    ap.add_argument("--phases", help="comma-separated phase numbers of the "
                    f"docstring's list, 2..{LAST_PHASE - 1} (1 always runs)")
    args = ap.parse_args(argv)
    if args.phases is None:
        return None
    try:
        chosen = {int(p) for p in args.phases.split(",") if p.strip()}
    except ValueError:
        ap.error(f"--phases takes comma-separated integers, got "
                 f"{args.phases!r}")
    bad = sorted(p for p in chosen if not 1 <= p < LAST_PHASE)
    if bad:
        ap.error(f"no phase {bad}: phases are 1..{LAST_PHASE - 1}")
    chosen.add(1)
    for p in sorted(chosen):
        chosen |= PHASE_NEEDS.get(p, set())
    return chosen


def use_bytecode_cache() -> None:
    """Caches the bytecode of every module that this run and its child
    processes import under build/pycache in the checkout.  A Python whose
    packages carry no bytecode (a read-only or freshly copied
    site-packages) otherwise compiles torch's sources anew in each of the
    run's some 30 processes."""
    prefix = os.path.join(ROOT, "build", "pycache")
    os.environ["PYTHONPYCACHEPREFIX"] = prefix
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    sys.pycache_prefix = prefix
    sys.dont_write_bytecode = False


def main(argv=None) -> int:
    chosen = parse_phases(sys.argv[1:] if argv is None else argv)
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
    use_bytecode_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)

    def want(n: int) -> bool:
        return chosen is None or n in chosen

    def run(fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        say(f"chip_smoke: {fn.__name__} took {time.perf_counter() - t:.1f}s")
        return out

    def need_rows(names, where):
        for name in names:
            missing = [k for k in ("ms", "plain_ms", "library_ms")
                       if main_rows[name][k] is None]
            if missing:
                fail(f"torch.profiler returned no device events for "
                     f"{missing} of {name} at {where}")

    card = run(phase_environment)
    main_rows, launches, tc_launches = {}, {}, {}
    if want(2):
        main_rows["flash_fwd"] = run(phase_kernel)[MAIN_ATTN]
        need_rows(["flash_fwd"], "the main path's shape (64, 49, 4, 32) "
                                 "bf16")
    if want(4):
        bwd_rows = run(phase_bwd_kernels)
        for name in ("flash_dq", "flash_dkv"):
            main_rows[name] = bwd_rows[(name,) + MAIN_ATTN]
        need_rows(["flash_dq", "flash_dkv"], "the main path's shape "
                                             "(64, 49, 4, 32) bf16")
    serve_launches = None
    if want(3):
        serve_launches = run(phase_main_path, "cuda")
        run(phase_profile, os.path.join(WORK, "rsl",
                                        "bestmodel-mnist-vit.ckpt"))
    if want(5):
        run(phase_train_step_parity)
    if want(6):
        train_launches, train_tc, best = run(phase_train)
        for name in ("flash_fwd", "flash_dq", "flash_dkv"):
            if train_launches[name] <= 0:
                fail(f"kernel {name} was not launched on the train path")
        launches.update(train_launches)
        # phase 6 fails unless every K1, K2 and K3 took the tensor cores
        tc_launches.update(flash_fwd=train_tc["flash_fwd"],
                           flash_dq=train_tc["flash_dq"],
                           flash_dkv=train_tc["flash_dkv"])
    elif want(18):
        write_vit_data()
    if want(7):
        run(phase_resume_and_test, best)
    if want(9):
        run(phase_train_profile)
    if want(10):
        main_rows["conv_dw"] = conv_dw_main_row(run(phase_conv_dw))
    if want(11):
        run(phase_cnn_step_parity)
    if want(12):
        launches["conv_dw"] = run(phase_cnn_epoch)
        # phase 12 fails unless every one of them took the tensor cores
        tc_launches["conv_dw"] = launches["conv_dw"]
    if want(13):
        run(phase_reference_job)
    if want(14):
        run(phase_ddp_one_card)
    if want(15):
        run(phase_cnn_profile)
    if want(16):
        ring_rows = run(phase_ring_kernels)
        for name in ("flash_fwd_pos", "flash_dq_pos", "flash_dkv_pos"):
            main_rows[name] = ring_rows[(name,) + RING_MAIN]
        need_rows(["flash_fwd_pos", "flash_dq_pos", "flash_dkv_pos"],
                  "the ring's main shape")
    if want(17):
        run(phase_ring_op)
    if want(18):
        ring_launches, ring_tc = run(phase_ring_train)
        for name in ("flash_fwd_pos", "flash_dq_pos", "flash_dkv_pos"):
            if ring_launches[name] <= 0:
                fail(f"kernel {name} was not launched on the ring train "
                     f"path")
        launches.update(ring_launches)
        # phase 18 fails unless every K4, K2p and K3p took the tensor cores
        tc_launches.update(ring_tc)
    if want(19):
        run(phase_ring_steps)
    if want(20):
        run(phase_ring_profile)
    if want(21):
        run(phase_zoo_parity)
    if want(22):
        run(phase_zoo_main_path)
    if want(23):
        run(phase_zoo_profile)
    kernels = [{"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches.get(name),
                **main_rows[name]} for name, source, replaces in KERNELS
               if chosen is None or name in main_rows]
    for row in kernels:
        if row["name"] == "flash_fwd" and serve_launches is not None:
            row["serve_launches"] = serve_launches
        if row["name"] in tc_launches:
            row["tensor_core_launches"] = tc_launches[row["name"]]
    if chosen is not None:
        say(card)
        say(json.dumps({"kernels": kernels}))
        say(f"chip_smoke: partial run: phases {sorted(chosen)} passed in "
            f"{time.perf_counter() - t0:.1f}s; skipped phases "
            f"{sorted(set(range(1, LAST_PHASE + 1)) - chosen)}; no ok line "
            f"(the full run is python3 chip_smoke.py with no argument)")
        return 0
    say(f"chip_smoke: all phases passed in {time.perf_counter() - t0:.1f}s")
    say(card)               # name, power limit: beside the numbers above
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
