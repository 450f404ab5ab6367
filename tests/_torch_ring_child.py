"""One rank of the port's ring checks (``--attention ring|ring_flash``).

Run with the env:// variables (WORLD_SIZE, RANK, LOCAL_RANK,
LOCAL_WORLD_SIZE, MASTER_ADDR, MASTER_PORT) set, or with none of them for
the world of one:

    python tests/_torch_ring_child.py attn IN.pt OUT.pt [--device cpu|cuda]
    python tests/_torch_ring_child.py vit IN.pt OUT.pt [--device cpu|cuda]
        [--model-parallel M]
    python tests/_torch_ring_child.py logits IN.pt OUT.pt [--device ...]
        [--model-parallel M]
    python tests/_torch_ring_child.py loader IN.pt OUT.pt [--device ...]
        [--model-parallel M]

``attn``: the world is one ring (model_parallel = world).  IN.pt holds a
list of cases, each a dict of q, k, v and the output's cotangent w (numpy
(B, S, H, D) float32 arrays), ``causal``, ``use_flash``, ``ragged`` (the
``make_ring_attention`` closure, which pads S to the ring; otherwise
``ring_attention``) and ``dtype``.  The rank writes each case's output
and q/k/v gradients, as float32 numpy arrays, to OUT.pt.

``vit``: IN.pt holds the vit's width (``arch``: dim, depth, heads), its
``attention``, initial ``params`` (a state dict, or None for random
weights from ``seed``) and the ``steps``, each the global batch's images,
labels and valid rows with its affine draws (float32 numpy), and
optionally ``remat`` (none, blocks or full: ``--remat``), ``optimizer``
(SGD by default), ``resume`` (a checkpoint restored, optimizer state
too, before the steps; its gathered state is written as ``resumed``),
``ckpt`` (a file rank 0 writes after the steps, from the gathered state),
``ckpt_dir`` (a checkpoint directory every rank writes after the steps,
``--ckpt-format orbax``, with ``Placement.join`` and ``full_state``
made to raise, as they are while a ``resume`` directory is read)
and ``saved_bytes`` (the bytes the first step's forward saves for the
backward, parameters left out) and, on the card, ``peak_memory`` (the
last step's ``torch.cuda.max_memory_allocated`` and the bytes allocated
before it).  An ``arch`` with ``tensor_parallel``
builds the Megatron vit over the mesh's model group.  The rank keeps its
data shard's rows (``runtime.Mesh``; under a model axis the parameters
are placed over the model group, ``parallel.place``: the initial ones go
in as the rank's slices, and the state written is the gathered whole)
and takes one optimizer step per entry through
``Engine.train_step_affine`` (in ``precision``, f32 by default; with
``overflow`` = (step, rank), that rank's loss numerator of that step is
multiplied by inf), then writes its parameters (and its optimizer state, gathered), the elements of
parameters and optimizer state it holds, the steps' metrics, its step and applied-update counts, its loss scale (or None)
and its kernel launches (all, and on the tensor cores) to OUT.pt.  An
``arch`` with ``scan_layers`` builds the stacked vit (``models/scan.py``;
its state is written in the scan layout).  An ``arch`` with ``moe_experts`` E
builds the switch MoE vit over the world's mesh (``models/moe.py``: the
data group's global batch), a ``grad_accum`` K accumulates K microbatches
a step, and ``eval`` (uint8 images of the global batch, with ``mean`` and
``std``) adds the rank's eval-mode logits of its data shard's rows after
the steps.  IN.pt may hold a list of such specs, each with its own
``model_parallel`` (default: the command line's): they run one after
another in the one world, and OUT.pt holds a list of results.  With ``profile`` = N (on the card), it then times N
more steps of the last batch (host clock, synchronized) and N under
torch.profiler, and writes the per-step wall and device time, kernel
count, the time of the ring kernels and of the host copies, and K2p's and
K3p's launches (on either route, and on the tensor cores).

``logits``: IN.pt holds the vit's ``arch``, ``attention``, ``precision``,
``params`` (a state dict), uint8 ``images`` with their ``mean`` and
``std``, and a ``batch`` size.  Every rank runs the eval transform and the
forward on all the rows, ``batch`` at a time, and writes the float32
logits and its kernel launches to OUT.pt.

``loader``: IN.pt holds uint8 ``images``, int32 ``labels``, the
per-replica ``batch``, ``seed``, ``epoch`` and ``settings``, a list of
(prefetch, producer_threads, device_prefetch).  For each setting the rank
streams the epoch of its data shard through ``ShardedLoader`` and writes
the batches (images, labels, valid as numpy arrays) to OUT.pt.

``tests/test_torch_ring.py`` runs it on the CPU (against the JAX
package), ``chip_smoke.py`` on the card (against one process's flash and
full attention), TF32 off.  Imports no JAX.
"""

import argparse
import contextlib
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from distributedpytorch_tpu_torch import parallel, runtime  # noqa: E402
from distributedpytorch_tpu_torch.cli import (  # noqa: E402
    kernel_launches, tensor_core_launches)
from distributedpytorch_tpu_torch.models.registry import (  # noqa: E402
    attention_fn)
from distributedpytorch_tpu_torch.models.vit import ViT  # noqa: E402
from distributedpytorch_tpu_torch.ops import attention  # noqa: E402
from distributedpytorch_tpu_torch.ops.losses import cross_entropy  # noqa: E402
from distributedpytorch_tpu_torch.precision import PRESETS  # noqa: E402
from distributedpytorch_tpu_torch.train.engine import Engine  # noqa: E402


def run_attn(cases, device, mesh) -> list:
    out = []
    for case in cases:
        dtype = getattr(torch, case["dtype"])
        q, k, v = (torch.from_numpy(case[n]).to(device, dtype)
                   .requires_grad_() for n in "qkv")
        if case["ragged"]:
            fn = attention.make_ring_attention(
                mesh, causal=case["causal"], use_flash=case["use_flash"])
            o = fn(q, k, v)
        else:
            o = attention.ring_attention(q, k, v, mesh,
                                         causal=case["causal"],
                                         use_flash=case["use_flash"])
        w = torch.from_numpy(case["w"]).to(device)
        (o.float() * w).sum().backward()
        out.append({n: t.detach().float().cpu().numpy() for n, t in
                    (("o", o), ("dq", q.grad), ("dk", k.grad),
                     ("dv", v.grad))})
    return out


def profile_steps(step, n: int) -> dict:
    """Wall ms per step over ``n`` synchronized steps, then the device
    time by kernel over ``n`` steps under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]

    def us(*tags):
        return sum(e.self_device_time_total for e in events
                   if all(t in e.key for t in tags)) / n

    def count(*tags):
        return sum(e.count for e in events
                   if all(t in e.key for t in tags)) / n

    top = sorted(events, key=lambda e: -e.self_device_time_total)[:6]
    return {"wall_ms": wall_ms,
            "device_ms": us() / 1e3,
            "kernels": sum(e.count for e in events) / n,
            # K4, K2p and K3p on either route (the tensor-core kernels are
            # *_mma_*)
            "k4_us": us("flash_fwd_"), "k2p_us": us("flash_dq_"),
            "k3p_us": us("flash_dkv_"), "memcpy_us": us("Memcpy"),
            "k4_launches": count("flash_fwd_"),
            "k4_mma_launches": count("flash_fwd_mma"),
            "k2p_launches": count("flash_dq_"),
            "k3p_launches": count("flash_dkv_"),
            "k2p_mma_launches": count("flash_dq_mma"),
            "k3p_mma_launches": count("flash_dkv_mma"),
            "top": [(e.key[:48], e.self_device_time_total / n,
                     e.count // n) for e in top]}


def saved_bytes(model, x) -> int:
    """Bytes of the distinct tensors a train-mode forward of ``x`` saves
    for its backward, the parameters (and their slices) left out."""
    params = {p.data_ptr() for p in model.parameters()}
    seen = {}

    def pack(t):
        if t.data_ptr() not in params:
            seen[t.data_ptr()] = max(seen.get(t.data_ptr(), 0),
                                     t.numel() * t.element_size())
        return t

    model.train()
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        model(x)
    parallel.release(model)
    return sum(seen.values())


def local_elements(model, optimizer) -> tuple:
    """(parameter elements, optimizer-state elements) this rank holds."""
    moments = sum(t.numel() for st in optimizer.state.values()
                  for t in st.values()
                  if isinstance(t, torch.Tensor) and t.dim())
    return sum(p.numel() for p in model.parameters()), moments


@contextlib.contextmanager
def no_gather(on: bool):
    """With ``on``, ``Placement.join`` and ``parallel.full_state`` raise:
    a checkpoint directory is written and read with neither."""
    if not on:
        yield
        return

    def refuse(*_args, **_kw):
        raise AssertionError("a checkpoint directory gathered a tensor")

    saved = parallel.Placement.join, parallel.full_state
    parallel.Placement.join = parallel.full_state = refuse
    try:
        yield
    finally:
        parallel.Placement.join, parallel.full_state = saved


def run_vit(spec, device, mesh) -> dict:
    from distributedpytorch_tpu_torch import checkpoint as ckpt

    policy = PRESETS[spec.get("precision", "f32")]
    arch = dict(spec["arch"])
    if arch.get("moe_experts"):
        arch["moe_mesh"] = mesh
    if arch.pop("tensor_parallel", False):
        arch["tp_mesh"] = mesh
    remat = spec.get("remat", "none")
    model = ViT(dtype=policy.compute_dtype, device=device, num_classes=10,
                attention_fn=attention_fn(spec["attention"], mesh), **arch)
    model.remat_blocks = remat == "blocks"
    engine = Engine(model, cross_entropy, 0.13, 0.31, 28, policy, device,
                    optimizer=spec.get("optimizer", "SGD"),
                    steps_per_epoch=2, mesh=mesh,
                    remat=remat, grad_accum=spec.get("grad_accum", 1))
    state = engine.init_state(torch.Generator().manual_seed(spec["seed"]))
    placement = parallel.placement_of(model)
    if spec["params"] is not None:
        with torch.no_grad():
            for name, p in model.named_parameters():
                full = torch.as_tensor(spec["params"][name])
                p.copy_(full if placement is None
                        else placement.take(name, full))
    resumed = None
    if spec.get("resume"):
        with no_gather(os.path.isdir(spec["resume"])):
            ckpt.load_checkpoint(spec["resume"], model, state.optimizer,
                                 train_state=state)
        resumed = parallel.full_state(model, state.optimizer)
    before, before_tc = kernel_launches(), tensor_core_launches()
    metrics = []
    loss_fn = engine.loss_fn
    overflow = spec.get("overflow")

    def blowup(logits, labels):
        numer, denom = loss_fn(logits, labels)
        return numer * float("inf"), denom

    saved = peak_memory = None
    for i, (images, labels, valid, affine) in enumerate(spec["steps"]):
        engine.loss_fn = (blowup if overflow == (i, runtime.process_index())
                          else loss_fn)
        b = len(images) // mesh.data_parallel
        rows = slice(mesh.data_index * b, (mesh.data_index + 1) * b)
        batch = [torch.from_numpy(np.asarray(a[rows])).to(device)
                 for a in (images, labels, valid)]
        batch[1] = batch[1].long()
        draws = tuple(torch.from_numpy(np.asarray(a[rows])).to(device)
                      for a in affine)
        if spec.get("saved_bytes") and saved is None:
            from distributedpytorch_tpu_torch.data import augment

            saved = saved_bytes(model, augment.train_transform(
                batch[0], 0.13, 0.31, 28, draws,
                out_dtype=policy.compute_dtype))
        peak = spec.get("peak_memory") and i == len(spec["steps"]) - 1
        if peak:
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        _, m = engine.train_step_affine(state, *batch, draws)
        metrics.append([m["loss"].item(), m["correct"].item(),
                        m["valid"].item()])
        if peak:
            peak_memory = (torch.cuda.max_memory_allocated(), held)
    if spec.get("ckpt_dir"):
        with no_gather(True):
            ckpt.save_directory(spec["ckpt_dir"], "vit", model, 0, 1.0,
                                state.optimizer, state.step, state.updates,
                                state.loss_scale)
    params, opt_state = parallel.full_state(model, state.optimizer)
    if spec.get("ckpt"):
        if runtime.is_main():
            ckpt.save_checkpoint(spec["ckpt"], "vit", model, 0, 1.0,
                                 state.optimizer, state.step, state.updates,
                                 state.loss_scale, (params, opt_state))
        runtime.barrier()
    result = {"state": params, "opt_state": opt_state, "resumed": resumed,
              "saved_bytes": saved,
              "peak_memory": peak_memory,
              "elements": local_elements(model, state.optimizer),
              "metrics": metrics,
              "counters": (int(state.step), int(state.updates)),
              "loss_scale": (None if state.loss_scale is None
                             else state.loss_scale.to_dict()),
              "launches": {k: v - before[k]
                           for k, v in kernel_launches().items()},
              "tensor_core": {k: v - before_tc[k]
                              for k, v in tensor_core_launches().items()}}
    if spec.get("eval") is not None:
        from distributedpytorch_tpu_torch.data import augment

        images = spec["eval"]
        b = len(images) // mesh.data_parallel
        x = augment.eval_transform(
            torch.from_numpy(images[mesh.data_index * b:
                                    (mesh.data_index + 1) * b]).to(device),
            spec["mean"], spec["std"], 28, out_dtype=policy.compute_dtype)
        model.eval()
        with torch.no_grad():
            result["eval_logits"] = model(x).float().cpu().numpy()
    if spec.get("profile"):
        result["profile"] = profile_steps(
            lambda: engine.train_step_affine(state, *batch, draws),
            spec["profile"])
    return result


def run_logits(spec, device, mesh) -> dict:
    from distributedpytorch_tpu_torch.data import augment

    policy = PRESETS[spec["precision"]]
    model = ViT(dtype=policy.compute_dtype, device=device, num_classes=10,
                attention_fn=attention_fn(spec["attention"], mesh),
                **spec["arch"])
    model.load_state_dict(spec["params"])
    before = kernel_launches()
    images, n = spec["images"], spec["batch"]
    out = []
    with torch.inference_mode():
        for i in range(0, len(images), n):
            x = augment.eval_transform(
                torch.from_numpy(images[i:i + n]).to(device), spec["mean"],
                spec["std"], 28, out_dtype=policy.compute_dtype)
            out.append(model(x).float().cpu())
    return {"logits": torch.cat(out).numpy(),
            "launches": {k: v - before[k]
                         for k, v in kernel_launches().items()}}


def run_loader(spec, device, mesh) -> dict:
    from distributedpytorch_tpu_torch.data.datasets import Split
    from distributedpytorch_tpu_torch.data.pipeline import ShardedLoader

    split = Split(spec["images"], spec["labels"])
    out = []
    for prefetch, threads, device_prefetch in spec["settings"]:
        loader = ShardedLoader(
            split, spec["batch"], True, spec["seed"], device,
            world=runtime.world_size(), rank=runtime.process_index(),
            model_parallel=mesh.model_parallel, prefetch=prefetch,
            producer_threads=threads, device_prefetch=device_prefetch)
        out.append([tuple(t.cpu().numpy() for t in batch)
                    for batch in loader.epoch(spec["epoch"])])
    return {"batches": out}


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("mode", choices=("attn", "vit", "logits", "loader"))
    p.add_argument("inp")
    p.add_argument("out")
    p.add_argument("--device", default="cpu", choices=("cpu", "cuda"))
    p.add_argument("--model-parallel", type=int, default=0,
                   help="default: the world (one ring)")
    args = p.parse_args()
    if args.device == "cpu":
        torch.set_num_threads(1)
    else:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
    device = runtime.resolve_device(args.device)
    backend = runtime.initialize_distributed(device)
    mesh = runtime.make_mesh(args.model_parallel or runtime.world_size())
    spec = torch.load(args.inp, weights_only=False)
    if args.mode == "vit" and isinstance(spec, list):
        meshes = {}
        results = []
        for one in spec:
            mp = one.get("model_parallel", mesh.model_parallel)
            if mp not in meshes:
                meshes[mp] = (mesh if mp == mesh.model_parallel
                              else runtime.make_mesh(mp))
            results.append(dict(run_vit(one, device, meshes[mp]),
                                data_index=meshes[mp].data_index,
                                model_index=meshes[mp].model_index))
        torch.save(results, args.out)
        runtime.shutdown_distributed()
        return
    if args.mode == "attn":
        result = {"cases": run_attn(spec, device, mesh)}
    elif args.mode == "logits":
        result = run_logits(spec, device, mesh)
    elif args.mode == "loader":
        result = run_loader(spec, device, mesh)
    else:
        result = run_vit(spec, device, mesh)
    result.update(rank=runtime.process_index(), world=runtime.world_size(),
                  backend=backend, data_index=mesh.data_index,
                  model_index=mesh.model_index)
    torch.save(result, args.out)
    runtime.shutdown_distributed()


if __name__ == "__main__":
    main()
