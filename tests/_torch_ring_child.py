"""One rank of the port's ring checks (``--attention ring|ring_flash``).

Run with the env:// variables (WORLD_SIZE, RANK, LOCAL_RANK,
LOCAL_WORLD_SIZE, MASTER_ADDR, MASTER_PORT) set, or with none of them for
the world of one:

    python tests/_torch_ring_child.py attn IN.pt OUT.pt [--device cpu|cuda]
    python tests/_torch_ring_child.py vit IN.pt OUT.pt [--device cpu|cuda]
        [--model-parallel M]
    python tests/_torch_ring_child.py logits IN.pt OUT.pt [--device ...]
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
labels and valid rows with its affine draws (float32 numpy).  The rank
keeps its data shard's rows (``runtime.Mesh``) and takes one SGD step per
entry through ``Engine.train_step_affine`` (in ``precision``, f32 by
default), then writes its parameters, the steps' metrics and its kernel
launches to OUT.pt.  With ``profile`` = N (on the card), it then times N
more steps of the last batch (host clock, synchronized) and N under
torch.profiler, and writes the per-step wall and device time, kernel
count, the time of the ring kernels and of the host copies, and K2p's and
K3p's launches (on either route, and on the tensor cores).

``logits``: IN.pt holds the vit's ``arch``, ``attention``, ``precision``,
``params`` (a state dict), uint8 ``images`` with their ``mean`` and
``std``, and a ``batch`` size.  Every rank runs the eval transform and the
forward on all the rows, ``batch`` at a time, and writes the float32
logits and its kernel launches to OUT.pt.

``tests/test_torch_ring.py`` runs it on the CPU (against the JAX
package), ``chip_smoke.py`` on the card (against one process's flash and
full attention), TF32 off.  Imports no JAX.
"""

import argparse
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from distributedpytorch_tpu_torch import runtime  # noqa: E402
from distributedpytorch_tpu_torch.cli import kernel_launches  # noqa: E402
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


def run_vit(spec, device, mesh) -> dict:
    policy = PRESETS[spec.get("precision", "f32")]
    arch = spec["arch"]
    model = ViT(dtype=policy.compute_dtype, device=device, num_classes=10,
                attention_fn=attention_fn(spec["attention"], mesh), **arch)
    engine = Engine(model, cross_entropy, 0.13, 0.31, 28, policy, device,
                    optimizer="SGD", steps_per_epoch=2, mesh=mesh)
    state = engine.init_state(torch.Generator().manual_seed(spec["seed"]))
    if spec["params"] is not None:
        with torch.no_grad():
            for name, p in model.named_parameters():
                p.copy_(torch.as_tensor(spec["params"][name]))
    before = kernel_launches()
    metrics = []
    for images, labels, valid, affine in spec["steps"]:
        b = len(images) // mesh.data_parallel
        rows = slice(mesh.data_index * b, (mesh.data_index + 1) * b)
        batch = [torch.from_numpy(np.asarray(a[rows])).to(device)
                 for a in (images, labels, valid)]
        batch[1] = batch[1].long()
        draws = tuple(torch.from_numpy(np.asarray(a[rows])).to(device)
                      for a in affine)
        _, m = engine.train_step_affine(state, *batch, draws)
        metrics.append([m["loss"].item(), m["correct"].item(),
                        m["valid"].item()])
    result = {"state": {k: v.detach().cpu().clone()
                        for k, v in model.state_dict().items()},
              "metrics": metrics,
              "launches": {k: v - before[k]
                           for k, v in kernel_launches().items()}}
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


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("mode", choices=("attn", "vit", "logits"))
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
    if args.mode == "attn":
        result = {"cases": run_attn(spec, device, mesh)}
    elif args.mode == "logits":
        result = run_logits(spec, device, mesh)
    else:
        result = run_vit(spec, device, mesh)
    result.update(rank=runtime.process_index(), world=runtime.world_size(),
                  backend=backend, data_index=mesh.data_index,
                  model_index=mesh.model_index)
    torch.save(result, args.out)
    runtime.shutdown_distributed()


if __name__ == "__main__":
    main()
