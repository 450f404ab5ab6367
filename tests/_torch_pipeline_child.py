"""One rank of the port's pipeline checks (``--pipeline-parallel``).

Run with the env:// variables (WORLD_SIZE, RANK, LOCAL_RANK,
LOCAL_WORLD_SIZE, MASTER_ADDR, MASTER_PORT) set:

    python tests/_torch_pipeline_child.py IN.pt OUT.pt [--device cpu|cuda]

IN.pt holds a list of specs, run one after another in the one world, each
on the mesh of its ``mesh`` = (model_parallel, seq_parallel) (the world
divided by both is the data axis).  OUT.pt holds a list of results, each
with the rank's ``data_index``, ``model_index`` and ``seq_index``.

``kind`` "fn": the schedule alone (``make_pipeline_fn``): ``params`` (the
twelve stacked tensors by name, numpy float32), ``x`` and ``w`` (the
global batch's tokens (B, S, dim) and the output's cotangent, numpy
float32), ``heads``, ``n_micro`` and ``ring``; with ``placed`` the
stacked tensors that the placement splits go in as the stage's blocks.
The rank feeds its data shard's rows and writes its output rows, the
gradient of sum(out * w) over them for its rows' tokens, the parameters'
gradients summed over the data group (whole: a stage's blocks gathered
over the model group), and the schedule's tick count.

``kind`` "engine": ``PipelinedViT`` of ``arch`` (dim, depth, heads; the
full width by default) with ``n_micro`` microbatches (the ring over the
seq group with ``ring``; on a mesh with no model axis, its blocks in
order; with ``plain``, the plain vit with ``--attention full`` instead)
through ``Engine.train_step_affine`` for each of
``steps`` (the global batch's images, labels, valid rows and affine
draws), with ``optimizer`` (SGD by default) in ``precision`` (f32 by
default), from ``params`` (a state dict, or random weights from
``seed``), optionally first restoring ``resume`` (optimizer state too;
the gathered state written as ``resumed``) and after the steps writing
``ckpt`` (rank 0, from the gathered state) and ``eval`` logits of the
data shard's rows of those uint8 images.  The rank writes the gathered
parameters, its own copies of the tensors it holds whole (to hold the
model group's equal), its elements of parameters and optimizer state,
the steps' metrics and its kernel launches; on the card, with
``profile`` = N, then the wall and device time of N more steps of the
last batch (``_torch_ring_child.profile_steps``).

``tests/test_torch_pipeline.py`` runs it on the CPU (against the JAX
package), ``chip_smoke.py`` on the card (against one process).  Imports
no JAX.
"""

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from distributedpytorch_tpu_torch import parallel, runtime  # noqa: E402
from distributedpytorch_tpu_torch.cli import kernel_launches  # noqa: E402
from distributedpytorch_tpu_torch.models import vit_pipeline  # noqa: E402
from distributedpytorch_tpu_torch.models.vit import ViT  # noqa: E402
from distributedpytorch_tpu_torch.ops.losses import cross_entropy  # noqa: E402
from distributedpytorch_tpu_torch.precision import PRESETS  # noqa: E402
from distributedpytorch_tpu_torch.train.engine import Engine  # noqa: E402

MEAN, STD = 0.13, 0.31


def _rows(a, mesh):
    b = len(a) // mesh.data_parallel
    return a[mesh.data_index * b:(mesh.data_index + 1) * b]


def run_fn(spec, device, mesh) -> dict:
    names = vit_pipeline.STACKED
    depth = spec["params"]["qkv_kernel"].shape[0]
    fn = vit_pipeline.make_pipeline_fn(mesh, mesh.model_parallel, depth,
                                       spec["heads"], spec["n_micro"],
                                       spec["ring"])
    per = depth // mesh.model_parallel
    leaves = {}
    for k in names:
        full = torch.from_numpy(spec["params"][k]).to(device)
        local = spec.get("placed") and parallel.leaf_spec(
            tuple(full.shape), mesh.model_parallel, prefer_axis0=True) == 0
        if local:
            full = full[mesh.model_index * per:(mesh.model_index + 1) * per]
        leaves[k] = full.clone().requires_grad_()
    x = torch.from_numpy(_rows(spec["x"], mesh)).to(device).requires_grad_()
    w = torch.from_numpy(_rows(spec["w"], mesh)).to(device)
    out = fn(leaves, x)
    (out * w).sum().backward()
    grads = {}
    for k, t in leaves.items():
        g = t.grad
        if g.shape[0] != depth:
            g = runtime.all_gather_seq(mesh, g, dim=0)
        g = g.clone()
        runtime.all_reduce_sum(g, mesh.data_group)
        grads[k] = g.cpu().numpy()
    return {"out": out.detach().cpu().numpy(),
            "dx": x.grad.cpu().numpy(), "grads": grads,
            "ticks": fn.schedule.ticks}


def run_engine(spec, device, mesh) -> dict:
    from distributedpytorch_tpu_torch import checkpoint as ckpt
    from distributedpytorch_tpu_torch.data import augment

    policy = PRESETS[spec.get("precision", "f32")]
    arch = spec.get("arch", {})
    if spec.get("plain"):
        model = ViT(dtype=policy.compute_dtype, device=device,
                    num_classes=10, **arch)
    else:
        model = vit_pipeline.PipelinedViT(
            dtype=policy.compute_dtype, device=device, num_classes=10,
            mesh=mesh if mesh.model_parallel > 1 else None,
            n_micro=spec.get("n_micro", 0), ring=spec.get("ring", False),
            **arch)
    engine = Engine(model, cross_entropy, MEAN, STD, 28, policy, device,
                    optimizer=spec.get("optimizer", "SGD"),
                    steps_per_epoch=2, mesh=mesh,
                    grad_accum=spec.get("grad_accum", 1))
    state = engine.init_state(torch.Generator().manual_seed(
        spec.get("seed", 0)))
    placement = parallel.placement_of(model)
    if spec.get("params") is not None:
        with torch.no_grad():
            for name, p in model.named_parameters():
                full = torch.as_tensor(spec["params"][name])
                p.copy_(full if placement is None
                        else placement.take(name, full))
    resumed = None
    if spec.get("resume"):
        ckpt.load_checkpoint(spec["resume"], model, state.optimizer,
                             train_state=state)
        resumed = parallel.full_state(model, state.optimizer)
    before = kernel_launches()
    metrics = []
    for images, labels, valid, affine in spec.get("steps", []):
        batch = [torch.from_numpy(np.asarray(_rows(a, mesh))).to(device)
                 for a in (images, labels, valid)]
        batch[1] = batch[1].long()
        draws = tuple(torch.from_numpy(np.asarray(_rows(a, mesh))).to(device)
                      for a in affine)
        _, m = engine.train_step_affine(state, *batch, draws)
        metrics.append([m["loss"].item(), m["correct"].item(),
                        m["valid"].item()])
    launches = {k: v - before[k] for k, v in kernel_launches().items()}
    params, opt_state = parallel.full_state(model, state.optimizer)
    if spec.get("ckpt"):
        if runtime.is_main():
            ckpt.save_checkpoint(spec["ckpt"], "vit", model, 0, 1.0,
                                 state.optimizer, state.step, state.updates,
                                 state.loss_scale, (params, opt_state))
        runtime.barrier()
    whole = {n: p.detach().cpu().clone() for n, p in model.named_parameters()
             if placement is None or n not in placement.shards}
    moments = sum(t.numel() for st in state.optimizer.state.values()
                  for t in st.values()
                  if isinstance(t, torch.Tensor) and t.dim())
    result = {"state": params, "whole": whole, "resumed": resumed,
              "elements": (sum(p.numel() for p in model.parameters()),
                           moments),
              "metrics": metrics, "launches": launches}
    if spec.get("profile"):
        from _torch_ring_child import profile_steps

        result["profile"] = profile_steps(
            lambda: engine.train_step_affine(state, *batch, draws),
            spec["profile"])
    if spec.get("eval") is not None:
        x = augment.eval_transform(
            torch.from_numpy(_rows(spec["eval"], mesh)).to(device), MEAN,
            STD, 28, out_dtype=policy.compute_dtype)
        model.eval()
        with torch.no_grad():
            result["eval_logits"] = model(x).float().cpu().numpy()
    return result


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("inp")
    p.add_argument("out")
    p.add_argument("--device", default="cpu", choices=("cpu", "cuda"))
    args = p.parse_args()
    if args.device == "cpu":
        torch.set_num_threads(1)
    else:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        # the ranks of a model group compute their replicated tensors'
        # gradients apart: cuDNN's atomics would set them apart
        torch.backends.cudnn.deterministic = True
    device = runtime.resolve_device(args.device)
    runtime.initialize_distributed(device)
    meshes, results = {}, []
    for spec in torch.load(args.inp, weights_only=False):
        key = tuple(spec["mesh"])
        if key not in meshes:
            meshes[key] = runtime.make_mesh(*key)
        mesh = meshes[key]
        run = run_fn if spec["kind"] == "fn" else run_engine
        results.append(dict(run(spec, device, mesh),
                            data_index=mesh.data_index,
                            model_index=mesh.model_index,
                            seq_index=mesh.seq_index))
    torch.save(results, args.out)
    runtime.shutdown_distributed()


if __name__ == "__main__":
    main()
