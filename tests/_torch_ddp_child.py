"""One rank of the port's data-parallel step check.

Run with the env:// variables (WORLD_SIZE, RANK, LOCAL_RANK,
LOCAL_WORLD_SIZE, MASTER_ADDR, MASTER_PORT) set, or with none of them for
the world of one:

    python tests/_torch_ddp_child.py MODEL OUT.pt [--device cpu|cuda]
        [--global-batch N] [--precision f32|f64]

MODEL is ``cnn`` (with K5), ``mlp``, ``resnet_small`` (two stages of
width 8 at 32), ``resnet_shallow`` (resnet18's widths, one block a
stage, at 224) or ``vgg64`` (vgg11_bn's widths at 64, with dropout).
Every rank builds the same global batch from a numpy seed and keeps its
rank-major rows, then takes three SGD steps.  In the first the valid rows
spread unevenly over the ranks (half the batch and the last row).  In f32
the first step's affine draws are injected, with dropout masks drawn for
the global batch from a generator seeded alike on every rank, and the
other two steps draw both from a step generator seeded alike on every
rank.  In f64
(f64 compute, f32 parameters) every step runs on the identity affine.
The rank writes its parameters, BatchNorm buffers, the steps' metrics and
its K5 launches to OUT.pt.  ``tests/test_torch_ddp.py`` runs it on the CPU
and ``chip_smoke.py`` on the card (TF32 off).  Imports no JAX.
"""

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from distributedpytorch_tpu_torch import runtime  # noqa: E402
from distributedpytorch_tpu_torch.data import augment  # noqa: E402
from distributedpytorch_tpu_torch.models import registry  # noqa: E402
from distributedpytorch_tpu_torch.models.resnet import ResNet  # noqa: E402
from distributedpytorch_tpu_torch.ops import conv  # noqa: E402
from distributedpytorch_tpu_torch.ops.losses import cross_entropy  # noqa: E402
from distributedpytorch_tpu_torch.precision import (  # noqa: E402
    PRESETS, PrecisionPolicy)
from distributedpytorch_tpu_torch.train.engine import Engine  # noqa: E402

F64 = PrecisionPolicy(name="f64", param_dtype=torch.float32,
                      compute_dtype=torch.float64, accum_dtype=torch.float64)


def build(name: str, policy: PrecisionPolicy, device):
    """(model, input size)."""
    dtype = policy.compute_dtype
    if name == "resnet_small":
        return ResNet((1, 1), width=8, dtype=dtype, device=device), 32
    if name == "resnet_shallow":
        return ResNet((1, 1, 1, 1), dtype=dtype, device=device), 224
    if name == "vgg64":
        return registry.get_model("vgg", 10, policy, device=device), 64
    return (registry.get_model(name, 10, policy, device=device,
                               pallas_dw=name == "cnn"),
            registry.get_model_input_size(name))


def identity_affine(b: int, device):
    """No rotation, the whole 28x28 image as the crop."""
    zeros = torch.zeros(b, device=device)
    return (zeros, zeros, zeros, zeros + 28.0, zeros + 28.0)


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("model")
    p.add_argument("out")
    p.add_argument("--device", default="cpu", choices=("cpu", "cuda"))
    p.add_argument("--global-batch", type=int, default=8)
    p.add_argument("--precision", default="f32", choices=("f32", "f64"))
    args = p.parse_args()
    if args.device == "cpu":
        torch.set_num_threads(1)
    else:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
    device = runtime.resolve_device(args.device)
    backend = runtime.initialize_distributed(device)
    world, rank = runtime.world_size(), runtime.process_index()
    gb = args.global_batch
    b = gb // world
    rows = slice(rank * b, (rank + 1) * b)
    valid0 = (np.arange(gb) < gb // 2) | (np.arange(gb) == gb - 1)
    policy = PRESETS["f32"] if args.precision == "f32" else F64
    model, size = build(args.model, policy, device)
    engine = Engine(model, cross_entropy, 0.13, 0.31, size, policy, device,
                    optimizer="SGD", steps_per_epoch=2)
    state = engine.init_state(torch.Generator().manual_seed(7))
    rng = np.random.default_rng(3)
    conv.conv3x3_dw.launches = 0
    metrics = []
    for step in range(3):
        images = rng.integers(0, 256, (gb, 28, 28), dtype=np.uint8)
        labels = rng.integers(0, 10, gb)
        u = rng.random((gb, 5), dtype=np.float32)
        valid = valid0 if step == 0 else np.ones(gb, bool)
        batch = tuple(torch.from_numpy(a[rows]).to(device)
                      for a in (images, labels, valid))
        masks = [mk[rows] for mk in engine.draw_dropout_masks(
            torch.Generator(device=device).manual_seed(50 + step), gb)]
        if args.precision == "f64":
            _, m = engine.train_step_affine(
                state, *batch, identity_affine(b, device), masks)
        elif step == 0:
            affine = augment.affine_from_uniform(
                torch.from_numpy(u[rows]).to(device), 28, 28)
            _, m = engine.train_step_affine(state, *batch, affine, masks)
        else:
            gen = torch.Generator(device=device).manual_seed(100 + step)
            _, m = engine.train_step(state, *batch, gen)
        metrics.append([m["loss"].item(), m["correct"].item(),
                        m["valid"].item()])
    torch.save({"state": {k: v.detach().cpu().clone() for k, v in
                          model.state_dict().items()},
                "metrics": metrics, "world": world, "rank": rank,
                "ddp": state.ddp is not None, "backend": backend,
                "k5": conv.conv3x3_dw.launches}, args.out)
    runtime.shutdown_distributed()


if __name__ == "__main__":
    main()
