"""``--epochs-per-dispatch K``: K train and validation epochs a dispatch.

Counterpart of ``Engine._train_epochs`` (``distributedpytorch_tpu/train/
engine.py:582-610``), which scans K (train pass + validation pass) epochs
in one XLA program and returns the per-epoch sums.  The port's counterpart
of one program is a CUDA Graph: ``ChunkRunner`` captures the train step
and the eval step once each (``StepGraph``) and replays them once per step
of the chunk's resident plan, with no read of the device until the chunk
ends, when the per-step train metrics and the per-epoch eval sums come
back in one read.

What a replay reads is on the device, in buffers that outlive the
capture: the chunk's sampler plans (``ResidentLoader.epoch_plan_many``),
copied in before the chunk's first step; a step counter that selects the
plan's row inside the graph and moves on; the model, optimizer and loss
scale state, which the step moves in place.  The step's augmentation and
dropout draws come from one generator registered with the train graph and
seeded with ``utils.step_seed`` before each replay, so every replay draws
what the eager path's per-step generator draws.  The kernels' launch
counters count at capture; after a capture they are moved back by the
capture's launches, and each replay adds them, so a counter reads the
launches of one capture times the replays.

A graph is captured after ``warmup`` real steps run eagerly on a side
stream (3; 11 under DDP, as PyTorch asks before capturing its hooks): the
kernels are built, the optimizer's state and the library workspaces
exist, and nothing has to be rolled back.  A capture that fails raises;
the steps never fall back to eager ones.  On the CPU every step runs
eagerly, the same sync-free step with the chunk's cadence.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from .. import runtime, utils
from ..ops import KERNELS
from .engine import Engine, TrainState

EVAL_KEYS = ("loss_numer", "loss_denom", "correct", "valid")
WARMUP_STEPS = 3
DDP_WARMUP_STEPS = 11


def _launch_counts() -> Dict[str, int]:
    return {f"{name}.{kind}": getattr(fn, kind)
            for name, fn in KERNELS.items()
            for kind in ("launches", "tensor_core_launches")}


def _add_launches(counts: Dict[str, int], times: int) -> None:
    for key, n in counts.items():
        name, kind = key.split(".")
        fn = KERNELS[name]
        setattr(fn, kind, getattr(fn, kind) + times * n)


class StepGraph:
    """``fn`` (no arguments, reads and writes device tensors only) as a
    CUDA Graph on ``device``: its first ``warmup`` calls run it eagerly on
    a side stream, the next one captures it (``generator``, if given,
    registered with the graph) and replays it, every later one replays
    it.  On the CPU every call runs ``fn``."""

    def __init__(self, fn: Callable[[], None], device: torch.device,
                 warmup: int, generator: Optional[torch.Generator] = None):
        self.fn = fn
        self.device = torch.device(device)
        self.warmup = int(warmup)
        self.generator = generator
        self.calls = 0
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.per_replay: Dict[str, int] = {}
        self._side = None

    def __call__(self) -> None:
        if self.device.type != "cuda":
            self.fn()
        elif self.calls < self.warmup:
            if self._side is None:
                self._side = torch.cuda.Stream(self.device)
            main = torch.cuda.current_stream(self.device)
            self._side.wait_stream(main)
            with torch.cuda.stream(self._side):
                self.fn()
            main.wait_stream(self._side)
        else:
            if self.graph is None:
                self._capture()
            self.graph.replay()
            _add_launches(self.per_replay, 1)
        self.calls += 1

    def _capture(self) -> None:
        graph = torch.cuda.CUDAGraph()
        if self.generator is not None:
            graph.register_generator_state(self.generator)
        before = _launch_counts()
        with torch.cuda.graph(graph):
            self.fn()
        self.per_replay = {k: v - before[k]
                           for k, v in _launch_counts().items()}
        _add_launches(self.per_replay, -1)     # the capture ran nothing
        self.graph = graph


class ChunkRunner:
    """The chunks of one training run: ``run(epochs)`` trains and
    evaluates up to ``epochs_per_dispatch`` consecutive epochs and returns
    their sums, read from the device once."""

    def __init__(self, engine: Engine, state: TrainState, train_loader,
                 valid_loader, seed: int, epochs_per_dispatch: int):
        self.engine = engine
        self.state = state
        self.loaders = (train_loader, valid_loader)
        self.seed = int(seed)
        self.steps = (len(train_loader), len(valid_loader))
        dev = train_loader.device
        k = int(epochs_per_dispatch)
        acc = engine.precision.accum_dtype

        def plan(loader, steps):
            width = loader.batch_per_replica * len(loader.samplers)
            return (torch.zeros((k * steps, width), dtype=torch.int64,
                                device=dev),
                    torch.zeros((k * steps, width), dtype=torch.bool,
                                device=dev))

        self.plans = (plan(train_loader, self.steps[0]),
                      plan(valid_loader, self.steps[1]))
        self.counters = (torch.zeros((), dtype=torch.int64, device=dev),
                         torch.zeros((), dtype=torch.int64, device=dev))
        self.train_sums = torch.zeros((k * self.steps[0], 3), dtype=acc,
                                      device=dev)
        self.eval_sums = torch.zeros((k, len(EVAL_KEYS)), dtype=acc,
                                     device=dev)
        self.generator = torch.Generator(device=dev)
        warmup = WARMUP_STEPS if state.ddp is None else DDP_WARMUP_STEPS
        self.train_step = StepGraph(self._train_step, dev, warmup,
                                    self.generator)
        self.eval_step = StepGraph(self._eval_step, dev, warmup)

    def _rows(self, which: int):
        """The images, labels and valid mask of the plan's row at the
        step counter, gathered on the device."""
        idx, valid = self.plans[which]
        row = self.counters[which].view(1)
        ids = idx.index_select(0, row).view(-1)
        loader = self.loaders[which]
        return (loader.images.index_select(0, ids),
                loader.labels.index_select(0, ids),
                valid.index_select(0, row).view(-1))

    def _train_step(self) -> None:
        _, m = self.engine.train_step(self.state, *self._rows(0),
                                      self.generator)
        i = self.counters[0]
        self.train_sums.index_copy_(0, i.view(1), torch.stack(
            [m["loss"], m["correct"], m["valid"]]).view(1, 3).to(
                self.train_sums.dtype))
        i.add_(1)

    def _eval_step(self) -> None:
        m = self.engine.eval_step(self.state, *self._rows(1))
        j = self.counters[1]
        epoch = torch.div(j, self.steps[1], rounding_mode="floor")
        self.eval_sums.index_add_(0, epoch.view(1), torch.stack(
            [m[key] for key in EVAL_KEYS]).view(1, -1).to(
                self.eval_sums.dtype))
        j.add_(1)

    def run(self, epochs: Sequence[int]) -> Dict[str, np.ndarray]:
        """Train and evaluate ``epochs``; returns ``train``, (K, steps, 3)
        loss, correct and valid rows of every step (global sums), and
        ``eval``, (K, 4) numerator, denominator, correct and valid rows of
        every validation pass, summed over the data shards."""
        n = len(epochs)
        for (idx, valid), loader, steps in zip(self.plans, self.loaders,
                                               self.steps):
            plan_idx, plan_valid = loader.epoch_plan_many(epochs)
            idx[:n * steps].copy_(plan_idx)
            valid[:n * steps].copy_(plan_valid)
        for c in self.counters:
            c.zero_()
        self.eval_sums.zero_()
        for epoch in epochs:
            for step in range(self.steps[0]):
                self.generator.manual_seed(
                    utils.step_seed(self.seed, epoch, step))
                self.train_step()
            for _ in range(self.steps[1]):
                self.eval_step()
        evals = runtime.all_reduce_sum(self.eval_sums[:n].clone(),
                                       self.engine.mesh.data_group)
        train = self.train_sums[:n * self.steps[0]]
        out = torch.cat([train.reshape(-1), evals.reshape(-1)]).cpu().numpy()
        cut = train.numel()
        return {"train": out[:cut].reshape(n, self.steps[0], 3),
                "eval": out[cut:].reshape(n, len(EVAL_KEYS))}
