"""The port's entry point: ``python -m distributedpytorch_tpu_torch
{train,test,serve,fleet,telemetry,goodput,timeline,roofline,incidents}``.

Counterpart of ``distributedpytorch_tpu/cli.py``:

  * ``run_train`` follows ``run_train``/``_train_world``/
    ``_run_train_epochs`` (:601-1016, :1208-1335) with ``_run_train_pass``,
    ``_run_eval_pass`` and ``_progress_logs`` (:335-476), and
    ``--epochs-per-dispatch K`` > 1 follows ``_run_train_chunked``
    (:479-600): K epochs a chunk, each step a replay of a captured CUDA
    Graph on the card (``train/dispatch.py``), per-epoch log lines from
    one read at the chunk's end, the rolling checkpoint once a chunk and
    the best file whenever an epoch of the chunk improved.
    ``--precision f16`` scales the loss (skipped steps and the final
    scale are logged), ``--grad-accum K`` accumulates K
    microbatches a step, and ``--ckpt-async`` hands rank 0's checkpoint
    writes and rotation deletes to a background ``AsyncSaver`` (joined
    before a preemption exit and closed before telemetry; a directory of
    a world of several ranks is saved synchronously, as in JAX).  Under
    ``torchrun`` (or any env:// launch) every
    process is one data-parallel rank (``runtime.py``); a plain launch is
    a world of one.  The data is device-resident (a step gathers its
    rank's rows on the device) or streamed (``--data-mode stream``, or
    ``auto`` over the budget of ``_resident_budget_bytes``: gathered on
    the host and copied to the device a step at a time); either way a
    step draws the global batch's augmentation
    from a generator seeded from (seed, epoch, step), and per-step metrics
    (global sums) stay on the device until one read per epoch.  Rank 0
    writes ``test.log`` and the checkpoints: the rolling one every epoch
    and the best model on improvement, with the best loss updated before
    the save.  cuDNN is set deterministic, so a resumed run reproduces an
    uninterrupted one bit for bit.
  * Observability as ``_run_train_pass``/``_run_train_epochs``/
    ``_run_train_chunked`` carry it in the JAX package (:191-224,
    :403-476, :479-600, :1215-1271): the flight recorder (on by default)
    records every step and feeds ``--anomaly-capture``'s detector; the
    goodput ledger (with ``--telemetry`` or ``--metrics-port``) charges
    each step's dispatch to ``compute`` and its wait to ``data_wait`` and
    reconciles at each epoch or chunk; ``--metrics-port`` serves
    ``/metrics`` and ``/healthz``; ``throughput/mfu`` is written each
    epoch against the card's peak (``ops/flops.py``); ``--profile``
    traces the second epoch with ``torch.profiler`` into RSL_PATH/trace
    and writes its roofline.  With the recorder and telemetry off, the
    step loop does no added work a step.  ``--aot-warmup``
    (``_aot_warmup``, JAX :231-330) builds and loads the run's kernel
    libraries and runs one train step and one eval forward on a
    throwaway copy of the model before epoch 1, recording
    ``compile/warmup_s``, ``compile/cache_hit`` (every library found
    built) and RSL_PATH/costs.json; it leaves the state, the generators
    and the launch counters as they were.  ``--compilation-cache-dir``
    and ``--no-compile-cache`` pick the kernels' build directory
    (``ops/build.py``).
  * Faults and elastic worlds as the JAX ``run_train`` carries them
    (:601-918, :1019-1205): ``--fault-plan`` is installed before the
    process group's init; every epoch (or chunk) ends at
    ``_health_boundary``, one ``runtime.agree_health`` all-gather of the
    failed, shutdown and grow flags (goodput ``collective_skew``),
    bounded by ``--health-timeout``; a failure anywhere inside the epoch,
    a DDP backward whose peer died included, reaches it.  Without
    ``--elastic`` a failed or vanished peer ends every rank together
    (``faults.PeerFailureError``, exit 1); with it the healthy ranks
    raise ``elastic.WorldChangedError`` and ``run_train``'s loop tears the
    world down, rendezvouses (``elastic.reconfigure``), reshards the
    loaders and reruns ``_train_world`` from the newest checkpoint, at
    most ``--max-reconfigures`` times; join claims scanned at the
    boundary grow the world the same way, and ``--elastic-join`` enters a
    running world.  Launch ``--elastic`` ranks one process each with the
    env:// variables set by hand: torchrun's agent ends every rank when
    one exits non-zero.
  * ``run_test`` follows ``run_test`` (:1338-1415): every rank evaluates
    its shard of the test split and the sums are all-reduced.  It reads
    the port's checkpoints and the JAX package's msgpack files.
  * ``run_serve`` follows ``_serve_warmup``, ``_serve_build_replica`` and
    ``run_serve`` (:1418-1705): one replica a rank process, on
    ``--serve-port`` + its initial rank, with the fault plan, the flight
    recorder, the goodput ledger and, with ``--metrics-port``, the
    exporter on ``--metrics-port`` + rank, whose ``/healthz`` carries the
    tier's ``serve`` block; ``/admin/reload`` hot-swaps the served
    checkpoint (a port file or a JAX-written one) between batches; a
    world of several replicas (or ``--elastic``) agrees on health between
    batches, and under ``--elastic`` survives the loss of a replica as
    ``run_train`` does, rebuilding the replica from the checkpoint it
    serves.  Launch several replicas one process each with the env://
    variables set by hand, as ``--elastic`` training ranks are launched.
  * ``fleet`` runs the collector (``fleet.py``) and ``telemetry``,
    ``goodput``, ``timeline``, ``roofline`` and ``incidents`` read a run
    directory offline, as ``main`` dispatches them in the JAX package
    (:1710-1790).

Under ``--model-parallel M`` the world is the JAX (world / M, M) mesh
(``runtime.Mesh``): a rank trains and evaluates its data shard's rows,
the parameters and optimizer state are placed over the M ranks of a
shard (``parallel.py``; ``Engine.init_state``, wherever the state is
built, restored or rebuilt after an elastic reconfigure), which split
the vit's tokens in the ring of ``--attention ring|ring_flash``, its
heads under ``--tensor-parallel`` and a MoE vit's experts, and run the
vit's blocks as GPipe stages under ``--pipeline-parallel``
(``--seq-parallel S`` adds the third mesh axis, the (world / (M*S), M,
S) mesh, whose seq groups ring inside the stages; a data shard's rows
are dealt to its M x S ranks), and the loss and metric sums count each
shard once.  Every rank gathers the full state before rank 0 writes a
checkpoint file, the same file a replicated run writes, and a rank takes
its slices of any file it restores (a vit file of the other block layout
converted first).  With ``--ckpt-format orbax`` (JAX ``_save_ckpt``,
:118-160) every rank writes its own slices into a checkpoint directory
and nothing is gathered; ``train -f``, ``test -f`` and ``serve -f`` read
a directory (``os.path.isdir``), each rank the chunks of its slices, at
any ``--model-parallel``.

The reference's log lines are kept word for word in RSL_PATH/test.log
(the ``process:`` line adds the backend of a process group; a ``mesh:``
line names what the model group carries, and its transport).  ``train``
and ``test`` log the launches of kernels K1 (flash_fwd), K2 (flash_dq),
K3 (flash_dkv) and K5 (conv_dw) on rank 0, and on a second line those of the ring's K4 (flash_fwd_pos),
K2p (flash_dq_pos) and K3p (flash_dkv_pos), then the same two lines of
their launches on the tensor-core route; ``serve`` logs K1's, and how
many of them took the tensor cores.  The device is ``cuda`` unless
``--device cpu`` is given; without a GPU the run stops with one line
instead of running on the CPU.
"""

from __future__ import annotations

import contextlib
import functools
import logging
import math
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from . import checkpoint as ckpt
from . import (costs, elastic, faults, flightrec, goodput, parallel,
               runtime, telemetry, tracing, utils)
from .config import OFFLINE_ACTIONS, RESIDENT_MAX_BYTES, \
    STREAM_DISPATCH_MESSAGE, Config, check_moe, check_pipeline_batch, \
    check_ported, config_from_argv
from .data.datasets import Dataset, Split, load_dataset
from .data.pipeline import ResidentLoader, ShardedLoader
from .models import get_model, get_model_input_size, pretrained
from .ops import KERNELS
from .ops import build as kbuild
from .ops import flash_attention as fa
from .ops import flops as flops_mod
from .ops.losses import get_loss_fn
from .train import dispatch
from .train.dispatch import ChunkRunner
from .train.engine import Engine, Predictor, TrainState, make_optimizer

RING_KERNELS = ("flash_fwd_pos", "flash_dq_pos", "flash_dkv_pos")
RESIDENT_HBM_FRACTION = 0.3


def kernel_launches() -> dict:
    """The launch counters of the port's kernels, by kernel name."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def tensor_core_launches() -> dict:
    """Of those launches, the ones on the tensor-core route (every kernel
    has a tensor-core and a scalar route), by kernel name."""
    return {name: fn.tensor_core_launches for name, fn in KERNELS.items()}


def _launch_line(now: dict, before: dict, ring: bool = False) -> str:
    """The counts of ``now`` since ``before``: of K1, K2, K3 and K5, or
    with ``ring`` of K4, K2p and K3p (those that ``now`` has)."""
    return ", ".join(f"{name} {now[name] - before[name]}" for name in now
                     if (name in RING_KERNELS) == ring)


def _log_launches(action: str, before: dict, before_tc: dict,
                  over: str) -> None:
    """The launch lines since ``before`` (``kernel_launches``) and
    ``before_tc`` (``tensor_core_launches``), the ring kernels' on lines
    of their own."""
    for kind, now, was in (("kernel", kernel_launches(), before),
                           ("tensor-core", tensor_core_launches(),
                            before_tc)):
        for ring in (False, True):
            logging.info(f"{action}: {'ring ' if ring else ''}{kind} "
                         f"launches {_launch_line(now, was, ring)} over "
                         f"{over}")


def _build_engine(cfg: Config, model_name: str, dataset: Dataset,
                  steps_per_epoch: int, device: torch.device,
                  mesh: runtime.Mesh) -> Engine:
    policy = cfg.precision_policy()
    model = get_model(model_name, dataset.nb_classes, policy,
                      attention=cfg.attention, device=device, mesh=mesh,
                      remat=cfg.remat, moe_experts=cfg.moe_experts,
                      tensor_parallel=cfg.tensor_parallel,
                      pipeline_parallel=cfg.pipeline_parallel,
                      pipeline_microbatches=cfg.pipeline_microbatches,
                      scan_layers=cfg.scan_layers)
    class_weights = (dataset.class_weights()
                     if cfg.loss in ("weighted_cross_entropy", "focal_loss")
                     else None)
    loss_fn = get_loss_fn(cfg.loss, class_weights, cfg.focal_gamma,
                          device=device)
    engine = Engine(model, loss_fn, dataset.mean, dataset.std,
                    get_model_input_size(model_name), policy, device,
                    optimizer=cfg.optimizer,
                    learning_rate=cfg.learning_rate, momentum=cfg.momentum,
                    lr_step_gamma=cfg.lr_step_gamma,
                    steps_per_epoch=steps_per_epoch,
                    feature_extract=cfg.feature_extract, mesh=mesh,
                    grad_accum=(cfg.grad_accum if cfg.action == "train"
                                else 1),
                    remat=cfg.remat)
    # the FLOP count's head and experts
    engine.num_classes = dataset.nb_classes
    engine.moe_experts = cfg.moe_experts
    return engine


def _resident_budget_bytes(device: torch.device) -> int:
    """The byte cap of one split kept device-resident under ``auto`` (JAX
    ``_resident_budget_bytes``, cli.py:73-91): RESIDENT_MAX_BYTES, bounded
    by RESIDENT_HBM_FRACTION of the card's memory (every rank holds the
    whole split, and train and valid are both resident); on the CPU the
    cap alone."""
    budget = RESIDENT_MAX_BYTES
    memory = runtime.device_memory_limit(device)
    if memory is not None:
        budget = min(budget, int(RESIDENT_HBM_FRACTION * memory))
    return budget


def _is_resident(cfg: Config, split: Split, device: torch.device) -> bool:
    """``resident``, or ``auto`` with the split within the budget."""
    return (cfg.data_mode == "resident"
            or (cfg.data_mode == "auto"
                and split.images.nbytes <= _resident_budget_bytes(device)))


def _make_loader(cfg: Config, split: Split, shuffle: bool,
                 device: torch.device, mesh: runtime.Mesh):
    """The resident loader or the streaming one, picked by
    ``_is_resident`` as the JAX ``_make_loader`` picks (cli.py:176-188):
    the rows of each data shard dealt to the M x S ranks of its block."""
    shard = dict(seed=cfg.seed, device=device, world=runtime.world_size(),
                 rank=runtime.process_index(),
                 model_parallel=mesh.shard_ranks)
    if _is_resident(cfg, split, device):
        return ResidentLoader(split, cfg.batch_size, shuffle, **shard)
    return ShardedLoader(split, cfg.batch_size, shuffle, **shard,
                         prefetch=cfg.prefetch,
                         producer_threads=cfg.producer_threads,
                         device_prefetch=cfg.device_prefetch)


def _start(cfg: Config, action: str) -> tuple:
    """Common start of train and test: refusals, the fault plan (before
    the process group's init, whose ``runtime.init`` site it may target),
    device, the process world (``train --elastic-join``: entered as a
    joiner) and its mesh, logging (rank 0 writes RSL_PATH/test.log; the
    other ranks log warnings only), telemetry, the run_start event.
    Returns (device, telemetry, mesh, the join info or None)."""
    check_ported(cfg)
    if cfg.batch_size < 1:
        raise ValueError(f"batch size must be >= 1, got {cfg.batch_size}")
    faults.configure(cfg.fault_plan, cfg.fault_seed, cfg.retry_max_attempts,
                     cfg.retry_base_delay, cfg.retry_timeout)
    device = runtime.resolve_device(cfg.device)
    join_info = None
    if action == "train" and cfg.elastic_join:
        join_info = runtime.join_distributed(_elastic_dir(cfg), device,
                                             timeout_s=cfg.elastic_join_wait)
        backend = runtime.backend()
    else:
        backend = runtime.initialize_distributed(device)
    _enter_world(cfg)
    rank, world = runtime.process_index(), runtime.world_size()
    if runtime.is_main():
        utils.initialize_logging(cfg.rsl_path, cfg.log_file, truncate=True)
    else:
        utils.quiet_logging()
    tel = telemetry.configure(cfg.rsl_path, cfg.telemetry, rank=rank)
    _start_observability(cfg, action, device)
    tel.event("run_start", action=action, model=cfg.model_name,
              dataset=cfg.dataset, world=world,
              processes=runtime.process_count(),
              batch_per_replica=cfg.batch_size, device=str(device),
              backend=backend)
    logging.info(f"process: {rank}/{runtime.process_count()}, world size: "
                 f"{world}" + (f", backend: {backend}" if backend else ""))
    mesh = _make_mesh(cfg, device)
    return device, tel, mesh, join_info


def _enter_world(cfg: Config) -> None:
    """The first collective of every member of a world, made as soon as
    the world forms and before any set-up of the member's own: the
    agreement's group (``runtime.health_group``), whose creation waits
    ``--health-timeout`` for every member.  A joiner's set-up (its
    dataset, its engine or replica) then runs after the group exists,
    and its lateness is no longer charged to the survivors' bound."""
    if runtime.distributed():
        runtime.health_group(cfg.health_timeout)


def _make_mesh(cfg: Config, device: torch.device) -> runtime.Mesh:
    """The world's (data, model[, seq]) mesh, its ``mesh:`` line logged
    when it has a model axis, naming what the model group carries (and
    the seq group: the ring inside the pipeline's stages)."""
    mesh = runtime.make_mesh(cfg.model_parallel, cfg.seq_parallel)
    if mesh.model_parallel > 1:
        staged = runtime.staged_through_host(mesh.model_group, device)
        carries = ["parameters placed"]
        if cfg.pipeline_parallel:
            carries.append("pipeline stages")
        elif cfg.attention in ("ring", "ring_flash"):
            carries.append("the ring")
        if cfg.tensor_parallel:
            carries.append("tensor parallelism")
        if cfg.moe_experts:
            carries.append("the experts")
        seq = (f" x seq {mesh.seq_parallel}" if mesh.seq_parallel > 1
               else "")
        logging.info(
            f"mesh: data {mesh.data_parallel} x model {mesh.model_parallel}"
            f"{seq}, {' and '.join(carries)} over the model group"
            + (" and the ring over seq" if seq else "")
            + f" on {runtime.backend()}"
            + (" (CUDA tensors staged through host memory)" if staged
               else ""))
    return mesh


def _elastic_dir(cfg: Config) -> str:
    return cfg.elastic_dir or elastic.default_elastic_dir(cfg.rsl_path)


def _start_observability(cfg: Config, action: str,
                         device: torch.device) -> None:
    """The flight recorder (and, in ``train``, ``--anomaly-capture``'s
    detector), the goodput ledger (with ``--telemetry``, or in ``train``
    ``--metrics-port``), the exporter (``train``), the cost registry and
    the kernels' build directory, as the JAX ``run_train``/``run_test``
    set them up (cli.py:620-660, :1367-1373)."""
    rank = runtime.process_index()
    rec = flightrec.configure(cfg.rsl_path, cfg.flightrec, rank=rank,
                              ring_size=cfg.flightrec_ring)
    train = action == "train"
    if train and cfg.anomaly_capture:
        flightrec.attach_detector(
            rec, trace_dir=os.path.join(cfg.rsl_path, "anomaly_traces"),
            window=cfg.anomaly_window, mad_k=cfg.anomaly_mad_k,
            rel_factor=cfg.anomaly_rel_factor,
            min_excess_s=cfg.anomaly_min_excess,
            capture_steps=cfg.anomaly_capture_steps,
            max_captures=cfg.anomaly_max_captures, rank=rank)
    goodput.configure(cfg.rsl_path,
                      bool(cfg.telemetry or (train and cfg.metrics_port)),
                      rank=rank, world=runtime.process_count())
    if train and cfg.metrics_port:
        goodput.start_exporter(cfg.metrics_port, rank=rank,
                               world_size_fn=runtime.world_size,
                               generation_fn=elastic.generation)
    costs.reset(flops_mod.device_kind(device))
    if cfg.no_compile_cache:
        kbuild.private_build_dir()
    else:
        kbuild.set_build_dir(cfg.compilation_cache_dir)


def _close_observability(crashed: bool) -> None:
    """The flight recorder's last dump, the exporter, the ledger's final
    reconcile and write, the build directory back to the default (a
    private one removed): before telemetry closes."""
    try:
        flightrec.get().close("crash" if crashed else "run_end")
        goodput.stop_exporter()
        goodput.get().close()
    finally:
        kbuild.reset_build_dir()


def _run_eval_pass(engine: Engine, state: TrainState, loader, epoch: int
                   ) -> tuple[float, float]:
    """One no-grad pass over this rank's data shard; returns (loss,
    accuracy) over the valid rows of every shard (one all-reduce over the
    data group), read from the device once; goodput ``compute``."""
    with goodput.get().timed("compute"), \
            telemetry.get().span("eval_pass", epoch=epoch,
                                 steps=len(loader)):
        totals = None
        for images, labels, valid in loader.epoch(epoch):
            m = engine.eval_step(state, images, labels, valid)
            totals = m if totals is None else {k: totals[k] + m[k]
                                               for k in totals}
        numer, denom, correct, n_valid = runtime.all_reduce_sum(
            torch.stack([totals[k] for k in ("loss_numer", "loss_denom",
                                             "correct", "valid")]),
            engine.mesh.data_group).cpu().tolist()
    return numer / max(denom, 1e-9), correct / max(n_valid, 1.0)


def _progress_logs(epoch: int, losses: np.ndarray) -> None:
    """The reference's every-10% in-epoch log lines, with the mean over
    i + 1 batches."""
    nb_iters = len(losses)
    last_log = 0
    for i in range(nb_iters):
        n = i / nb_iters * 100
        if i and n // 10 > last_log:
            last_log = n // 10
            logging.info(f"\repoch:{epoch:03d} nb batches:{i + 1:04d} "
                         f"mean train loss:{losses[:i + 1].mean():.5f}")


def _run_train_pass(engine: Engine, state: TrainState, loader,
                    epoch: int, seed: int
                    ) -> tuple[TrainState, float, float]:
    """One optimization pass over either loader; per-step metrics stay on
    the device and are read once at the end, which also feeds the
    every-10% log lines.  With the flight recorder, telemetry or the
    goodput ledger on, each step is timed: its dispatch (the host's
    enqueue of the eager step, under a ``train_step`` profiler range)
    and its wait for the loader feed the ``step/dispatch_s`` histogram,
    goodput's ``compute`` and ``data_wait``, the exporter's last-step
    stamp and the flight recorder (and its anomaly detector); with all
    three off the loop does no added work."""
    nb_iters = len(loader)
    hist = []
    main = runtime.is_main()
    tel = telemetry.get()
    rec = flightrec.get()
    gp = goodput.get()
    exporter = goodput.exporter()
    instrument = tel.enabled or rec.enabled or gp.enabled
    step_hist = tel.histogram("step/dispatch_s") if tel.enabled else None
    prev_end = time.perf_counter() if instrument else 0.0
    gp.begin_steps()
    for i, (images, labels, valid) in enumerate(loader.epoch(epoch)):
        if instrument:
            t0 = time.perf_counter()
            with torch.profiler.record_function("train_step"):
                gen = utils.step_generator(seed, epoch, i, loader.device)
                state, m = engine.train_step(state, images, labels, valid,
                                             gen)
            dispatch_s = time.perf_counter() - t0
            if step_hist is not None:
                step_hist.observe(dispatch_s)
        else:
            gen = utils.step_generator(seed, epoch, i, loader.device)
            state, m = engine.train_step(state, images, labels, valid, gen)
        hist.append(torch.stack([m["loss"], m["correct"], m["valid"]]))
        if main:
            print(f"\r{epoch:03d} {i / nb_iters * 100:.0f}%", end="\r")
        if instrument:
            end = time.perf_counter()
            category = gp.step(dispatch_s, t0 - prev_end)
            if exporter is not None:
                exporter.note_step()
            flightrec.observe_step(
                rec, epoch=epoch, step=i, step_s=end - prev_end,
                dispatch_s=dispatch_s, wait_s=t0 - prev_end,
                category=category)
            prev_end = end
    gp.end_steps()
    with gp.timed("compute"):
        metrics = torch.stack(hist).cpu().numpy()  # ONE read per epoch
    losses = metrics[:, 0]
    _progress_logs(epoch, losses)
    return (state, float(losses.mean()),
            float(metrics[:, 1].sum() / max(float(metrics[:, 2].sum()), 1.0)))


def _rotate_ckpt(cfg: Config, saver, model_name: str, epoch: int) -> None:
    """The rolling file's rotation, rank 0, in order with the async
    writer: an earlier epoch's pending write lands before the delete (a
    write after it would bring the file back)."""
    def rotate():
        ckpt.rotate_checkpoint(cfg.rsl_path, cfg.dataset, model_name,
                               epoch, keep=cfg.keep_ckpts)

    if saver is None:
        rotate()
    else:
        saver.submit(rotate)


def _gather_state(cfg: Config, state: TrainState) -> Optional[tuple]:
    """Under a placement and ``--ckpt-format msgpack``, the full
    parameters and optimizer state on the CPU (``parallel.full_state``:
    a collective every rank makes before rank 0 writes), else None: a
    directory is written from every rank's own slices."""
    if cfg.ckpt_format == "orbax" \
            or parallel.placement_of(state.model) is None:
        return None
    with goodput.get().timed("ckpt_blocking"):
        return parallel.full_state(state.model, state.optimizer)


def _save_ckpts(cfg: Config, saver, paths: list, model_name: str,
                state: TrainState, epoch: int, best_valid_loss: float,
                full: Optional[tuple]) -> None:
    """The epoch's checkpoints (JAX ``_save_ckpt``): a file of rank 0,
    written now, or with ``--ckpt-async`` snapshotted now and written by
    ``saver``, ``full`` the gathered state of a placed model
    (``_gather_state``); with ``--ckpt-format orbax`` a directory that
    EVERY rank writes, its own slices (``ckpt.save_directory``)."""
    orbax = cfg.ckpt_format == "orbax"
    if not (orbax or runtime.is_main()):
        return
    args = (model_name, state.model, epoch, best_valid_loss,
            state.optimizer, state.step, state.updates, state.loss_scale)
    for path in paths:
        with goodput.get().timed("ckpt_blocking"):
            if orbax and (saver is not None or cfg.ckpt_async):
                ckpt.save_directory_async(saver, path, *args)
            elif orbax:
                ckpt.save_directory(path, *args)
            elif saver is None:
                ckpt.save_checkpoint(path, *args, full)
            else:
                ckpt.save_checkpoint_async(saver, path, *args, full)


def _epoch_logs(epoch: int, improved: bool, epoch_s: float, end: float,
                start_time: float, train_loss: float, train_acc: float,
                valid_loss: float, valid_acc: float, sps_chip: float,
                world: int) -> None:
    """The reference's four lines after an epoch."""
    epoch_mins, epoch_secs = utils.get_duration(0.0, epoch_s)
    mins, _secs = utils.get_duration(start_time, end)
    logging.info(
        f"{'*' if improved else ' '} Epoch: {epoch + 1:03}  "
        f"| Duration: {epoch_mins:03d}m {epoch_secs:02d}s  "
        f"| Overall duration: {mins / 60:.2f}h")
    logging.info(f"  Train       | Loss: {train_loss:.5f}     "
                 f"  | Acc: {train_acc * 100:.2f}%")
    logging.info(f"  Validation  | Loss: {valid_loss:.5f}     "
                 f"  | Acc: {valid_acc * 100:.2f}%")
    logging.info(f"  Throughput  | {sps_chip:,.0f} "
                 f"samples/s/chip "
                 f"({world} chip{'s' if world > 1 else ''})")


def _epoch_header(epoch: int) -> None:
    logging.info(f"====================== epoch{epoch + 1:4d} "
                 f"======================")


@functools.lru_cache(maxsize=None)
def _flops_per_sample(model_name: str, num_classes: int,
                      moe_experts: int = 0) -> Optional[float]:
    """``ops/flops.py``'s count, once a process per model; None when the
    count fails (the gauge is then a recorded null, never a failed
    run)."""
    try:
        return flops_mod.train_flops_per_sample(model_name, num_classes,
                                                moe_experts=moe_experts)
    # broad on purpose: the count is optional (the MFU gauge and
    # costs.json), as the JAX engine's is (engine.py:177-185)
    except Exception as e:
        logging.warning(f"model FLOPs not counted for {model_name}: {e}")
        return None


def _mfu_factors(engine: Engine, model_name: str) -> tuple:
    """(flops_per_sample, peak_flops_per_chip, peak_dtype) of the MFU
    gauge (JAX ``_mfu_factors``, cli.py:191-204): the model's FLOPs over
    the card's peak at the run's compute type (``compute_peak_label``:
    an f32 run that may take TF32 divides by the TF32 peak); the peak is
    None on the CPU or an unknown card."""
    fps = _flops_per_sample(model_name, engine.num_classes,
                            engine.moe_experts)
    label = flops_mod.compute_peak_label(engine.precision.compute_dtype)
    peak = flops_mod.peak_flops(flops_mod.device_kind(engine.device), label)
    return fps, peak, label


def _record_throughput(tel, sps_chip: float, fps, peak, epoch: int,
                       peak_dtype: str = "bf16") -> None:
    """samples/s/chip, and the MFU as a share of the card's peak when the
    model FLOPs and the peak are known, else a recorded null with its
    reason (JAX ``_record_throughput``, cli.py:207-224)."""
    tel.gauge("throughput/samples_per_sec_per_chip").set(sps_chip,
                                                         epoch=epoch)
    if fps and peak:
        tel.gauge("throughput/mfu").set(sps_chip * fps / peak, epoch=epoch,
                                        peak_dtype=peak_dtype)
    else:
        tel.gauge("throughput/mfu").set(
            None, epoch=epoch, peak_dtype=peak_dtype,
            reason="unknown_peak" if fps else "unknown_model_flops")


def _finish_profile(cfg: Config, prof, tel) -> None:
    """Stop the ``--profile`` session, write its trace under
    RSL_PATH/trace, and (rank 0) costs.json and the trace's roofline.
    Advisory, as in the JAX package: a failed analysis is logged, the run
    goes on."""
    trace_dir = os.path.join(cfg.rsl_path, "trace")
    flightrec.stop_profiler(prof, trace_dir, runtime.process_index())
    if not runtime.is_main():
        return
    logging.info(f"profiler trace written to {trace_dir}")
    costs.save(cfg.rsl_path)
    try:
        from . import roofline

        rep = roofline.analyze(trace_dir, rsl_path=cfg.rsl_path)
        roofline.save_report(rep, cfg.rsl_path)
        roofline.emit_telemetry(rep, tel)
        logging.info(f"roofline: {rep['coverage'] * 100:.1f}% of step time "
                     f"attributed to {rep['n_ops']} ops (top: "
                     f"{rep['ops'][0]['name']})")
    # advisory post-run analysis: a torn trace or a parse bug must never
    # fail the run
    except Exception as e:
        logging.warning(f"roofline analysis skipped: {e}")


def _run_train_epochs(cfg: Config, engine: Engine, state: TrainState,
                      train_loader, valid_loader, model_name: str,
                      start_epoch: int, best_valid_loss: float,
                      start_time: float, shutdown, saver=None) -> dict:
    """The per-epoch loop (ref classif.py:151-192); rank 0 writes the
    checkpoints.  ``--profile`` traces the second epoch (its kernels'
    costs recorded), stopped in a ``finally``.  Any failure inside an
    epoch is carried to ``_health_boundary``, where every rank agrees."""
    history = []
    tel = telemetry.get()
    world = runtime.world_size()
    fps, peak, pdt = (_mfu_factors(engine, model_name) if tel.enabled
                      else (None, None, "bf16"))
    for epoch in range(start_epoch, cfg.nb_epochs):
        epoch_err = None
        try:
            _epoch_header(epoch)
            epoch_start = time.monotonic()
            with contextlib.ExitStack() as stack:
                if cfg.profile and epoch == start_epoch + 1:
                    stack.callback(_finish_profile, cfg,
                                   flightrec.start_profiler(), tel)
                    stack.enter_context(costs.recording_kernels())
                with tel.span("epoch", epoch=epoch):
                    with tel.span("train_pass", epoch=epoch,
                                  steps=len(train_loader)):
                        state, train_loss, train_acc = _run_train_pass(
                            engine, state, train_loader, epoch, cfg.seed)
                    train_end = time.monotonic()
                    valid_loss, valid_acc = _run_eval_pass(
                        engine, state, valid_loader, epoch)
            end = time.monotonic()
            train_samples = len(train_loader) * train_loader.global_batch
            sps_chip = (train_samples / max(train_end - epoch_start, 1e-9)
                        / world)
            _record_throughput(tel, sps_chip, fps, peak, epoch, pdt)
            # best updated BEFORE the checkpoint write, so the rolling file
            # carries the post-epoch best
            improved = valid_loss < best_valid_loss
            if improved:
                best_valid_loss = valid_loss
            _epoch_logs(epoch, improved, end - epoch_start, end, start_time,
                        train_loss, train_acc, valid_loss, valid_acc,
                        sps_chip, world)
            full = _gather_state(cfg, state)
            if runtime.is_main():
                _rotate_ckpt(cfg, saver, model_name, epoch)
            paths = [ckpt.checkpoint_path(cfg.rsl_path, cfg.dataset,
                                          model_name, epoch)]
            if improved:
                paths.append(ckpt.best_model_path(
                    cfg.rsl_path, cfg.dataset, model_name))
            _save_ckpts(cfg, saver, paths, model_name, state, epoch,
                        best_valid_loss, full)
            history.append({"epoch": epoch, "train_loss": train_loss,
                            "train_acc": train_acc, "valid_loss": valid_loss,
                            "valid_acc": valid_acc,
                            "train_s": train_end - epoch_start})
        # broad on purpose: any failure of the epoch (a step, a peer gone
        # in DDP's backward, a checkpoint write, an injected fault)
        # reaches the same agreement on every rank
        except Exception as e:
            epoch_err = e
        stop = _health_boundary(cfg, tel, shutdown, epoch, epoch_err, saver)
        # after the agreement, so the window holds its collective_skew
        goodput.get().reconcile(epoch)
        if stop:
            break
    return {"history": history, "best_valid_loss": best_valid_loss,
            "model_name": model_name, "state": state,
            "preempted": shutdown.requested}


def _peer_loss_exit(tel, epoch: int, err, elastic_on: bool):
    """A peer is GONE (a dead transport mid-collective, or a timed-out
    health agreement): under ``--elastic`` the reconfigure signal,
    otherwise the coordinated exit (JAX ``_peer_loss_exit``,
    cli.py:1062-1080).  Always raises."""
    tel.event("peer_loss", epoch=epoch, elastic=elastic_on,
              error=repr(err))
    tel.flush()
    if elastic_on:
        raise elastic.WorldChangedError(
            f"peer lost during epoch {epoch + 1}: {err}") from err
    flightrec.get().dump("peer_failure")
    raise faults.PeerFailureError(
        f"a peer process vanished during epoch {epoch + 1} ({err}); "
        "exiting") from err


def _health_boundary(cfg: Config, tel, shutdown, epoch: int, err,
                     saver=None) -> bool:
    """The epoch or chunk boundary's agreement (JAX ``_health_boundary``,
    cli.py:1083-1175): ONE ``runtime.agree_health`` all-gather of the
    failed flag, the shutdown flag and the elastic grow vote, timed under
    goodput ``collective_skew`` and bounded by ``--health-timeout``.  A
    rank that failed re-raises its own error and its peers raise
    ``faults.PeerFailureError`` (under ``--elastic``,
    ``elastic.WorldChangedError``); an epoch that died inside a
    collective, or an agreement that timed out, is a peer loss
    (``_peer_loss_exit``); an admissible join claim becomes
    ``WorldChangedError(grow=True)``.  Failure and preemption outrank a
    grow.  Returns True when the run should stop cleanly (preemption),
    after the async writer drained."""
    elastic_on = cfg.elastic
    tel.flush()  # boundary: buffered events hit the disk
    if elastic.is_peer_loss(err):
        # the epoch died inside a collective: the agreement would ride
        # the same broken transport; the local error is the verdict
        _peer_loss_exit(tel, epoch, err, elastic_on)
    admit_ids = _scan_grow(cfg, tel, epoch) if elastic_on else []
    timeout_s = cfg.health_timeout or None
    try:
        with goodput.get().timed("collective_skew"):
            any_failed, any_shutdown, any_grow = runtime.agree_health(
                err is not None, shutdown.requested, timeout_s=timeout_s,
                grow=bool(admit_ids))
    except faults.HealthTimeoutError as timeout_err:
        tel.event("health_timeout", epoch=epoch, timeout_s=timeout_s)
        tel.flush()
        if err is not None:
            raise err  # the local failure outranks the missing peer
        _peer_loss_exit(tel, epoch, timeout_err, elastic_on)
    # broad on purpose: the transport surfaces a dead peer as a
    # RuntimeError whose text names it; anything else re-raises
    except Exception as agree_err:
        if err is None and elastic.is_peer_loss(agree_err):
            _peer_loss_exit(tel, epoch, agree_err, elastic_on)
        raise err if err is not None else agree_err
    # returned at (nearly) the same instant on every rank: the timeline's
    # cross-rank alignment point
    tel.event("health_boundary", epoch=epoch)
    if any_failed:
        tel.event("peer_failure", epoch=epoch, local=err is not None,
                  error=repr(err) if err is not None else None)
        tel.flush()
        flightrec.get().dump("peer_failure")
        if err is not None:
            raise err
        if elastic_on:
            raise elastic.WorldChangedError(
                f"a peer reported failure during epoch {epoch + 1}")
        raise faults.PeerFailureError(
            f"a peer process failed during epoch {epoch + 1}; exiting "
            "with it (health agreement)")
    if any_shutdown:
        shutdown.requested = True
        if saver is not None:
            saver.wait()    # the rolling file is whole before exit
        tel.event("preempt", after_epoch=epoch)
        logging.info(f"preempted after epoch {epoch + 1}: "
                     f"checkpoint written, resume with -f")
        return True
    if any_grow and elastic_on:
        tel.event("elastic/grow", epoch=epoch, joiners=admit_ids)
        tel.flush()
        raise elastic.WorldChangedError(
            f"join claim(s) admitted at the epoch {epoch + 1} boundary;"
            " growing the world", grow=True)
    return False


def _scan_grow(cfg: Config, tel, epoch: int) -> list:
    """The boundary's join poll (JAX ``_scan_grow``, cli.py:1176-1205):
    pending claims through the ``--elastic-target`` policy; rank 0
    answers declines at once, admissions only raise this rank's grow
    vote.  A filesystem hiccup skips the scan (the next boundary
    retries)."""
    elastic_dir = _elastic_dir(cfg)
    try:
        admit, declined = elastic.scan_joins(
            elastic_dir, runtime.process_count(), cfg.elastic_target,
            cfg.elastic_min_world)
        if declined and runtime.is_main():
            elastic.decline_joins(elastic_dir, declined,
                                  elastic.generation() + 1)
            for jid, reason in declined:
                tel.event("elastic/join_declined", epoch=epoch,
                          join_id=jid, reason=reason,
                          target=cfg.elastic_target,
                          min_world=cfg.elastic_min_world)
    except OSError as e:
        logging.warning(f"elastic: join scan failed at the epoch "
                        f"{epoch + 1} boundary (retrying next): {e}")
        return []
    if admit:
        tel.event("elastic/join_admit", epoch=epoch, joiners=admit,
                  target=cfg.elastic_target)
    return admit


def _run_train_chunked(cfg: Config, engine: Engine, state: TrainState,
                       train_loader: ResidentLoader,
                       valid_loader: ResidentLoader, model_name: str,
                       start_epoch: int, best_valid_loss: float,
                       start_time: float, shutdown, saver=None) -> dict:
    """--epochs-per-dispatch K > 1 (JAX ``_run_train_chunked``): K train
    and validation epochs a chunk (``ChunkRunner``), the per-epoch log
    lines of ``_run_train_epochs`` from one read at the chunk's end; only
    the chunk's final state exists, so the rolling checkpoint is written
    once a chunk, and the best file (that state) whenever any epoch of the
    chunk improved the best validation loss."""
    history = []
    tel = telemetry.get()
    world = runtime.world_size()
    fps, peak, pdt = (_mfu_factors(engine, model_name) if tel.enabled
                      else (None, None, "bf16"))
    runner = ChunkRunner(engine, state, train_loader, valid_loader,
                         cfg.seed, cfg.epochs_per_dispatch)
    epoch = start_epoch
    while epoch < cfg.nb_epochs:
        chunk = list(range(epoch, min(epoch + cfg.epochs_per_dispatch,
                                      cfg.nb_epochs)))
        chunk_start = time.monotonic()
        chunk_err = None
        try:
            with goodput.get().timed("compute"), \
                    tel.span("chunk_dispatch", first_epoch=epoch,
                             epochs=len(chunk)):
                out = runner.run(chunk)
            end = time.monotonic()
            per_epoch_s = (end - chunk_start) / len(chunk)
            train_samples = len(train_loader) * train_loader.global_batch
            sps_chip = train_samples / max(per_epoch_s, 1e-9) / world
            _record_throughput(tel, sps_chip, fps, peak, chunk[-1], pdt)
            chunk_improved = False
            for k, e in enumerate(chunk):
                metrics = out["train"][k]
                losses = metrics[:, 0]
                train_loss = float(losses.mean())
                train_acc = float(metrics[:, 1].sum()
                                  / max(float(metrics[:, 2].sum()), 1.0))
                numer, denom, correct, n_valid = out["eval"][k].tolist()
                valid_loss = numer / max(denom, 1e-9)
                valid_acc = correct / max(n_valid, 1.0)
                improved = valid_loss < best_valid_loss
                if improved:
                    best_valid_loss = valid_loss
                    chunk_improved = True
                _epoch_header(e)
                _progress_logs(e, losses)
                _epoch_logs(e, improved, per_epoch_s, end, start_time,
                            train_loss, train_acc, valid_loss, valid_acc,
                            sps_chip, world)
                history.append({"epoch": e, "train_loss": train_loss,
                                "train_acc": train_acc,
                                "valid_loss": valid_loss,
                                "valid_acc": valid_acc,
                                "train_s": per_epoch_s})
            last = chunk[-1]
            full = _gather_state(cfg, state)
            if runtime.is_main():
                # the rolling files of this chunk's earlier epochs were
                # never written; the previous chunk's goes
                for e in [last] + chunk[:-1]:
                    _rotate_ckpt(cfg, saver, model_name, e)
            paths = [ckpt.checkpoint_path(cfg.rsl_path, cfg.dataset,
                                          model_name, last)]
            if chunk_improved:
                paths.append(ckpt.best_model_path(
                    cfg.rsl_path, cfg.dataset, model_name))
            _save_ckpts(cfg, saver, paths, model_name, state, last,
                        best_valid_loss, full)
            epoch = last + 1
        # broad on purpose: any failure of the chunk (a step, a checkpoint
        # write) reaches the same agreement on every rank
        except Exception as e:
            chunk_err = e
        stop = _health_boundary(cfg, tel, shutdown, chunk[-1], chunk_err,
                                saver)
        goodput.get().reconcile(chunk[-1])
        if stop:
            break
    return {"history": history, "best_valid_loss": best_valid_loss,
            "model_name": model_name, "state": state,
            "preempted": shutdown.requested}


def _run_libraries(cfg: Config, device: torch.device) -> tuple:
    """The kernel libraries (``csrc/<name>.cu``) that the run's path
    launches: the flash kernels' two for ``--attention flash`` (K1-K3) or
    ``ring_flash`` (K4, K2p, K3p); none on the CPU (the plain versions
    run there) or for any other model or attention (K5 is reachable from
    the API only)."""
    if device.type != "cuda" or cfg.attention not in ("flash",
                                                      "ring_flash"):
        return ()
    return ("flash_fwd", "flash_bwd")


def _warm_batch(loader, device: torch.device) -> tuple:
    """A step's (images u8, labels, valid) of ``loader``'s shapes: zeros,
    every row valid."""
    rows = loader.batch_per_replica * len(loader.samplers)
    images = torch.zeros((rows,) + tuple(loader.images.shape[1:]),
                         dtype=loader.images.dtype, device=device)
    return (images, torch.zeros(rows, dtype=torch.int64, device=device),
            torch.ones(rows, dtype=torch.bool, device=device))


def _aot_warmup(cfg: Config, engine: Engine, state: TrainState,
                model_name: str, dataset: Dataset, train_loader,
                valid_loader, device: torch.device,
                mesh: runtime.Mesh) -> None:
    """``--aot-warmup`` (JAX ``_aot_warmup``, cli.py:231-330): before epoch
    1 build (in parallel) and load every kernel library the run launches,
    then one train step and one eval forward at the run's batch shapes on
    a throwaway copy of the model (its own optimizer and loss scale, a
    generator of its own, the process's generators forked), which fills
    the libraries' and cuBLAS/cuDNN's workspaces and records the kernels'
    launch shapes in the cost registry; the launch counters are moved
    back by the warmup's launches (as ``train/dispatch.py`` does after a
    capture).  No CUDA Graph is captured: a capture is bound to the live
    state.  Records ``compile/warmup_s``, ``compile/cache_hit`` (1 when
    every library was found built), goodput ``compile``, the programs'
    FLOPs and the MFU denominator in RSL_PATH/costs.json."""
    from .models.registry import freeze_backbone

    tel = telemetry.get()
    t0 = time.perf_counter()
    names = _run_libraries(cfg, device)
    if names:
        with ThreadPoolExecutor(len(names)) as pool:
            built = list(pool.map(kbuild.build, names))
        for name in names:
            kbuild.load(name)
    else:
        built = []
    hit = all(seconds == 0.0 for _, seconds in built)
    counts = dispatch._launch_counts()
    cuda = device.type == "cuda"
    try:
        forked = [device.index if device.index is not None
                  else torch.cuda.current_device()] if cuda else []
        with torch.random.fork_rng(devices=forked), \
                costs.recording_kernels():
            warm = _build_engine(cfg, model_name, dataset,
                                 len(train_loader), device, mesh)
            parallel.place(warm.model, mesh)
            warm.model.load_state_dict(state.model.state_dict())
            if cfg.feature_extract:
                freeze_backbone(warm.model)
            warm_state = TrainState(
                warm.model, make_optimizer(warm.optimizer_name, warm.model,
                                           warm.learning_rate,
                                           warm.momentum),
                loss_scale=warm.fresh_loss_scale())
            gen = (torch.Generator(device=device) if cuda
                   else torch.Generator()).manual_seed(cfg.seed)
            warm.train_step(warm_state, *_warm_batch(train_loader, device),
                            gen)
            warm.eval_step(warm_state, *_warm_batch(valid_loader, device))
            if cuda:
                torch.cuda.synchronize(device)
    finally:
        after = dispatch._launch_counts()
        dispatch._add_launches({k: after[k] - counts[k] for k in counts}, -1)
    warmup_s = time.perf_counter() - t0
    goodput.get().add("compile", warmup_s)
    tel.gauge("compile/warmup_s").set(warmup_s)
    tel.gauge("compile/cache_hit").set(1.0 if hit else 0.0)
    fps, peak, pdt = _mfu_factors(engine, model_name)
    if fps:
        chunked = cfg.epochs_per_dispatch > 1
        for program, per_sample in (
                ("train_graph" if chunked else "train_step", fps),
                ("eval_graph" if chunked else "eval_step", fps / 3.0)):
            costs.record(program, flops=per_sample * cfg.batch_size,
                         note="ops.flops count x the per-replica batch, "
                              "one step")
        costs.record_analytic("train_flops_per_sample",
                              flops_per_sample=fps,
                              note="FlopCounterMode count of the "
                                   "attention='full' model (ops.flops); "
                                   "x global_batch for per-step")
    if peak:
        costs.record_mfu_denominator(peak, pdt,
                                     flops_mod.device_kind(device))
    if runtime.is_main():
        costs.save(cfg.rsl_path)
        logging.info(f"AOT warmup: kernel libraries "
                     f"{', '.join(names) or 'none'} built and loaded, one "
                     f"train step and one eval forward run in "
                     f"{warmup_s:.2f}s "
                     f"({'kernel-cache hit' if hit else 'cold'})")


def run_train(cfg: Config) -> dict:
    """ref train() (classif.py:75-192) on the world of this process, with
    the JAX ``run_train``'s elastic loop (cli.py:601-918): one
    ``_train_world`` per world, a reconfigure between two."""
    if not cfg.checkpoint_file:     # a resume's model: once the file's read
        check_moe(cfg, cfg.model_name)
    check_pipeline_batch(cfg)
    device, tel, mesh, join_info = _start(cfg, "train")
    saver = None
    crashed = True
    try:
        if device.type == "cuda":
            torch.backends.cudnn.deterministic = True
            torch.backends.cudnn.benchmark = False
        logging.info(f"batch size: {cfg.batch_size}/replica "
                     f"({cfg.batch_size * runtime.world_size()} global), "
                     f"prefetch: {cfg.prefetch}")
        if join_info is not None:
            # the joiner's birth certificate: its stream (perhaps a
            # departed rank's file, reopened in append) restarts here
            tel.event("elastic/join", generation=join_info["generation"],
                      new_world=join_info["new_world"],
                      new_rank=join_info["new_rank"],
                      coordinator=join_info["coordinator"])
            tel.gauge("elastic/world_size").set(join_info["new_world"])
            tel.flush()
            flightrec.get().record_event(
                "elastic_join", generation=join_info["generation"],
                new_world=join_info["new_world"])
        model_name = cfg.model_name
        if cfg.checkpoint_file:
            try:
                model_name = ckpt.get_checkpoint_model_name(
                    cfg.checkpoint_file)
            except ValueError as e:
                # a torn head must not stop the restart: the fallback
                # below recovers the state from an earlier snapshot
                logging.warning(f"cannot read model name from "
                                f"{cfg.checkpoint_file!r} ({e}); using "
                                f"--model {cfg.model_name}")
        check_moe(cfg, model_name)
        dataset = load_dataset(cfg.dataset, cfg.data_path, cfg.seed,
                               debug=cfg.debug, log=True,
                               synthetic_fallback=cfg.synthetic_fallback)
        if cfg.epochs_per_dispatch > 1 and not all(
                _is_resident(cfg, dataset.splits[s], device)
                for s in ("train", "valid")):
            # JAX _train_world's refusal, before any work on the device
            raise ValueError(STREAM_DISPATCH_MESSAGE)
        train_loader = _make_loader(cfg, dataset.splits["train"], True,
                                    device, mesh)
        valid_loader = _make_loader(cfg, dataset.splits["valid"], False,
                                    device, mesh)
        # rank 0 writes (and stays rank 0 across reconfigures: losing it
        # loses the world); a background writer failure degrades to
        # synchronous saves (a ckpt_async_degraded event) instead of
        # killing the run at the next join
        if cfg.ckpt_async and runtime.is_main():
            saver = ckpt.AsyncSaver(on_error="degrade")
        start_time = time.monotonic()
        shutdown = utils.GracefulShutdown()
        resume_file = cfg.checkpoint_file
        if join_info is not None and not resume_file:
            # the snapshot the grown world's members restore too
            resume_file = ckpt.newest_checkpoint(cfg.rsl_path, cfg.dataset,
                                                 model_name)
        reconfigures = 0
        with shutdown:
            while True:
                try:
                    result = _train_world(
                        cfg, model_name, dataset, device, mesh,
                        train_loader, valid_loader, resume_file,
                        start_time, shutdown, saver)
                    break
                except elastic.WorldChangedError as e:
                    grow = e.grow
                    reconfigures = _count_reconfigure(cfg, reconfigures, e)
                    # drop what pins the old group (the tracebacks' frames
                    # hold its DDP wrapper and state, the mesh its groups,
                    # the loaders their threads) so that the teardown
                    # closes its sockets
                    exc = e
                    while exc is not None:
                        exc.__traceback__ = None
                        exc = exc.__cause__ or exc.__context__
                    mesh = None
                    if isinstance(train_loader, ShardedLoader):
                        train_loader.release()
                        valid_loader.release()
                    else:
                        train_loader = valid_loader = None
                # outside the except block, whose exception state would
                # hold the traceback until it exits
                with goodput.get().timed("elastic_reconfigure"):
                    mesh, reconfigures = _reconfigure_world(
                        cfg, tel, saver, device, grow, "train",
                        reconfigures)
                    if isinstance(train_loader, ShardedLoader):
                        train_loader = train_loader.reshard(mesh)
                        valid_loader = valid_loader.reshard(mesh)
                    else:
                        train_loader = _make_loader(
                            cfg, dataset.splits["train"], True, device, mesh)
                        valid_loader = _make_loader(
                            cfg, dataset.splits["valid"], False, device,
                            mesh)
                    # None (no snapshot yet) restarts from initialization
                    resume_file = ckpt.newest_checkpoint(
                        cfg.rsl_path, cfg.dataset, model_name)
        if saver is not None:
            saver.wait()
        runtime.barrier()       # every rank returns after rank 0's writes
        crashed = False
        return result
    finally:
        # pending writes land (and their spans) before telemetry closes;
        # the flight record's dump before it too, so a crash leaves both
        try:
            if saver is not None:
                saver.close()
        finally:
            try:
                _close_observability(crashed)
            finally:
                tel.close()


def _train_world(cfg: Config, model_name: str, dataset: Dataset,
                 device: torch.device, mesh: runtime.Mesh, train_loader,
                 valid_loader, resume_file: Optional[str],
                 start_time: float, shutdown, saver) -> dict:
    """Engine, DDP, state and resume for ONE world, then its epochs (JAX
    ``_train_world``, cli.py:919-1016): ``resume_file`` is ``-f`` in the
    first world and the newest rolling snapshot after a reconfigure (None:
    fresh initialization).  The launch lines count this world's
    launches."""
    tel = telemetry.get()
    engine = _build_engine(cfg, model_name, dataset, len(train_loader),
                           device, mesh)
    tel.event("precision_policy", remat=cfg.remat,
              grad_accum=cfg.grad_accum, **engine.precision.describe())
    load_weights = None
    if cfg.use_pretrained:
        def load_weights(model):
            pretrained.load_pretrained(model_name, cfg.pretrained_path,
                                       model)
            logging.info(f"pretrained backbone loaded from "
                         f"{cfg.pretrained_path}")
    state = engine.init_state(torch.Generator().manual_seed(cfg.seed),
                              load_weights)
    if resume_file:
        with goodput.get().timed("ckpt_blocking"):
            start_epoch, best_valid_loss, _step = \
                ckpt.load_checkpoint_with_fallback(
                    resume_file, state.model, state.optimizer,
                    cfg.rsl_path, cfg.dataset, model_name,
                    train_state=state)
    else:
        start_epoch, best_valid_loss = 0, math.inf
    if cfg.elastic and elastic.generation() > 0:
        # where this generation's world picked up
        tel.event("elastic/resume", generation=elastic.generation(),
                  epoch=start_epoch, world=runtime.world_size())
        tel.flush()
    if cfg.aot_warmup:
        _aot_warmup(cfg, engine, state, model_name, dataset,
                    train_loader, valid_loader, device, mesh)
    before, before_tc = kernel_launches(), tensor_core_launches()
    step0, updates0 = int(state.step), int(state.updates)
    loop = (_run_train_chunked if cfg.epochs_per_dispatch > 1
            else _run_train_epochs)
    try:
        result = loop(cfg, engine, state, train_loader, valid_loader,
                      model_name, start_epoch, best_valid_loss, start_time,
                      shutdown, saver)
    finally:
        # every rank's record of this world's launches (only rank 0 logs
        # them), a world left by a reconfigure included
        steps = int(state.step) - step0
        now, now_tc = kernel_launches(), tensor_core_launches()
        tel.event("kernel_launches", steps=steps,
                  generation=elastic.generation(),
                  launches={k: v - before[k] for k, v in now.items()},
                  tensor_core={k: v - before_tc[k]
                               for k, v in now_tc.items()})
    evals = len(result["history"]) * len(valid_loader)
    _log_launches("train", before, before_tc,
                  f"{steps} train steps and {evals} eval batches")
    if state.loss_scale is not None:
        skipped = steps - (int(state.updates) - updates0)
        scale = float(state.loss_scale.scale)
        tel.event("loss_scale", skipped=skipped, steps=steps, scale=scale)
        logging.info(f"train: loss scale {scale:g} "
                     f"after {steps} steps, {skipped} skipped on "
                     f"non-finite gradients")
    result["launches"] = {k: v - before[k] for k, v in now.items()}
    return result


def _elastic_reconfigure(cfg: Config, tel, saver, device: torch.device,
                         grow: bool = False,
                         purpose: str = "train") -> runtime.Mesh:
    """Shrink into the surviving world, or grow into the admitted one,
    and return its mesh (JAX ``_elastic_reconfigure``, cli.py:1019-1061):
    the async writer drained (the newest snapshot is what the new world
    resumes from), the flight record dumped with reason ``reconfigure``,
    then ``elastic.reconfigure``; an ``elastic/reconfigure`` event and the
    ``elastic/world_size`` gauge.  Telemetry keeps its original rank
    file."""
    if saver is not None:
        try:
            saver.wait()
        except Exception as e:
            # lineage verification skips a bad file on restore
            logging.error(f"async checkpoint flush failed during "
                          f"reconfigure (continuing): {e}")
    flightrec.get().dump("reconfigure")
    old_rank = runtime.process_index()
    old_world = runtime.process_count()
    info = elastic.reconfigure(_elastic_dir(cfg), old_rank, old_world,
                               device, grow=grow, target=cfg.elastic_target,
                               min_world=cfg.elastic_min_world,
                               purpose=purpose)
    tel.event("elastic/reconfigure", generation=info["generation"],
              old_world=old_world, new_world=info["new_world"],
              old_rank=old_rank, new_rank=info["new_rank"], grow=grow,
              joined=info["joiners"], coordinator=info["coordinator"],
              purpose=info["purpose"])
    tel.gauge("elastic/world_size").set(info["new_world"])
    tel.flush()
    flightrec.get().record_event("elastic_reconfigure",
                                 generation=info["generation"],
                                 new_world=info["new_world"])
    try:
        _enter_world(cfg)
    # broad on purpose: only a peer loss is caught, anything else re-raises
    except Exception as e:
        if not elastic.is_peer_loss(e):
            raise
        # a member of the new world is gone before its first collective
        tel.event("peer_loss", generation=info["generation"],
                  elastic=True, error=repr(e))
        tel.flush()
        raise elastic.WorldChangedError(
            f"a member of generation {info['generation']} did not reach "
            f"its health group: {e}") from e
    return _make_mesh(cfg, device)


def _count_reconfigure(cfg: Config, reconfigures: int, err) -> int:
    """One more reconfigure for ``err``; over ``--max-reconfigures`` the
    agreed exit."""
    reconfigures += 1
    if reconfigures > cfg.max_reconfigures:
        raise faults.PeerFailureError(
            f"world changed {reconfigures} times, over the "
            f"--max-reconfigures {cfg.max_reconfigures} cap; exiting with "
            "the last failure") from err
    return reconfigures


def _reconfigure_world(cfg: Config, tel, saver, device: torch.device,
                       grow: bool, purpose: str, reconfigures: int) -> tuple:
    """``_elastic_reconfigure`` until a world forms whole (a member lost
    on the way is a shrink more, counted); returns (mesh,
    reconfigures)."""
    while True:
        try:
            return (_elastic_reconfigure(cfg, tel, saver, device, grow,
                                         purpose), reconfigures)
        except elastic.WorldChangedError as e:
            grow = False
            reconfigures = _count_reconfigure(cfg, reconfigures, e)


def run_test(cfg: Config) -> dict:
    """ref test() (classif.py:197-243), one process on one device."""
    device, tel, mesh, _ = _start(cfg, "test")
    crashed = True
    try:
        model_name = ckpt.get_checkpoint_model_name(cfg.checkpoint_file)
        dataset = load_dataset(cfg.dataset, cfg.data_path, cfg.seed,
                               debug=cfg.debug, log=True,
                               synthetic_fallback=cfg.synthetic_fallback)
        test_loader = _make_loader(cfg, dataset.splits["test"], False,
                                   device, mesh)
        engine = _build_engine(cfg, model_name, dataset, len(test_loader),
                               device, mesh)
        state = engine.init_state(torch.Generator().manual_seed(cfg.seed))
        ckpt.load_checkpoint(cfg.checkpoint_file, state.model,
                             restore_optimizer=False)
        before, before_tc = kernel_launches(), tensor_core_launches()
        start_time = time.monotonic()
        loss, acc = _run_eval_pass(engine, state, test_loader, epoch=0)
        mins, secs = utils.get_duration(start_time, time.monotonic())
        crashed = False
    finally:
        try:
            _close_observability(crashed)
        finally:
            tel.close()
    logging.info(f"Time: {mins}m {secs}s, Acc: {acc * 100:.2f}%")
    _log_launches("test", before, before_tc,
                  f"{len(test_loader)} eval batches")
    return {"test_loss": loss, "test_acc": acc, "model_name": model_name}


def _serve_warmup(predictor: Predictor, buckets, sample_shape,
                  sample_dtype) -> None:
    """Run one forward per bucket before the port answers, so every
    request-path batch shape has run once (kernels built and loaded,
    library workspaces allocated).  Recorded as the compile/warmup_s
    gauge, as the JAX package records its AOT warmup."""
    t0 = time.perf_counter()
    for b in buckets:
        predictor.predict_step(np.zeros((b,) + tuple(sample_shape),
                                        sample_dtype))
    if predictor.device.type == "cuda":
        torch.cuda.synchronize(predictor.device)
    warmup_s = time.perf_counter() - t0
    telemetry.get().gauge("compile/warmup_s").set(warmup_s)
    logging.info(f"serve: {len(buckets)} buckets "
                 f"({','.join(str(b) for b in buckets)}) warmed in "
                 f"{warmup_s:.2f}s on {predictor.device}")


def _serve_build_replica(cfg: Config, path: str, model_name: str, dataset,
                         buckets, sample_shape, sample_dtype,
                         device: torch.device):
    """model -> lineage-verified restore of ``path`` -> device -> warmup;
    returns the tier's ``infer`` closure."""
    policy = cfg.precision_policy()
    model = get_model(model_name, dataset.nb_classes, policy,
                      attention=cfg.attention, device=device,
                      moe_experts=cfg.moe_experts,
                      scan_layers=cfg.scan_layers)
    ckpt.restore_for_serving(path, model)
    predictor = Predictor(model, dataset.mean, dataset.std,
                          get_model_input_size(model_name), policy, device)
    _serve_warmup(predictor, buckets, sample_shape, sample_dtype)

    def infer(arr):
        labels, confs = predictor.predict_step(arr)
        # the one device -> host read on the serving path
        return labels.cpu().numpy(), confs.cpu().numpy()

    return infer


class _ServeLaunches:
    """K1's launches since the replica started, split into warm-up and
    batches, kept in telemetry gauges (``kernel/flash_fwd_launches``,
    ``kernel/flash_fwd_tensor_core_launches`` and
    ``kernel/flash_fwd_warmup_launches``, on ``/metrics`` with
    ``--metrics-port``) after every build and every batch."""

    def __init__(self, tel):
        self._tel = tel
        self._k1 = fa.flash_attention_fwd
        self._base = (self._k1.launches, self._k1.tensor_core_launches)
        self.warmup = 0

    def counts(self) -> tuple:
        """(launches, tensor-core launches, warm-up launches)."""
        return (self._k1.launches - self._base[0],
                self._k1.tensor_core_launches - self._base[1], self.warmup)

    def note(self) -> None:
        launches, tensor_core, warmup = self.counts()
        self._tel.gauge("kernel/flash_fwd_launches").set(launches)
        self._tel.gauge("kernel/flash_fwd_tensor_core_launches").set(
            tensor_core)
        self._tel.gauge("kernel/flash_fwd_warmup_launches").set(warmup)

    def build(self, build_infer):
        """``build_infer()``'s closure, its warm-up counted, wrapped to
        note the gauges after each batch."""
        before = self._k1.launches
        infer = build_infer()
        self.warmup += self._k1.launches - before
        self.note()

        def counted(arr):
            out = infer(arr)
            self.note()
            return out

        return counted


def run_serve(cfg: Config) -> dict:
    """Batched, elastic inference from a checkpoint over HTTP (JAX
    ``run_serve``, cli.py:1489-1705): each process is one replica,
    answering on ``--serve-port`` + its initial rank, bound once and kept
    across reconfigures.  Under a multi-process launch or ``--elastic`` the
    dispatcher ticks ``_health_boundary`` between batches (the replica's
    predict step has no collective); a lost peer under ``--elastic``
    tears the world down, reconfigures (``purpose: "serve"``) and rebuilds
    the replica from the checkpoint it serves, the hot-swapped one
    included, while the listener keeps admitting requests."""
    from . import serving

    check_ported(cfg)
    buckets = serving.parse_buckets(cfg.serve_buckets)
    if cfg.serve_queue < max(buckets):
        raise ValueError(
            f"--serve-queue {cfg.serve_queue} is smaller than the "
            f"largest bucket {max(buckets)}: the queue could never "
            "fill a full batch")
    faults.configure(cfg.fault_plan, cfg.fault_seed, cfg.retry_max_attempts,
                     cfg.retry_base_delay, cfg.retry_timeout)
    device = runtime.resolve_device(cfg.device)
    join_info = None
    if cfg.elastic_join:
        join_info = runtime.join_distributed(_elastic_dir(cfg), device,
                                             timeout_s=cfg.elastic_join_wait)
        backend = runtime.backend()
    else:
        backend = runtime.initialize_distributed(device)
    _enter_world(cfg)
    rank = runtime.process_index()
    utils.initialize_logging(cfg.rsl_path, cfg.log_file,
                             truncate=runtime.is_main())
    # Telemetry and request tracing are always on in serve mode: they are
    # the tier's operational surface, as in the JAX package.
    tel = telemetry.configure(cfg.rsl_path, True, rank=rank)
    tracing.configure(cfg.rsl_path, True, rank=rank)
    flightrec.configure(cfg.rsl_path, cfg.flightrec, rank=rank,
                        ring_size=cfg.flightrec_ring)
    goodput.configure(cfg.rsl_path, True, rank=rank,
                      world=runtime.process_count())
    if cfg.metrics_port:
        goodput.start_exporter(cfg.metrics_port, rank=rank,
                               world_size_fn=runtime.world_size,
                               generation_fn=elastic.generation)
    # bound once from the INITIAL rank: ranks renumber at every
    # reconfigure, and a port that moved with them would break every
    # client mid-incident
    port = cfg.serve_port + rank
    tel.event("run_start", action="serve", dataset=cfg.dataset,
              world=runtime.world_size(), processes=runtime.process_count(),
              buckets=list(buckets), port=port, device=str(device),
              backend=backend)
    if join_info is not None:
        tel.event("elastic/join", generation=join_info["generation"],
                  new_world=join_info["new_world"],
                  new_rank=join_info["new_rank"],
                  coordinator=join_info["coordinator"])
        tel.gauge("elastic/world_size").set(join_info["new_world"])
        tel.flush()
    logging.info(f"serve: process {rank}/{runtime.process_count()} on "
                 f"{device}" + (f", backend: {backend}" if backend else "")
                 + f", replica port {port}")

    crashed = True
    tier = None
    try:
        model_name = ckpt.get_checkpoint_model_name(cfg.checkpoint_file)
        dataset = load_dataset(cfg.dataset, cfg.data_path, cfg.seed,
                               debug=cfg.debug, log=runtime.is_main(),
                               synthetic_fallback=cfg.synthetic_fallback)
        images = dataset.splits["test"].images
        sample_shape, sample_dtype = images.shape[1:], images.dtype
        k1 = _ServeLaunches(tel)

        def build(path):
            return k1.build(functools.partial(
                _serve_build_replica, cfg, path, model_name, dataset,
                buckets, sample_shape, sample_dtype, device))

        shutdown = utils.GracefulShutdown()
        reconfigures = 0
        with shutdown:
            tier = serving.ServingTier(
                build(cfg.checkpoint_file), sample_shape, sample_dtype,
                buckets, max_queue=cfg.serve_queue,
                max_latency_s=cfg.serve_max_latency_ms / 1000.0,
                port=port, request_timeout_s=cfg.serve_request_timeout,
                max_requests=cfg.serve_max_requests)
            # the served-model identity rides /livez, the exporter's
            # /healthz serve block and every trace record; current_ckpt
            # follows hot-swaps, so that a rebuild after a reconfigure
            # restores what is actually served
            current_ckpt = [cfg.checkpoint_file]
            tier.set_checkpoint(ckpt.lineage_info(cfg.checkpoint_file))
            tracing.get().set_lineage((tier.checkpoint or {}).get("sha256"))

            def swap_fn(path):
                # the /admin/reload seam: lineage-verify, rebuild the
                # predict closure (restore and warm-up), hand it back to
                # the dispatcher
                new_name = ckpt.get_checkpoint_model_name(path)
                if new_name != model_name:
                    raise ValueError(
                        f"checkpoint {path!r} holds model {new_name!r}; "
                        f"this replica serves {model_name!r}")
                reason = ckpt.verify_checkpoint(path)
                if reason is not None:
                    raise ValueError(f"lineage verification failed for "
                                     f"{path!r}: {reason}")
                new_infer = build(path)
                current_ckpt[0] = path
                return new_infer, ckpt.lineage_info(path)

            tier.set_swap_fn(swap_fn)
            goodput.set_health_extra(tier.stats)
            tier.start()

            def health_fn():
                # the training boundary as it is: ONE agreement of the
                # failure, shutdown and grow flags; a peer loss under
                # --elastic raises WorldChangedError, a clean stop
                # returns True
                return _health_boundary(cfg, tel, shutdown, 0, None)

            multi = runtime.process_count() > 1 or cfg.elastic
            while True:
                try:
                    answered = tier.run(health_fn=health_fn if multi
                                        else None, shutdown=shutdown)
                    break
                except elastic.WorldChangedError as e:
                    grow = e.grow
                    reconfigures = _count_reconfigure(cfg, reconfigures, e)
                    # run_train's release discipline: the old predict
                    # step and the exception chain's frames go before
                    # the teardown
                    tier.set_infer(None)
                    exc = e
                    while exc is not None:
                        exc.__traceback__ = None
                        exc = exc.__cause__ or exc.__context__
                # outside the except block, whose exception state would
                # hold the traceback; the listener keeps admitting into
                # the bounded queue through the window
                with goodput.get().timed("elastic_reconfigure"):
                    _, reconfigures = _reconfigure_world(
                        cfg, tel, None, device, grow, "serve", reconfigures)
                    tier.set_infer(build(current_ckpt[0]))
                logging.info(f"serve: replica rebuilt for generation "
                             f"{elastic.generation()}; resuming with "
                             f"{tier.batcher.depth()} queued requests")
        batches = int(tel.counter("serve/batches").value)
        launches, tc_launches, warm_launches = k1.counts()
        tel.event("kernel_launches", batches=batches,
                  generation=elastic.generation(),
                  launches={"flash_fwd": launches},
                  tensor_core={"flash_fwd": tc_launches},
                  warmup={"flash_fwd": warm_launches})
        logging.info(f"serve: stopped after answering {answered} requests "
                     f"in {batches} batches")
        logging.info(f"serve: flash_fwd launches {launches} "
                     f"({warm_launches} in warm-up), {tc_launches} on the "
                     f"tensor cores")
        crashed = False
        return {"answered": answered, "port": tier.port,
                "model_name": model_name, "batches": batches,
                "flash_launches": launches,
                "flash_tensor_core_launches": tc_launches,
                "flash_warmup_launches": warm_launches,
                "reconfigures": reconfigures}
    finally:
        try:
            if tier is not None:
                tier.close()
            tracing.get().close()
            _close_observability(crashed)
        finally:
            tel.close()


def run_offline(cfg: Config) -> int:
    """The readers of a run directory, the fleet collector, the front
    door and the simulator (JAX ``main``, cli.py:1710-1800): no banner, no
    device, never a member of a world."""
    if cfg.action == "fleet":
        from . import fleet

        return fleet.run_cli(cfg)
    if cfg.action == "frontdoor":
        from .serving import frontdoor

        return frontdoor.run_cli(cfg)
    try:
        if cfg.action == "sim":
            from .sim import runner

            return runner.run_cli(cfg)
        if cfg.action == "incidents":
            from . import slo

            print(slo.incidents_report(cfg.rsl_path))
        elif cfg.action == "telemetry":
            print(telemetry.json_report(cfg.rsl_path) if cfg.report_json
                  else telemetry.report(cfg.rsl_path))
        elif cfg.action == "goodput":
            print(goodput.report(cfg.rsl_path))
        elif cfg.action == "timeline":
            from . import timeline

            print(timeline.run_cli(cfg.rsl_path, out=cfg.timeline_out))
        else:
            from . import roofline

            print(roofline.run_cli(
                cfg.rsl_path, trace_dir=cfg.roofline_trace_dir,
                from_anomaly=cfg.roofline_from_anomaly,
                top=cfg.roofline_top, as_json=cfg.report_json))
    except ValueError as e:
        logging.error(f"{e}, exiting...")
        return 1
    return 0


def main(argv=None) -> int:
    try:
        cfg = config_from_argv(argv)
    except ValueError as e:
        logging.error(f"{e}, exiting...")
        return 1
    if cfg.action in OFFLINE_ACTIONS:
        return run_offline(cfg)
    print("========================= start =========================")
    run = {"train": run_train, "test": run_test, "serve": run_serve}
    try:
        run[cfg.action](cfg)
    except ValueError as e:
        logging.error(f"{e}, exiting...")
        return 1
    except (faults.FatalFaultError, faults.PeerFailureError,
            faults.HealthTimeoutError) as e:
        # the agreed exit: every rank takes it at the same boundary
        logging.error(f"fatal failure: {e}, exiting...")
        return 1
    finally:
        runtime.shutdown_distributed()
    print("========================= end ==========================")
    return 0


if __name__ == "__main__":
    sys.exit(main())
