"""The port's entry point: ``python -m distributedpytorch_tpu_torch
{train,test,serve}``.

Counterpart of ``distributedpytorch_tpu/cli.py`` with a fixed world:

  * ``run_train`` follows ``run_train``/``_train_world``/
    ``_run_train_epochs`` (:601-1016, :1208-1335) with ``_run_train_pass``,
    ``_run_eval_pass`` and ``_progress_logs`` (:335-476): no elastic
    world, fault plans, flight recorder, goodput ledger, exporter, roofline
    or chunked epochs.  Under ``torchrun`` (or any env:// launch) every
    process is one data-parallel rank (``runtime.py``); a plain launch is
    a world of one.  The data is device-resident; a step gathers its
    rank's rows on the device and draws the global batch's augmentation
    from a generator seeded from (seed, epoch, step), and per-step metrics
    (global sums) stay on the device until one read per epoch.  Rank 0
    writes ``test.log`` and the checkpoints: the rolling one every epoch
    and the best model on improvement, with the best loss updated before
    the save.  cuDNN is set deterministic, so a resumed run reproduces an
    uninterrupted one bit for bit.
  * ``run_test`` follows ``run_test`` (:1338-1415): every rank evaluates
    its shard of the test split and the sums are all-reduced.  It reads
    the port's checkpoints and the JAX package's msgpack files.
  * ``run_serve`` follows ``_serve_warmup``, ``_serve_build_replica`` and
    ``run_serve`` (:1418-1705) reduced to one replica: no elastic world,
    metrics exporter, flight recorder, goodput ledger or hot-swap
    (``/admin/reload`` answers 501).

Under ``--model-parallel M`` the world is the JAX (world / M, M) mesh
(``runtime.Mesh``): a rank trains and evaluates its data shard's rows, the
M ranks of a shard split the vit's tokens in the ring of ``--attention
ring|ring_flash``, and the loss and metric sums count each shard once.

The reference's log lines are kept word for word in RSL_PATH/test.log
(the ``process:`` line adds the backend of a process group; a ``mesh:``
line names the ring's transport).  ``train`` and ``test`` log the launches
of kernels K1 (flash_fwd), K2 (flash_dq), K3 (flash_dkv) and K5 (conv_dw)
on rank 0, and on a second line those of the ring's K4 (flash_fwd_pos),
K2p (flash_dq_pos) and K3p (flash_dkv_pos), then the same two lines of
their launches on the tensor-core route; ``serve`` logs K1's, and how
many of them took the tensor cores.  The device is ``cuda`` unless
``--device cpu`` is given; without a GPU the run stops with one line
instead of running on the CPU.
"""

from __future__ import annotations

import logging
import math
import sys
import time

import numpy as np
import torch

from . import checkpoint as ckpt
from . import runtime, telemetry, tracing, utils
from .config import NUM_WORKERS, RESIDENT_MAX_BYTES, Config, \
    check_ported, config_from_argv
from .data.datasets import Dataset, Split, load_dataset
from .data.pipeline import ResidentLoader
from .models import get_model, get_model_input_size, pretrained
from .ops.conv import conv3x3_dw
from .ops import flash_attention as fa
from .ops.losses import get_loss_fn
from .train.engine import Engine, Predictor, TrainState

KERNELS = {"flash_fwd": fa.flash_attention_fwd,
           "flash_dq": fa.flash_attention_dq,
           "flash_dkv": fa.flash_attention_dkv, "conv_dw": conv3x3_dw,
           "flash_fwd_pos": fa.flash_attention_partial_fwd,
           "flash_dq_pos": fa.flash_attention_partial_dq,
           "flash_dkv_pos": fa.flash_attention_partial_dkv}
RING_KERNELS = ("flash_fwd_pos", "flash_dq_pos", "flash_dkv_pos")


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
                      attention=cfg.attention, device=device, mesh=mesh)
    class_weights = (dataset.class_weights()
                     if cfg.loss in ("weighted_cross_entropy", "focal_loss")
                     else None)
    loss_fn = get_loss_fn(cfg.loss, class_weights, cfg.focal_gamma,
                          device=device)
    return Engine(model, loss_fn, dataset.mean, dataset.std,
                  get_model_input_size(model_name), policy, device,
                  optimizer=cfg.optimizer, learning_rate=cfg.learning_rate,
                  momentum=cfg.momentum, lr_step_gamma=cfg.lr_step_gamma,
                  steps_per_epoch=steps_per_epoch,
                  feature_extract=cfg.feature_extract, mesh=mesh)


def _make_loader(cfg: Config, split: Split, shuffle: bool,
                 device: torch.device, mesh: runtime.Mesh
                 ) -> ResidentLoader:
    """The device-resident loader; a split over the resident cap would
    need the streaming loader, which is not ported yet."""
    if cfg.data_mode == "auto" and split.images.nbytes > RESIDENT_MAX_BYTES:
        raise ValueError(f"not ported yet: --data-mode stream (the split's "
                         f"{split.images.nbytes} bytes exceed the resident "
                         f"cap of {RESIDENT_MAX_BYTES})")
    return ResidentLoader(split, cfg.batch_size, shuffle=shuffle,
                          seed=cfg.seed, device=device,
                          world=runtime.world_size(),
                          rank=runtime.process_index(),
                          model_parallel=mesh.model_parallel)


def _start(cfg: Config, action: str) -> tuple:
    """Common start of train and test: refusals, device, the process
    world and its mesh, logging (rank 0 writes RSL_PATH/test.log; the other
    ranks log warnings only), telemetry, the run_start event.  Returns
    (device, telemetry, mesh)."""
    check_ported(cfg)
    if cfg.batch_size < 1:
        raise ValueError(f"batch size must be >= 1, got {cfg.batch_size}")
    device = runtime.resolve_device(cfg.device)
    backend = runtime.initialize_distributed(device)
    rank, world = runtime.process_index(), runtime.world_size()
    if runtime.is_main():
        utils.initialize_logging(cfg.rsl_path, cfg.log_file, truncate=True)
    else:
        utils.quiet_logging()
    tel = telemetry.configure(cfg.rsl_path, cfg.telemetry, rank=rank)
    tel.event("run_start", action=action, model=cfg.model_name,
              dataset=cfg.dataset, world=world,
              processes=runtime.process_count(),
              batch_per_replica=cfg.batch_size, device=str(device),
              backend=backend)
    logging.info(f"process: {rank}/{runtime.process_count()}, world size: "
                 f"{world}" + (f", backend: {backend}" if backend else ""))
    mesh = runtime.make_mesh(cfg.model_parallel)
    if mesh.model_parallel > 1:
        staged = runtime.staged_through_host(mesh.model_group, device)
        logging.info(
            f"mesh: data {mesh.data_parallel} x model {mesh.model_parallel}"
            f", ring over the model group on {backend}"
            + (" (CUDA blocks staged through host memory)" if staged
               else ""))
    return device, tel, mesh


def _run_eval_pass(engine: Engine, state: TrainState,
                   loader: ResidentLoader, epoch: int
                   ) -> tuple[float, float]:
    """One no-grad pass over this rank's data shard; returns (loss,
    accuracy) over the valid rows of every shard (one all-reduce over the
    data group), read from the device once."""
    with telemetry.get().span("eval_pass", epoch=epoch, steps=len(loader)):
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


def _run_train_pass(engine: Engine, state: TrainState,
                    loader: ResidentLoader, epoch: int, seed: int
                    ) -> tuple[TrainState, float, float]:
    """One optimization pass; per-step metrics stay on the device and are
    read once at the end, which also feeds the every-10% log lines."""
    nb_iters = len(loader)
    hist = []
    main = runtime.is_main()
    for i, (images, labels, valid) in enumerate(loader.epoch(epoch)):
        gen = utils.step_generator(seed, epoch, i, loader.device)
        state, m = engine.train_step(state, images, labels, valid, gen)
        hist.append(torch.stack([m["loss"], m["correct"], m["valid"]]))
        if main:
            print(f"\r{epoch:03d} {i / nb_iters * 100:.0f}%", end="\r")
    metrics = torch.stack(hist).cpu().numpy()      # ONE read per epoch
    losses = metrics[:, 0]
    _progress_logs(epoch, losses)
    return (state, float(losses.mean()),
            float(metrics[:, 1].sum() / max(float(metrics[:, 2].sum()), 1.0)))


def _run_train_epochs(cfg: Config, engine: Engine, state: TrainState,
                      train_loader: ResidentLoader,
                      valid_loader: ResidentLoader, model_name: str,
                      start_epoch: int, best_valid_loss: float,
                      start_time: float, shutdown) -> dict:
    """The per-epoch loop (ref classif.py:151-192); rank 0 writes the
    checkpoints."""
    history = []
    tel = telemetry.get()
    world = runtime.world_size()
    for epoch in range(start_epoch, cfg.nb_epochs):
        logging.info(f"====================== epoch{epoch + 1:4d} "
                     f"======================")
        epoch_start = time.monotonic()
        with tel.span("epoch", epoch=epoch):
            with tel.span("train_pass", epoch=epoch,
                          steps=len(train_loader)):
                state, train_loss, train_acc = _run_train_pass(
                    engine, state, train_loader, epoch, cfg.seed)
            train_end = time.monotonic()
            valid_loss, valid_acc = _run_eval_pass(engine, state,
                                                   valid_loader, epoch)
        end = time.monotonic()
        epoch_mins, epoch_secs = utils.get_duration(epoch_start, end)
        mins, _secs = utils.get_duration(start_time, end)
        train_samples = len(train_loader) * train_loader.global_batch
        sps_chip = train_samples / max(train_end - epoch_start, 1e-9) / world
        tel.gauge("throughput/samples_per_sec_per_chip").set(sps_chip,
                                                             epoch=epoch)
        # best updated BEFORE the checkpoint write, so the rolling file
        # carries the post-epoch best
        improved = valid_loss < best_valid_loss
        if improved:
            best_valid_loss = valid_loss
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
        if runtime.is_main():
            ckpt.rotate_checkpoint(cfg.rsl_path, cfg.dataset, model_name,
                                   epoch, keep=cfg.keep_ckpts)
            paths = [ckpt.checkpoint_path(cfg.rsl_path, cfg.dataset,
                                          model_name, epoch)]
            if improved:
                paths.append(ckpt.best_model_path(cfg.rsl_path, cfg.dataset,
                                                  model_name))
            for path in paths:
                ckpt.save_checkpoint(path, model_name, state.model, epoch,
                                     best_valid_loss, state.optimizer,
                                     state.step)
        history.append({"epoch": epoch, "train_loss": train_loss,
                        "train_acc": train_acc, "valid_loss": valid_loss,
                        "valid_acc": valid_acc,
                        "train_s": train_end - epoch_start})
        tel.flush()
        # every rank stops after the same epoch
        if runtime.any_process(shutdown.requested):
            tel.event("preempt", after_epoch=epoch)
            logging.info(f"preempted after epoch {epoch + 1}: "
                         f"checkpoint written, resume with -f")
            break
    return {"history": history, "best_valid_loss": best_valid_loss,
            "model_name": model_name, "state": state,
            "preempted": shutdown.requested}


def run_train(cfg: Config) -> dict:
    """ref train() (classif.py:75-192), one process on one device."""
    device, tel, mesh = _start(cfg, "train")
    try:
        if device.type == "cuda":
            torch.backends.cudnn.deterministic = True
            torch.backends.cudnn.benchmark = False
        logging.info(f"batch size: {cfg.batch_size}/replica "
                     f"({cfg.batch_size * runtime.world_size()} global), "
                     f"prefetch: {NUM_WORKERS}")
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
        dataset = load_dataset(cfg.dataset, cfg.data_path, cfg.seed,
                               debug=cfg.debug, log=True,
                               synthetic_fallback=cfg.synthetic_fallback)
        train_loader = _make_loader(cfg, dataset.splits["train"], True,
                                    device, mesh)
        valid_loader = _make_loader(cfg, dataset.splits["valid"], False,
                                    device, mesh)
        engine = _build_engine(cfg, model_name, dataset, len(train_loader),
                               device, mesh)
        tel.event("precision_policy", remat="none", grad_accum=1,
                  **engine.precision.describe())
        load_weights = None
        if cfg.use_pretrained:
            def load_weights(model):
                pretrained.load_pretrained(model_name, cfg.pretrained_path,
                                           model)
                logging.info(f"pretrained backbone loaded from "
                             f"{cfg.pretrained_path}")
        state = engine.init_state(torch.Generator().manual_seed(cfg.seed),
                                  load_weights)
        if cfg.checkpoint_file:
            start_epoch, best_valid_loss, state.step = \
                ckpt.load_checkpoint_with_fallback(
                    cfg.checkpoint_file, state.model, state.optimizer,
                    cfg.rsl_path, cfg.dataset, model_name)
        else:
            start_epoch, best_valid_loss = 0, math.inf
        before, before_tc = kernel_launches(), tensor_core_launches()
        step0 = state.step
        start_time = time.monotonic()
        shutdown = utils.GracefulShutdown()
        with shutdown:
            result = _run_train_epochs(cfg, engine, state, train_loader,
                                       valid_loader, model_name, start_epoch,
                                       best_valid_loss, start_time, shutdown)
        runtime.barrier()       # every rank returns after rank 0's writes
        steps = state.step - step0
        evals = len(result["history"]) * len(valid_loader)
        _log_launches("train", before, before_tc,
                      f"{steps} train steps and {evals} eval batches")
        result["launches"] = {k: v - before[k]
                              for k, v in kernel_launches().items()}
        return result
    finally:
        tel.close()


def run_test(cfg: Config) -> dict:
    """ref test() (classif.py:197-243), one process on one device."""
    device, tel, mesh = _start(cfg, "test")
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


def _serve_build_replica(cfg: Config, model_name: str, dataset, buckets,
                         sample_shape, sample_dtype, device: torch.device):
    """model -> lineage-verified restore -> device -> warmup; returns the
    tier's ``infer`` closure."""
    policy = cfg.precision_policy()
    model = get_model(model_name, dataset.nb_classes, policy,
                      attention=cfg.attention, device=device)
    ckpt.restore_for_serving(cfg.checkpoint_file, model)
    predictor = Predictor(model, dataset.mean, dataset.std,
                          get_model_input_size(model_name), policy, device)
    _serve_warmup(predictor, buckets, sample_shape, sample_dtype)

    def infer(arr):
        labels, confs = predictor.predict_step(arr)
        # the one device -> host read on the serving path
        return labels.cpu().numpy(), confs.cpu().numpy()

    return infer


def run_serve(cfg: Config) -> dict:
    """Batched inference from a checkpoint over HTTP, one replica."""
    from . import serving

    check_ported(cfg)
    runtime.check_single_process("serve")
    rank = runtime.process_index()
    device = runtime.resolve_device(cfg.device)
    buckets = serving.parse_buckets(cfg.serve_buckets)
    if cfg.serve_queue < max(buckets):
        raise ValueError(
            f"--serve-queue {cfg.serve_queue} is smaller than the "
            f"largest bucket {max(buckets)}: the queue could never "
            "fill a full batch")
    utils.initialize_logging(cfg.rsl_path, cfg.log_file, truncate=True)
    # Telemetry and request tracing are always on in serve mode: they are
    # the tier's operational surface, as in the JAX package.
    tel = telemetry.configure(cfg.rsl_path, True, rank=rank)
    tracing.configure(cfg.rsl_path, True, rank=rank)
    port = cfg.serve_port
    tel.event("run_start", action="serve", dataset=cfg.dataset, world=1,
              processes=1, buckets=list(buckets), port=port,
              device=str(device))
    logging.info(f"serve: one replica on {device}, port {port}")

    model_name = ckpt.get_checkpoint_model_name(cfg.checkpoint_file)
    dataset = load_dataset(cfg.dataset, cfg.data_path, cfg.seed,
                           debug=cfg.debug, log=True,
                           synthetic_fallback=cfg.synthetic_fallback)
    images = dataset.splits["test"].images
    sample_shape, sample_dtype = images.shape[1:], images.dtype

    launches0 = fa.flash_attention_fwd.launches
    tc0 = fa.flash_attention_fwd.tensor_core_launches
    shutdown = utils.GracefulShutdown()
    tier = None
    try:
        with shutdown:
            infer = _serve_build_replica(cfg, model_name, dataset, buckets,
                                         sample_shape, sample_dtype, device)
            warm_launches = fa.flash_attention_fwd.launches - launches0
            tier = serving.ServingTier(
                infer, sample_shape, sample_dtype, buckets,
                max_queue=cfg.serve_queue,
                max_latency_s=cfg.serve_max_latency_ms / 1000.0,
                port=port,
                request_timeout_s=cfg.serve_request_timeout,
                max_requests=cfg.serve_max_requests)
            tier.set_checkpoint(ckpt.lineage_info(cfg.checkpoint_file))
            tracing.get().set_lineage((tier.checkpoint or {}).get("sha256"))
            tier.start()
            answered = tier.run(shutdown=shutdown)
        batches = int(tel.counter("serve/batches").value)
        launches = fa.flash_attention_fwd.launches - launches0
        tc_launches = fa.flash_attention_fwd.tensor_core_launches - tc0
        logging.info(f"serve: stopped after answering {answered} requests "
                     f"in {batches} batches")
        logging.info(f"serve: flash_fwd launches {launches} "
                     f"({warm_launches} in warm-up), {tc_launches} on the "
                     f"tensor cores")
        return {"answered": answered, "port": tier.port,
                "model_name": model_name, "batches": batches,
                "flash_launches": launches,
                "flash_tensor_core_launches": tc_launches,
                "flash_warmup_launches": warm_launches}
    finally:
        if tier is not None:
            tier.close()
        tracing.get().close()
        tel.close()


def main(argv=None) -> int:
    try:
        cfg = config_from_argv(argv)
    except ValueError as e:
        logging.error(f"{e}, exiting...")
        return 1
    print("========================= start =========================")
    run = {"train": run_train, "test": run_test, "serve": run_serve}
    try:
        run[cfg.action](cfg)
    except ValueError as e:
        logging.error(f"{e}, exiting...")
        return 1
    finally:
        runtime.shutdown_distributed()
    print("========================= end ==========================")
    return 0


if __name__ == "__main__":
    sys.exit(main())
