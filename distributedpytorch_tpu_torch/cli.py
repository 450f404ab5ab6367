"""The port's entry point: ``python -m distributedpytorch_tpu_torch
{train,test,serve}``.

Counterpart of ``distributedpytorch_tpu/cli.py`` reduced to one process
and one world:

  * ``run_train`` follows ``run_train``/``_train_world``/
    ``_run_train_epochs`` (:601-1016, :1208-1335) with ``_run_train_pass``,
    ``_run_eval_pass`` and ``_progress_logs`` (:335-476): no elastic
    world, fault plans, flight recorder, goodput ledger, exporter, roofline
    or chunked epochs.  The data is device-resident; a step gathers its
    batch on the device and draws its augmentation from a generator seeded
    from (seed, epoch, step), and per-step metrics stay on the device until
    one read per epoch.  The rolling checkpoint is written every epoch and
    the best model on improvement, with the best loss updated before the
    save.  cuDNN is set deterministic, so a resumed run reproduces an
    uninterrupted one bit for bit.
  * ``run_test`` follows ``run_test`` (:1338-1415) and reads the port's
    checkpoints and the JAX package's msgpack files.
  * ``run_serve`` follows ``_serve_warmup``, ``_serve_build_replica`` and
    ``run_serve`` (:1418-1705) reduced to one replica: no elastic world,
    metrics exporter, flight recorder, goodput ledger or hot-swap
    (``/admin/reload`` answers 501).

The reference's log lines are kept word for word in RSL_PATH/test.log.
``train`` and ``test`` log the launches of kernels K1 (flash_fwd), K2
(flash_dq) and K3 (flash_dkv); ``serve`` logs K1's.  The device is
``cuda`` unless ``--device cpu`` is given; without a GPU the run stops
with one line instead of running on the CPU.
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
from .models import get_model, get_model_input_size
from .ops.flash_attention import (flash_attention_dkv, flash_attention_dq,
                                  flash_attention_fwd)
from .ops.losses import get_loss_fn
from .train.engine import Engine, Predictor, TrainState

KERNELS = {"flash_fwd": flash_attention_fwd, "flash_dq": flash_attention_dq,
           "flash_dkv": flash_attention_dkv}


def kernel_launches() -> dict:
    """The launch counters of the port's kernels, by kernel name."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def _launch_line(before: dict) -> str:
    now = kernel_launches()
    return ", ".join(f"{name} {now[name] - before[name]}" for name in now)


def _build_engine(cfg: Config, model_name: str, dataset: Dataset,
                  steps_per_epoch: int, device: torch.device) -> Engine:
    policy = cfg.precision_policy()
    model = get_model(model_name, dataset.nb_classes, policy,
                      attention=cfg.attention, device=device)
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
                  feature_extract=cfg.feature_extract)


def _make_loader(cfg: Config, split: Split, shuffle: bool,
                 device: torch.device) -> ResidentLoader:
    """The device-resident loader; a split over the resident cap would
    need the streaming loader, which is not ported yet."""
    if cfg.data_mode == "auto" and split.images.nbytes > RESIDENT_MAX_BYTES:
        raise ValueError(f"not ported yet: --data-mode stream (the split's "
                         f"{split.images.nbytes} bytes exceed the resident "
                         f"cap of {RESIDENT_MAX_BYTES})")
    return ResidentLoader(split, cfg.batch_size, shuffle=shuffle,
                          seed=cfg.seed, device=device)


def _start(cfg: Config, action: str) -> tuple:
    """Common start of train and test: refusals, device, logging,
    telemetry, the run_start event.  Returns (device, telemetry)."""
    check_ported(cfg)
    if cfg.batch_size < 1:
        raise ValueError(f"batch size must be >= 1, got {cfg.batch_size}")
    rank = runtime.process_index()
    device = runtime.resolve_device(cfg.device)
    utils.initialize_logging(cfg.rsl_path, cfg.log_file, truncate=True)
    tel = telemetry.configure(cfg.rsl_path, cfg.telemetry, rank=rank)
    tel.event("run_start", action=action, model=cfg.model_name,
              dataset=cfg.dataset, world=1, processes=1,
              batch_per_replica=cfg.batch_size, device=str(device))
    logging.info("process: 0/1, world size: 1")
    return device, tel


def _run_eval_pass(engine: Engine, state: TrainState,
                   loader: ResidentLoader, epoch: int
                   ) -> tuple[float, float]:
    """One no-grad pass; returns (loss, accuracy) over the valid rows,
    read from the device once."""
    with telemetry.get().span("eval_pass", epoch=epoch, steps=len(loader)):
        totals = None
        for images, labels, valid in loader.epoch(epoch):
            m = engine.eval_step(state, images, labels, valid)
            totals = m if totals is None else {k: totals[k] + m[k]
                                               for k in totals}
        numer, denom, correct, n_valid = torch.stack(
            [totals[k] for k in ("loss_numer", "loss_denom", "correct",
                                 "valid")]).cpu().tolist()
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
    for i, (images, labels, valid) in enumerate(loader.epoch(epoch)):
        gen = utils.step_generator(seed, epoch, i, loader.device)
        state, m = engine.train_step(state, images, labels, valid, gen)
        hist.append(torch.stack([m["loss"], m["correct"], m["valid"]]))
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
    """The per-epoch loop (ref classif.py:151-192)."""
    history = []
    tel = telemetry.get()
    world = 1
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
        ckpt.rotate_checkpoint(cfg.rsl_path, cfg.dataset, model_name, epoch,
                               keep=cfg.keep_ckpts)
        paths = [ckpt.checkpoint_path(cfg.rsl_path, cfg.dataset, model_name,
                                      epoch)]
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
        if shutdown.requested:
            tel.event("preempt", after_epoch=epoch)
            logging.info(f"preempted after epoch {epoch + 1}: "
                         f"checkpoint written, resume with -f")
            break
    return {"history": history, "best_valid_loss": best_valid_loss,
            "model_name": model_name, "state": state,
            "preempted": shutdown.requested}


def run_train(cfg: Config) -> dict:
    """ref train() (classif.py:75-192), one process on one device."""
    device, tel = _start(cfg, "train")
    try:
        if device.type == "cuda":
            torch.backends.cudnn.deterministic = True
            torch.backends.cudnn.benchmark = False
        logging.info(f"batch size: {cfg.batch_size}/replica "
                     f"({cfg.batch_size} global), prefetch: {NUM_WORKERS}")
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
                                    device)
        valid_loader = _make_loader(cfg, dataset.splits["valid"], False,
                                    device)
        engine = _build_engine(cfg, model_name, dataset, len(train_loader),
                               device)
        tel.event("precision_policy", remat="none", grad_accum=1,
                  **engine.precision.describe())
        state = engine.init_state(torch.Generator().manual_seed(cfg.seed))
        if cfg.checkpoint_file:
            start_epoch, best_valid_loss, state.step = \
                ckpt.load_checkpoint_with_fallback(
                    cfg.checkpoint_file, state.model, state.optimizer,
                    cfg.rsl_path, cfg.dataset, model_name)
        else:
            start_epoch, best_valid_loss = 0, math.inf
        before = kernel_launches()
        step0 = state.step
        start_time = time.monotonic()
        shutdown = utils.GracefulShutdown()
        with shutdown:
            result = _run_train_epochs(cfg, engine, state, train_loader,
                                       valid_loader, model_name, start_epoch,
                                       best_valid_loss, start_time, shutdown)
        steps = state.step - step0
        evals = len(result["history"]) * len(valid_loader)
        logging.info(f"train: kernel launches {_launch_line(before)} over "
                     f"{steps} train steps and {evals} eval batches")
        result["launches"] = {k: v - before[k]
                              for k, v in kernel_launches().items()}
        return result
    finally:
        tel.close()


def run_test(cfg: Config) -> dict:
    """ref test() (classif.py:197-243), one process on one device."""
    device, tel = _start(cfg, "test")
    try:
        model_name = ckpt.get_checkpoint_model_name(cfg.checkpoint_file)
        dataset = load_dataset(cfg.dataset, cfg.data_path, cfg.seed,
                               debug=cfg.debug, log=True,
                               synthetic_fallback=cfg.synthetic_fallback)
        test_loader = _make_loader(cfg, dataset.splits["test"], False,
                                   device)
        engine = _build_engine(cfg, model_name, dataset, len(test_loader),
                               device)
        state = engine.init_state(torch.Generator().manual_seed(cfg.seed))
        ckpt.load_checkpoint(cfg.checkpoint_file, state.model,
                             restore_optimizer=False)
        before = kernel_launches()
        start_time = time.monotonic()
        loss, acc = _run_eval_pass(engine, state, test_loader, epoch=0)
        mins, secs = utils.get_duration(start_time, time.monotonic())
    finally:
        tel.close()
    logging.info(f"Time: {mins}m {secs}s, Acc: {acc * 100:.2f}%")
    logging.info(f"test: kernel launches {_launch_line(before)} over "
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

    launches0 = flash_attention_fwd.launches
    shutdown = utils.GracefulShutdown()
    tier = None
    try:
        with shutdown:
            infer = _serve_build_replica(cfg, model_name, dataset, buckets,
                                         sample_shape, sample_dtype, device)
            warm_launches = flash_attention_fwd.launches - launches0
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
        launches = flash_attention_fwd.launches - launches0
        logging.info(f"serve: stopped after answering {answered} requests "
                     f"in {batches} batches")
        logging.info(f"serve: flash_fwd launches {launches} "
                     f"({warm_launches} in warm-up)")
        return {"answered": answered, "port": tier.port,
                "model_name": model_name, "batches": batches,
                "flash_launches": launches,
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
    print("========================= end ==========================")
    return 0


if __name__ == "__main__":
    sys.exit(main())
