"""The port's entry point: ``python -m distributedpytorch_tpu_torch serve``.

Counterpart of ``distributedpytorch_tpu/cli.py`` (``_serve_warmup``,
``_serve_build_replica`` and ``run_serve``, :1418-1705) reduced to one
replica: no elastic world, no metrics exporter, no flight recorder, no
goodput ledger, and no hot-swap (``/admin/reload`` answers 501).  The
sequence: load the dataset (its test split gives the request shape, its
train split the normalization) -> build the model -> restore the
checkpoint onto the device -> warm every bucket with one forward (in
place of the AOT compile) -> ``ServingTier`` -> answer until
``--serve-max-requests``.

The device is ``cuda`` unless ``--device cpu`` is given; without a GPU the
run stops with one line instead of serving from the CPU.
"""

from __future__ import annotations

import logging
import sys
import time

import numpy as np
import torch

from . import checkpoint as ckpt
from . import runtime, telemetry, tracing, utils
from .config import Config, check_ported, config_from_argv
from .data.datasets import load_dataset
from .models import get_model, get_model_input_size
from .ops.flash_attention import flash_attention_fwd
from .train.engine import Predictor


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
    try:
        run_serve(cfg)
    except ValueError as e:
        logging.error(f"{e}, exiting...")
        return 1
    print("========================= end ==========================")
    return 0


if __name__ == "__main__":
    sys.exit(main())
