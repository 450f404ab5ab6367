"""Configuration of the ported ``serve`` subcommand.

Counterpart of ``distributedpytorch_tpu/config.py`` (``Config`` at
:62-316, ``build_parser`` at :711-760, ``config_from_argv`` at
:1110-1252), cut to what ``serve`` reads, with the same flag spellings,
plus ``--device {cuda,cpu}`` (default ``cuda``).

A flag of the JAX CLI that this slice does not support fails loudly with
one line, ``not ported yet: --X`` (``check_ported``); it is never ignored.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Optional

DEBUG = False
DATA_PATH = "./data"
RSL_PATH = "./rsl"
LOG_FILE = "test.log"
SEED = 1234

VALID_RATIO = 0.9           # ref dataloader.py:23
DEBUG_SUBSET = 200          # ref dataloader.py:141

MODEL_CHOICES = (
    "cnn", "mlp", "resnet", "alexnet", "vgg", "squeezenet", "densenet",
    "inception", "vit",
)
DATASET_CHOICES = ("mnist", "fashion_mnist", "cifar10", "synthetic",
                   "synthetic_hard")
DEVICE_CHOICES = ("cuda", "cpu")


@dataclasses.dataclass(frozen=True)
class Config:
    """What ``serve`` needs.  The fields below ``device`` exist only so a
    programmatic Config can be refused the same way the CLI is."""

    action: str = "serve"
    data_path: str = DATA_PATH
    rsl_path: str = RSL_PATH
    log_file: str = LOG_FILE
    dataset: str = "mnist"
    # None: the architecture comes from the checkpoint's model_name
    model_name: Optional[str] = None
    seed: int = SEED
    checkpoint_file: Optional[str] = None
    debug: bool = DEBUG
    half_precision: bool = True
    precision: Optional[str] = None
    attention: str = "full"
    synthetic_fallback: bool = False
    serve_port: int = 8100
    serve_buckets: str = "1,4,16,64"
    serve_max_latency_ms: float = 20.0
    serve_queue: int = 256
    serve_request_timeout: float = 30.0
    serve_max_requests: int = 0
    device: str = "cuda"
    # -- flags of the JAX CLI that are not ported yet ------------------
    use_pretrained: bool = False
    remat: str = "none"
    scan_layers: bool = False
    moe_experts: int = 0
    tensor_parallel: bool = False
    pipeline_parallel: bool = False
    model_parallel: int = 1
    seq_parallel: int = 1
    elastic: bool = False
    elastic_join: bool = False
    elastic_dir: Optional[str] = None
    elastic_target: Optional[str] = None
    elastic_min_world: Optional[int] = None
    elastic_join_wait: Optional[float] = None
    fault_plan: Optional[str] = None
    metrics_port: int = 0
    flightrec: bool = False
    ckpt_format: str = "msgpack"

    def precision_policy(self):
        """The resolved precision.PrecisionPolicy for this config."""
        from .precision import from_flags

        return from_flags(self.precision, self.half_precision)


def not_ported(cfg: Config) -> Optional[str]:
    """The first flag of ``cfg`` this slice does not support, spelled as
    on the command line, or None."""
    checks = (
        (cfg.model_name not in (None, "vit"), f"--model {cfg.model_name}"),
        (cfg.attention in ("ring", "ring_flash"),
         f"--attention {cfg.attention}"),
        (cfg.precision not in (None, "bf16", "f32"),
         f"--precision {cfg.precision}"),
        (cfg.moe_experts != 0, "--moe-experts"),
        (cfg.tensor_parallel, "--tensor-parallel"),
        (cfg.pipeline_parallel, "--pipeline-parallel"),
        (cfg.model_parallel != 1, "--model-parallel"),
        (cfg.seq_parallel != 1, "--seq-parallel"),
        (cfg.scan_layers, "--scan-layers"),
        (cfg.remat != "none", f"--remat {cfg.remat}"),
        (cfg.elastic, "--elastic"),
        (cfg.elastic_join, "--elastic-join"),
        (cfg.elastic_dir is not None, "--elastic-dir"),
        (cfg.elastic_target is not None, "--elastic-target"),
        (cfg.elastic_min_world is not None, "--elastic-min-world"),
        (cfg.elastic_join_wait is not None, "--elastic-join-wait"),
        (cfg.fault_plan is not None, "--fault-plan"),
        (cfg.metrics_port != 0, "--metrics-port"),
        (cfg.flightrec, "--flightrec"),
        (cfg.ckpt_format != "msgpack", f"--ckpt-format {cfg.ckpt_format}"),
    )
    for refused, flag in checks:
        if refused:
            return flag
    return None


def check_ported(cfg: Config) -> Config:
    """Raise ValueError("not ported yet: --X") for the first unsupported
    flag; return ``cfg`` otherwise."""
    flag = not_ported(cfg)
    if flag is not None:
        raise ValueError(f"not ported yet: {flag}")
    if cfg.use_pretrained:
        raise ValueError(
            "--use-pretrained is not applicable to the serve subcommand: "
            "weights come from -f FILE")
    if cfg.device not in DEVICE_CHOICES:
        raise ValueError(f"--device must be one of {DEVICE_CHOICES}, got "
                         f"{cfg.device!r}")
    return cfg


def build_parser() -> argparse.ArgumentParser:
    """The ``serve`` subcommand of the JAX CLI, same spellings."""
    parser = argparse.ArgumentParser(
        prog="python -m distributedpytorch_tpu_torch",
        description="PyTorch/CUDA port of the distributed classifier "
                    "(serve only in this slice)")
    sub = parser.add_subparsers(dest="action", required=True,
                                help="action to execute")
    p = sub.add_parser(
        "serve", help="serve a trained checkpoint: micro-batched "
                      "inference over HTTP with warmed batch buckets and "
                      "bounded-queue backpressure")
    p.add_argument("--debug", action="store_true", default=DEBUG,
                   help="debug mode (200-sample subsets)")
    p.add_argument("-d", "--data_path", metavar="data_path", type=str,
                   dest="dataPath", required=True, help="data path")
    p.add_argument("--dataset", choices=DATASET_CHOICES, default="mnist",
                   help="dataset whose test split and normalization the "
                        "server uses (default: mnist)")
    p.add_argument("--model", choices=MODEL_CHOICES, default=None,
                   dest="modelName",
                   help="model architecture (ported: vit; default: the "
                        "checkpoint's)")
    p.add_argument("--rsl_path", type=str, default=RSL_PATH,
                   help=f"results dir (default: {RSL_PATH})")
    p.add_argument("--no-bf16", action="store_true",
                   help="float32 compute (equivalent to --precision f32)")
    p.add_argument("--precision",
                   choices=("f32", "bf16", "bf16_full", "f16"), default=None,
                   help="mixed-precision preset (ported: f32, bf16)")
    p.add_argument("--attention",
                   choices=("full", "ring", "flash", "ring_flash"),
                   default="full",
                   help="attention for --model vit: full (plain PyTorch) "
                        "or flash (the CUDA kernel K1); ring and "
                        "ring_flash are not ported yet")
    p.add_argument("--synthetic-fallback", action="store_true",
                   dest="syntheticFallback",
                   help="use the deterministic synthetic corpus when the "
                        "real dataset's raw files are absent")
    p.add_argument("--device", choices=DEVICE_CHOICES, default="cuda",
                   help="device to serve on (default: cuda; never falls "
                        "back to the CPU on its own)")
    p.add_argument("-f", "--file", metavar="file_path", type=str,
                   dest="checkpointFile", required=True,
                   help="checkpoint to serve: the port's own file or a "
                        "msgpack .ckpt written by the JAX package")
    p.add_argument("--serve-port", type=int, default=8100,
                   dest="servePort", metavar="PORT",
                   help="HTTP port for /predict (default 8100)")
    p.add_argument("--serve-buckets", type=str, default="1,4,16,64",
                   dest="serveBuckets", metavar="B1,B2,...",
                   help="batch-size buckets warmed at start; every "
                        "micro-batch pads to one of these "
                        "(default 1,4,16,64)")
    p.add_argument("--serve-max-latency-ms", type=float, default=20.0,
                   dest="serveMaxLatencyMs", metavar="MS",
                   help="micro-batcher flush deadline (default 20)")
    p.add_argument("--serve-queue", type=int, default=256,
                   dest="serveQueue", metavar="N",
                   help="bounded request-queue depth; past it requests "
                        "are shed with 503 (default 256)")
    p.add_argument("--serve-request-timeout", type=float, default=30.0,
                   dest="serveRequestTimeout", metavar="S",
                   help="per-request wait before a 504 (default 30)")
    p.add_argument("--serve-max-requests", type=int, default=0,
                   dest="serveMaxRequests", metavar="N",
                   help="stop after answering N requests (0 = forever)")
    # Flags of the JAX CLI this slice refuses (check_ported).
    p.add_argument("--use-pretrained", action="store_true",
                   dest="usePretrained")
    p.add_argument("--remat", choices=("none", "blocks", "full"),
                   default="none")
    p.add_argument("--scan-layers", action="store_true", dest="scanLayers")
    p.add_argument("--moe-experts", type=int, default=0, dest="moeExperts")
    p.add_argument("--tensor-parallel", action="store_true",
                   dest="tensorParallel")
    p.add_argument("--pipeline-parallel", action="store_true",
                   dest="pipelineParallel")
    p.add_argument("--model-parallel", type=int, default=1,
                   dest="modelParallel")
    p.add_argument("--seq-parallel", type=int, default=1,
                   dest="seqParallel")
    p.add_argument("--elastic", action="store_true")
    p.add_argument("--elastic-join", action="store_true",
                   dest="elasticJoin")
    p.add_argument("--elastic-dir", type=str, default=None,
                   dest="elasticDir")
    p.add_argument("--elastic-target", type=str, default=None,
                   dest="elasticTarget")
    p.add_argument("--elastic-min-world", type=int, default=None,
                   dest="elasticMinWorld")
    p.add_argument("--elastic-join-wait", type=float, default=None,
                   dest="elasticJoinWait")
    p.add_argument("--fault-plan", type=str, default=None, dest="faultPlan")
    p.add_argument("--metrics-port", type=int, default=0,
                   dest="metricsPort")
    p.add_argument("--flightrec", action=argparse.BooleanOptionalAction,
                   default=False)
    p.add_argument("--ckpt-format", choices=("msgpack", "orbax"),
                   default="msgpack", dest="ckptFormat")
    return parser


def config_from_argv(argv=None) -> Config:
    """Parse, then refuse what is not ported yet (ValueError)."""
    args = build_parser().parse_args(argv)
    return check_ported(Config(
        action=args.action,
        data_path=args.dataPath,
        rsl_path=args.rsl_path,
        dataset=args.dataset,
        model_name=args.modelName,
        checkpoint_file=args.checkpointFile,
        debug=args.debug,
        half_precision=not args.no_bf16,
        precision=args.precision,
        attention=args.attention,
        synthetic_fallback=args.syntheticFallback,
        serve_port=args.servePort,
        serve_buckets=args.serveBuckets,
        serve_max_latency_ms=args.serveMaxLatencyMs,
        serve_queue=args.serveQueue,
        serve_request_timeout=args.serveRequestTimeout,
        serve_max_requests=args.serveMaxRequests,
        device=args.device,
        use_pretrained=args.usePretrained,
        remat=args.remat,
        scan_layers=args.scanLayers,
        moe_experts=args.moeExperts,
        tensor_parallel=args.tensorParallel,
        pipeline_parallel=args.pipelineParallel,
        model_parallel=args.modelParallel,
        seq_parallel=args.seqParallel,
        elastic=args.elastic,
        elastic_join=args.elasticJoin,
        elastic_dir=args.elasticDir,
        elastic_target=args.elasticTarget,
        elastic_min_world=args.elasticMinWorld,
        elastic_join_wait=args.elasticJoinWait,
        fault_plan=args.faultPlan,
        metrics_port=args.metricsPort,
        flightrec=args.flightrec,
        ckpt_format=args.ckptFormat,
    ))
