"""Configuration of the ported ``train``, ``test`` and ``serve``
subcommands.

Counterpart of ``distributedpytorch_tpu/config.py`` (``Config`` at
:62-316, ``_common_args`` at :394-708, ``build_parser`` at :711-760,
``config_from_argv`` at :1110-1252), cut to what this slice runs, with the
same flag spellings and defaults, plus ``--device {cuda,cpu}`` (default
``cuda``).

A flag of the JAX CLI that this slice does not support fails loudly with
one line, ``not ported yet: --X``; it is never ignored.  The flags that
only exist to be refused are one table each (``REFUSED_EVERYWHERE``,
``REFUSED_TRAIN_TEST``) and are not Config fields; the settings a Config
holds are refused by ``check_ported``.  ``train``, ``test`` and ``serve``
run all nine models of the JAX registry (``resnet`` is the default, as in
the JAX package); ``train --use-pretrained --pretrained-path FILE`` starts
from a torchvision ``state_dict``, and ``test``, ``serve`` and a resumed
``train`` refuse it with the JAX messages.  ``--attention`` other than
``full`` on a model without attention is refused with the JAX registry's
message.
``--model-parallel M`` (M >= 2) runs only the ring of ``--attention ring``
or ``ring_flash`` over the (world / M, M) mesh, with the parameters
replicated on every rank: the JAX package's placement of parameters over
'model' (a memory layout that changes no number) is not ported, so with
any other attention it is refused.  Two
defaults differ because the JAX default is not ported: the flight
recorder is off (``--flightrec`` is refused), and ``test`` takes the model
from the checkpoint, so its ``--model`` defaults to none (the JAX ``test``
reads the checkpoint's too and ignores the flag).
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Optional

DEBUG = False
MODEL_NAME = "resnet"       # the JAX default
OPTIMIZER = "adam"
LOSS = "cross_entropy"
DATA_PATH = "./data"
RSL_PATH = "./rsl"
LOG_FILE = "test.log"
NB_EPOCHS = 2
BATCH_SIZE = 64
NUM_WORKERS = 2             # the JAX package's streamed prefetch depth
SEED = 1234
FEATURE_EXTRACT = False

VALID_RATIO = 0.9           # ref dataloader.py:23
DEBUG_SUBSET = 200          # ref dataloader.py:141
RESIDENT_MAX_BYTES = 512 * 1024 * 1024

MODEL_CHOICES = (
    "cnn", "mlp", "resnet", "alexnet", "vgg", "squeezenet", "densenet",
    "inception", "vit",
)
OPTIMIZER_CHOICES = ("adam", "SGD")
LOSS_CHOICES = ("cross_entropy", "weighted_cross_entropy", "focal_loss")
DATASET_CHOICES = ("mnist", "fashion_mnist", "cifar10", "synthetic",
                   "synthetic_hard")
DEVICE_CHOICES = ("cuda", "cpu")


@dataclasses.dataclass(frozen=True)
class Config:
    """What ``train``, ``test`` and ``serve`` need."""

    action: str = "train"
    data_path: str = DATA_PATH
    rsl_path: str = RSL_PATH
    log_file: str = LOG_FILE
    dataset: str = "mnist"
    # None: the architecture comes from the checkpoint's model_name
    model_name: Optional[str] = None
    optimizer: str = OPTIMIZER
    loss: str = LOSS
    batch_size: int = BATCH_SIZE
    nb_epochs: int = NB_EPOCHS
    learning_rate: float = 1e-3
    momentum: float = 0.9
    lr_step_gamma: float = 0.1
    focal_gamma: float = 2.0
    seed: int = SEED
    feature_extract: bool = FEATURE_EXTRACT
    use_pretrained: bool = False
    # a torchvision state_dict file for use_pretrained (never downloaded)
    pretrained_path: Optional[str] = None
    checkpoint_file: Optional[str] = None
    debug: bool = DEBUG
    keep_ckpts: int = 1
    telemetry: bool = False
    data_mode: str = "auto"
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
    model_parallel: int = 1

    def precision_policy(self):
        """The resolved precision.PrecisionPolicy for this config."""
        from .precision import from_flags

        return from_flags(self.precision, self.half_precision)


def not_ported(cfg: Config) -> Optional[str]:
    """The first setting of ``cfg`` this slice does not support, spelled
    as on the command line, or None."""
    ring = cfg.attention in ("ring", "ring_flash")
    checks = (
        (ring and cfg.action == "serve" and cfg.model_name in (None, "vit"),
         f"--attention {cfg.attention}"),
        (cfg.precision not in (None, "bf16", "f32"),
         f"--precision {cfg.precision}"),
        (cfg.data_mode == "stream", "--data-mode stream"),
        (cfg.model_parallel > 1 and not ring and cfg.action != "serve",
         "--model-parallel (parameter sharding over 'model')"),
    )
    for refused, flag in checks:
        if refused:
            return flag
    return None


def check_ported(cfg: Config) -> Config:
    """Raise ValueError("not ported yet: --X") for the first unsupported
    setting; return ``cfg`` otherwise."""
    if cfg.action == "serve" and cfg.model_parallel > 1:
        # the JAX run_serve's refusal (cli.py:1499-1509)
        raise ValueError(
            "serve runs replica-local data-parallel inference; "
            "--model-parallel/--tensor-parallel/--pipeline-parallel/"
            "--seq-parallel do not apply (model-parallel-trained "
            "checkpoints convert at load)")
    check_pretrained(cfg)
    flag = not_ported(cfg)
    if flag is not None:
        raise ValueError(f"not ported yet: {flag}")
    if cfg.action == "train":       # test and serve: the checkpoint's
        from .models.registry import check_attention

        check_attention(cfg.model_name, cfg.attention)
    check_model_axis(cfg)
    if cfg.device not in DEVICE_CHOICES:
        raise ValueError(f"--device must be one of {DEVICE_CHOICES}, got "
                         f"{cfg.device!r}")
    return cfg


def check_pretrained(cfg: Config) -> None:
    """The JAX refusals of ``--use-pretrained`` (``cli.py:692-699``,
    ``:809-812``, ``:1340-1344``, ``:1495-1497``): weights come from the
    checkpoint on ``test``, ``serve`` and a resumed ``train``, and the
    architecture and the file are checked before any data is read."""
    if not cfg.use_pretrained:
        return
    if cfg.action in ("test", "serve"):
        raise ValueError(
            f"--use-pretrained is not applicable to the {cfg.action} "
            "subcommand: weights come from -f FILE")
    if cfg.checkpoint_file:
        raise ValueError(
            "--use-pretrained cannot be combined with -f/--file resume: "
            "all weights come from the checkpoint")
    from .models.pretrained import validate_request

    validate_request(cfg.model_name, cfg.pretrained_path)


def check_model_axis(cfg: Config) -> None:
    """``--attention ring|ring_flash`` needs ``--model-parallel`` >= 2:
    ``train`` fails with the JAX ``run_train`` message (cli.py:740-754),
    before the dataset load; ``test`` with the JAX registry's, which is
    where the JAX ``test`` fails."""
    if cfg.action == "serve" or cfg.attention not in ("ring", "ring_flash") \
            or cfg.model_parallel >= 2:
        return
    if cfg.action == "train":
        raise ValueError(
            "--attention ring/flash/ring_flash, --tensor-parallel and "
            "--pipeline-parallel require --model vit, are mutually "
            "exclusive (except --pipeline-parallel + --attention ring "
            "with --seq-parallel >= 2), and (except single-chip flash) "
            "need --model-parallel >= 2; "
            f"got model={cfg.model_name!r}, "
            f"model_parallel={cfg.model_parallel}, "
            f"attention={cfg.attention!r}, "
            "tensor_parallel=False, "
            "pipeline_parallel=False")
    from .models.registry import require_model_axis

    require_model_axis(None, f"--attention {cfg.attention} (token axis)")


def _model_parallel_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--model-parallel", type=int, default=1,
                   dest="model_parallel", metavar="N",
                   help="the N-way 'model' mesh axis of --attention ring "
                        "and ring_flash (must divide the world; default 1; "
                        "parameters stay replicated)")


def _device_arg(p: argparse.ArgumentParser, what: str) -> None:
    p.add_argument("--device", choices=DEVICE_CHOICES, default="cuda",
                   help=f"device to {what} on (default: cuda; never falls "
                        "back to the CPU on its own)")


_ON = {"action": "store_true"}
_INT = {"type": int}
_FLOAT = {"type": float}
_STR = {"type": str}

# Flags of the JAX CLI that this slice refuses: (flag, how it parses, the
# value that asks for what the port does anyway).  They have no default,
# so only a flag given on the command line is looked at; any other value
# is refused (``refused_flag``), never ignored.
REFUSED_EVERYWHERE = (
    ("--remat", {"choices": ("none", "blocks", "full")}, "none"),
    ("--scan-layers", _ON, False),
    ("--moe-experts", _INT, 0),
    ("--tensor-parallel", _ON, False),
    ("--pipeline-parallel", _ON, False),
    ("--seq-parallel", _INT, 1),
    ("--elastic", _ON, False),
    ("--elastic-join", _ON, False),
    ("--elastic-dir", _STR, None),
    ("--elastic-target", _STR, None),
    ("--elastic-min-world", _INT, None),
    ("--elastic-join-wait", _FLOAT, None),
    ("--fault-plan", _STR, None),
    ("--metrics-port", _INT, 0),
    ("--flightrec", {"action": argparse.BooleanOptionalAction}, False),
    ("--ckpt-format", {"choices": ("msgpack", "orbax")}, "msgpack"),
)
REFUSED_TRAIN_TEST = REFUSED_EVERYWHERE + (
    ("--prefetch", _INT, NUM_WORKERS),
    ("--producer-threads", _INT, 1),
    ("--device-prefetch", _INT, 0),
    ("--ckpt-async", _ON, False),
    ("--compilation-cache-dir", _STR, None),
    ("--no-compile-cache", _ON, False),
    ("--aot-warmup", _ON, False),
    ("--fault-seed", _INT, 0),
    ("--retry-max-attempts", _INT, 3),
    ("--retry-base-delay", _FLOAT, 0.05),
    ("--retry-timeout", _FLOAT, 60.0),
    ("--health-timeout", _FLOAT, 0.0),
    ("--max-reconfigures", _INT, 3),
    ("--profile", _ON, False),
    ("--flightrec-ring", _INT, 4096),
    ("--anomaly-capture", _ON, False),
    ("--anomaly-window", _INT, 32),
    ("--anomaly-mad-k", _FLOAT, 8.0),
    ("--anomaly-min-excess", _FLOAT, 0.05),
    ("--anomaly-capture-steps", _INT, 4),
    ("--anomaly-max-captures", _INT, 2),
    ("--epochs-per-dispatch", _INT, 1),
    ("--grad-accum", _INT, 1),
    ("--pipeline-microbatches", _INT, 0),
)


def _dest(flag: str) -> str:
    return flag[2:].replace("-", "_")


def _refused_args(p: argparse.ArgumentParser, table) -> None:
    for flag, how, _ok in table:
        p.add_argument(flag, dest=_dest(flag), default=argparse.SUPPRESS,
                       help="not ported yet", **how)


def refused_flag(args: dict, table) -> Optional[str]:
    """The first flag of ``table`` given in the parsed ``args`` with a
    value the port does not run, spelled as on the command line, or
    None."""
    for flag, how, ok in table:
        dest = _dest(flag)
        if dest in args and args[dest] != ok:
            return f"{flag} {args[dest]}" if "choices" in how else flag
    return None


def _pretrained_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--use-pretrained", action="store_true",
                   dest="use_pretrained",
                   help="train: initialize the backbone from "
                        "--pretrained-path (a torchvision state_dict); "
                        "test and serve refuse it")
    p.add_argument("--pretrained-path", type=str, default=None,
                   dest="pretrained_path", metavar="FILE",
                   help="torch .pth state_dict for --use-pretrained "
                        "(never downloaded)")


def _train_test_args(p: argparse.ArgumentParser, action: str) -> None:
    """The JAX ``_common_args`` of train and test, same spellings and
    defaults; the ones this slice refuses are parsed so that they can be
    refused by name."""
    p.add_argument("--debug", action="store_true", default=DEBUG,
                   help="debug mode (200-sample subsets)")
    p.add_argument("-d", "--data_path", metavar="data_path", type=str,
                   dest="data_path", required=True, help="data path")
    p.add_argument("-b", "--batchSize", metavar="N", type=int,
                   dest="batch_size", default=BATCH_SIZE,
                   help=f"batch size (default: {BATCH_SIZE})")
    p.add_argument("--dataset", choices=DATASET_CHOICES, default="mnist",
                   help="dataset to load (default: mnist)")
    if action == "train":
        p.add_argument("--model", choices=MODEL_CHOICES, default=MODEL_NAME,
                       dest="model_name",
                       help=f"model architecture (default: {MODEL_NAME})")
    else:
        p.add_argument("--model", choices=MODEL_CHOICES, default=None,
                       dest="model_name",
                       help="model architecture (default: the "
                            "checkpoint's)")
    p.add_argument("--optimizer", choices=OPTIMIZER_CHOICES,
                   default=OPTIMIZER, help=f"optimizer (default: {OPTIMIZER})")
    p.add_argument("--loss", choices=LOSS_CHOICES, default=LOSS,
                   help=f"loss (default: {LOSS})")
    p.add_argument("--rsl_path", type=str, default=RSL_PATH,
                   help=f"results/checkpoint dir (default: {RSL_PATH})")
    p.add_argument("--no-bf16", action="store_true",
                   help="float32 compute (equivalent to --precision f32)")
    p.add_argument("--precision",
                   choices=("f32", "bf16", "bf16_full", "f16"), default=None,
                   help="mixed-precision preset (ported: f32, bf16)")
    p.add_argument("--data-mode", choices=("auto", "stream", "resident"),
                   default="auto", dest="data_mode",
                   help="device-resident batches (auto, resident); stream "
                        "is not ported yet")
    p.add_argument("--keep-ckpts", type=int, default=1, dest="keep_ckpts",
                   metavar="K",
                   help="rolling-checkpoint lineage depth (default 1)")
    p.add_argument("--feature-extract", action="store_true",
                   dest="feature_extract", default=FEATURE_EXTRACT,
                   help="freeze the backbone, train only the head")
    _pretrained_args(p)
    p.add_argument("--synthetic-fallback", action="store_true",
                   dest="synthetic_fallback",
                   help="use the deterministic synthetic corpus when the "
                        "real dataset's raw files are absent")
    p.add_argument("--telemetry", action="store_true",
                   help="emit structured JSONL telemetry to "
                        "RSL_PATH/telemetry/rank<N>.jsonl")
    p.add_argument("--attention",
                   choices=("full", "ring", "flash", "ring_flash"),
                   default="full",
                   help="attention for --model vit: full (plain PyTorch), "
                        "flash (the CUDA kernels K1, K2, K3), ring (plain "
                        "PyTorch) or ring_flash (the CUDA kernels K4, K2p, "
                        "K3p) over --model-parallel ranks")
    _model_parallel_arg(p)
    _device_arg(p, action)
    _refused_args(p, REFUSED_TRAIN_TEST)


def build_parser() -> argparse.ArgumentParser:
    """The ``train``, ``test`` and ``serve`` subcommands of the JAX CLI,
    same spellings."""
    parser = argparse.ArgumentParser(
        prog="python -m distributedpytorch_tpu_torch",
        description="PyTorch/CUDA port of the distributed classifier "
                    "(train and test the nine models on one or several "
                    "ranks; serve any of them)")
    sub = parser.add_subparsers(dest="action", required=True,
                                help="action to execute")
    p_train = sub.add_parser("train", help="train model")
    _train_test_args(p_train, "train")
    p_train.add_argument("-e", "--epochs", metavar="N", type=int,
                         dest="nb_epochs", default=NB_EPOCHS,
                         help=f"number of training epochs "
                              f"(default: {NB_EPOCHS})")
    p_train.add_argument("-f", "--file", metavar="file_path", type=str,
                         dest="checkpoint_file", default=None,
                         help="training checkpoint file (resume)")
    p_test = sub.add_parser("test", help="test model")
    _train_test_args(p_test, "test")
    p_test.add_argument("-f", "--file", metavar="file_path", type=str,
                        dest="checkpoint_file", required=True,
                        help="model file: the port's own or a msgpack "
                             ".ckpt written by the JAX package")

    p = sub.add_parser(
        "serve", help="serve a trained checkpoint: micro-batched "
                      "inference over HTTP with warmed batch buckets and "
                      "bounded-queue backpressure")
    p.add_argument("--debug", action="store_true", default=DEBUG,
                   help="debug mode (200-sample subsets)")
    p.add_argument("-d", "--data_path", metavar="data_path", type=str,
                   dest="data_path", required=True, help="data path")
    p.add_argument("--dataset", choices=DATASET_CHOICES, default="mnist",
                   help="dataset whose test split and normalization the "
                        "server uses (default: mnist)")
    p.add_argument("--model", choices=MODEL_CHOICES, default=None,
                   dest="model_name",
                   help="model architecture (default: the checkpoint's)")
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
                   dest="synthetic_fallback",
                   help="use the deterministic synthetic corpus when the "
                        "real dataset's raw files are absent")
    _pretrained_args(p)
    _model_parallel_arg(p)
    _device_arg(p, "serve")
    p.add_argument("-f", "--file", metavar="file_path", type=str,
                   dest="checkpoint_file", required=True,
                   help="checkpoint to serve: the port's own file or a "
                        "msgpack .ckpt written by the JAX package")
    p.add_argument("--serve-port", type=int, default=8100,
                   dest="serve_port", metavar="PORT",
                   help="HTTP port for /predict (default 8100)")
    p.add_argument("--serve-buckets", type=str, default="1,4,16,64",
                   dest="serve_buckets", metavar="B1,B2,...",
                   help="batch-size buckets warmed at start; every "
                        "micro-batch pads to one of these "
                        "(default 1,4,16,64)")
    p.add_argument("--serve-max-latency-ms", type=float, default=20.0,
                   dest="serve_max_latency_ms", metavar="MS",
                   help="micro-batcher flush deadline (default 20)")
    p.add_argument("--serve-queue", type=int, default=256,
                   dest="serve_queue", metavar="N",
                   help="bounded request-queue depth; past it requests "
                        "are shed with 503 (default 256)")
    p.add_argument("--serve-request-timeout", type=float, default=30.0,
                   dest="serve_request_timeout", metavar="S",
                   help="per-request wait before a 504 (default 30)")
    p.add_argument("--serve-max-requests", type=int, default=0,
                   dest="serve_max_requests", metavar="N",
                   help="stop after answering N requests (0 = forever)")
    _refused_args(p, REFUSED_EVERYWHERE)
    return parser


def config_from_argv(argv=None) -> Config:
    """Parse, then refuse what is not ported yet (ValueError).  Every
    other argument's dest is the name of its Config field."""
    args = vars(build_parser().parse_args(argv))
    flag = refused_flag(args, REFUSED_EVERYWHERE if args["action"] == "serve"
                        else REFUSED_TRAIN_TEST)
    if flag is not None:
        raise ValueError(f"not ported yet: {flag}")
    fields = {f.name: args[f.name] for f in dataclasses.fields(Config)
              if f.name in args}
    fields["half_precision"] = not args["no_bf16"]
    return check_ported(Config(**fields))
