"""Configuration of the ported ``train``, ``test`` and ``serve``
subcommands, of the offline ``telemetry``, ``goodput``, ``timeline``,
``roofline`` and ``incidents`` readers, of the ``fleet`` collector, the
``frontdoor`` and the ``sim`` simulator.

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
``--precision`` takes the four JAX presets: ``f32``, ``bf16``,
``bf16_full`` (bfloat16 weights) and ``f16`` (float16 compute with the
dynamic loss scale).  ``train`` takes ``--grad-accum K`` (K microbatches
a step; K must divide the per-replica batch, the JAX message otherwise),
``--ckpt-async`` (checkpoint files written by a background thread) and
``--epochs-per-dispatch K`` (K epochs a chunk, each step a CUDA Graph
replay on the card; K >= 1, the JAX message otherwise, and K > 1 over
gloo on the card is refused); ``test`` accepts and ignores all three, as
the JAX ``test`` does.
``--data-mode`` picks the device-resident loader or the streaming one
(``auto``: resident while the split fits the budget, ``cli._make_loader``),
with the streaming loader's ``--prefetch``, ``--producer-threads`` and
``--device-prefetch``; ``--remat none|blocks|full`` recomputes the
forward in the backward (``models/remat.py``).  ``test`` and ``serve``
accept all five, as the JAX parser does, and nothing off the train step's
gradient path reads ``--remat``.
``--model-parallel M`` (M >= 2) lays the world out as the (world / M, M)
mesh and places every model's parameters and optimizer state over its
model group (``parallel.py``, the JAX ``_place_state``), under any
attention; ``--attention ring|ring_flash`` rings over that group, and
``--tensor-parallel`` (the vit with ``--attention full``) splits heads and
the MLP hidden axis over it, Megatron style; ``train`` and ``test`` check
both with the JAX messages (``check_model_axis``).
``train``, ``test`` and ``serve`` take ``--moe-experts E`` (the vit's
MLPs as switch mixtures of E experts, expert parallel over a model group
of 2 ranks or more, with any attention, precision and train option);
``train`` checks it with the JAX ``run_train``'s messages before the
dataset load (``check_moe``), and ``test`` and ``serve`` fail with the
registry's.  ``train`` and ``test`` take ``--pipeline-parallel``,
``--pipeline-microbatches`` and ``--seq-parallel`` (the GPipe vit and the
ring inside its stages, ``models/vit_pipeline.py``), checked with the
JAX ``run_train``'s and ``run_test``'s messages (``check_model_axis``,
``check_pipeline``, ``check_pipeline_batch``).  ``serve`` refuses
``--model-parallel``, ``--tensor-parallel``, ``--pipeline-parallel`` and
``--seq-parallel`` with the JAX ``run_serve``'s message, and serves a
file of any layout whole (a pipeline file converted at load).
``train`` and ``test`` take the observability and compile-cache flags
with the JAX spellings and defaults: the flight recorder is on
(``--no-flightrec`` turns it off; ``--flightrec-ring``),
``--metrics-port``, ``--profile``, ``--anomaly-capture`` and its
``--anomaly-*`` knobs, ``--aot-warmup``, ``--compilation-cache-dir`` and
``--no-compile-cache`` (the kernels' build directory, ``ops/build.py``;
its default stays ``build/kernels`` where the JAX default is
``RSL_PATH/xla_cache``); ``test`` ignores ``--aot-warmup``,
``--profile`` and ``--metrics-port``, as the JAX ``test`` does.
``serve`` takes ``--metrics-port``, ``--flightrec`` (on by default) and
``--flightrec-ring``.
``train`` and ``test`` take the JAX fault, retry, health and elastic
families with the JAX spellings, defaults and checks (``--fault-plan``,
``--fault-seed``, ``--retry-max-attempts``, ``--retry-base-delay``,
``--retry-timeout``, ``--health-timeout``, ``--max-reconfigures``,
``--elastic``, ``--elastic-join``, ``--elastic-dir``, ``--elastic-target``,
``--elastic-min-world``, ``--elastic-join-wait``): ``train --elastic-join``
without ``--elastic`` and a malformed ``--elastic-target`` fail before
any work, with the JAX ``run_train`` messages (cli.py:608-623); ``test``
configures the fault plan and ignores the elastic flags, as the JAX
``test`` does.  ``serve`` takes the whole family, with the JAX
``run_serve``'s check that ``--elastic-join`` needs ``--elastic``
(cli.py:1519-1524).  ``fleet`` takes the JAX collector's flags and
defaults (config.py:859-905), ``frontdoor`` the JAX front door's
(:906-1050) and ``sim`` the JAX simulator's (:1062-1092).  One default
differs: ``test`` takes the model from the checkpoint, so its ``--model``
defaults to none (the JAX ``test`` reads the checkpoint's too and ignores
the flag).
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
PRODUCER_THREADS = 1        # the JAX CLI's default (library: 0)
REMAT_CHOICES = ("none", "blocks", "full")
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
    prefetch: int = NUM_WORKERS
    producer_threads: int = PRODUCER_THREADS
    device_prefetch: int = 0
    remat: str = "none"
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
    # Megatron tensor parallelism of the vit over the model group
    tensor_parallel: bool = False
    # > 0: the vit's MLPs as switch mixtures of that many experts
    # (models/moe.py), expert parallel over a model group of 2 ranks or
    # more (JAX config.py:198-201)
    moe_experts: int = 0
    # GPipe stages of the vit over the model group, M microbatches a step
    # (0: one a stage), and the seq axis of the ring inside each stage
    # (JAX config.py:167-196)
    pipeline_parallel: bool = False
    pipeline_microbatches: int = 0
    seq_parallel: int = 1
    grad_accum: int = 1
    ckpt_async: bool = False
    epochs_per_dispatch: int = 1
    # observability (JAX config.py:261-302)
    profile: bool = False
    flightrec: bool = True
    flightrec_ring: int = 4096
    metrics_port: int = 0
    anomaly_capture: bool = False
    anomaly_window: int = 32
    anomaly_mad_k: float = 8.0
    anomaly_rel_factor: float = 3.0
    anomaly_min_excess: float = 0.05
    anomaly_capture_steps: int = 4
    anomaly_max_captures: int = 2
    # the kernels' build directory (ops/build.py) and the warmup
    compilation_cache_dir: Optional[str] = None
    no_compile_cache: bool = False
    aot_warmup: bool = False
    # fault injection and the retry policy (JAX config.py:202-215)
    fault_plan: Optional[str] = None
    fault_seed: int = 0
    retry_max_attempts: int = 3
    retry_base_delay: float = 0.05
    retry_timeout: float = 60.0
    # the elastic world (JAX config.py:216-241)
    elastic: bool = False
    elastic_dir: Optional[str] = None
    health_timeout: float = 0.0
    max_reconfigures: int = 3
    elastic_target: str = "capacity"
    elastic_min_world: int = 1
    elastic_join: bool = False
    elastic_join_wait: float = 600.0
    # the offline readers
    report_json: bool = False
    timeline_out: Optional[str] = None
    roofline_trace_dir: Optional[str] = None
    roofline_from_anomaly: bool = False
    roofline_top: int = 20
    # the fleet collector (JAX config.py:317-331)
    fleet_ranks: int = 1
    fleet_port: int = 9200
    fleet_interval: float = 1.0
    fleet_stale_after: int = 3
    fleet_max_cycles: int = 0
    slo_spec: Optional[str] = None
    # the fleet front door (JAX config.py:333-373)
    fd_port: int = 8080
    fd_ranks: int = 1
    fd_min_world: int = 1
    fd_max_world: int = 0
    fd_interval: float = 0.5
    fd_upstream_timeout: float = 10.0
    fd_pending_budget: int = 64
    fd_retry_after: float = 1.0
    fd_eject_after: int = 3
    fd_max_step_age: float = 0.0
    fd_max_cycles: int = 0
    fd_autoscale: bool = False
    fd_queue_high: float = 8.0
    fd_queue_low: float = 1.0
    fd_up_hold: float = 2.0
    fd_down_hold: float = 10.0
    fd_cooldown: float = 5.0
    fd_launch_cmd: Optional[str] = None
    fd_rollout: bool = False
    fd_watch_dir: Optional[str] = None
    fd_canary_fraction: float = 0.34
    fd_canary_hold: float = 5.0
    fd_canary_min_requests: int = 20
    fd_canary_max_error: float = 0.05
    fd_canary_p95_factor: float = 3.0
    # the fleet simulator (JAX config.py:256-260)
    sim_scenario: str = "control"
    sim_seed: int = 0
    sim_replicas: int = 0
    sim_duration: float = 0.0
    sim_model: Optional[str] = None

    def precision_policy(self):
        """The resolved precision.PrecisionPolicy for this config."""
        from .precision import from_flags

        return from_flags(self.precision, self.half_precision)


def not_ported(cfg: Config) -> Optional[str]:
    """The first setting of ``cfg`` this slice does not support, spelled
    as on the command line, or None."""
    ring = cfg.attention in ("ring", "ring_flash")
    if ring and cfg.action == "serve" and cfg.model_name in (None, "vit"):
        return f"--attention {cfg.attention}"
    return None


def check_ported(cfg: Config) -> Config:
    """Raise ValueError("not ported yet: --X") for the first unsupported
    setting; return ``cfg`` otherwise."""
    if cfg.action == "serve" and (cfg.model_parallel > 1
                                  or cfg.tensor_parallel
                                  or cfg.pipeline_parallel
                                  or cfg.seq_parallel > 1):
        # the JAX run_serve's refusal (cli.py:1500-1509)
        raise ValueError(
            "serve runs replica-local data-parallel inference; "
            "--model-parallel/--tensor-parallel/--pipeline-parallel/"
            "--seq-parallel do not apply (model-parallel-trained "
            "checkpoints convert at load)")
    check_pretrained(cfg)
    flag = not_ported(cfg)
    if flag is not None:
        raise ValueError(f"not ported yet: {flag}")
    if cfg.action == "train":
        check_epochs_per_dispatch(cfg)
    if cfg.action in ("train", "serve"):
        check_elastic(cfg)
    if cfg.action == "train" and (cfg.grad_accum < 1
                                  or cfg.batch_size % cfg.grad_accum):
        # the JAX run_train's check (cli.py:725-728)
        raise ValueError(
            f"--grad-accum must be >= 1 and divide the per-replica batch "
            f"size ({cfg.batch_size}); got {cfg.grad_accum}")
    cfg.precision_policy()      # --no-bf16 against another preset
    if cfg.remat not in REMAT_CHOICES:
        # the JAX _validate_precision's check (cli.py:104-106)
        raise ValueError(
            f"--remat must be none|blocks|full, got {cfg.remat!r}")
    if cfg.action == "train":       # test and serve: the checkpoint's
        from .models.registry import check_attention

        check_attention(cfg.model_name, cfg.attention)
    check_model_axis(cfg)
    check_pipeline(cfg)
    if cfg.device not in DEVICE_CHOICES:
        raise ValueError(f"--device must be one of {DEVICE_CHOICES}, got "
                         f"{cfg.device!r}")
    return cfg


# The JAX _train_world's refusal of a streamed run in chunks
# (cli.py:941-949), word for word.
STREAM_DISPATCH_MESSAGE = (
    "--epochs-per-dispatch > 1 requires device-resident data "
    "(whole epochs are fused into one XLA program); this run is "
    "streaming — drop --data-mode stream or lower the corpus size "
    "below --resident-max-bytes")


def check_epochs_per_dispatch(cfg: Config) -> None:
    """K < 1 fails with the JAX ``run_train`` message (cli.py:721-724),
    and K > 1 with ``--data-mode stream`` with its ``_train_world``
    message (``cli.run_train`` refuses an ``auto`` run that streams the
    same way, before any work on the device).
    K > 1 on the card captures the steps as CUDA Graphs, which capture
    NCCL's collectives but not gloo's: a world of several ranks on
    ``cuda`` whose launch would take gloo (more local ranks than cards) is
    refused here, before any work on the device."""
    k = cfg.epochs_per_dispatch
    if k < 1:
        raise ValueError(f"--epochs-per-dispatch must be >= 1, got {k}")
    if k > 1 and cfg.data_mode == "stream":
        raise ValueError(STREAM_DISPATCH_MESSAGE)
    if k == 1 or cfg.device != "cuda":
        return
    from . import runtime

    if runtime.launched_distributed() and runtime._env_int("WORLD_SIZE") > 1:
        import torch

        if runtime.backend_for(torch.device("cuda")) == "gloo":
            raise ValueError(
                f"not ported yet: --epochs-per-dispatch {k} over gloo (a "
                f"CUDA Graph captures NCCL's collectives, not gloo's; "
                f"gloo carries a world with more local ranks than cards)")


def check_elastic(cfg: Config) -> None:
    """The JAX ``run_train``'s and ``run_serve``'s launch-time checks
    (cli.py:608-623, :1519-1531): ``--elastic-join`` needs ``--elastic``
    (each with its own wording), and the admission policy is parsed now,
    so a malformed ``--elastic-target`` fails at launch rather than at the
    first health boundary."""
    if cfg.elastic_join and not cfg.elastic:
        joiner = ("a joining replica" if cfg.action == "serve"
                  else "a joiner")
        raise ValueError(
            f"--elastic-join requires --elastic: {joiner} becomes a "
            "normal elastic member and must keep reconfiguring with "
            "its world")
    if cfg.elastic:
        from .elastic import evaluate_join_policy

        evaluate_join_policy(1, [], cfg.elastic_target,
                             cfg.elastic_min_world)


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
    """``--attention ring|ring_flash``, ``--tensor-parallel`` and
    ``--pipeline-parallel`` need ``--model-parallel`` >= 2 and the vit,
    and exclude one another but for the ring inside the pipeline
    (``--seq-parallel`` >= 2): ``train`` fails with the JAX
    ``run_train`` message (cli.py:731-763), before the dataset load;
    ``test`` with the JAX registry's (``registry.py:173-212``,
    ``_require_model_axis``), which is where the JAX ``test`` fails (the
    checkpoint's model is checked when it is built; the pipeline's there
    too)."""
    ring = cfg.attention in ("ring", "ring_flash")
    tp, pp = cfg.tensor_parallel, cfg.pipeline_parallel
    if cfg.action == "serve" or not (ring or tp or pp):
        return
    if cfg.action == "train":
        ring_pp = pp and cfg.attention == "ring" and cfg.seq_parallel >= 2
        exclusive = sum((cfg.attention != "full", tp, pp)) > 1 \
            and not ring_pp
        if cfg.model_name != "vit" or exclusive or cfg.model_parallel < 2:
            raise ValueError(
                "--attention ring/flash/ring_flash, --tensor-parallel and "
                "--pipeline-parallel require --model vit, are mutually "
                "exclusive (except --pipeline-parallel + --attention ring "
                "with --seq-parallel >= 2), and (except single-chip flash) "
                "need --model-parallel >= 2; "
                f"got model={cfg.model_name!r}, "
                f"model_parallel={cfg.model_parallel}, "
                f"attention={cfg.attention!r}, "
                f"tensor_parallel={tp}, "
                f"pipeline_parallel={pp}")
        return
    if pp:
        return
    from .models.registry import check_tensor_parallel, require_model_axis

    if tp and cfg.attention != "full":
        check_tensor_parallel("vit", cfg.attention, None)
    if cfg.model_parallel < 2:
        require_model_axis(None, "--tensor-parallel (head/hidden axes)" if tp
                           else f"--attention {cfg.attention} (token axis)")


def check_pipeline(cfg: Config) -> None:
    """The JAX ``run_train``'s checks of ``--seq-parallel`` and
    ``--pipeline-microbatches`` (cli.py:756-767) and ``run_test``'s
    guard of ``--seq-parallel`` (:1347-1358), word for word."""
    if cfg.action not in ("train", "test"):
        return
    ring_pp = cfg.pipeline_parallel and cfg.attention == "ring"
    if cfg.action == "train" and cfg.seq_parallel > 1 and not (
            ring_pp and cfg.seq_parallel >= 2):
        raise ValueError(
            "--seq-parallel >= 2 is the ring x pipeline composition's "
            "third mesh axis: it requires --pipeline-parallel with "
            "--attention ring (for plain sequence parallelism use "
            "--attention ring, which rings over the 'model' axis); got "
            f"seq_parallel={cfg.seq_parallel}, "
            f"attention={cfg.attention!r}, "
            f"pipeline_parallel={cfg.pipeline_parallel}")
    if cfg.action == "test" and cfg.seq_parallel > 1 and not ring_pp:
        raise ValueError(
            "--seq-parallel >= 2 is the ring x pipeline composition's "
            "third mesh axis: it requires --pipeline-parallel with "
            "--attention ring; got "
            f"seq_parallel={cfg.seq_parallel}, "
            f"attention={cfg.attention!r}, "
            f"pipeline_parallel={cfg.pipeline_parallel}")
    if cfg.action == "train" and cfg.pipeline_microbatches \
            and not cfg.pipeline_parallel:
        raise ValueError(
            "--pipeline-microbatches requires --pipeline-parallel "
            "(it sets the GPipe M)")


def check_pipeline_batch(cfg: Config) -> None:
    """The JAX ``run_train``'s check that the pipeline engages
    (cli.py:784-807): each data shard's rows the model sees (-b x M x
    S / K) must be a multiple of the microbatches."""
    if not cfg.pipeline_parallel:
        return
    n_micro = cfg.pipeline_microbatches or cfg.model_parallel
    b_local = (cfg.batch_size * cfg.model_parallel
               * cfg.seq_parallel // cfg.grad_accum)
    if b_local < n_micro or b_local % n_micro:
        raise ValueError(
            f"--pipeline-parallel needs the per-data-shard batch "
            f"seen by the model (-b {cfg.batch_size} x "
            f"model_parallel {cfg.model_parallel} / grad_accum "
            f"{cfg.grad_accum} = {b_local}) to be a multiple of the "
            f"{n_micro} pipeline microbatches; raise -b or lower "
            f"--pipeline-microbatches/--grad-accum")


def _model_parallel_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--model-parallel", type=int, default=1,
                   dest="model_parallel", metavar="N",
                   help="the N-way 'model' mesh axis (must divide the "
                        "world; default 1): parameters and optimizer state "
                        "placed over it, and the axis of --attention ring "
                        "and ring_flash, --tensor-parallel and expert "
                        "parallelism")


def _tensor_parallel_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--tensor-parallel", action="store_true",
                   dest="tensor_parallel",
                   help="Megatron-style tensor parallelism for --model "
                        "vit: heads + MLP hidden sharded over the 'model' "
                        "mesh axis with sharded activations (requires "
                        "--model-parallel >= 2)")


def _pipeline_args(p: argparse.ArgumentParser) -> None:
    """The JAX ``_common_args``' --seq-parallel, --pipeline-microbatches
    and --pipeline-parallel (config.py:669-707), same defaults."""
    p.add_argument("--seq-parallel", type=int, default=1,
                   dest="seq_parallel", metavar="N",
                   help="N-way 'seq' mesh axis for --pipeline-parallel "
                        "+ --attention ring (ring attention inside each "
                        "pipeline stage; default 1 = 2-D mesh)")
    p.add_argument("--pipeline-microbatches", type=int, default=0,
                   dest="pipeline_microbatches", metavar="M",
                   help="GPipe microbatches per step for "
                        "--pipeline-parallel (default 0 = one per "
                        "stage); larger M shrinks the pipeline bubble "
                        "(P-1)/(M+P-1); per-device batch must divide "
                        "by M")
    p.add_argument("--pipeline-parallel", action="store_true",
                   dest="pipeline_parallel",
                   help="GPipe stage parallelism for --model vit: "
                        "transformer blocks sharded over the 'model' "
                        "mesh axis as pipeline stages (requires "
                        "--model-parallel >= 2)")


def _moe_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--moe-experts", type=int, default=0,
                   dest="moe_experts", metavar="E",
                   help="replace the vit MLPs with E-expert switch "
                        "mixture-of-experts layers (expert-parallel "
                        "over the 'model' axis when --model-parallel "
                        ">= 2; default 0 = dense MLPs)")


def check_moe(cfg: Config, model_name: str) -> None:
    """The JAX ``run_train``'s checks of ``--moe-experts`` (cli.py:768-783),
    word for word, against the model the run trains (the checkpoint's
    under ``-f``), before the dataset load."""
    if cfg.moe_experts and (model_name != "vit" or cfg.tensor_parallel
                            or cfg.pipeline_parallel
                            or cfg.moe_experts < 2):
        raise ValueError(
            "--moe-experts needs --model vit, E >= 2, and is exclusive "
            "with --tensor-parallel/--pipeline-parallel; got "
            f"model={model_name!r}, moe_experts={cfg.moe_experts}, "
            f"tensor_parallel={cfg.tensor_parallel}, "
            f"pipeline_parallel={cfg.pipeline_parallel}")
    if (cfg.moe_experts and cfg.model_parallel >= 2
            and cfg.moe_experts % cfg.model_parallel):
        raise ValueError(
            f"--moe-experts {cfg.moe_experts} must be divisible by "
            f"--model-parallel {cfg.model_parallel} for expert "
            "parallelism (each device holds E/mp experts)")


def _device_arg(p: argparse.ArgumentParser, what: str) -> None:
    p.add_argument("--device", choices=DEVICE_CHOICES, default="cuda",
                   help=f"device to {what} on (default: cuda; never falls "
                        "back to the CPU on its own)")


_ON = {"action": "store_true"}
_INT = {"type": int}

# Flags of the JAX CLI that this slice refuses: (flag, how it parses, the
# value that asks for what the port does anyway).  They have no default,
# so only a flag given on the command line is looked at; any other value
# is refused (``refused_flag``), never ignored.
REFUSED_EVERYWHERE = (
    ("--scan-layers", _ON, False),
    ("--ckpt-format", {"choices": ("msgpack", "orbax")}, "msgpack"),
)
REFUSED_TRAIN_TEST = REFUSED_EVERYWHERE


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


def _data_remat_args(p: argparse.ArgumentParser) -> None:
    """The JAX ``_common_args``' --remat, --data-mode and the streaming
    loader's three flags (config.py:428-456), same defaults."""
    p.add_argument("--remat", choices=REMAT_CHOICES, default="none",
                   help="gradient rematerialization: blocks = recompute "
                        "each vit/densenet/inception block's interior in "
                        "backward keeping the outputs of matmuls with no "
                        "batch dimension (the whole forward for the other "
                        "models), full = save nothing (the backward "
                        "recomputes the forward)")
    p.add_argument("--data-mode", choices=("auto", "stream", "resident"),
                   default="auto", dest="data_mode",
                   help="device-resident vs streamed batches (default: "
                        "auto: resident while the split fits the budget)")
    p.add_argument("--prefetch", type=int, default=NUM_WORKERS,
                   metavar="N",
                   help="streamed-mode prefetch depth (the ref NUM_WORKERS "
                        f"analogue; default {NUM_WORKERS}; 0 = strictly "
                        "synchronous)")
    p.add_argument("--producer-threads", type=int, default=PRODUCER_THREADS,
                   metavar="N", dest="producer_threads",
                   help="streamed-mode background threads gathering (and "
                        "copying) batches; order stays byte-identical "
                        f"(default {PRODUCER_THREADS}; 0 = on the training "
                        "thread)")
    p.add_argument("--device-prefetch", type=int, default=0, metavar="N",
                   dest="device_prefetch",
                   help="streamed-mode transfer thread that copies the "
                        "next N batches to the device in step order "
                        "while the current step computes (default 0 = "
                        "off)")


def _observability_args(p: argparse.ArgumentParser) -> None:
    """The JAX ``_common_args``' observability and compile-cache flags
    (config.py:468-477, :588-648), same spellings and defaults."""
    p.add_argument("--compilation-cache-dir", type=str, default=None,
                   dest="compilation_cache_dir", metavar="DIR",
                   help="build the CUDA kernels' libraries into DIR and "
                        "look them up there (default build/kernels "
                        "beside the package)")
    p.add_argument("--no-compile-cache", action="store_true",
                   dest="no_compile_cache",
                   help="build the kernels into a fresh private directory "
                        "removed at the end of the run")
    p.add_argument("--aot-warmup", action="store_true", dest="aot_warmup",
                   help="before epoch 1 build and load every kernel of "
                        "the run and run one train step and one eval "
                        "forward on a throwaway copy of the model "
                        "(records compile/warmup_s, compile/cache_hit and "
                        "RSL_PATH/costs.json; test ignores it)")
    p.add_argument("--profile", action="store_true",
                   help="write a torch.profiler trace of the second epoch "
                        "to RSL_PATH/trace and its roofline to "
                        "RSL_PATH/roofline.json (test ignores it)")
    p.add_argument("--flightrec", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="per-rank ring-buffer flight recorder of the "
                        "steps, dumped to RSL_PATH/flightrec-rank<N>.json "
                        "on a crash and at run end (default: on; "
                        "--no-flightrec disables)")
    p.add_argument("--flightrec-ring", type=int, default=4096,
                   dest="flightrec_ring", metavar="N",
                   help="flight-recorder ring size (default 4096)")
    p.add_argument("--metrics-port", type=int, default=0,
                   dest="metrics_port", metavar="PORT",
                   help="serve /metrics and /healthz on PORT+rank while "
                        "the run is alive; 0 disables (default; test "
                        "ignores it)")
    p.add_argument("--anomaly-capture", action="store_true",
                   dest="anomaly_capture",
                   help="when a step goes anomalous capture the next K "
                        "steps with torch.profiler into "
                        "RSL_PATH/anomaly_traces/ (requires the flight "
                        "recorder)")
    p.add_argument("--anomaly-window", type=int, default=32,
                   dest="anomaly_window", metavar="W",
                   help="anomaly baseline: the last W step times "
                        "(default 32)")
    p.add_argument("--anomaly-mad-k", type=float, default=8.0,
                   dest="anomaly_mad_k", metavar="K",
                   help="anomalous when the excess over the median "
                        "exceeds K*MAD (default 8.0)")
    p.add_argument("--anomaly-min-excess", type=float, default=0.05,
                   dest="anomaly_min_excess", metavar="SEC",
                   help="absolute floor on the excess (default 0.05)")
    p.add_argument("--anomaly-capture-steps", type=int, default=4,
                   dest="anomaly_capture_steps", metavar="K",
                   help="steps a capture (default 4)")
    p.add_argument("--anomaly-max-captures", type=int, default=2,
                   dest="anomaly_max_captures", metavar="N",
                   help="captures a run at most (default 2)")


def _fault_args(p: argparse.ArgumentParser) -> None:
    """The JAX ``_common_args``' fault and retry flags (config.py:
    480-509), same spellings and defaults."""
    p.add_argument("--fault-plan", type=str, default=None,
                   dest="fault_plan", metavar="PLAN",
                   help="fault-injection plan: "
                        "'site:kind:after_n[:count[:stall_s]]' "
                        "(';'-separated, e.g. 'data.read:ioerror:2') or a "
                        "JSON plan file; sites: data.read data.host_batch "
                        "ckpt.save ckpt.finalize ckpt.restore runtime.init "
                        "elastic.reinit elastic.join elastic.grow_reinit "
                        "telemetry.write; kinds: ioerror fatal preempt "
                        "torn stall rank_loss rank_join (default: no "
                        "faults, zero overhead)")
    p.add_argument("--fault-seed", type=int, default=0, dest="fault_seed",
                   metavar="S",
                   help="seed for the fault plan + deterministic retry "
                        "jitter (default 0)")
    p.add_argument("--retry-max-attempts", type=int, default=3,
                   dest="retry_max_attempts", metavar="N",
                   help="attempts per transient-failure site (dataset "
                        "reads, checkpoint I/O, distributed init) before "
                        "giving up (default 3)")
    p.add_argument("--retry-base-delay", type=float, default=0.05,
                   dest="retry_base_delay", metavar="SEC",
                   help="first retry backoff delay in seconds; doubles "
                        "per attempt with deterministic jitter "
                        "(default 0.05)")
    p.add_argument("--retry-timeout", type=float, default=60.0,
                   dest="retry_timeout", metavar="SEC",
                   help="per-site wall-clock retry deadline: no new "
                        "attempt starts after this many seconds "
                        "(default 60)")


def _elastic_args(p: argparse.ArgumentParser) -> None:
    """The JAX ``_common_args``' health and elastic flags (config.py:
    510-564), same spellings and defaults."""
    p.add_argument("--elastic", action="store_true",
                   help="survive rank loss: on peer failure the healthy "
                        "ranks tear the process group down, re-elect a "
                        "coordinator, join the smaller surviving world and "
                        "resume from the newest verified checkpoint (see "
                        "elastic.py; coordinator loss is not survivable; "
                        "launch one process per rank, not under torchrun)")
    p.add_argument("--elastic-dir", type=str, default=None,
                   dest="elastic_dir", metavar="DIR",
                   help="shared rendezvous directory for --elastic "
                        "(claim files + world.json; default "
                        "RSL_PATH/elastic — already shared, the "
                        "checkpoints live there)")
    p.add_argument("--health-timeout", type=float, default=0.0,
                   dest="health_timeout", metavar="SEC",
                   help="bound the boundary health agreement: if the "
                        "agree_health all-gather does not complete in "
                        "SEC seconds, treat it as a peer loss locally "
                        "(reconfigure under --elastic, exit loudly "
                        "otherwise) instead of hanging on a dead rank "
                        "(default 0 = unbounded)")
    p.add_argument("--max-reconfigures", type=int, default=3,
                   dest="max_reconfigures", metavar="N",
                   help="cap on elastic reconfigure rounds (shrink or "
                        "grow) per process; exceeding it exits with the "
                        "underlying error (default 3)")
    p.add_argument("--elastic-target", type=str, default="capacity",
                   dest="elastic_target", metavar="POLICY",
                   help="autoscaling admission policy for join claims "
                        "at each health boundary: 'capacity' admits "
                        "every claim (scale to whatever shows up), "
                        "'fixed:N' admits only up to a world of N "
                        "(default capacity)")
    p.add_argument("--elastic-min-world", type=int, default=1,
                   dest="elastic_min_world", metavar="N",
                   help="floor for elastic grow admissions: a join "
                        "batch whose admission would still leave the "
                        "world below N is declined whole — the "
                        "reconfigure window is not worth paying "
                        "(default 1)")
    p.add_argument("--elastic-join", action="store_true",
                   dest="elastic_join",
                   help="join a running --elastic world instead of "
                        "initializing one: drop a join claim in "
                        "--elastic-dir, wait for the coordinator's "
                        "admit/decline verdict, and enter the grown "
                        "world at the rank it assigns (fresh capacity "
                        "or a departed rank restarting)")
    p.add_argument("--elastic-join-wait", type=float, default=600.0,
                   dest="elastic_join_wait", metavar="S",
                   help="how long a joiner waits for the coordinator's "
                        "admit/decline verdict before emitting "
                        "elastic/join_wait_timeout and giving up; must "
                        "dominate an epoch plus a reconfigure window "
                        "(default 600)")


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
                   help="mixed-precision preset: f32, bf16 (f32 weights, "
                        "bf16 compute; the default), bf16_full (bf16 "
                        "weights too) or f16 (f16 compute with a dynamic "
                        "loss scale)")
    p.add_argument("--grad-accum", type=int, default=1, dest="grad_accum",
                   metavar="K",
                   help="accumulate gradients over K microbatches per "
                        "optimizer step (default 1; test ignores it)")
    p.add_argument("--ckpt-async", action="store_true", dest="ckpt_async",
                   help="non-blocking checkpoint saves: serialization and "
                        "file I/O run on a background writer joined at the "
                        "next save, preemption or exit (the same bytes; "
                        "test ignores it)")
    p.add_argument("--epochs-per-dispatch", type=int, default=1,
                   dest="epochs_per_dispatch", metavar="K",
                   help="train K epochs (train + validation passes) a "
                        "dispatch: on the card each step replays a "
                        "captured CUDA Graph and the epochs' sums are read "
                        "once a chunk; the rolling checkpoint is written "
                        "once a chunk (default 1; test ignores it)")
    _data_remat_args(p)
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
    _tensor_parallel_arg(p)
    _pipeline_args(p)
    _moe_arg(p)
    _device_arg(p, action)
    _observability_args(p)
    _fault_args(p)
    _elastic_args(p)
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
                   help="mixed-precision preset: f32, bf16 (the default), "
                        "bf16_full or f16")
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
    _data_remat_args(p)
    _model_parallel_arg(p)
    _tensor_parallel_arg(p)
    _pipeline_args(p)
    _moe_arg(p)
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
    p.add_argument("--flightrec", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="per-rank ring-buffer flight recorder of the "
                        "batches, dumped to RSL_PATH/flightrec-rank<N>.json "
                        "on a crash and at run end (default: on; "
                        "--no-flightrec disables)")
    p.add_argument("--flightrec-ring", type=int, default=4096,
                   dest="flightrec_ring", metavar="N",
                   help="flight-recorder ring size (default 4096)")
    p.add_argument("--metrics-port", type=int, default=0,
                   dest="metrics_port", metavar="PORT",
                   help="serve /metrics and /healthz (with the replica's "
                        "serve block) on PORT+rank while the replica is "
                        "alive; 0 disables (default)")
    _fault_args(p)
    _elastic_args(p)
    _refused_args(p, REFUSED_EVERYWHERE)
    _fleet_parser(sub)
    _frontdoor_parser(sub)
    _offline_parsers(sub)
    return parser


def _fleet_parser(sub) -> None:
    """The JAX ``fleet`` collector's parser (config.py:859-905), same
    flags and defaults."""
    p = sub.add_parser(
        "fleet", help="run the fleet metrics collector: scrape all "
                      "rank /metrics+/healthz exporters, merge into "
                      "fleet-level series (elastic-aware), re-export "
                      "/metrics + /fleet, evaluate --slo-spec "
                      "burn-rate objectives into incident bundles")
    p.add_argument("--rsl_path", type=str, default=RSL_PATH,
                   help=f"run directory shared with the serve world: "
                        f"fleet-metrics.jsonl and incident-*.json land "
                        f"here, trace records are mined from here "
                        f"(default: {RSL_PATH})")
    p.add_argument("--metrics-port", type=int, default=9100,
                   dest="metrics_port", metavar="PORT",
                   help="base port of the per-rank exporters to scrape "
                        "(rank r answers on PORT + r; default 9100)")
    p.add_argument("--ranks", type=int, default=1, dest="fleet_ranks",
                   metavar="N",
                   help="candidate rank count: ports PORT..PORT+N-1 are "
                        "probed every cycle, so elastic joiners appear "
                        "within one interval (default 1)")
    p.add_argument("--fleet-port", type=int, default=9200,
                   dest="fleet_port", metavar="PORT",
                   help="serve the merged fleet /metrics (Prom text) and "
                        "/fleet (JSON) here (default 9200; 0 disables "
                        "re-export)")
    p.add_argument("--interval", type=float, default=1.0,
                   dest="fleet_interval", metavar="S",
                   help="scrape cycle period in seconds (default 1.0)")
    p.add_argument("--stale-after", type=int, default=3,
                   dest="fleet_stale_after", metavar="N",
                   help="consecutive failed scrapes before a rank ages "
                        "out of the merged series (default 3)")
    p.add_argument("--max-cycles", type=int, default=0,
                   dest="fleet_max_cycles", metavar="N",
                   help="stop after N scrape cycles (0 = run until "
                        "interrupted; gates use N)")
    p.add_argument("--slo-spec", type=str, default=None, dest="slo_spec",
                   metavar="FILE",
                   help="JSON file declaring SLO objectives (slo.py "
                        "schema); firing objectives write "
                        "incident-*.json bundles")


def _frontdoor_parser(sub) -> None:
    """The JAX ``frontdoor`` parser (config.py:906-1050), same flags,
    defaults and help; ``--launch-cmd`` names this package's ``serve``."""
    p = sub.add_parser(
        "frontdoor", help="run the fleet front door: route client "
                          "/predict traffic across the serve replicas "
                          "with health-aware admission, autoscale on "
                          "queue/SLO pressure, and canary-roll out "
                          "newer lineage-verified checkpoints")
    p.add_argument("--rsl_path", type=str, default=RSL_PATH,
                   help=f"run directory shared with the serve world: "
                        f"telemetry events and join logs land here "
                        f"(default: {RSL_PATH})")
    p.add_argument("--port", type=int, default=8080, dest="fd_port",
                   metavar="PORT",
                   help="the one client-facing port (default 8080)")
    p.add_argument("--ranks", type=int, default=1, dest="fd_ranks",
                   metavar="N",
                   help="initial replica count: predict ports "
                        "serve-port..serve-port+N-1 (default 1)")
    p.add_argument("--serve-port", type=int, default=8100,
                   dest="serve_port", metavar="PORT",
                   help="base /predict port of the replicas (replica i "
                        "answers on PORT + i; default 8100)")
    p.add_argument("--metrics-port", type=int, default=0,
                   dest="metrics_port", metavar="PORT",
                   help="base port of the per-rank exporters: health "
                        "probes hit PORT + i /healthz and the embedded "
                        "fleet collector scrapes them (0 = probe /livez "
                        "on the predict port instead, no collector; "
                        "default 0)")
    p.add_argument("--interval", type=float, default=0.5,
                   dest="fd_interval", metavar="S",
                   help="control-loop period: probe + scrape + "
                        "autoscale/rollout decisions (default 0.5)")
    p.add_argument("--upstream-timeout", type=float, default=10.0,
                   dest="fd_upstream_timeout", metavar="S",
                   help="per-attempt deadline on a proxied /predict; a "
                        "hung replica is cut off and the request retried "
                        "once on another (default 10.0)")
    p.add_argument("--pending-budget", type=int, default=64,
                   dest="fd_pending_budget", metavar="N",
                   help="fleet-wide in-flight request budget past which "
                        "admission sheds with 503 + Retry-After "
                        "(default 64)")
    p.add_argument("--retry-after", type=float, default=1.0,
                   dest="fd_retry_after", metavar="S",
                   help="Retry-After hint on shed responses (default 1.0)")
    p.add_argument("--eject-after", type=int, default=3,
                   dest="fd_eject_after", metavar="N",
                   help="consecutive probe/transport failures before a "
                        "replica is ejected from routing (readmitted on "
                        "recovery; default 3)")
    p.add_argument("--max-step-age", type=float, default=0.0,
                   dest="fd_max_step_age", metavar="S",
                   help="eject a replica whose /healthz last_step_age_s "
                        "exceeds S (0 disables the staleness check; "
                        "default 0)")
    p.add_argument("--max-cycles", type=int, default=0,
                   dest="fd_max_cycles", metavar="N",
                   help="stop after N control cycles (0 = run until "
                        "interrupted; gates use N)")
    p.add_argument("--slo-spec", type=str, default=None, dest="slo_spec",
                   metavar="FILE",
                   help="SLO objectives (slo.py schema) evaluated by the "
                        "embedded collector; firing verdicts are "
                        "scale-up pressure")
    p.add_argument("--stale-after", type=int, default=3,
                   dest="fleet_stale_after", metavar="N",
                   help="collector scrapes before a silent rank ages out "
                        "of the merged series (default 3)")
    p.add_argument("--autoscale", action="store_true", dest="fd_autoscale",
                   help="enable the autoscale controller")
    p.add_argument("--min-world", type=int, default=1, dest="fd_min_world",
                   metavar="N",
                   help="never drain below N replicas; a world below N is "
                        "repaired by launching (default 1)")
    p.add_argument("--max-world", type=int, default=0, dest="fd_max_world",
                   metavar="N",
                   help="never launch above N replicas (0 = --ranks; "
                        "default 0)")
    p.add_argument("--queue-high", type=float, default=8.0,
                   dest="fd_queue_high", metavar="D",
                   help="scale up when every replica's queue depth holds "
                        "at/above D (default 8.0)")
    p.add_argument("--queue-low", type=float, default=1.0,
                   dest="fd_queue_low", metavar="D",
                   help="scale down only when every queue depth holds "
                        "at/below D (default 1.0)")
    p.add_argument("--up-hold", type=float, default=2.0, dest="fd_up_hold",
                   metavar="S",
                   help="pressure must hold S seconds before a scale-up "
                        "(default 2.0)")
    p.add_argument("--down-hold", type=float, default=10.0,
                   dest="fd_down_hold", metavar="S",
                   help="calm must hold S seconds before a scale-down "
                        "(default 10.0)")
    p.add_argument("--cooldown", type=float, default=5.0,
                   dest="fd_cooldown", metavar="S",
                   help="minimum spacing between scale actions "
                        "(default 5.0)")
    p.add_argument("--launch-cmd", type=str, default=None,
                   dest="fd_launch_cmd", metavar="CMD",
                   help="shell-ish command launched (Popen, no shell) to "
                        "add a replica on scale-up — typically python -m "
                        "distributedpytorch_tpu_torch serve --elastic "
                        "--elastic-join")
    p.add_argument("--rollout", action="store_true", dest="fd_rollout",
                   help="enable canary rollout of newer lineage-verified "
                        "checkpoints")
    p.add_argument("--watch-dir", type=str, default=None,
                   dest="fd_watch_dir", metavar="DIR",
                   help="directory whose ckpt-lineage.json is watched for "
                        "new checkpoints (default: rsl_path)")
    p.add_argument("--canary-fraction", type=float, default=0.34,
                   dest="fd_canary_fraction", metavar="F",
                   help="fraction of routable replicas given the "
                        "candidate (always >=1, never all; default 0.34)")
    p.add_argument("--canary-hold", type=float, default=5.0,
                   dest="fd_canary_hold", metavar="S",
                   help="canary soak time before promotion (default 5.0)")
    p.add_argument("--canary-min-requests", type=int, default=20,
                   dest="fd_canary_min_requests", metavar="N",
                   help="canary answers required before a "
                        "promote/rollback verdict (default 20)")
    p.add_argument("--canary-max-error", type=float, default=0.05,
                   dest="fd_canary_max_error", metavar="R",
                   help="canary error ratio above which (and above "
                        "stable's) the candidate is rolled back "
                        "(default 0.05)")
    p.add_argument("--canary-p95-factor", type=float, default=3.0,
                   dest="fd_canary_p95_factor", metavar="X",
                   help="roll back when canary p95 exceeds stable p95 by "
                        "this factor (default 3.0)")


# the readers of a run directory, the fleet collector, the front door and
# the simulator: no device, no model, no refusals
OFFLINE_ACTIONS = ("telemetry", "goodput", "timeline", "roofline",
                   "incidents", "fleet", "frontdoor", "sim")


def _offline_parsers(sub) -> None:
    """The JAX readers of a run directory (config.py:780-840)."""
    p = sub.add_parser("telemetry",
                       help="summarize a run's telemetry JSONL files")
    p.add_argument("--rsl_path", type=str, default=RSL_PATH,
                   help=f"run directory holding telemetry/ "
                        f"(default: {RSL_PATH})")
    p.add_argument("--json", action="store_true", dest="report_json",
                   help="machine-readable aggregate output")
    p = sub.add_parser("goodput",
                       help="summarize a run's goodput ledger: per-rank "
                            "wall-clock attribution by category")
    p.add_argument("--rsl_path", type=str, default=RSL_PATH,
                   help=f"run directory holding goodput*.json "
                        f"(default: {RSL_PATH})")
    p = sub.add_parser("timeline",
                       help="merge per-rank telemetry + flight records "
                            "into a Perfetto-loadable Chrome trace")
    p.add_argument("--rsl_path", type=str, default=RSL_PATH,
                   help=f"run directory holding telemetry/ and flightrec "
                        f"dumps (default: {RSL_PATH})")
    p.add_argument("-o", "--out", type=str, default=None, metavar="FILE",
                   dest="timeline_out",
                   help="trace output path (default: "
                        "RSL_PATH/timeline.json)")
    p = sub.add_parser("roofline",
                       help="per-op roofline attribution of a profiler "
                            "trace: time share, compute- vs memory-bound")
    p.add_argument("--rsl_path", type=str, default=RSL_PATH,
                   help=f"run directory holding trace/ and costs.json "
                        f"(default: {RSL_PATH})")
    p.add_argument("--trace-dir", type=str, default=None, metavar="DIR",
                   dest="roofline_trace_dir",
                   help="analyze this torch.profiler capture instead of "
                        "RSL_PATH/trace")
    p.add_argument("--from-anomaly", action="store_true",
                   dest="roofline_from_anomaly",
                   help="analyze the newest anomaly capture under "
                        "RSL_PATH/anomaly_traces/ instead")
    p.add_argument("--top", type=int, default=20, dest="roofline_top",
                   help="rows in the ranked table (default 20)")
    p.add_argument("--json", action="store_true", dest="report_json",
                   help="print the full roofline.json report instead of "
                        "the table")
    p = sub.add_parser(
        "incidents", help="report the SLO incident bundles a fleet "
                          "collector wrote for this run")
    p.add_argument("--rsl_path", type=str, default=RSL_PATH,
                   help=f"run directory holding incident-*.json "
                        f"(default: {RSL_PATH})")
    # the JAX ``sim`` parser (config.py:1062-1092)
    p = sub.add_parser(
        "sim", help="run a seeded fleet-scale scenario through the real "
                    "control-plane policies and emit live-run JSONL "
                    "artifacts")
    p.add_argument("--rsl_path", type=str, default=RSL_PATH,
                   help=f"artifact output directory (default: {RSL_PATH})")
    p.add_argument("--scenario", type=str, default="control",
                   dest="sim_scenario", metavar="NAME|PATH",
                   help="built-in scenario name (control, diurnal, burst, "
                        "preemption_wave, chaos) or a scenario JSON path "
                        "(default control)")
    p.add_argument("--seed", type=int, default=0, dest="sim_seed",
                   metavar="N",
                   help="simulation seed — same seed + same scenario = "
                        "byte-identical event log (default 0)")
    p.add_argument("--replicas", type=int, default=0, dest="sim_replicas",
                   metavar="N",
                   help="fleet size override (0 = scenario default)")
    p.add_argument("--duration", type=float, default=0.0,
                   dest="sim_duration", metavar="S",
                   help="virtual-seconds override (0 = scenario default)")
    p.add_argument("--model", type=str, default=None, dest="sim_model",
                   metavar="PATH",
                   help="latency-model JSON in the JAX package's format "
                        "(default: built-in calibration)")


def config_from_argv(argv=None) -> Config:
    """Parse, then refuse what is not ported yet (ValueError).  Every
    other argument's dest is the name of its Config field."""
    args = vars(build_parser().parse_args(argv))
    fields = {f.name: args[f.name] for f in dataclasses.fields(Config)
              if f.name in args}
    if args["action"] in OFFLINE_ACTIONS:
        return Config(**fields)
    flag = refused_flag(args, REFUSED_EVERYWHERE
                        if args["action"] == "serve" else REFUSED_TRAIN_TEST)
    if flag is not None:
        raise ValueError(f"not ported yet: {flag}")
    fields["half_precision"] = not args["no_bf16"]
    return check_ported(Config(**fields))
