"""Device resolution and the data-parallel process world.

Counterpart of ``distributedpytorch_tpu/runtime.py`` (``initialize_
distributed`` at :68-138, ``process_index``/``process_count``/``is_main``/
``world_size``/``barrier`` at :169-259).  The device is ``cuda`` unless
the caller asks for the CPU, and a missing GPU is an error, never a quiet
run on the CPU.

A launch by ``torchrun`` (or anything that sets ``WORLD_SIZE``, ``RANK``,
``MASTER_ADDR`` and ``MASTER_PORT``: the reference's env:// contract, ref
classif.py:86-87) joins a ``torch.distributed`` world, one rank per
process; a plain launch is a world of one with no process group.  The
backend follows the device: gloo for ``cpu``; NCCL for ``cuda`` when
every local rank has a card of its own (rank ``LOCAL_RANK`` takes card
``LOCAL_RANK``); gloo over CUDA tensors when the local ranks outnumber the
cards (NCCL refuses two ranks on one card), the device staying ``cuda``.

``make_mesh`` lays the world out as the JAX ``(data, model)`` mesh
(``runtime.py:192-220``) with process groups, for ``--model-parallel``:
``ring_shift`` and ``all_gather_seq`` are the ring attention's traffic
over a model group.

``agree_health`` is the JAX bounded health agreement (``runtime.py:
275-350``): one all-gather of three flags at each epoch boundary.  It runs
on host memory over a gloo group kept for it alone (``health_group``),
even in an NCCL world, created once a world with the ``--health-timeout``
as its timeout, so that a peer that never arrives surfaces as gloo's own
timeout error (``faults.HealthTimeoutError``) and nothing is left blocked
on a thread.  A world after an elastic reconfigure is joined through a
``TCPStore`` at the address its coordinator published (``init_world``,
``elastic.py``); ``teardown_distributed`` aborts an NCCL communicator
before it destroys the group.
"""

from __future__ import annotations

import dataclasses
import os
import warnings
from datetime import timedelta
from typing import Optional, Tuple

import torch
import torch.distributed as dist
# Imported before any process group exists: its functions take
# ``group=group.WORLD`` as default arguments, evaluated at import, and
# DistributedDataParallel imports it.  Imported after a world is up, it
# pins that world's group, and with it the group's gloo sockets, for the
# life of the process: ``destroy_process_group`` then closes nothing, and
# a peer blocked in a collective on this process is never woken.
import torch.distributed.nn.functional  # noqa: F401

from . import faults

# The process group's own timeout (a blocked collective on a live peer).
GROUP_TIMEOUT = timedelta(minutes=10)


def resolve_device(device: str = "cuda") -> torch.device:
    """``"cuda"`` or ``"cpu"`` -> torch.device.  Raises ValueError when
    CUDA is asked for and no CUDA device is available.  In a world of
    several ranks on ``cuda``, the rank's own card."""
    if device == "cpu":
        return torch.device("cpu")
    if device == "cuda":
        # a failed CUDA initialization shows only as a warning
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            available = torch.cuda.is_available()
        if not available:
            why = "".join(f"; {w.message}" for w in caught)
            raise ValueError(
                "--device cuda: no CUDA device is available "
                f"(torch.cuda.is_available() is false{why}); pass "
                "--device cpu to run on the CPU")
        index = local_rank() % torch.cuda.device_count()
        return torch.device("cuda", index)
    raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")


def device_memory_limit(device: torch.device) -> Optional[int]:
    """The device's memory in bytes (the card's total memory), or None on
    the CPU: the JAX ``device_memory_limit`` (:488-506), which is None
    where the backend reports nothing."""
    if device.type != "cuda":
        return None
    return int(torch.cuda.get_device_properties(device).total_memory)


def launched_distributed() -> bool:
    """True under a multi-process launcher (``WORLD_SIZE`` is set)."""
    return os.environ.get("WORLD_SIZE", "").strip() != ""


def _env_int(name: str, default: Optional[int] = None) -> int:
    value = os.environ.get(name, "").strip()
    if not value:
        if default is None:
            raise ValueError(f"multi-process launch: {name} is not set "
                             f"(env:// rendezvous needs WORLD_SIZE, RANK, "
                             f"MASTER_ADDR and MASTER_PORT)")
        return default
    try:
        return int(value)
    except ValueError:
        raise ValueError(f"multi-process launch: {name}={value!r} is not "
                         f"an integer") from None


def local_rank() -> int:
    return _env_int("LOCAL_RANK", 0) if launched_distributed() else 0


def backend_for(device: torch.device) -> str:
    """gloo on the CPU; on CUDA, NCCL when each local rank has its own
    card, else gloo over CUDA tensors."""
    if device.type != "cuda":
        return "gloo"
    local_world = _env_int("LOCAL_WORLD_SIZE", 1)
    return "nccl" if local_world <= torch.cuda.device_count() else "gloo"


def initialize_distributed(device: torch.device) -> Optional[str]:
    """Join the launcher's world (env:// rendezvous) on the backend that
    ``device`` calls for; returns the backend, or None for a plain launch.
    Idempotent.  The init runs under the process retry policy at fault
    site ``runtime.init`` (JAX runtime.py:122-136): a coordinator that is
    not up yet is the canonical transient failure."""
    if not launched_distributed():
        return None
    if dist.is_initialized():
        return dist.get_backend()
    world = _env_int("WORLD_SIZE")
    rank = _env_int("RANK")
    for name in ("MASTER_ADDR", "MASTER_PORT"):
        if not os.environ.get(name, "").strip():
            _env_int(name)                      # raises, naming it
    if not 0 <= rank < world:
        raise ValueError(f"multi-process launch: RANK={rank} outside "
                         f"WORLD_SIZE={world}")
    backend = backend_for(device)
    kwargs = {}
    if backend == "nccl":
        torch.cuda.set_device(device)
        kwargs["device_id"] = device

    def _init():
        faults.fire("runtime.init")
        dist.init_process_group(backend, init_method="env://",
                                world_size=world, rank=rank,
                                timeout=GROUP_TIMEOUT, **kwargs)

    faults.retry(_init, "runtime.init",
                 transient=(OSError, TimeoutError, RuntimeError))
    return backend


_store = None   # the TCPStore of an elastic generation's world


def init_world(coordinator: str, world: int, rank: int, backend: str,
               device: torch.device, store=None) -> None:
    """Join an elastic generation's world: a ``TCPStore`` at
    ``coordinator`` ("host:port"; rank 0 passes the server ``store`` it
    opened before publishing the address), then the process group of
    ``world`` ranks on ``backend``."""
    global _store
    host, port = coordinator.rsplit(":", 1)
    if store is None:
        store = dist.TCPStore(host, int(port), world, is_master=False,
                              timeout=GROUP_TIMEOUT)
    kwargs = {}
    if backend == "nccl":
        torch.cuda.set_device(device)
        kwargs["device_id"] = device
    dist.init_process_group(backend, store=store, world_size=world,
                            rank=rank, timeout=GROUP_TIMEOUT, **kwargs)
    _store = store


def open_store(world: int):
    """The server of the next generation's ``TCPStore``, on a port the
    system picks (read back from ``store.port``): bound before its
    address is published, so no follower can race its start."""
    host = os.environ.get("DPT_ELASTIC_HOST", "127.0.0.1")
    return dist.TCPStore(host, 0, world, is_master=True,
                         timeout=GROUP_TIMEOUT, wait_for_workers=False), host


def join_distributed(elastic_dir: str, device: torch.device,
                     timeout_s: Optional[float] = None) -> dict:
    """Enter a running ``--elastic`` world as a joiner (JAX
    runtime.py:141-166): drop a join claim in the rendezvous directory,
    wait for the world's coordinator to admit it at a health boundary,
    and join at the rank the admit marker assigns
    (``elastic.join_world``).  Returns the join info."""
    if distributed():
        raise RuntimeError("join_distributed: the process group is "
                           "already initialized in this process")
    from . import elastic

    return elastic.join_world(elastic_dir, device, timeout_s)


def teardown_distributed() -> None:
    """End this process's part in the current world, whatever state its
    peers are in: the health group dropped, an NCCL communicator aborted
    first (destroying one whose peer is gone can hang), then the group
    destroyed.  Closing this process's gloo sockets is what wakes a peer
    still blocked in a collective on a live neighbour (``elastic.py``)."""
    global _health, _store
    _health = None
    if not distributed():
        _store = None
        return
    if dist.get_backend() == "nccl":
        from torch.distributed import distributed_c10d as c10d

        abort = getattr(c10d, "_abort_process_group", None)
        try:
            if abort is not None:
                abort()
            else:
                dist.group.WORLD.abort()
        # broad on purpose: the communicator is being thrown away, and a
        # failed abort must not stop the teardown
        except Exception as e:
            import logging

            logging.warning(f"NCCL abort during teardown: {e}")
    if distributed():
        dist.destroy_process_group()
    _store = None


def shutdown_distributed() -> None:
    global _health, _store
    _health = _store = None
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def distributed() -> bool:
    """True when this process is a rank of a process group."""
    return dist.is_available() and dist.is_initialized()


def backend() -> Optional[str]:
    """The live process group's backend, or None without one."""
    return dist.get_backend() if distributed() else None


def process_index() -> int:
    """Global rank of this process (ref: firstLocalRank+gpu,
    classif.py:82)."""
    return dist.get_rank() if distributed() else 0


def process_count() -> int:
    return dist.get_world_size() if distributed() else 1


def world_size() -> int:
    """Data-parallel replicas: one per process."""
    return process_count()


def is_main() -> bool:
    """Gate for logging and checkpointing: global rank 0."""
    return process_index() == 0


def barrier() -> None:
    """Block until every rank reaches this point (no-op in a world of
    one)."""
    if distributed():
        dist.barrier()


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """``t`` summed over the ranks of ``group`` (the world by default), in
    place (``t`` itself in a world or group of one); no gradient."""
    if distributed() and dist.get_world_size(group) > 1:
        dist.all_reduce(t, group=group)
    return t


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The process world as the JAX package's (data, model) mesh
    (``make_mesh`` at :192-220, ``devs.reshape(dp, mp)``): rank r is data
    index r // model_parallel and model index r % model_parallel.  The
    ranks of one data index form its model group (the ring of ``--attention
    ring|ring_flash``), the ranks of one model index its data group (the
    sums of the loss and metrics, one per data shard).  With
    ``model_parallel`` 1 there are no groups: the data group is the
    world."""

    data_parallel: int = 1
    model_parallel: int = 1
    data_index: int = 0
    model_index: int = 0
    model_ranks: Tuple[int, ...] = (0,)   # global ranks, in model order
    model_group: Optional[object] = None
    data_group: Optional[object] = None   # None: the whole world


def make_mesh(model_parallel: int = 1) -> Mesh:
    """The (world / model_parallel, model_parallel) mesh of the process
    world.  Raises with the JAX message when ``model_parallel`` does not
    divide the world.  ``dist.new_group`` is collective: every rank
    creates every group, in one order."""
    n = world_size()
    if model_parallel < 1 or n % model_parallel:
        raise ValueError(
            f"model_parallel={model_parallel} * seq_parallel=1"
            f" must divide device count {n}")
    dp, mp = n // model_parallel, model_parallel
    d, m = divmod(process_index(), mp)
    model_group = data_group = None
    if mp > 1:
        for i in range(dp):
            group = dist.new_group(list(range(i * mp, (i + 1) * mp)))
            if i == d:
                model_group = group
        for j in range(mp):
            group = dist.new_group(list(range(j, n, mp)))
            if j == m:
                data_group = group
    return Mesh(dp, mp, d, m, tuple(range(d * mp, (d + 1) * mp)),
                model_group, data_group)


def staged_through_host(group, device: torch.device) -> bool:
    """True when ``group`` moves tensors on ``device`` through host
    memory: gloo with a CUDA device (two ranks on one card, where NCCL
    refuses to run).
    gloo's send, receive and all-gather read a CUDA tensor's device
    pointer as host memory and fail ("writev: Bad address", seen on the
    H100), so the ring copies its CUDA blocks to the host and back."""
    return device.type == "cuda" and dist.get_backend(group) == "gloo"


def _outgoing(group, tensors) -> list:
    """Contiguous copies to send (on the host where
    ``staged_through_host``), detached."""
    out = [t.detach().contiguous() for t in tensors]
    if staged_through_host(group, tensors[0].device):
        out = [t.cpu() for t in out]
    return out


def ring_shift(mesh: Mesh, tensors, step: int = 1) -> list:
    """Each tensor of this rank sent to model index (m + step) mod M and
    the one of model index (m - step) mod M received in its place, all in
    one ``batch_isend_irecv`` (with two ranks, each sends to and receives
    from one peer: separate blocking sends would deadlock).  No
    gradient."""
    n = mesh.model_parallel
    dst = mesh.model_ranks[(mesh.model_index + step) % n]
    src = mesh.model_ranks[(mesh.model_index - step) % n]
    sends = _outgoing(mesh.model_group, tensors)
    recvs = [torch.empty_like(t) for t in sends]
    ops = [dist.P2POp(dist.isend, t, dst, mesh.model_group) for t in sends]
    ops += [dist.P2POp(dist.irecv, t, src, mesh.model_group) for t in recvs]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return [r.to(t.device) for r, t in zip(recvs, tensors)]


def all_gather_seq(mesh: Mesh, x: torch.Tensor, dim: int = 1
                   ) -> torch.Tensor:
    """The model group's ``x`` concatenated along ``dim`` in model order
    (through host memory where ``staged_through_host``).  No
    gradient."""
    src, = _outgoing(mesh.model_group, [x])
    parts = [torch.empty_like(src) for _ in range(mesh.model_parallel)]
    dist.all_gather(parts, src, group=mesh.model_group)
    return torch.cat(parts, dim=dim).to(x.device)


_health = None      # (timeout seconds or None, the gloo group)


def health_group(timeout_s: Optional[float] = None):
    """The gloo group of ``agree_health``, created on the first call of a
    world (collective: every rank calls it at the same point, as the
    world's first boundary or its start) with ``timeout_s`` as its
    timeout (None or 0: ``GROUP_TIMEOUT``), and again when the timeout
    asked for changes."""
    global _health
    timeout_s = timeout_s or None
    if _health is None or _health[0] != timeout_s:
        timeout = (GROUP_TIMEOUT if timeout_s is None
                   else timedelta(seconds=timeout_s))
        _health = (timeout_s, dist.new_group(backend="gloo",
                                             timeout=timeout))
    return _health[1]


def agree_health(failed: bool, shutdown: bool,
                 timeout_s: Optional[float] = None,
                 grow: bool = False) -> tuple:
    """(any_failed, any_shutdown, any_grow) across every rank, from ONE
    all-gather of the three flags (JAX runtime.py:275-350): a rank that
    failed reports it here instead of raising out of the loop, so its
    peers learn of it through a collective they all reach; a rank that
    saw an admissible join claim votes to grow, and one vote suffices.

    The exchange runs on host memory over ``health_group(timeout_s)``:
    a peer that never reaches the boundary makes gloo time out after
    ``timeout_s`` (--health-timeout), raised here as
    ``faults.HealthTimeoutError``; a peer whose process is gone surfaces
    as gloo's connection error, raised as it is.  One process: no
    communication."""
    if process_count() == 1:
        return bool(failed), bool(shutdown), bool(grow)
    group = health_group(timeout_s)
    mine = torch.tensor([bool(failed), bool(shutdown), bool(grow)],
                        dtype=torch.uint8)
    flags = [torch.empty_like(mine) for _ in range(process_count())]
    try:
        dist.all_gather(flags, mine, group=group)
    except RuntimeError as e:
        if "timed out" in str(e).lower():
            raise faults.HealthTimeoutError(
                f"health agreement did not complete within {timeout_s}s"
                f" — a peer died or wedged before reaching the boundary "
                f"({e})") from e
        raise
    flags = torch.stack(flags)
    return (bool(flags[:, 0].any()), bool(flags[:, 1].any()),
            bool(flags[:, 2].any()))

