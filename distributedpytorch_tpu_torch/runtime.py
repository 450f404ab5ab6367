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
"""

from __future__ import annotations

import dataclasses
import os
from datetime import timedelta
from typing import Optional, Tuple

import torch
import torch.distributed as dist


def resolve_device(device: str = "cuda") -> torch.device:
    """``"cuda"`` or ``"cpu"`` -> torch.device.  Raises ValueError when
    CUDA is asked for and no CUDA device is available.  In a world of
    several ranks on ``cuda``, the rank's own card."""
    if device == "cpu":
        return torch.device("cpu")
    if device == "cuda":
        if not torch.cuda.is_available():
            raise ValueError(
                "--device cuda: no CUDA device is available "
                "(torch.cuda.is_available() is false); pass --device cpu "
                "to run on the CPU")
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
    Idempotent."""
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
    dist.init_process_group(backend, init_method="env://", world_size=world,
                            rank=rank, timeout=timedelta(minutes=10),
                            **kwargs)
    return backend


def shutdown_distributed() -> None:
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def distributed() -> bool:
    """True when this process is a rank of a process group."""
    return dist.is_available() and dist.is_initialized()


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


def any_process(flag: bool) -> bool:
    """True when ``flag`` is true on any rank (one all-reduce)."""
    if not (distributed() and dist.get_world_size() > 1):
        return bool(flag)
    device = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend() == "nccl" else torch.device("cpu"))
    t = torch.tensor([int(bool(flag))], device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def check_single_process(what: str) -> None:
    """Raise ValueError under a multi-process launch: ``what`` runs one
    process (the serving replica)."""
    if launched_distributed() and _env_int("WORLD_SIZE") != 1:
        raise ValueError(f"not ported yet: multi-process launch of {what} "
                         f"(WORLD_SIZE={os.environ['WORLD_SIZE']})")
