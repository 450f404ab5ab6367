"""Device resolution and process identity for the port.

Counterpart of ``distributedpytorch_tpu/runtime.py``, cut to what a
single-process serving replica needs.  The device is ``cuda`` unless the
caller asks for the CPU, and a missing GPU is an error, never a quiet run
on the CPU.  This slice is single-process: ``process_index()`` is 0 and a
multi-process launch (``WORLD_SIZE`` > 1, as torchrun sets it) raises.
"""

from __future__ import annotations

import os

import torch


def resolve_device(device: str = "cuda") -> torch.device:
    """``"cuda"`` or ``"cpu"`` -> torch.device.  Raises ValueError when
    CUDA is asked for and no CUDA device is available."""
    if device == "cpu":
        return torch.device("cpu")
    if device == "cuda":
        if not torch.cuda.is_available():
            raise ValueError(
                "--device cuda: no CUDA device is available "
                "(torch.cuda.is_available() is false); pass --device cpu "
                "to run on the CPU")
        return torch.device("cuda")
    raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")


def check_single_process() -> None:
    """Raise ValueError under a multi-process launch: this slice ports
    the one-replica serving path only."""
    world = os.environ.get("WORLD_SIZE", "1")
    if world.strip() not in ("", "1"):
        raise ValueError(f"not ported yet: multi-process launch "
                         f"(WORLD_SIZE={world})")


def process_index() -> int:
    check_single_process()
    return 0

