"""``--remat``: the forward recomputed in the backward.

Counterpart of the JAX package's rematerialisation: ``nn.remat`` at the
block boundaries of vit, densenet and inception (``models/vit.py:121-139``,
``densenet.py:44-64``, ``inception.py:172-190``, wired by
``registry.py:104-112``) and ``jax.checkpoint`` around the whole apply in
the engine (``train/engine.py:114-133``).  ``call(fn, *args, save_dots)``
runs ``fn`` under ``torch.utils.checkpoint`` (non-reentrant):

  * ``save_dots=True`` is JAX's ``dots_with_no_batch_dims_saveable``: a
    selective-checkpoint policy keeps the outputs of matmuls with no batch
    dimension (``aten.mm`` and ``aten.addmm``, which the dense layers
    reach) and recomputes everything else: batched products,
    convolutions, norms, elementwise passes and the attention kernels;
  * ``save_dots=False`` (``--remat full``) saves nothing.

The recompute reruns ``fn`` whole, the port's kernels included: K1/K4's
``autograd.Function`` forward launches again (and counts) and saves its O
and lse anew for K2/K3.  Nothing in a forward draws random numbers (the
dropout masks and the affine draws are made before it), so the RNG state
is not stashed (``preserve_rng_state=False``): reading it is illegal
inside a CUDA Graph capture, which ``--epochs-per-dispatch`` makes.
``recomputing()`` is true inside the recompute, where BatchNorm leaves
its running statistics alone: they move once a step, as flax discards
the mutations of ``nn.remat``'s recompute.  BatchNorm's all-reduce of
its sums runs again in the recompute, in the same order on every rank.
"""

from __future__ import annotations

import contextlib
import functools
import threading

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

# Models that checkpoint their own blocks under --remat blocks (JAX
# REMAT_BLOCK_MODELS); the engine checkpoints the others' whole forward.
REMAT_BLOCK_MODELS = frozenset({"vit", "densenet", "inception"})

_SAVED = frozenset({torch.ops.aten.mm.default, torch.ops.aten.addmm.default})
_local = threading.local()


def recomputing() -> bool:
    """True inside a recompute of ``call`` on this thread."""
    return getattr(_local, "depth", 0) > 0


@contextlib.contextmanager
def _recompute_flag():
    _local.depth = getattr(_local, "depth", 0) + 1
    try:
        yield
    finally:
        _local.depth -= 1


def _save_dots(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED
            else CheckpointPolicy.PREFER_RECOMPUTE)


@contextlib.contextmanager
def _recompute(inner):
    with inner, _recompute_flag():
        yield


def _contexts(save_dots: bool):
    """(forward context, recompute context) of one ``call``."""
    if save_dots:
        forward, inner = create_selective_checkpoint_contexts(_save_dots)
    else:
        forward, inner = contextlib.nullcontext(), contextlib.nullcontext()
    return forward, _recompute(inner)


def call(fn, *args, save_dots: bool):
    """``fn(*args)``, its activations recomputed in the backward (see the
    module docstring)."""
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False,
                      context_fn=functools.partial(_contexts, save_dots))


def active(module: torch.nn.Module) -> bool:
    """Whether a forward of ``module`` now is on the gradient path, where
    remat applies (train mode, autograd recording)."""
    return module.training and torch.is_grad_enabled()


def run_block(owner: torch.nn.Module, block, x: torch.Tensor
              ) -> torch.Tensor:
    """``block(x)`` of a model of REMAT_BLOCK_MODELS, checkpointed with
    the matmul outputs saved when the model was built with
    ``remat_blocks`` and the forward is on the gradient path."""
    if owner.remat_blocks and active(owner):
        return call(block, x, save_dots=True)
    return block(x)
