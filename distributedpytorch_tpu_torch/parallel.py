"""Placement of parameters and optimizer state over the model group, and
the collectives of tensor and expert parallelism.

Counterpart of ``distributedpytorch_tpu/parallel.py``.  The JAX package
has two strategies on its mesh's 'model' axis, and the port keeps both:

1. **ZeRO-3 placement** (``--model-parallel M``): a parameter of at
   least MIN_SHARD_ELEMENTS elements is split on its largest axis that M
   divides (the first such axis on ties), ``leaf_spec``'s rule; a smaller
   one, or one with no divisible axis, stays whole on every rank.  The
   optimizer's moments follow, since the optimizer is built over the
   rank's slices.  The M ranks of a model group hold the same rows and
   compute the same math: before the model's forward each sharded
   parameter is gathered over the model group (``place`` hangs that on
   the model's forward pre-hook), and the gather's backward keeps the
   rank's own slice of the full gradient, which is the same on every
   rank of the group (no sum over it).  The rule is applied to the torch
   layout's shape: ``Linear``'s (out, in) and an OIHW conv hold the same
   set of dimensions as flax's (in, out) and HWIO, so the same tensors
   are sharded, each to the same count a rank as in JAX; only the axis
   of a tie can differ.

2. **Model-local slices** (``Shard(gathered=False)``), which a model
   declares through ``local_shards()``: the pipelined vit's stacked
   blocks (``leaf_spec(prefer_axis0=True)``, as JAX's ``_place_state``
   asks under ``--pipeline-parallel``, ``cli.py:60-69``: stage s holds
   blocks [s*depth/M, (s+1)*depth/M) of each large stacked tensor,
   ``models/vit_pipeline.py``), the vit's Megatron tensor
   parallelism (``--tensor-parallel``: qkv and mlp_up split by output
   rows, proj and mlp_down by input columns, qkv's rows taken per head
   from each of q, k and v) and the MoE vit's expert parallelism (the
   experts' ``w_up``/``w_down`` split on the expert axis).  The model
   computes on these slices and never gathers them; ``copy_to_model``,
   ``reduce_from_model``, ``split_to_model`` and ``gather_from_model``
   are its collectives.

``full_state`` gathers the full tensors of a placed model and its
optimizer (a collective: every rank calls it), which a checkpoint file
holds; ``Placement.local_state_dict`` and ``local_optimizer_state`` take a
rank's slices of full tensors (no communication), so that one file
loads at any M.  A checkpoint directory (``--ckpt-format orbax``) is
written and read with no gather: ``Placement.chunk`` says where a rank's
slice lies in the full tensor, ``pieces`` and ``full_shape`` where the
parts of a slice it restores lie.  Gathers run through host memory where
``runtime.staged_through_host`` (gloo on a CUDA device).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from . import runtime

# Tensors smaller than this stay whole on every rank (JAX parallel.py):
# sharding a 64-element bias saves nothing and costs a gather.
MIN_SHARD_ELEMENTS = 2 ** 14


def leaf_spec(shape, model_parallel: int,
              prefer_axis0: bool = False) -> Optional[int]:
    """The axis of ``shape`` that JAX's ``leaf_spec`` puts on 'model'
    (the largest one that ``model_parallel`` divides, the first on ties;
    with ``prefer_axis0``, axis 0 whenever it divides: the pipeline's
    stacked (depth, ...) blocks, JAX ``parallel.py:55-80``), or None:
    replicated (no model axis, a tensor below MIN_SHARD_ELEMENTS, or no
    divisible axis)."""
    if model_parallel <= 1 or math.prod(shape) < MIN_SHARD_ELEMENTS:
        return None
    divisible = [i for i in range(len(shape))
                 if shape[i] % model_parallel == 0]
    if not divisible:
        return None
    if prefer_axis0 and 0 in divisible:
        return 0
    return max(divisible, key=lambda i: shape[i])


@dataclasses.dataclass(frozen=True)
class Shard:
    """How a parameter lies on the model group: split M ways along
    ``dim``; ``groups`` > 1 splits each of that many equal blocks of the
    dim (qkv's q, k and v) M ways, a rank holding its part of each.
    ``gathered``: ZeRO placement, gathered for the forward; else the
    model computes on the slice."""

    dim: int
    gathered: bool = True
    groups: int = 1


# -- collectives with their gradients -------------------------------------

def _all_reduce_f32(mesh: runtime.Mesh, x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the model group in f32, cast back."""
    y = x.detach().to(torch.float32, copy=True).contiguous()
    dist.all_reduce(y, group=mesh.model_group)
    return y.to(x.dtype)


def _own(mesh: runtime.Mesh, x: torch.Tensor, dim: int) -> torch.Tensor:
    n = x.shape[dim] // mesh.model_parallel
    return x.narrow(dim, mesh.model_index * n, n).clone()


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, x, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return runtime.all_gather_seq(mesh, x, dim)

    @staticmethod
    def backward(ctx, g):
        return None, _own(ctx.mesh, g, ctx.dim), None


class _SplitToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, x, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return _own(mesh, x, dim)

    @staticmethod
    def backward(ctx, g):
        return None, runtime.all_gather_seq(ctx.mesh, g, ctx.dim), None


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, x):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return None, _all_reduce_f32(ctx.mesh, g)


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, x):
        return _all_reduce_f32(mesh, x)

    @staticmethod
    def backward(ctx, g):
        return None, g


def gather_from_model(mesh: runtime.Mesh, x: torch.Tensor, dim: int
                      ) -> torch.Tensor:
    """The model group's slices concatenated along ``dim``; the backward
    keeps this rank's slice of the gradient, which every rank of the
    group holds alike (not a reduce-scatter)."""
    return _GatherFromModel.apply(mesh, x, dim)


def split_to_model(mesh: runtime.Mesh, x: torch.Tensor, dim: int
                   ) -> torch.Tensor:
    """This rank's slice along ``dim`` of ``x``, which every rank of the
    group holds alike; the backward all-gathers the slices' gradients."""
    return _SplitToModel.apply(mesh, x, dim)


def copy_to_model(mesh: runtime.Mesh, x: torch.Tensor) -> torch.Tensor:
    """The input of a column-parallel region: identity forward, the
    gradient summed over the model group."""
    return _CopyToModel.apply(mesh, x)


def reduce_from_model(mesh: runtime.Mesh, x: torch.Tensor) -> torch.Tensor:
    """The output of a row-parallel region: the ranks' partial products
    summed over the model group (in f32), identity backward."""
    return _ReduceFromModel.apply(mesh, x)


# -- the placement ---------------------------------------------------------

def _owner(model: nn.Module, name: str) -> Tuple[nn.Module, str]:
    path, _, attr = name.rpartition(".")
    return (model.get_submodule(path) if path else model), attr


class Placement:
    """The shards of one placed model over ``mesh``'s model group
    (``place`` makes it)."""

    def __init__(self, mesh: runtime.Mesh, shards: Dict[str, Shard]):
        self.mesh = mesh
        self.shards = shards
        self._gathered: Dict[str, Tuple[nn.Module, str]] = {}
        self._live: list = []

    def take(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's slice of parameter ``name``'s full tensor (or of a
        moment of its shape); ``full`` itself when it is not sharded."""
        shard = self.shards.get(name)
        if shard is None:
            return full
        m, n = self.mesh.model_index, self.mesh.model_parallel
        blocks = full.unflatten(shard.dim, (shard.groups, n, -1))
        return blocks.select(shard.dim + 1, m).flatten(
            shard.dim, shard.dim + 1).clone()

    def join(self, name: str, local: torch.Tensor) -> torch.Tensor:
        """The full tensor of ``name`` from the group's slices: a
        collective of the model group; ``local`` when not sharded."""
        shard = self.shards.get(name)
        if shard is None:
            return local
        d = shard.dim
        parts = runtime.all_gather_seq(
            self.mesh, local.unflatten(d, (shard.groups, -1)).unsqueeze(
                d + 1), d + 1)
        return parts.flatten(d, d + 2)

    def chunk(self, name: str, local: torch.Tensor
              ) -> Tuple[torch.Tensor, tuple, tuple]:
        """This rank's slice of ``name`` (or of a moment of its shape) as
        a chunk of the full tensor: (the chunk, its offsets, the full
        shape), no communication.  A ``groups`` > 1 slice is a chunk of
        the full tensor's ``(groups, -1)`` view, on ``dim`` + 1; a tensor
        that is not sharded is the chunk at offset 0 of itself."""
        shard = self.shards.get(name) if local.dim() else None
        if shard is None:
            return local, (0,) * local.dim(), tuple(local.shape)
        d = shard.dim
        if shard.groups > 1:
            local = local.unflatten(d, (shard.groups, -1))
            d += 1
        offsets = [0] * local.dim()
        offsets[d] = self.mesh.model_index * local.shape[d]
        shape = list(local.shape)
        shape[d] *= self.mesh.model_parallel
        return local, tuple(offsets), tuple(shape)

    def pieces(self, name: str, local: torch.Tensor) -> list:
        """[(a view of ``local``, its offsets in the full tensor)]: the
        one slice, or one a group of a ``groups`` > 1 shard (qkv's part
        of q, of k and of v)."""
        shard = self.shards.get(name) if local.dim() else None
        if shard is None:
            return [(local, [0] * local.dim())]
        d, n = shard.dim, local.shape[shard.dim] // shard.groups
        out = []
        for j in range(shard.groups):
            offsets = [0] * local.dim()
            offsets[d] = (j * self.mesh.model_parallel
                          + self.mesh.model_index) * n
            out.append((local.narrow(d, j * n, n), offsets))
        return out

    def full_shape(self, name: str, shape) -> tuple:
        """The full shape of ``name`` (or of a moment of it) whose slice
        has ``shape``."""
        shard = self.shards.get(name) if len(shape) else None
        shape = list(shape)
        if shard is not None:
            shape[shard.dim] *= self.mesh.model_parallel
        return tuple(shape)

    def local_state_dict(self, full: dict) -> dict:
        """A full state dict's entries sliced for this rank (no
        communication)."""
        return {k: self.take(k, v) for k, v in full.items()}

    def local_optimizer_state(self, names: Dict[int, str], full: dict
                              ) -> dict:
        """A full ``optimizer.state_dict()`` with every moment of a
        sharded parameter sliced for this rank; ``names`` maps the state
        dict's parameter indices to parameter names."""
        state = {}
        for idx, st in full["state"].items():
            name = names[idx]
            state[idx] = {k: (self.take(name, v) if isinstance(
                v, torch.Tensor) and v.dim() else v) for k, v in st.items()}
        return {"state": state, "param_groups": full["param_groups"]}

    # the forward's gathers (ZeRO placement)

    def gather(self, _module=None, _args=None) -> None:
        """Every gathered shard's full tensor set on its module for the
        forward, in the module's ``__dict__``, which attribute lookup
        reads before ``_parameters``; they stay until ``release`` (a
        recomputing backward reads them again)."""
        self.release()
        for name, (owner, attr) in self._gathered.items():
            full = gather_from_model(self.mesh, owner._parameters[attr],
                                     self.shards[name].dim)
            owner.__dict__[attr] = full
            self._live.append((owner, attr))

    def release(self) -> None:
        """Drop the gathered tensors: the modules read their slices
        again."""
        for owner, attr in self._live:
            owner.__dict__.pop(attr, None)
        self._live = []

    def _after_forward(self, _module, _args, _out) -> None:
        if not torch.is_grad_enabled():
            self.release()      # no backward will recompute this forward


def place(model: nn.Module, mesh: runtime.Mesh) -> None:
    """Split ``model``'s parameters over ``mesh``'s model group in place
    (each sharded ``Parameter`` replaced by one holding this rank's
    slice, ``requires_grad`` kept; ``placement_of`` gives the
    ``Placement``), and hang the gathers of the ZeRO shards on its
    forward; nothing without a model axis.  Call it before the optimizer
    is built over the parameters."""
    if mesh.model_parallel < 2:
        return
    local = model.local_shards() if hasattr(model, "local_shards") else {}
    shards = {}
    for name, p in model.named_parameters():
        if name in local:
            shards[name] = local[name]
            continue
        dim = leaf_spec(tuple(p.shape), mesh.model_parallel)
        if dim is not None:
            shards[name] = Shard(dim)
    placement = Placement(mesh, shards)
    with torch.no_grad():
        for name, shard in shards.items():
            owner, attr = _owner(model, name)
            old = owner._parameters[attr]
            owner._parameters[attr] = nn.Parameter(
                placement.take(name, old.detach()),
                requires_grad=old.requires_grad)
            if shard.gathered:
                placement._gathered[name] = (owner, attr)
    if placement._gathered:
        model.register_forward_pre_hook(placement.gather)
        model.register_forward_hook(placement._after_forward)
    model._placement = placement


def placement_of(model: nn.Module) -> Optional[Placement]:
    """The ``Placement`` of a placed model, else None."""
    return getattr(model, "_placement", None)


def release(model: nn.Module) -> None:
    """Drop a placed model's gathered parameters (after the backward)."""
    placement = placement_of(model)
    if placement is not None:
        placement.release()


def optimizer_names(model: nn.Module, optimizer: torch.optim.Optimizer
                    ) -> Dict[int, str]:
    """``optimizer.state_dict()``'s parameter indices -> parameter
    names."""
    by_id = {id(p): n for n, p in model.named_parameters()}
    params = [p for g in optimizer.param_groups for p in g["params"]]
    return {i: by_id[id(p)] for i, p in enumerate(params)}


def full_state(model: nn.Module,
               optimizer: Optional[torch.optim.Optimizer] = None
               ) -> Tuple[dict, Optional[dict]]:
    """(``model.state_dict()``, ``optimizer.state_dict()`` or None) with
    every sharded tensor gathered whole, all on the CPU: what a
    replicated run's state dicts hold.  A collective of the model group
    for a placed model (every rank calls it, in one order)."""
    placement = placement_of(model)

    def full(name, t):
        t = t.detach()
        if placement is not None and t.dim():   # Adam's step count: 0-d
            t = placement.join(name, t)
        return t.to("cpu", copy=True)

    params = {k: full(k, v) for k, v in model.state_dict().items()}
    if optimizer is None:
        return params, None
    osd = optimizer.state_dict()
    names = optimizer_names(model, optimizer)
    state = {idx: {k: (full(names[idx], v) if isinstance(v, torch.Tensor)
                       else v) for k, v in st.items()}
             for idx, st in osd["state"].items()}
    return params, {"state": state, "param_groups": osd["param_groups"]}

