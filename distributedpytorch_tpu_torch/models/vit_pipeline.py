"""The pipeline-parallel vit: GPipe stages over the model group.

Counterpart of ``distributedpytorch_tpu/models/vit_pipeline.py``
(``--pipeline-parallel``, ``--pipeline-microbatches``, and with
``--attention ring --seq-parallel S`` the ring inside each stage):

  * ``PipelinedViT`` holds the transformer blocks' parameters STACKED on
    a leading (depth,) axis under the JAX module's twelve names and
    shapes (``ln1_scale`` ... ``down_bias``; the kernels in flax's (in,
    out) orientation, ``qkv_kernel`` (depth, d, 3d)), so a JAX file's
    stacked leaves are the port's tensors as they are.  Patch embedding,
    position embedding, the final LayerNorm (``norm``) and ``head`` are
    the plain vit's (``models/vit.py``), under its names.
  * ``_layernorm`` and ``_block_apply`` keep the JAX block's numerics
    (:58-98): LayerNorm in f32 with the two-pass variance, cast back;
    every kernel cast to the compute type at its matmul, the bias added
    after; scores, softmax and PV in f32; flax's ``nn.gelu``, the tanh
    approximation.  ``sequential_blocks`` applies the blocks in order:
    the schedule's reference, and the model's forward without a mesh.
  * ``make_pipeline_fn`` is the GPipe schedule over the mesh's model
    group (stage s = model index s holds blocks [s*depth/P,
    (s+1)*depth/P)): P + M - 1 ticks, stage s applying its blocks to
    microbatch t - s at tick t (microbatch j is rows [j*b/M, (j+1)*b/M)
    of the data shard's b rows) and handing the result to stage s + 1
    at the tick's end (``runtime.stage_handoff``, one neighbour-only
    exchange a tick, no wrap).  The port computes the active ticks only:
    JAX's idle ticks compute masked values that nothing reads.  The last
    stage's outputs are summed over the model group with the others'
    zeros (JAX's ``psum(result * mask)``), so every stage holds them and
    runs the final LayerNorm, pool and head replicated.
  * The backward is written by hand (``_GPipe``), over each active tick's
    saved stage input and output: the ticks in reverse, stage s taking
    the output's cotangent of microbatch j from stage s + 1 (the last
    stage: its own share of the output's, given once) and sending its
    input's cotangent to stage s - 1, in the same lockstep exchange, so
    blocking sends and receives meet in one order on neighbouring ranks.
    Then, as shard_map transposes its replicated inputs (JAX :244-254):
    the tokens' cotangent (stage 0's; the others hold zeros) summed over
    the model group, and a stacked tensor that every rank holds whole
    (the small LayerNorm scales and biases, ``MIN_SHARD_ELEMENTS``; or
    every one before ``parallel.place``) gets the model group's sum of
    the stages' slices; a placed stacked tensor (``local_shards``: a
    stage's own blocks) keeps its own.  Every rank of a model group then
    holds equal gradients of the replicated parameters.
  * ``ring=True`` (the 3-D mesh, ``--seq-parallel S``): the tokens are
    padded to a multiple of S (49 -> 50 at S = 2) and sharded over the
    seq group for the whole schedule; each stage's attention is the
    einsum ring body (``ops.attention._ring_attention_local``, no kernel)
    over the seq group (``Mesh.over_seq``) with the pad masked
    (``kv_valid``), and the output is gathered over the seq group and
    the pad sliced off.  The stacked tensors' gradients are then summed
    over the seq group too (each seq rank saw its tokens), and the
    tokens' cotangent is gathered.

No kernel of the port runs here, as in JAX, whose registry refuses
``--attention flash|ring_flash`` under ``--pipeline-parallel``.

``params_layout`` and ``convert_layout`` (JAX :287-354) name and convert
the two layouts of a vit ``state_dict``: ``stacked`` (this module) and
``blocks`` (``models/vit.py``: ``blocks.{i}.qkv.weight`` (out, in), ...),
for the parameters and for the optimizer moments that mirror them.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from .. import parallel, runtime
from ..ops.attention import _ring_attention_local
from .layers import dense, lecun_init_
from .vit import LayerNorm

_LN_EPS = 1e-6

# stacked name -> (plain-vit submodule, leaf, transposed): a flax
# (in, out) kernel is a torch Linear's (out, in) weight transposed
_STACK_TO_BLOCK = {
    "ln1_scale": ("ln1", "weight", False),
    "ln1_bias": ("ln1", "bias", False),
    "qkv_kernel": ("qkv", "weight", True),
    "qkv_bias": ("qkv", "bias", False),
    "proj_kernel": ("proj", "weight", True),
    "proj_bias": ("proj", "bias", False),
    "ln2_scale": ("ln2", "weight", False),
    "ln2_bias": ("ln2", "bias", False),
    "up_kernel": ("mlp_up", "weight", True),
    "up_bias": ("mlp_up", "bias", False),
    "down_kernel": ("mlp_down", "weight", True),
    "down_bias": ("mlp_down", "bias", False),
}
STACKED = tuple(_STACK_TO_BLOCK)


def _layernorm(x: torch.Tensor, scale: torch.Tensor,
               bias: torch.Tensor) -> torch.Tensor:
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, unbiased=False, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + _LN_EPS)
    return (y * scale + bias).to(x.dtype)


def _matmul(h: torch.Tensor, kernel: torch.Tensor,
            bias: torch.Tensor) -> torch.Tensor:
    dtype = h.dtype
    return h @ kernel.to(dtype) + bias.to(dtype)


def _block_apply(p: Dict[str, torch.Tensor], x: torch.Tensor, heads: int,
                 attn_fn=None) -> torch.Tensor:
    """One pre-LN block; ``p`` holds THIS block's (unstacked) tensors.
    ``attn_fn`` ((B, S, H, D) q, k, v -> (B, S, H, D)) replaces the inline
    softmax attention (the ring inside a stage)."""
    b, s, dim = x.shape
    head_dim = dim // heads
    dtype = x.dtype
    h = _layernorm(x, p["ln1_scale"], p["ln1_bias"])
    qkv = _matmul(h, p["qkv_kernel"], p["qkv_bias"])
    q, k, v = (t.reshape(b, s, heads, head_dim)
               for t in qkv.split(dim, dim=-1))
    if attn_fn is not None:
        attn = attn_fn(q, k, v).to(dtype).reshape(b, s, dim)
    else:
        scale = 1.0 / math.sqrt(head_dim)
        scores = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                              k.float()) * scale
        probs = torch.softmax(scores, dim=-1)
        attn = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
        attn = attn.to(dtype).reshape(b, s, dim)
    x = x + _matmul(attn, p["proj_kernel"], p["proj_bias"])
    h = _layernorm(x, p["ln2_scale"], p["ln2_bias"])
    h = _matmul(h, p["up_kernel"], p["up_bias"])
    h = F.gelu(h, approximate="tanh")
    h = _matmul(h, p["down_kernel"], p["down_bias"])
    return x + h


def _blocks(stacked, x: torch.Tensor, heads: int, n: int,
            attn_fn=None) -> torch.Tensor:
    """``stacked``'s first ``n`` blocks applied in order (a list of
    STACKED's tensors, or a mapping by name)."""
    if not isinstance(stacked, dict):
        stacked = dict(zip(STACKED, stacked))
    for i in range(n):
        x = _block_apply({k: v[i] for k, v in stacked.items()}, x, heads,
                         attn_fn)
    return x


def sequential_blocks(stacked: Dict[str, torch.Tensor], x: torch.Tensor,
                      heads: int, depth: int) -> torch.Tensor:
    """The unpipelined reference schedule: blocks applied in order."""
    return _blocks(stacked, x, heads, depth)


class _Schedule:
    """The GPipe schedule of one model over one mesh (see the module
    docstring): ``forward`` runs it, ``backward`` its hand-written
    transpose."""

    def __init__(self, mesh: runtime.Mesh, n_stages: int, depth: int,
                 heads: int, n_micro: int, seq_n: int):
        self.mesh = mesh
        self.stages = n_stages
        self.depth = depth
        self.per_stage = depth // n_stages
        self.heads = heads
        self.n_micro = n_micro
        self.seq_n = seq_n
        self.ring_mesh = mesh.over_seq() if seq_n > 1 else None
        self.ticks = n_stages + n_micro - 1

    def _stage_params(self, leaves, grad: bool) -> list:
        """This stage's blocks of each stacked tensor (a slice of a whole
        one), detached; leaves of the local graphs under ``grad``."""
        lo = self.mesh.model_index * self.per_stage
        out = []
        for leaf in leaves:
            part = leaf if leaf.shape[0] == self.per_stage else \
                leaf.narrow(0, lo, self.per_stage)
            out.append(part.detach().requires_grad_(grad))
        return out

    def _stage(self, params: list, x: torch.Tensor,
               kv_valid: Optional[int]) -> torch.Tensor:
        attn_fn = None
        if self.ring_mesh is not None:
            attn_fn = functools.partial(
                _ring_attention_local, mesh=self.ring_mesh,
                s_local=x.shape[1], causal=False, kv_valid=kv_valid)
        return _blocks(params, x, self.heads, self.per_stage, attn_fn)

    def _seq_part(self, t: torch.Tensor) -> torch.Tensor:
        if self.seq_n == 1:
            return t
        n = t.shape[1] // self.seq_n
        return t.narrow(1, self.mesh.seq_index * n, n)

    def forward(self, tokens: torch.Tensor, leaves, kv_valid: Optional[int],
                grad: bool) -> tuple:
        """(the output (B, S, dim) on every stage, the saved state of the
        backward: this stage's tensors, each active tick's (input, output)
        under ``grad``, the shapes and dtypes of the inputs)."""
        mesh, s, last = self.mesh, self.mesh.model_index, self.stages - 1
        x = self._seq_part(tokens).detach()
        mb = x.shape[0] // self.n_micro
        shape = (mb,) + tuple(x.shape[1:])
        micro = x.reshape((self.n_micro,) + shape)
        params = self._stage_params(leaves, grad)
        saved, outs, held = [], [None] * self.n_micro, None
        for t in range(self.ticks):
            j, y = t - s, None
            if 0 <= j < self.n_micro:
                x_in = micro[j] if s == 0 else held
                if grad:
                    x_in = x_in.detach().requires_grad_()
                with torch.set_grad_enabled(grad):
                    y = self._stage(params, x_in, kv_valid)
                if grad:
                    saved.append((x_in, y))
                if s == last:
                    outs[j] = y.detach()
            takes = s > 0 and 0 <= t + 1 - s < self.n_micro
            held = runtime.stage_handoff(
                mesh, y.detach() if y is not None and s < last else None,
                (shape, x.dtype, x.device) if takes else None)
        out = torch.cat(outs) if s == last else torch.zeros_like(x)
        # JAX's psum(result * mask): the last stage's result on every stage
        total = out.float()
        runtime.all_reduce_sum(total, mesh.model_group)
        out = total.to(x.dtype)
        if self.seq_n > 1:
            out = runtime.all_gather_seq(self.ring_mesh, out, dim=1)
        metas = [(tokens.shape, None)] + [(t.shape, t.dtype) for t in leaves]
        return out, (params, saved, shape, x.dtype, x.device, metas)

    def backward(self, state: tuple, g: torch.Tensor) -> list:
        """The cotangents of (tokens, *leaves) from the output's ``g``,
        the same on every rank of the model group."""
        params, saved, shape, dtype, device, metas = state
        (tokens_shape, _), leaves = metas[0], metas[1:]
        mesh, s, last = self.mesh, self.mesh.model_index, self.stages - 1
        if s == last:
            g_micro = self._seq_part(g).reshape((self.n_micro,) + shape)
        grads: List[Optional[torch.Tensor]] = [None] * len(params)
        g_in, held = [None] * self.n_micro, None
        for t in reversed(range(self.ticks)):
            j, gx = t - s, None
            if 0 <= j < self.n_micro:
                x_in, y = saved.pop()
                gy = g_micro[j] if s == last else held
                got = torch.autograd.grad(y, [x_in, *params], gy.to(y.dtype))
                gx = got[0]
                for i, gp in enumerate(got[1:]):
                    grads[i] = gp if grads[i] is None else grads[i] + gp
                if s == 0:
                    g_in[j] = gx
            takes = s < last and 0 <= t - 1 - s < self.n_micro
            held = runtime.stage_handoff(
                mesh, gx if gx is not None and s > 0 else None,
                (shape, dtype, device) if takes else None, forward=False)
        g_x = (torch.cat(g_in) if s == 0
               else torch.zeros((shape[0] * self.n_micro,) + shape[1:],
                                dtype=dtype, device=device))
        # the model group's sum: the tokens' cotangent (stage 0's) and
        # each whole tensor's (each stage's slice in place)
        lo = s * self.per_stage
        whole = [i for i, (leaf_shape, _) in enumerate(leaves)
                 if leaf_shape[0] != self.per_stage]
        parts = [g_x.float()]
        for i in whole:
            full = torch.zeros(leaves[i][0], dtype=torch.float32,
                               device=device)
            full.narrow(0, lo, self.per_stage).copy_(grads[i])
            parts.append(full)
        parts = _all_reduce_flat(parts, mesh.model_group)
        g_x = parts[0].to(dtype)
        for i, full in zip(whole, parts[1:]):
            grads[i] = full
        if self.seq_n > 1:
            # every seq rank's share of the stacked tensors' gradients
            grads = _all_reduce_flat([t.float() for t in grads],
                                     mesh.seq_group)
            g_x = runtime.all_gather_seq(self.ring_mesh, g_x, dim=1)
        return [g_x.reshape(tokens_shape)] + [
            gp.to(leaf_dtype) for gp, (_, leaf_dtype) in zip(grads, leaves)]


def _all_reduce_flat(tensors: list, group) -> list:
    """f32 ``tensors`` summed over ``group`` in one all-reduce."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    runtime.all_reduce_sum(flat, group)
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].view_as(t))
        at += t.numel()
    return out


class _GPipe(torch.autograd.Function):
    """The schedule as one node of the autograd graph: its backward is
    ``_Schedule.backward`` over the ticks ``forward`` saved."""

    @staticmethod
    def forward(ctx, schedule, kv_valid, tokens, *leaves):
        out, ctx.state = schedule.forward(tokens, leaves, kv_valid, True)
        ctx.schedule = schedule
        return out

    @staticmethod
    def backward(ctx, g):
        grads = ctx.schedule.backward(ctx.state, g)
        ctx.state = None
        return (None, None, *[gr if need else None for gr, need in
                              zip(grads, ctx.needs_input_grad[2:])])


def make_pipeline_fn(mesh: runtime.Mesh, n_stages: int, depth: int,
                     heads: int, n_micro: Optional[int] = None,
                     ring: bool = False):
    """(stacked tensors by name, tokens (B, S, dim)) -> (B, S, dim),
    pipelined over ``mesh``'s model group, with JAX's errors (:190-226).
    The returned function's ``schedule.ticks`` is the number of ticks its
    forward and backward each run, P + M - 1."""
    if depth % n_stages:
        raise ValueError(f"depth {depth} not divisible by "
                         f"--pipeline-parallel {n_stages}")
    n_micro = n_micro or n_stages
    seq_n = 1
    if ring:
        if mesh.seq_parallel < 2:
            raise ValueError(
                "--attention ring with --pipeline-parallel runs on a "
                "3-D mesh: pass --seq-parallel >= 2")
        seq_n = mesh.seq_parallel
    schedule = _Schedule(mesh, n_stages, depth, heads, n_micro, seq_n)

    def fn(stacked: Dict[str, torch.Tensor], tokens: torch.Tensor
           ) -> torch.Tensor:
        b, s, _ = tokens.shape
        if b % n_micro:
            raise ValueError(
                f"per-device batch {b} not divisible by "
                f"pipeline microbatches {n_micro}")
        pad = (-s) % seq_n
        if pad:
            tokens = F.pad(tokens, (0, 0, 0, pad))
        kv_valid = s if pad else None
        leaves = [stacked[k] for k in STACKED]
        if torch.is_grad_enabled() and (
                tokens.requires_grad or any(t.requires_grad for t in leaves)):
            out = _GPipe.apply(schedule, kv_valid, tokens, *leaves)
        else:
            out, _ = schedule.forward(tokens, leaves, kv_valid, False)
        return out[:, :s] if pad else out

    fn.schedule = schedule
    return fn


# -- the two layouts of a vit state_dict -----------------------------------

def params_layout(sd) -> Optional[str]:
    """'stacked' (PipelinedViT) | 'blocks' (ViT) | None for a vit
    ``state_dict``-like mapping by name."""
    if not isinstance(sd, dict):
        return None
    if all(k in sd for k in STACKED):
        return "stacked"
    if "blocks.0.qkv.weight" in sd:
        return "blocks"
    return None


def _leaf(t, i: Optional[int], transpose: bool):
    """``t[i]`` (a 0-d tensor, Adam's step, as it is), transposed."""
    if not isinstance(t, torch.Tensor) or t.dim() == 0:
        return t
    t = t[i] if i is not None else t
    return t.T.contiguous() if transpose else t


def convert_layout(sd: dict, target: str,
                   depth: Optional[int] = None) -> dict:
    """A vit ``state_dict``-like mapping (parameters, or an optimizer
    moment by parameter name) in the ``target`` layout ('stacked' |
    'blocks'); one already in it, or of no vit layout, as it is.
    ``depth``: the blocks of a stacked mapping that holds no stacked
    tensor to read it from (Adam's 0-d step counts alone)."""
    if target not in ("stacked", "blocks"):
        raise ValueError(f"unknown layout {target!r}")
    layout = params_layout(sd)
    if layout is None or layout == target:
        return sd
    if layout == "stacked":
        if depth is None:
            depth = int(sd["qkv_kernel"].shape[0])
        out = {k: v for k, v in sd.items() if k not in _STACK_TO_BLOCK}
        for i in range(depth):
            for name, (sub, leaf, tr) in _STACK_TO_BLOCK.items():
                out[f"blocks.{i}.{sub}.{leaf}"] = _leaf(sd[name], i, tr)
        return out
    depth = 1 + max(int(k.split(".")[1]) for k in sd
                    if k.startswith("blocks."))
    out = {k: v for k, v in sd.items() if not k.startswith("blocks.")}
    for name, (sub, leaf, tr) in _STACK_TO_BLOCK.items():
        parts = [_leaf(sd[f"blocks.{i}.{sub}.{leaf}"], None, tr)
                 for i in range(depth)]
        out[name] = (parts[0] if parts[0].dim() == 0
                     else torch.stack(parts))
    return out


class PipelinedViT(nn.Module):
    """The vit with stacked blocks (see the module docstring).  ``mesh``
    (a ``runtime.Mesh`` with a model axis of 2 ranks or more) runs the
    blocks as GPipe stages over its model group, ``n_micro`` (0: one a
    stage) microbatches, with the ring over its seq group under
    ``ring``; None runs them in order."""

    def __init__(self, num_classes: int = 10, patch: int = 4,
                 dim: int = 128, depth: int = 4, heads: int = 4,
                 mlp_ratio: int = 4, dtype: torch.dtype = torch.bfloat16,
                 mesh: Optional[runtime.Mesh] = None, n_micro: int = 0,
                 ring: bool = False, input_size: int = 28, device=None):
        super().__init__()
        if dim % heads:
            raise ValueError(f"dim {dim} is not divisible by heads {heads}")
        self.patch, self.depth, self.heads = patch, depth, heads
        self.dtype = dtype
        self.mesh = mesh
        self.pipeline_fn = (None if mesh is None else make_pipeline_fn(
            mesh, mesh.model_parallel, depth, heads, n_micro or None, ring))
        self.patch_embed = nn.Conv2d(3, dim, patch, stride=patch,
                                     device=device)
        tokens = (input_size // patch) ** 2
        self.pos_embed = nn.Parameter(torch.zeros(1, tokens, dim,
                                                  device=device))
        hidden = mlp_ratio * dim
        shapes = {"ln1_scale": (dim,), "ln1_bias": (dim,),
                  "qkv_kernel": (dim, 3 * dim), "qkv_bias": (3 * dim,),
                  "proj_kernel": (dim, dim), "proj_bias": (dim,),
                  "ln2_scale": (dim,), "ln2_bias": (dim,),
                  "up_kernel": (dim, hidden), "up_bias": (hidden,),
                  "down_kernel": (hidden, dim), "down_bias": (dim,)}
        for name in STACKED:
            self.register_parameter(name, nn.Parameter(torch.zeros(
                (depth,) + shapes[name], device=device)))
        self.norm = LayerNorm(dim, device=device)
        self.head = nn.Linear(dim, num_classes, device=device)

    def init_weights(self, generator: torch.Generator) -> "PipelinedViT":
        """flax's initializers, drawn on the generator's device: the
        stacked kernels lecun-normal per block (fan-in = a block's input
        width, JAX's ``batch_axis=0``) truncated at 2 sigma, zero biases,
        unit LayerNorm scales, normal(0.02) position embedding."""
        lecun_init_(self, generator)
        with torch.no_grad():
            for name in STACKED:
                p = getattr(self, name)
                if name.endswith("_kernel"):
                    std = math.sqrt(1.0 / p.shape[1]) / 0.87962566103423978
                    w = torch.empty(p.shape, device=generator.device)
                    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                                          generator=generator)
                    p.copy_(w)
                elif name.endswith("_scale"):
                    nn.init.ones_(p)
                else:
                    nn.init.zeros_(p)
            nn.init.ones_(self.norm.weight)
            nn.init.zeros_(self.norm.bias)
            pos = torch.empty(self.pos_embed.shape, device=generator.device)
            nn.init.normal_(pos, std=0.02, generator=generator)
            self.pos_embed.copy_(pos)
        return self

    def local_shards(self) -> dict:
        """The stacked tensors that JAX's ``leaf_spec(prefer_axis0=True)``
        splits on axis 0: a stage computes on its own blocks and never
        gathers them.  The small ones stay whole, sliced in the
        forward."""
        if self.mesh is None:
            return {}
        mp = self.mesh.model_parallel
        return {name: parallel.Shard(0, False) for name in STACKED
                if parallel.leaf_spec(tuple(getattr(self, name).shape), mp,
                                      prefer_axis0=True) == 0}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.dtype
        x = F.conv2d(x.to(dtype).permute(0, 3, 1, 2),
                     self.patch_embed.weight.to(dtype), stride=self.patch)
        x = x.permute(0, 2, 3, 1) + self.patch_embed.bias.to(dtype)
        b, gh, gw, c = x.shape
        x = x.reshape(b, gh * gw, c) + self.pos_embed.to(dtype)
        stacked = {name: getattr(self, name) for name in STACKED}
        if self.pipeline_fn is not None:
            x = self.pipeline_fn(stacked, x)
        else:
            x = sequential_blocks(stacked, x, self.heads, self.depth)
        x = self.norm(x).float().mean(dim=1).to(dtype)  # mean-pool tokens
        return dense(self.head, x).float()
