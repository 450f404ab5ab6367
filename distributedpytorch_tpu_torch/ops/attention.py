"""Attention ops: full (the plain reference) and ring (sequence-parallel)
attention.

Counterpart of ``distributedpytorch_tpu/ops/attention.py``.
``full_attention`` is the plain reference the flash kernels are held
against and the ``--attention full`` path.  ``ring_attention`` and
``make_ring_attention`` are ``--attention ring`` (the einsum ring,
``_ring_attention_local``: plain torch ops, no kernel) and ``--attention
ring_flash`` (``_ring_local_flash``: kernel K4 at every ring step, K2p and
K3p in the backward, at every shard length).

The JAX ring is one ``shard_map`` program over the mesh's 'model' axis.
Here every rank is a process, and the axis is the model group of
``runtime.Mesh``.  The model ranks of a data shard hold the same
activations (the vit stays replicated over them), so ``ring_attention``
takes the global (B, S, H, D) q, k, v as the JAX one does, and each rank:

  * takes its S/M tokens (backward: the model group's gradients of the
    slices, all-gathered along S);
  * runs the ring: its q against the K/V block it holds, merged into an
    f32 accumulator, the block passed on to model index m + 1 between
    steps (``_RingShift``, whose backward passes the gradient back to
    m - 1: the transpose of ``ppermute``);
  * all-gathers the outputs along S (backward: its own slice of the
    gradient, which is the same on every model rank; not a sum).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from .. import runtime


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool = False) -> torch.Tensor:
    """q/k/v (B, S, H, D) -> (B, S, H, D).  Computed in float32 for a
    stable softmax, cast back to the input dtype."""
    dtype = q.dtype
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        s_q, s_k = scores.shape[-2], scores.shape[-1]
        mask = torch.ones((s_q, s_k), dtype=torch.bool,
                          device=q.device).tril()
        scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    return out.to(dtype)


# Finite "masked" sentinel: keeps every exp and subtraction finite, so the
# forward and the backward are NaN-free (as in the JAX package).
_MASKED = -1e30
_FAR = 2 ** 30  # padded-position sentinel (>= any kv_valid)


class _RingShift(torch.autograd.Function):
    """Rotate tensors one step around the model group: rank m's go to
    m + 1, m - 1's arrive.  The backward rotates the gradients the other
    way."""

    @staticmethod
    def forward(ctx, mesh, *tensors):
        ctx.mesh = mesh
        return tuple(runtime.ring_shift(mesh, tensors, 1))

    @staticmethod
    def backward(ctx, *grads):
        return (None, *runtime.ring_shift(ctx.mesh, grads, -1))


class _ShardTokens(torch.autograd.Function):
    """q, k, v (B, S, H, D), the same on every model rank -> this rank's
    S/M tokens of each.  The backward all-gathers the ranks' gradients of
    their slices (one gather of the three stacked)."""

    @staticmethod
    def forward(ctx, mesh, *tensors):
        ctx.mesh = mesh
        s_local = tensors[0].shape[1] // mesh.model_parallel
        return tuple(t.narrow(1, mesh.model_index * s_local, s_local)
                     for t in tensors)

    @staticmethod
    def backward(ctx, *grads):
        full = runtime.all_gather_seq(ctx.mesh, torch.stack(grads), dim=2)
        return (None, *full.unbind(0))


class _GatherTokens(torch.autograd.Function):
    """This rank's (B, S/M, H, D) output -> the model group's (B, S, H, D).
    The gradient of the gathered output is the same on every model rank
    (what follows attention is replicated), so the backward keeps this
    rank's slice of it."""

    @staticmethod
    def forward(ctx, mesh, x):
        ctx.mesh = mesh
        return runtime.all_gather_seq(mesh, x)

    @staticmethod
    def backward(ctx, g):
        s_local = g.shape[1] // ctx.mesh.model_parallel
        return None, g.narrow(1, ctx.mesh.model_index * s_local, s_local)


def _block_positions(mesh, s_local: int, device) -> list:
    """Global positions of the key block a rank holds at each ring step:
    block t came from model index (m - t) mod M."""
    base = torch.arange(s_local, dtype=torch.int32, device=device)
    n, m = mesh.model_parallel, mesh.model_index
    return [base + ((m - t) % n) * s_local for t in range(n)]


def _ring_attention_local(q, k, v, mesh, s_local: int, causal: bool,
                          kv_valid: Optional[int]) -> torch.Tensor:
    """The einsum ring (``_ring_body`` / ``_ring_attention_local``): q/k/v
    are this rank's (B, S_local, H, D) blocks; returns its output block.
    f32 running max, sum and accumulator; masked scores at ``_MASKED``."""
    dtype = q.dtype
    d = q.shape[-1]
    scale = 1.0 / math.sqrt(d)
    positions = [p.long() for p in _block_positions(mesh, s_local, q.device)]
    q_glob = positions[0]
    qf, kf, vf = q.float(), k.float(), v.float()
    acc = m = l = None
    for t, k_pos in enumerate(positions):
        scores = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
        mask = None
        if causal:
            mask = q_glob[:, None] >= k_pos[None, :]
        if kv_valid is not None:
            kvm = (k_pos < kv_valid)[None, :]
            mask = kvm if mask is None else mask & kvm
        if mask is not None:
            scores = torch.where(mask, scores, _MASKED)
        if acc is None:
            acc = torch.zeros(scores.shape[:3] + (d,), dtype=torch.float32,
                              device=q.device)
            m = torch.full(scores.shape[:3], _MASKED, dtype=torch.float32,
                           device=q.device)
            l = torch.zeros(scores.shape[:3], dtype=torch.float32,
                            device=q.device)
        m_new = torch.maximum(m, scores.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(scores - m_new[..., None])
        if mask is not None:
            p = torch.where(mask, p, 0.0)   # masked entries add exactly 0
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vf)
        m = m_new
        if t < mesh.model_parallel - 1:
            kf, vf = _RingShift.apply(mesh, kf, vf)
    # fully masked rows (padded queries) have l == 0: the output is 0
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return torch.einsum("bhqd->bqhd", out).to(dtype)


def _lse_rows(lse: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """(B*H, S) per-row values -> (B, S, H, 1), to scale a (B, S, H, D)
    output."""
    b, s, h, _ = like.shape
    return lse.reshape(b, h, s).permute(0, 2, 1)[..., None]


def _merge_partials(o_run, lse_run, o_blk, lse_blk):
    """Exact flash combine of two softmax partials over disjoint key sets
    (the JAX ``_merge_partials``): each o (B, S, H, D) is its own
    softmax-normalised result, each lse (B*H, S) the log-sum-exp over its
    keys.  Returns the merged (o, lse)."""
    lse_new = torch.logaddexp(lse_run, lse_blk)
    w_run = _lse_rows(torch.exp(lse_run - lse_new), o_run)
    w_blk = _lse_rows(torch.exp(lse_blk - lse_new), o_run)
    return o_run * w_run + o_blk.to(o_run.dtype) * w_blk, lse_new


def _ring_local_flash(q, k, v, mesh, s_local: int, causal: bool,
                      kv_valid: Optional[int]) -> torch.Tensor:
    """The flash ring (``_ring_local_flash``): each step attends this
    rank's q against the K/V block it holds with K4
    (``flash_attention_partial``, masked by global positions) and merges
    the f32 partial into the running one.  Unlike the JAX ring nothing is
    padded to a kernel block (K4 masks its ragged tail), so the kernel
    runs at every shard length, and the first partial is the running one
    (the JAX merge into the (0, -1e30) seed is the identity)."""
    from .flash_attention import flash_attention_partial

    positions = _block_positions(mesh, s_local, q.device)
    o_run = lse_run = None
    for t, k_pos in enumerate(positions):
        o_blk, lse_blk = flash_attention_partial(q, k, v, positions[0],
                                                 k_pos, causal, kv_valid)
        if o_run is None:
            o_run, lse_run = o_blk, lse_blk
        else:
            o_run, lse_run = _merge_partials(o_run, lse_run, o_blk, lse_blk)
        if t < mesh.model_parallel - 1:
            k, v = _RingShift.apply(mesh, k, v)
    return o_run.to(q.dtype)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mesh, causal: bool = False,
                   kv_valid: Optional[int] = None,
                   use_flash: bool = False) -> torch.Tensor:
    """Sequence-parallel attention over ``mesh``'s model group.

    q/k/v: the global (B, S, H, D) tensors, the same on every model rank
    of a data shard.  The same function as ``full_attention``; every rank
    returns the whole output.  ``kv_valid`` masks key positions >=
    kv_valid, so callers may zero-pad S up to a multiple of the ring size
    (``make_ring_attention``).  ``use_flash`` attends each ring step with
    kernel K4 instead of the einsum."""
    n_dev = mesh.model_parallel
    s = q.shape[1]
    if s % n_dev:
        raise ValueError(f"sequence length {s} not divisible by "
                         f"model axis size {n_dev}")
    if kv_valid is not None and not 0 < kv_valid <= s:
        raise ValueError(f"kv_valid={kv_valid} out of range (0, {s}]")
    local = _ring_local_flash if use_flash else _ring_attention_local
    ql, kl, vl = _ShardTokens.apply(mesh, q, k, v)
    out = local(ql, kl, vl, mesh, s // n_dev, causal, kv_valid)
    return _GatherTokens.apply(mesh, out)


def make_ring_attention(mesh, causal: bool = False, use_flash: bool = False):
    """An ``attention_fn`` for models/vit.py: pads the token axis up to a
    multiple of the ring size, runs ring attention with the padded keys
    masked (kv_valid) and slices the padding back off, so any sequence
    length works (the vit's 49 tokens pad to 50 on a ring of two).  What
    ``--attention ring`` installs (``ring_flash``: ``use_flash=True``)."""
    n_dev = mesh.model_parallel

    def attn(q, k, v):
        s = q.shape[1]
        pad = (-s) % n_dev
        if pad == 0:
            return ring_attention(q, k, v, mesh, causal=causal,
                                  use_flash=use_flash)
        width = (0, 0, 0, 0, 0, pad)
        out = ring_attention(F.pad(q, width), F.pad(k, width),
                             F.pad(v, width), mesh, causal=causal,
                             kv_valid=s, use_flash=use_flash)
        return out[:, :s]

    return attn
