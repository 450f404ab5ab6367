"""Switch-style mixture-of-experts MLP (``--moe-experts E``), expert
parallel over a model group of 2 ranks or more.

Counterpart of ``distributedpytorch_tpu/models/moe.py`` (``SwitchMLP``,
``GROUP_TOKENS``, ``_rows_per_group``), at JAX's rounding points and
with its dense one-hot dispatch:

  * the router is an f32 ``Linear(D, E)`` on the tokens cast to f32 (a
    true f32 product on the card, TF32 off); the expert is the argmax of
    its softmax (the first index on ties) and the gate its max;
  * tokens are split into groups of whole rows of the GLOBAL batch
    (``rows_per_group``, about GROUP_TOKENS tokens a group), and an
    expert takes at most cap = ceil(n_g / E * capacity_factor) tokens of
    a group, in token order (pos = cumsum(onehot) * onehot, kept while
    0 < pos <= cap); a dropped token's output is exactly 0;
  * dispatch and combine are the one-hot products (G, N_g, E, C) x
    (G, N_g, D) -> (G, E, C, D) and back, the combine weights
    ``disp * gate`` rounded to the compute dtype; the experts' FFNs are
    one batched product each, (E, G*C, D) x (E, D, H), the bias added in
    the compute dtype, tanh GELU, then (E, G*C, H) x (E, H, D) plus bias;
    all four are ``torch.bmm`` calls, so ``--remat blocks`` (which saves
    ``mm``/``addmm`` outputs only) recomputes them, as JAX's
    ``dots_with_no_batch_dims_saveable`` does, and keeps the router's;
  * in train mode the Switch load-balance loss AUX_LOSS_COEF * E *
    sum_e f_e * P_e (f_e the pre-capacity share of tokens routed to e,
    P_e the mean router probability) over every token of the global
    batch, which ``forward`` returns beside the output (JAX sows it into
    the 'losses' collection).

The JAX model sees the global batch; a rank of the port holds its data
shard's rows ``[d*b, (d+1)*b)`` (``runtime.Mesh``; the ranks of a model
group hold the same rows).  A token's output depends only on its own
slot and on whether it is kept (the FFN works slot by slot, and a slot
holds at most one token), so a rank computes its own tokens exactly from
two things of the global batch: each group's per-expert count of the
tokens that come before its rows, and, for the loss, the global counts.
Both come from one all-reduce of the data group's per-row expert counts,
(dp * b, E) floats, made when a group straddles the ranks or the loss is
wanted; the loss returned is this rank's share, whose sum over the data
shards is JAX's value (its gradient flows through P_e only, as in JAX).
A rank's tokens are laid out as the whole groups they touch, the other
ranks' rows zero and never dispatched.  The forward makes no host sync
and has no data-dependent shape, so a step captures as a CUDA Graph and
counts its FLOPs on the meta device.

Expert parallelism (JAX ``moe_constrain``, ``models/moe.py:145-167``):
with a ``mesh`` of 2 model ranks or more, ``expert_parallel`` is set and
the placement (``parallel.place`` through the vit's ``local_shards``)
leaves rank m the experts [m*E/M, (m+1)*E/M) of ``w_up`` and ``w_down``;
the router and the biases are placed by the ZeRO rule (whole, at the
vit's widths).  The model ranks of a data shard hold the same tokens, so
each computes the whole dispatch, takes its experts' slice of the
expert batches (``parallel.split_to_model``: its backward all-gathers
the slices' gradients) and of the biases, runs the two ``bmm`` on it,
and all-gathers the outputs over the model group
(``parallel.gather_from_model``: its backward keeps the rank's slice of
the gradient, the same on every rank).  A module whose ``w_up`` holds
every expert runs them all.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .. import parallel, runtime
from ..utils import largest_divisor_leq

# Target tokens a dispatch group (JAX GROUP_TOKENS): capacity, and so the
# dispatch tensor's width, is per group, linear in the total tokens.
GROUP_TOKENS = 1024
AUX_LOSS_COEF = 0.01            # JAX SwitchMLP.aux_loss_coef


def rows_per_group(b: int, s: int) -> int:
    """Largest divisor of ``b`` whose group holds <= ~GROUP_TOKENS tokens
    (at least one row): JAX ``_rows_per_group`` of the global batch."""
    return largest_divisor_leq(b, max(1, GROUP_TOKENS // max(1, s)))


@contextlib.contextmanager
def _true_f32():
    """f32 matmuls without TF32 on the card, whatever the global setting:
    a router product in TF32 flips routes against the CPU's."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def _lecun_normal_(w: torch.Tensor, fan_in: int,
                   generator: torch.Generator) -> None:
    """flax ``lecun_normal`` (truncated at 2 sigma) drawn on the
    generator's device and copied in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    draw = torch.empty(w.shape, device=generator.device)
    nn.init.trunc_normal_(draw, std=std, a=-2 * std, b=2 * std,
                          generator=generator)
    w.copy_(draw)


class SwitchMLP(nn.Module):
    """Drop-in replacement for a transformer block's dense MLP: (B, S, D)
    in the compute dtype -> (output of the same shape and dtype, this
    rank's share of the load-balance loss in train mode, else None).
    ``mesh`` (a ``runtime.Mesh``) is the world whose data group holds the
    global batch; None: this process's batch is the global one."""

    def __init__(self, dim: int, hidden: int, num_experts: int,
                 capacity_factor: float = 1.25, mesh=None, device=None):
        super().__init__()
        self.num_experts = num_experts
        self.capacity_factor = capacity_factor
        self.mesh = mesh
        self.expert_parallel = mesh is not None and mesh.model_parallel >= 2
        e = num_experts
        self.router = nn.Linear(dim, e, device=device)
        self.w_up = nn.Parameter(torch.zeros(e, dim, hidden, device=device))
        self.b_up = nn.Parameter(torch.zeros(e, hidden, device=device))
        self.w_down = nn.Parameter(torch.zeros(e, hidden, dim,
                                               device=device))
        self.b_down = nn.Parameter(torch.zeros(e, dim, device=device))

    @torch.no_grad()
    def init_experts(self, generator: torch.Generator) -> None:
        """The experts' fresh weights: lecun-normal with ``batch_axis=0``
        (the fan-in excludes the expert axis), zero biases.  The router is
        a ``Linear``, drawn with the model's other layers."""
        _lecun_normal_(self.w_up, self.w_up.shape[1], generator)
        _lecun_normal_(self.w_down, self.w_down.shape[1], generator)
        self.b_up.zero_()
        self.b_down.zero_()

    def _layout(self, b: int, s: int) -> Tuple[int, int, int, int, int]:
        """(data shards, rows a group, the first global row of this rank,
        zero rows before this rank's rows in its first group, zero rows
        after them in its last)."""
        mesh = self.mesh
        dp = 1 if mesh is None else mesh.data_parallel
        rows = rows_per_group(dp * b, s)
        first = (0 if mesh is None else mesh.data_index) * b
        lead = first % rows
        trail = -(lead + b) % rows
        return dp, rows, first, lead, trail

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        b, s, d = x.shape
        e = self.num_experts
        dp, rows, first, lead, trail = self._layout(b, s)
        n_g = rows * s
        parts = (lead + b + trail) // rows
        cap = max(1, math.ceil(n_g / e * self.capacity_factor))
        tokens = x.reshape(b * s, d)
        with _true_f32():
            logits = (F.linear(tokens.float(), self.router.weight.float())
                      + self.router.bias.float())
        probs = torch.softmax(logits, dim=-1)                    # (N, E)
        expert = torch.argmax(probs, dim=-1)
        gate = probs.amax(dim=-1)
        onehot = (expert[:, None] == torch.arange(
            e, device=x.device)).to(torch.float32)
        row_counts = onehot.view(b, s, e).sum(dim=1)             # (b, E)
        counts, offset = row_counts, None
        if dp > 1 and (lead or trail or self.training):
            with torch.no_grad():
                counts = torch.zeros((dp * b, e), dtype=torch.float32,
                                     device=x.device)
                counts[first:first + b] = row_counts
                runtime.all_reduce_sum(counts, self.mesh.data_group)
            if lead:
                # the first group's tokens on the ranks before this one
                offset = counts[first - lead:first].sum(dim=0)

        def grouped(t: torch.Tensor) -> torch.Tensor:
            """(b, S, ...) -> (groups, N_g, ...), this rank's rows in
            place and zero rows for the other ranks'."""
            if lead or trail:
                t = F.pad(t, (0, 0) * (t.dim() - 2) + (0, 0, lead, trail))
            return t.reshape((parts, n_g) + t.shape[2:])

        oh = grouped(onehot.view(b, s, e))
        pos = torch.cumsum(oh, dim=1)
        if offset is not None:
            pos = pos + F.pad(offset[None, None], (0, 0, 0, 0, 0, parts - 1))
        pos = pos * oh
        keep = (pos > 0) & (pos <= cap)
        slot = torch.clamp(pos - 1, 0, cap - 1).long().sum(dim=-1)
        slot_oh = (slot[..., None] == torch.arange(
            cap, device=x.device)).to(torch.float32)              # (G, N, C)
        disp = slot_oh[:, :, None, :] * (oh * keep)[:, :, :, None]
        combine = disp * grouped(gate.view(b, s, 1))[..., None]

        aux = None
        if self.training:
            n_total = dp * b * s
            f = counts.sum(dim=0) / n_total
            p = probs.sum(dim=0) / n_total
            aux = AUX_LOSS_COEF * e * torch.sum(f * p)

        cdt = x.dtype
        # dispatch: (G, E*C, N) x (G, N, D) -> (G, E*C, D)
        expert_in = torch.bmm(disp.to(cdt).reshape(parts, n_g, e * cap)
                              .transpose(1, 2),
                              grouped(tokens.view(b, s, d)))
        expert_in = (expert_in.view(parts, e, cap, d).transpose(0, 1)
                     .reshape(e, parts * cap, d))
        b_up, b_down = self.b_up, self.b_down
        split = self.w_up.shape[0] != e     # this rank's experts only
        if split:
            expert_in, b_up, b_down = (
                parallel.split_to_model(self.mesh, t, 0)
                for t in (expert_in, b_up, b_down))
        h = torch.bmm(expert_in, self.w_up.to(cdt))
        h = F.gelu(h + b_up.to(cdt)[:, None, :], approximate="tanh")
        out = (torch.bmm(h, self.w_down.to(cdt))
               + b_down.to(cdt)[:, None, :])
        if split:
            out = parallel.gather_from_model(self.mesh, out, 0)
        out = (out.view(e, parts, cap, d).transpose(0, 1)
               .reshape(parts, e * cap, d))
        # combine: (G, N, E*C) x (G, E*C, D); a dropped token's row is 0
        y = torch.bmm(combine.to(cdt).reshape(parts, n_g, e * cap), out)
        y = y.reshape(parts * rows, s, d)
        if lead or trail:
            y = y[lead:lead + b]
        return y, aux
