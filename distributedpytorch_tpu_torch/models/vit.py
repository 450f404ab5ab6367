"""ViT-style patch-transformer classifier as ``nn.Module``s.

Counterpart of ``distributedpytorch_tpu/models/vit.py`` (``TransformerBlock``
and ``ViT``, :43-172): pre-LN blocks with GELU MLPs, a strided-conv patch
embedding, a learned position embedding, mean-pool over tokens and a
``head`` classifier.  ``attention_fn`` is injectable, with the public
(B, S, H, D) layout: ``ops.attention.full_attention`` or
``ops.flash_attention.flash_attention`` (kernel K1 forward, K2 and K3
backward).  q, k and v are strided views of the qkv projection, so K1
reads them without a copy, and autograd gathers the kernels' dq, dk and
dv back into the projection's gradient.

Numerics follow flax at the same rounding points, so logits agree with
the JAX model: weights are stored in f32 and cast to the compute dtype at
use; a dense layer rounds its product and then adds its bias in the
compute dtype; LayerNorm has eps 1e-6 and computes its statistics
(E[x^2] - E[x]^2, clipped at 0), scale and bias in f32 before casting;
GELU is the tanh approximation; the token mean is taken in f32.
``remat_blocks`` (``--remat blocks``, set by the registry) checkpoints
each ``TransformerBlock`` on the gradient path, keeping its matmul
outputs (``models/remat.py``); the parameter names do not change.

``moe_experts`` E > 0 (``--moe-experts``; JAX ``TransformerBlock`` at
:43-100) replaces each block's ``mlp_up``/``mlp_down`` with a
``models/moe.py`` ``SwitchMLP`` named ``moe`` (``blocks.{i}.moe.*``).
Such a block returns its load-balance loss beside its output, and the
train-mode forward returns ``{"logits": ..., "sown": the blocks' losses
summed}``, what JAX's ``mutable=["losses"]`` collects; the eval forward
returns the logits alone.

``tp_mesh`` (``--tensor-parallel``; JAX ``tp_constrain`` at :57-99) is
Megatron tensor parallelism over its model group: ``local_shards`` gives
rank m heads [m*H/M, (m+1)*H/M) -- its rows of each of q, k and v in
``qkv`` (weight and bias) and its rows of ``mlp_up`` -- and the matching
input columns of ``proj`` and ``mlp_down``, whose biases stay whole.  A
block's two column-parallel inputs are ``parallel.copy_to_model``
(identity forward, the gradient summed over the group) and its two
row-parallel outputs ``parallel.reduce_from_model`` (the partial
products summed in f32, identity backward), the bias added after the
sum: one all-reduce per residual sum, as GSPMD places it under JAX's
constraints.  A block holding the whole qkv (not yet placed) runs
unsplit.  A MoE vit with a model axis of 2 ranks or more is expert
parallel (``models/moe.py``), its experts' weights split by
``local_shards`` too.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from .. import parallel
from ..ops.attention import full_attention
from . import remat
from .layers import dense as _dense
from .layers import lecun_init_
from .moe import SwitchMLP

AttentionFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor],
                       torch.Tensor]


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` numerics (see the module docstring)."""

    def __init__(self, dim: int, eps: float = 1e-6, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = torch.clamp_min((xf * xf).mean(dim=-1, keepdim=True)
                              - mean * mean, 0.0)
        y = (xf - mean) * (torch.rsqrt(var + self.eps) * self.weight.float())
        return (y + self.bias.float()).to(x.dtype)


class TransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_ratio: int,
                 attention_fn: AttentionFn, moe_experts: int = 0,
                 moe_mesh=None, tp_mesh=None, device=None):
        super().__init__()
        self.dim = dim
        self.heads = heads
        self.attention_fn = attention_fn
        self.tp_mesh = tp_mesh
        self.ln1 = LayerNorm(dim, device=device)
        self.qkv = nn.Linear(dim, 3 * dim, device=device)
        self.proj = nn.Linear(dim, dim, device=device)
        self.ln2 = LayerNorm(dim, device=device)
        if moe_experts > 0:
            self.moe = SwitchMLP(dim, mlp_ratio * dim, moe_experts,
                                 mesh=moe_mesh, device=device)
        else:
            self.mlp_up = nn.Linear(dim, mlp_ratio * dim, device=device)
            self.mlp_down = nn.Linear(mlp_ratio * dim, dim, device=device)

    def forward(self, x: torch.Tensor):
        """The block's output; a MoE block's (output, its load-balance
        loss share in train mode, else None)."""
        b, s, _ = x.shape
        head_dim = self.dim // self.heads
        # this rank's width of q, k and v: dim, or dim / M under TP
        local = self.qkv.weight.shape[0] // 3
        tp = self.tp_mesh if local != self.dim else None
        qkv = _dense(self.qkv, self._column_in(tp, self.ln1(x)))
        # views into qkv: the flash kernel reads these strides directly
        q, k, v = (t.reshape(b, s, local // head_dim, head_dim)
                   for t in qkv.split(local, dim=-1))
        attn = self.attention_fn(q, k, v).reshape(b, s, local)
        x = x + self._row_out(tp, self.proj, attn)
        if hasattr(self, "moe"):
            h, aux = self.moe(self.ln2(x))
            return x + h, aux
        h = _dense(self.mlp_up, self._column_in(tp, self.ln2(x)))
        h = self._row_out(tp, self.mlp_down, F.gelu(h, approximate="tanh"))
        return x + h

    @staticmethod
    def _column_in(tp, h: torch.Tensor) -> torch.Tensor:
        return h if tp is None else parallel.copy_to_model(tp, h)

    @staticmethod
    def _row_out(tp, layer: nn.Linear, h: torch.Tensor) -> torch.Tensor:
        """flax ``Dense`` of a row-parallel layer: the partial products
        summed over the model group, then the bias."""
        if tp is None:
            return _dense(layer, h)
        y = parallel.reduce_from_model(tp, F.linear(h, layer.weight.to(
            h.dtype)))
        return y + layer.bias.to(h.dtype)


class ViT(nn.Module):
    """Small vision transformer; defaults size it for 28x28 inputs
    (patch 4 -> 49 tokens).  Input NHWC (B, H, W, 3), logits f32."""

    def __init__(self, num_classes: int = 10, patch: int = 4, dim: int = 128,
                 depth: int = 4, heads: int = 4, mlp_ratio: int = 4,
                 dtype: torch.dtype = torch.bfloat16,
                 attention_fn: Optional[AttentionFn] = None,
                 input_size: int = 28, moe_experts: int = 0, moe_mesh=None,
                 tp_mesh=None, device=None):
        super().__init__()
        if dim % heads:
            raise ValueError(f"dim {dim} is not divisible by heads {heads}")
        if tp_mesh is not None and heads % tp_mesh.model_parallel:
            raise ValueError(
                f"--tensor-parallel splits the {heads} heads over the "
                f"{tp_mesh.model_parallel} ranks of the model group: they "
                f"must divide by it")
        self.tp_mesh = tp_mesh
        self.patch = patch
        self.dtype = dtype
        self.remat_blocks = False
        attn = attention_fn or full_attention
        self.patch_embed = nn.Conv2d(3, dim, patch, stride=patch,
                                     device=device)
        tokens = (input_size // patch) ** 2
        self.pos_embed = nn.Parameter(torch.zeros(1, tokens, dim,
                                                  device=device))
        self.moe_experts = moe_experts
        self.blocks = nn.ModuleList(
            TransformerBlock(dim, heads, mlp_ratio, attn,
                             moe_experts=moe_experts, moe_mesh=moe_mesh,
                             tp_mesh=tp_mesh, device=device)
            for _ in range(depth))
        self.norm = LayerNorm(dim, device=device)
        self.head = nn.Linear(dim, num_classes, device=device)

    def init_weights(self, generator: torch.Generator) -> "ViT":
        """Random weights from ``generator`` with flax's initializers:
        lecun-normal kernels (truncated at 2 sigma), zero biases, unit
        LayerNorm scales, normal(0.02) position embedding.  The draws are
        made on the generator's device and copied to the model's, so one
        CPU generator gives the same weights on every device."""
        lecun_init_(self, generator)
        with torch.no_grad():
            for mod in self.modules():
                if isinstance(mod, LayerNorm):
                    nn.init.ones_(mod.weight)
                    nn.init.zeros_(mod.bias)
                elif isinstance(mod, SwitchMLP):
                    mod.init_experts(generator)
            pos = torch.empty(self.pos_embed.shape, device=generator.device)
            nn.init.normal_(pos, std=0.02, generator=generator)
            self.pos_embed.copy_(pos)
        return self

    def local_shards(self) -> dict:
        """{parameter name: ``parallel.Shard``} of what the blocks compute
        on as a rank's slice (see the module docstring); the placement
        splits every other parameter by the ZeRO rule."""
        out = {}
        col, row = parallel.Shard(0, False), parallel.Shard(1, False)
        for i, blk in enumerate(self.blocks):
            pre = f"blocks.{i}."
            if self.tp_mesh is not None:
                qkv = parallel.Shard(0, False, groups=3)
                out.update({pre + "qkv.weight": qkv, pre + "qkv.bias": qkv,
                            pre + "mlp_up.weight": col,
                            pre + "mlp_up.bias": col,
                            pre + "proj.weight": row,
                            pre + "mlp_down.weight": row})
            if hasattr(blk, "moe") and blk.moe.expert_parallel:
                out.update({pre + "moe.w_up": col, pre + "moe.w_down": col})
        return out

    def forward(self, x: torch.Tensor):
        """f32 logits; in train mode a MoE vit's ``{"logits", "sown"}``
        (see the module docstring)."""
        dtype = self.dtype
        x = F.conv2d(x.to(dtype).permute(0, 3, 1, 2),
                     self.patch_embed.weight.to(dtype), stride=self.patch)
        x = x.permute(0, 2, 3, 1) + self.patch_embed.bias.to(dtype)
        b, gh, gw, c = x.shape
        x = x.reshape(b, gh * gw, c) + self.pos_embed.to(dtype)
        sown = None
        for blk in self.blocks:
            x = remat.run_block(self, blk, x)
            if isinstance(x, tuple):
                x, aux = x
                if aux is not None:
                    sown = aux if sown is None else sown + aux
        x = self.norm(x).float().mean(dim=1).to(dtype)  # mean-pool tokens
        logits = _dense(self.head, x).float()
        if sown is not None:
            return {"logits": logits, "sown": sown}
        return logits
