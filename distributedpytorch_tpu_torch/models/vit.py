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
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import full_attention

AttentionFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor],
                       torch.Tensor]


def _dense(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """flax ``Dense(dtype=x.dtype)``: product in the compute dtype, then
    the bias added in it."""
    return F.linear(x, layer.weight.to(x.dtype)) + layer.bias.to(x.dtype)


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
                 attention_fn: AttentionFn, device=None):
        super().__init__()
        self.dim = dim
        self.heads = heads
        self.attention_fn = attention_fn
        self.ln1 = LayerNorm(dim, device=device)
        self.qkv = nn.Linear(dim, 3 * dim, device=device)
        self.proj = nn.Linear(dim, dim, device=device)
        self.ln2 = LayerNorm(dim, device=device)
        self.mlp_up = nn.Linear(dim, mlp_ratio * dim, device=device)
        self.mlp_down = nn.Linear(mlp_ratio * dim, dim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, _ = x.shape
        head_dim = self.dim // self.heads
        qkv = _dense(self.qkv, self.ln1(x))
        # views into qkv: the flash kernel reads these strides directly
        q, k, v = (t.reshape(b, s, self.heads, head_dim)
                   for t in qkv.split(self.dim, dim=-1))
        attn = self.attention_fn(q, k, v).reshape(b, s, self.dim)
        x = x + _dense(self.proj, attn)
        h = _dense(self.mlp_up, self.ln2(x))
        h = _dense(self.mlp_down, F.gelu(h, approximate="tanh"))
        return x + h


class ViT(nn.Module):
    """Small vision transformer; defaults size it for 28x28 inputs
    (patch 4 -> 49 tokens).  Input NHWC (B, H, W, 3), logits f32."""

    def __init__(self, num_classes: int = 10, patch: int = 4, dim: int = 128,
                 depth: int = 4, heads: int = 4, mlp_ratio: int = 4,
                 dtype: torch.dtype = torch.bfloat16,
                 attention_fn: Optional[AttentionFn] = None,
                 input_size: int = 28, device=None):
        super().__init__()
        if dim % heads:
            raise ValueError(f"dim {dim} is not divisible by heads {heads}")
        self.patch = patch
        self.dtype = dtype
        attn = attention_fn or full_attention
        self.patch_embed = nn.Conv2d(3, dim, patch, stride=patch,
                                     device=device)
        tokens = (input_size // patch) ** 2
        self.pos_embed = nn.Parameter(torch.zeros(1, tokens, dim,
                                                  device=device))
        self.blocks = nn.ModuleList(
            TransformerBlock(dim, heads, mlp_ratio, attn, device=device)
            for _ in range(depth))
        self.norm = LayerNorm(dim, device=device)
        self.head = nn.Linear(dim, num_classes, device=device)

    def init_weights(self, generator: torch.Generator) -> "ViT":
        """Random weights from ``generator`` with flax's initializers:
        lecun-normal kernels (truncated at 2 sigma), zero biases, unit
        LayerNorm scales, normal(0.02) position embedding.  The draws are
        made on the generator's device and copied to the model's, so one
        CPU generator gives the same weights on every device."""
        dev = generator.device
        with torch.no_grad():
            for mod in self.modules():
                if isinstance(mod, (nn.Linear, nn.Conv2d)):
                    fan_in = mod.weight[0].numel()
                    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                    w = torch.empty(mod.weight.shape, device=dev)
                    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                                          generator=generator)
                    mod.weight.copy_(w)
                    nn.init.zeros_(mod.bias)
                elif isinstance(mod, LayerNorm):
                    nn.init.ones_(mod.weight)
                    nn.init.zeros_(mod.bias)
            pos = torch.empty(self.pos_embed.shape, device=dev)
            nn.init.normal_(pos, std=0.02, generator=generator)
            self.pos_embed.copy_(pos)
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.dtype
        x = F.conv2d(x.to(dtype).permute(0, 3, 1, 2),
                     self.patch_embed.weight.to(dtype), stride=self.patch)
        x = x.permute(0, 2, 3, 1) + self.patch_embed.bias.to(dtype)
        b, gh, gw, c = x.shape
        x = x.reshape(b, gh * gw, c) + self.pos_embed.to(dtype)
        for blk in self.blocks:
            x = blk(x)
        x = self.norm(x).float().mean(dim=1).to(dtype)  # mean-pool tokens
        return _dense(self.head, x).float()
