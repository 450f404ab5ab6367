"""The small MNIST-scale models: ``SmallCNN`` and ``MLP``.

Counterpart of ``distributedpytorch_tpu/models/simple.py`` (:19-71).  The
layers carry flax's names (``Conv_0`` .. ``Conv_3``, ``Dense_0``,
``Dense_1``, ``head``), so a JAX params tree converts key by key.  Input
is NHWC (B, 28, 28, 3) as in the JAX package; the convs run on its NCHW
view, which is a channels_last tensor, and the features are flattened in
NHWC order before ``Dense_0``, as the JAX model flattens them
(``simple.py:52``), so ``Dense_0``'s rows need no permutation.

``pallas_dw=True`` takes the weight gradient of the convs with 32 or more
input channels (``Conv_1`` .. ``Conv_3``) through kernel K5
(``ops/conv.py``); ``Conv_0`` sees the 3 channels of the augmented input
and stays on the stock conv, as in the JAX model (``simple.py:41``).  The
forward, dx and the parameters are the same either way.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.pooling import max_pool_2x2
from .layers import conv, dense, lecun_init_


class SmallCNN(nn.Module):
    """Conv-conv-pool x2 + dense; logits f32."""

    def __init__(self, num_classes: int = 10,
                 dtype: torch.dtype = torch.bfloat16,
                 pallas_dw: bool = False, device=None):
        super().__init__()
        self.dtype = dtype
        self.pallas_dw = pallas_dw
        chans = ((3, 32), (32, 32), (32, 64), (64, 64))
        for i, (ci, co) in enumerate(chans):
            self.add_module(f"Conv_{i}", nn.Conv2d(ci, co, 3, padding=1,
                                                   device=device))
        self.Dense_0 = nn.Linear(7 * 7 * 64, 256, device=device)
        self.head = nn.Linear(256, num_classes, device=device)

    def init_weights(self, generator: torch.Generator) -> "SmallCNN":
        return lecun_init_(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        for i in range(4):
            layer = getattr(self, f"Conv_{i}")
            k5 = self.pallas_dw and layer.in_channels >= 32
            x = torch.relu(conv(layer, x, k5))
            if i % 2:
                x = max_pool_2x2(x)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = torch.relu(dense(self.Dense_0, x))
        return dense(self.head, x).float()


class MLP(nn.Module):
    """784*3 -> 512 -> 256 -> classes on the NHWC-flattened input."""

    def __init__(self, num_classes: int = 10,
                 dtype: torch.dtype = torch.bfloat16, input_size: int = 28,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.Dense_0 = nn.Linear(input_size * input_size * 3, 512,
                                 device=device)
        self.Dense_1 = nn.Linear(512, 256, device=device)
        self.head = nn.Linear(256, num_classes, device=device)

    def init_weights(self, generator: torch.Generator) -> "MLP":
        return lecun_init_(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype).reshape(x.shape[0], -1)
        x = torch.relu(dense(self.Dense_0, x))
        x = torch.relu(dense(self.Dense_1, x))
        return dense(self.head, x).float()
