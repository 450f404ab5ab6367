"""SqueezeNet 1.0 (ref utils.py:69-76 wraps torchvision squeezenet1_0).

Counterpart of ``distributedpytorch_tpu/models/squeezenet.py`` (:27-77): a
VALID 7x7/2 stem, ``Fire`` modules (a 1x1 squeeze, then 1x1 and 3x3
expands concatenated as [e1, e3] on channels), 3x3/2 max pools with
torchvision's ``ceil_mode=True``, then dropout on the feature map, the 1x1
conv ``head``, ReLU and a global mean.  The JAX ``_max_pool_ceil`` pads
the bottom/right with -inf where (dim - 3) is odd, which is torch's
``ceil_mode=True`` (109 -> 54 -> 27 -> 13 at 224).  Layer names are
flax's (``Conv_0``, ``Fire_0`` .. ``Fire_7`` each with ``Conv_0`` ..
``Conv_2``, ``head``).  Input NHWC, convs on its channels_last NCHW view.
Logits f32.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .common import global_mean
from .layers import Dropout, conv, lecun_init_

# (squeeze, expand1, expand3) of Fire_0 .. Fire_7; a max pool follows the
# stem, Fire_2 and Fire_6
_FIRES = ((16, 64, 64), (16, 64, 64), (32, 128, 128), (32, 128, 128),
          (48, 192, 192), (48, 192, 192), (64, 256, 256), (64, 256, 256))
_POOL_AFTER = (2, 6)


def max_pool_ceil(x: torch.Tensor) -> torch.Tensor:
    """torchvision ``MaxPool2d(3, 2, ceil_mode=True)``, the JAX
    ``_max_pool_ceil``."""
    return F.max_pool2d(x, 3, 2, ceil_mode=True)


def _pooled(n: int) -> int:
    return -(-(n - 3) // 2) + 1


class Fire(nn.Module):
    def __init__(self, in_channels: int, squeeze: int, expand1: int,
                 expand3: int, device=None):
        super().__init__()
        self.Conv_0 = nn.Conv2d(in_channels, squeeze, 1, device=device)
        self.Conv_1 = nn.Conv2d(squeeze, expand1, 1, device=device)
        self.Conv_2 = nn.Conv2d(squeeze, expand3, 3, padding=1,
                                device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(conv(self.Conv_0, x))
        return torch.cat([torch.relu(conv(self.Conv_1, x)),
                          torch.relu(conv(self.Conv_2, x))], dim=1)


class SqueezeNet(nn.Module):
    def __init__(self, num_classes: int = 10,
                 dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        self.dtype = dtype
        self.Conv_0 = nn.Conv2d(3, 96, 7, 2, device=device)
        channels = 96
        for i, (s, e1, e3) in enumerate(_FIRES):
            self.add_module(f"Fire_{i}", Fire(channels, s, e1, e3,
                                              device=device))
            channels = e1 + e3
        self.Dropout_0 = Dropout(0.5)
        self.head = nn.Conv2d(channels, num_classes, 1, device=device)

    def init_weights(self, generator: torch.Generator) -> "SqueezeNet":
        return lecun_init_(self, generator)

    @staticmethod
    def dropout_shapes(input_size: int) -> List[Tuple[int, ...]]:
        """A row's shape at the dropout, in the JAX layout (H, W, C)."""
        n = (input_size - 7) // 2 + 1
        for _ in range(3):
            n = _pooled(n)
        return [(n, n, _FIRES[-1][1] + _FIRES[-1][2])]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        x = max_pool_ceil(torch.relu(conv(self.Conv_0, x)))
        for i in range(len(_FIRES)):
            x = getattr(self, f"Fire_{i}")(x)
            if i in _POOL_AFTER:
                x = max_pool_ceil(x)
        x = self.Dropout_0(x)
        x = torch.relu(conv(self.head, x))
        return global_mean(x).float()
