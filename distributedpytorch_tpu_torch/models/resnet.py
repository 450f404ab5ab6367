"""ResNet-18 (ref utils.py:42-49 wraps torchvision resnet18).

Counterpart of ``distributedpytorch_tpu/models/resnet.py`` (:21-74): a 7x7/2
stem with BatchNorm and a 3x3/2 max pool (padded with -inf), stages of
``BasicBlock``s at widths width * 2^stage, a 1x1 projection where a block
changes shape, a global mean and the ``head``.  The paddings are the JAX
model's explicit (1, 1) and (3, 3), which are torch's.  Layer names are
flax's (``Conv_0``, ``BatchNorm_0``, ``BasicBlock_i``, ``head``), so a JAX
params / batch_stats tree converts key by key.  Input NHWC, convs on its
channels_last NCHW view, BatchNorm with flax's semantics and global
statistics (``models/norm.py``), logits f32.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import conv, dense, lecun_init_
from .norm import BatchNorm


class BasicBlock(nn.Module):
    def __init__(self, in_channels: int, filters: int, stride: int,
                 device=None):
        super().__init__()
        self.Conv_0 = nn.Conv2d(in_channels, filters, 3, stride, padding=1,
                                bias=False, device=device)
        self.BatchNorm_0 = BatchNorm(filters, device=device)
        self.Conv_1 = nn.Conv2d(filters, filters, 3, 1, padding=1,
                                bias=False, device=device)
        self.BatchNorm_1 = BatchNorm(filters, device=device)
        self.project = stride != 1 or in_channels != filters
        if self.project:
            self.Conv_2 = nn.Conv2d(in_channels, filters, 1, stride,
                                    bias=False, device=device)
            self.BatchNorm_2 = BatchNorm(filters, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.BatchNorm_0(conv(self.Conv_0, x)))
        y = self.BatchNorm_1(conv(self.Conv_1, y))
        residual = self.BatchNorm_2(conv(self.Conv_2, x)) if self.project \
            else x
        return torch.relu(y + residual)


class ResNet(nn.Module):
    def __init__(self, stage_sizes: Sequence[int], num_classes: int = 10,
                 width: int = 64, dtype: torch.dtype = torch.bfloat16,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.Conv_0 = nn.Conv2d(3, width, 7, 2, padding=3, bias=False,
                                device=device)
        self.BatchNorm_0 = BatchNorm(width, device=device)
        i, channels = 0, width
        for stage, n_blocks in enumerate(stage_sizes):
            for block in range(n_blocks):
                stride = 2 if stage > 0 and block == 0 else 1
                filters = width * 2 ** stage
                self.add_module(f"BasicBlock_{i}", BasicBlock(
                    channels, filters, stride, device=device))
                i, channels = i + 1, filters
        self.n_blocks = i
        self.head = nn.Linear(channels, num_classes, device=device)

    def init_weights(self, generator: torch.Generator) -> "ResNet":
        return lecun_init_(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        x = torch.relu(self.BatchNorm_0(conv(self.Conv_0, x)))
        x = F.max_pool2d(x, 3, 2, padding=1)
        for i in range(self.n_blocks):
            x = getattr(self, f"BasicBlock_{i}")(x)
        x = x.float().mean(dim=(2, 3)).to(self.dtype)
        return dense(self.head, x).float()


def resnet18(num_classes: int, dtype: torch.dtype = torch.bfloat16,
             device=None) -> ResNet:
    return ResNet((2, 2, 2, 2), num_classes=num_classes, dtype=dtype,
                  device=device)
