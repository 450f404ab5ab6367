"""DenseNet-121 (ref utils.py:78-85 wraps torchvision densenet121).

Counterpart of ``distributedpytorch_tpu/models/densenet.py`` (:17-103):
growth rate 32, blocks (6, 12,
24, 16), bn_size 4; a 7x7/2 stem with BatchNorm and a 3x3/2 max pool
padded with -inf; each ``DenseLayer`` is BN-ReLU-1x1 conv-BN-ReLU-3x3 conv
concatenated after its input; each transition is BN, ReLU, a 1x1 conv to
half the channels and a 2x2/2 average pool; then BN, ReLU, a global mean
and the ``head``.  Layer names are flax's: ``DenseLayer_0`` ..
``DenseLayer_57`` numbered across the blocks, the stem's ``Conv_0`` /
``BatchNorm_0``, the transitions' ``BatchNorm_1`` .. ``3`` / ``Conv_1`` ..
``3`` and the last norm ``BatchNorm_4``.  Input NHWC, convs on its
channels_last NCHW view, BatchNorm with flax's semantics and global
statistics.  Logits f32.  ``remat_blocks`` (``--remat blocks``, set by
the registry) checkpoints each ``DenseLayer`` on the gradient path,
keeping its matmul outputs (``models/remat.py``).  ``scan_layers``
(``--scan-layers``) holds each dense block's layers as
``DenseBlockScan_{b}``, a ``models/scan.py`` ``DenseBlockScan`` over a
zero-padded channel buffer (its steps checkpointed under ``--remat
blocks``); the stem, the transitions and the head keep their names.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from . import remat
from .common import global_mean
from .layers import conv, dense, lecun_init_
from .norm import BatchNorm
from .scan import DenseBlockScan


class DenseLayer(nn.Module):
    def __init__(self, in_channels: int, growth: int, bn_size: int,
                 device=None):
        super().__init__()
        width = bn_size * growth
        self.BatchNorm_0 = BatchNorm(in_channels, device=device)
        self.Conv_0 = nn.Conv2d(in_channels, width, 1, bias=False,
                                device=device)
        self.BatchNorm_1 = BatchNorm(width, device=device)
        self.Conv_1 = nn.Conv2d(width, growth, 3, padding=1, bias=False,
                                device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = conv(self.Conv_0, torch.relu(self.BatchNorm_0(x)))
        y = conv(self.Conv_1, torch.relu(self.BatchNorm_1(y)))
        return torch.cat([x, y], dim=1)


class DenseNet(nn.Module):
    def __init__(self, block_config: Sequence[int] = (6, 12, 24, 16),
                 growth: int = 32, bn_size: int = 4,
                 num_init_features: int = 64, num_classes: int = 10,
                 dtype: torch.dtype = torch.bfloat16,
                 scan_layers: bool = False, device=None):
        super().__init__()
        self.dtype = dtype
        self.remat_blocks = False
        self.scan_layers = scan_layers
        self.block_config = tuple(block_config)
        self.Conv_0 = nn.Conv2d(3, num_init_features, 7, 2, padding=3,
                                bias=False, device=device)
        self.BatchNorm_0 = BatchNorm(num_init_features, device=device)
        channels, layer = num_init_features, 0
        for i, n_layers in enumerate(self.block_config):
            if scan_layers:
                self.add_module(f"DenseBlockScan_{i}", DenseBlockScan(
                    n_layers, channels, growth, bn_size, device=device))
                channels += n_layers * growth
            for _ in range(0 if scan_layers else n_layers):
                self.add_module(f"DenseLayer_{layer}", DenseLayer(
                    channels, growth, bn_size, device=device))
                channels, layer = channels + growth, layer + 1
            if i != len(self.block_config) - 1:
                self.add_module(f"BatchNorm_{i + 1}",
                                BatchNorm(channels, device=device))
                self.add_module(f"Conv_{i + 1}", nn.Conv2d(
                    channels, channels // 2, 1, bias=False, device=device))
                channels //= 2
        self.add_module(f"BatchNorm_{len(self.block_config)}",
                        BatchNorm(channels, device=device))
        self.head = nn.Linear(channels, num_classes, device=device)

    def init_weights(self, generator: torch.Generator) -> "DenseNet":
        return lecun_init_(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        x = torch.relu(self.BatchNorm_0(conv(self.Conv_0, x)))
        x = F.max_pool2d(x, 3, 2, padding=1)
        layer = 0
        for i, n_layers in enumerate(self.block_config):
            if self.scan_layers:
                x = getattr(self, f"DenseBlockScan_{i}")(
                    x, checkpoint=self.remat_blocks and remat.active(self))
            for _ in range(0 if self.scan_layers else n_layers):
                x = remat.run_block(self, getattr(
                    self, f"DenseLayer_{layer}"), x)
                layer += 1
            if i != len(self.block_config) - 1:
                x = torch.relu(getattr(self, f"BatchNorm_{i + 1}")(x))
                x = F.avg_pool2d(conv(getattr(self, f"Conv_{i + 1}"), x), 2)
        last_norm = getattr(self, f"BatchNorm_{len(self.block_config)}")
        x = torch.relu(last_norm(x))
        return dense(self.head, global_mean(x)).float()


def densenet121(num_classes: int, dtype: torch.dtype = torch.bfloat16,
                scan_layers: bool = False, device=None) -> DenseNet:
    return DenseNet(num_classes=num_classes, dtype=dtype,
                    scan_layers=scan_layers, device=device)
