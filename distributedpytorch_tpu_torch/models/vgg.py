"""VGG11 with BatchNorm (ref utils.py:60-67 wraps torchvision vgg11_bn).

Counterpart of ``distributedpytorch_tpu/models/vgg.py`` (:21-68): config
'A', each 3x3 SAME conv followed by BatchNorm
and ReLU (the conv bias stays on, as torchvision's ``make_layers`` leaves
it, for state_dict parity), ``max_pool_2x2`` at each 'M', the adaptive
7x7 pool, then 4096-dropout-4096-dropout and the ``head``.  Layer names
are flax's (``Conv_0`` .. ``Conv_7``, ``BatchNorm_0`` .. ``BatchNorm_7``,
``Dense_0``, ``Dense_1``, ``head``).  Input NHWC, convs on its
channels_last NCHW view, features flattened in NHWC order, BatchNorm with
flax's semantics and global statistics.  Logits f32.  ``scan_layers``
(``--scan-layers``) holds the trailing 512->512 pair (``Conv_6``,
``Conv_7`` and their norms) as ``ConvScan_0``, a ``models/scan.py``
``VGGScan`` of 2 stacked steps; the other layers keep their names.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
from torch import nn

from ..ops.pooling import max_pool_2x2
from .common import adaptive_avg_pool
from .layers import Dropout, conv, dense, lecun_init_
from .norm import BatchNorm
from .scan import VGGScan

_VGG11 = (64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M")
# the scanned run within _VGG11's convs: its first index and its length
# (JAX VGG11BN._SCAN_START, _SCAN_LEN)
_SCAN_START, _SCAN_LEN = 6, 2


class VGG11BN(nn.Module):
    def __init__(self, num_classes: int = 10,
                 dtype: torch.dtype = torch.bfloat16,
                 scan_layers: bool = False, device=None):
        super().__init__()
        self.dtype = dtype
        self.scan_layers = scan_layers
        i, channels = 0, 3
        for v in _VGG11:
            if v == "M":
                continue
            if scan_layers and i == _SCAN_START:
                self.ConvScan_0 = VGGScan(_SCAN_LEN, v, device=device)
            elif not self._scanned(i):
                self.add_module(f"Conv_{i}", nn.Conv2d(
                    channels, v, 3, padding=1, device=device))
                self.add_module(f"BatchNorm_{i}", BatchNorm(v,
                                                            device=device))
            i, channels = i + 1, v
        self.Dense_0 = nn.Linear(512 * 7 * 7, 4096, device=device)
        self.Dropout_0 = Dropout(0.5)
        self.Dense_1 = nn.Linear(4096, 4096, device=device)
        self.Dropout_1 = Dropout(0.5)
        self.head = nn.Linear(4096, num_classes, device=device)

    def _scanned(self, i: int) -> bool:
        """Whether conv ``i`` is a step of ``ConvScan_0``."""
        return self.scan_layers and \
            _SCAN_START <= i < _SCAN_START + _SCAN_LEN

    def init_weights(self, generator: torch.Generator) -> "VGG11BN":
        return lecun_init_(self, generator)

    @staticmethod
    def dropout_shapes(input_size: int) -> List[Tuple[int, ...]]:
        """A row's shape at each dropout, in the JAX layout."""
        return [(4096,), (4096,)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        i = 0
        for v in _VGG11:
            if v == "M":
                x = max_pool_2x2(x)
                continue
            if self.scan_layers and i == _SCAN_START:
                x = self.ConvScan_0(x)
            elif not self._scanned(i):
                x = conv(getattr(self, f"Conv_{i}"), x)
                x = torch.relu(getattr(self, f"BatchNorm_{i}")(x))
            i += 1
        x = adaptive_avg_pool(x, 7)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = self.Dropout_0(torch.relu(dense(self.Dense_0, x)))
        x = self.Dropout_1(torch.relu(dense(self.Dense_1, x)))
        return dense(self.head, x).float()
