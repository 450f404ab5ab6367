"""Inception v3 with auxiliary logits (ref utils.py:87-99).

Counterpart of ``distributedpytorch_tpu/models/inception.py``:
``BasicConv`` (a bias-free conv,
BatchNorm with eps 1e-3, ReLU) stem, ``InceptionA_0`` .. ``2``,
``InceptionB_0``, ``InceptionC_0`` .. ``3``, ``InceptionD_0``,
``InceptionE_0`` .. ``1``, a global mean, dropout and the ``head``; in
train mode ``AuxHead_0`` branches off after ``InceptionC_3`` and the
forward returns ``(logits, aux_logits)``, which the engine takes as
``loss1 + 0.4 * loss2`` (ref classif.py:49-53).  The eval-mode forward
returns the logits alone.  Input 299x299 (ref utils.py:89).

Layer names are flax's: a block's ``BasicConv_i`` are numbered in the
order the JAX block creates them, which is the order of torchvision's
branches, each holding ``Conv_0`` and ``BatchNorm_0``; the aux classifier
is ``AuxHead_0.aux_head``.  The 3x3/1 average pools of the blocks count
the padding (flax's ``avg_pool`` and torch's default), the asymmetric
kernels are (1, 7)/(7, 1) and (1, 3)/(3, 1).  Input NHWC, convs on its
channels_last NCHW view (an f32 input on the card is made contiguous
NCHW first), BatchNorm with flax's semantics and global statistics.
Logits f32.  ``remat_blocks`` (``--remat blocks``, set by the registry)
checkpoints each Mixed block (``InceptionA_0`` .. ``InceptionE_1``) on
the gradient path, keeping its matmul outputs (``models/remat.py``); the
stem and the aux head stay outside, as in the JAX model.
``scan_layers`` (``--scan-layers``) holds ``InceptionC_1`` and
``InceptionC_2`` (768 channels in and out, c7 = 160) as
``InceptionCScan_0``, a ``models/scan.py`` ``ScanRun`` of 2 stacked
steps (each checkpointed under ``--remat blocks``); ``AuxHead_0`` still
branches after ``InceptionC_3``.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from . import remat
from .common import adaptive_avg_pool, global_mean
from .layers import Dropout, conv, dense, lecun_init_
from .norm import BatchNorm
from .scan import ScanRun

_H7, _V7 = ((1, 7), (0, 3)), ((7, 1), (3, 0))     # (kernel, padding)
_H3, _V3 = ((1, 3), (0, 1)), ((3, 1), (1, 0))


class BasicConv(nn.Module):
    def __init__(self, in_channels: int, filters: int, kernel, stride=1,
                 padding=0, device=None):
        super().__init__()
        self.Conv_0 = nn.Conv2d(in_channels, filters, kernel, stride,
                                padding=padding, bias=False, device=device)
        self.BatchNorm_0 = BatchNorm(filters, eps=1e-3, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.BatchNorm_0(conv(self.Conv_0, x)))


def _avg_pool_same(x: torch.Tensor) -> torch.Tensor:
    return F.avg_pool2d(x, 3, 1, padding=1)


class _Block(nn.Module):
    """A block of ``BasicConv_0`` .. ``BasicConv_{n-1}``, each made from
    (input, filters, kernel, stride, padding): input "x" takes the block's
    channels, None the previous conv's filters."""

    def __init__(self, in_channels: int, specs: Sequence[tuple],
                 device=None):
        super().__init__()
        prev = in_channels
        for i, (cin, filters, kernel, stride, padding) in enumerate(specs):
            self.add_module(f"BasicConv_{i}", BasicConv(
                in_channels if cin == "x" else prev, filters, kernel,
                stride, padding, device=device))
            prev = filters

    def c(self, i: int, x: torch.Tensor) -> torch.Tensor:
        return getattr(self, f"BasicConv_{i}")(x)


class InceptionA(_Block):
    def __init__(self, in_channels: int, pool_features: int, device=None):
        super().__init__(in_channels, (
            ("x", 64, 1, 1, 0), ("x", 48, 1, 1, 0), (None, 64, 5, 1, 2),
            ("x", 64, 1, 1, 0), (None, 96, 3, 1, 1), (None, 96, 3, 1, 1),
            ("x", pool_features, 1, 1, 0)), device)
        self.out_channels = 64 + 64 + 96 + pool_features

    def forward(self, x):
        return torch.cat([self.c(0, x), self.c(2, self.c(1, x)),
                          self.c(5, self.c(4, self.c(3, x))),
                          self.c(6, _avg_pool_same(x))], dim=1)


class InceptionB(_Block):
    def __init__(self, in_channels: int, device=None):
        super().__init__(in_channels, (
            ("x", 384, 3, 2, 0), ("x", 64, 1, 1, 0), (None, 96, 3, 1, 1),
            (None, 96, 3, 2, 0)), device)
        self.out_channels = 384 + 96 + in_channels

    def forward(self, x):
        return torch.cat([self.c(0, x), self.c(3, self.c(2, self.c(1, x))),
                          F.max_pool2d(x, 3, 2)], dim=1)


class InceptionC(_Block):
    def __init__(self, in_channels: int, channels_7x7: int, device=None):
        c7 = channels_7x7
        super().__init__(in_channels, (
            ("x", 192, 1, 1, 0), ("x", c7, 1, 1, 0),
            (None, c7, _H7[0], 1, _H7[1]), (None, 192, _V7[0], 1, _V7[1]),
            ("x", c7, 1, 1, 0), (None, c7, _V7[0], 1, _V7[1]),
            (None, c7, _H7[0], 1, _H7[1]),
            (None, c7, _V7[0], 1, _V7[1]), (None, 192, _H7[0], 1, _H7[1]),
            ("x", 192, 1, 1, 0)), device)
        self.out_channels = 4 * 192

    def forward(self, x):
        b7 = self.c(3, self.c(2, self.c(1, x)))
        bd = self.c(4, x)
        for i in (5, 6, 7, 8):
            bd = self.c(i, bd)
        return torch.cat([self.c(0, x), b7, bd,
                          self.c(9, _avg_pool_same(x))], dim=1)


class InceptionD(_Block):
    def __init__(self, in_channels: int, device=None):
        super().__init__(in_channels, (
            ("x", 192, 1, 1, 0), (None, 320, 3, 2, 0), ("x", 192, 1, 1, 0),
            (None, 192, _H7[0], 1, _H7[1]), (None, 192, _V7[0], 1, _V7[1]),
            (None, 192, 3, 2, 0)), device)
        self.out_channels = 320 + 192 + in_channels

    def forward(self, x):
        b7 = self.c(2, x)
        for i in (3, 4, 5):
            b7 = self.c(i, b7)
        return torch.cat([self.c(1, self.c(0, x)), b7,
                          F.max_pool2d(x, 3, 2)], dim=1)


class InceptionE(_Block):
    def __init__(self, in_channels: int, device=None):
        super().__init__(in_channels, (
            ("x", 320, 1, 1, 0), ("x", 384, 1, 1, 0),
            (None, 384, _H3[0], 1, _H3[1]), (None, 384, _V3[0], 1, _V3[1]),
            ("x", 448, 1, 1, 0), (None, 384, 3, 1, 1),
            (None, 384, _H3[0], 1, _H3[1]), (None, 384, _V3[0], 1, _V3[1]),
            ("x", 192, 1, 1, 0)), device)
        self.out_channels = 320 + 768 + 768 + 192

    def forward(self, x):
        b3 = self.c(1, x)
        bd = self.c(5, self.c(4, x))
        return torch.cat([self.c(0, x), self.c(2, b3), self.c(3, b3),
                          self.c(6, bd), self.c(7, bd),
                          self.c(8, _avg_pool_same(x))], dim=1)


class AuxHead(_Block):
    def __init__(self, in_channels: int, num_classes: int, device=None):
        super().__init__(in_channels, (("x", 128, 1, 1, 0),
                                       (None, 768, 5, 1, 0)), device)
        self.aux_head = nn.Linear(768, num_classes, device=device)

    def forward(self, x):
        if x.shape[2] < 17 or x.shape[3] < 17:
            raise ValueError(
                f"inception aux head needs a >=17x17 feature map, which "
                f"requires >=299px inputs; got a {x.shape[2]}x{x.shape[3]} "
                f"map — use 299x299 inputs for train mode")
        x = self.c(1, self.c(0, F.avg_pool2d(x, 5, 3)))
        x = adaptive_avg_pool(x, 1).reshape(x.shape[0], -1)
        return dense(self.aux_head, x)


class InceptionV3(_Block):
    def __init__(self, num_classes: int = 10,
                 dtype: torch.dtype = torch.bfloat16,
                 scan_layers: bool = False, device=None):
        super().__init__(3, (
            ("x", 32, 3, 2, 0), (None, 32, 3, 1, 0), (None, 64, 3, 1, 1),
            (None, 80, 1, 1, 0), (None, 192, 3, 1, 0)), device)
        self.dtype = dtype
        self.remat_blocks = False
        blocks = [("InceptionA_0", InceptionA, (32,)),
                  ("InceptionA_1", InceptionA, (64,)),
                  ("InceptionA_2", InceptionA, (64,)),
                  ("InceptionB_0", InceptionB, ())]
        blocks += [(f"InceptionC_{i}", InceptionC, (c7,))
                   for i, c7 in enumerate((128, 160, 160, 192))]
        blocks += [("InceptionD_0", InceptionD, ()),
                   ("InceptionE_0", InceptionE, ()),
                   ("InceptionE_1", InceptionE, ())]
        if scan_layers:
            # JAX inception.py:212-217: InceptionC_1 and _2 as one run
            blocks[5:7] = [("InceptionCScan_0", InceptionC, (160,))]
        channels = 192
        for name, cls, args in blocks:
            block = cls(channels, *args, device=device)
            channels = block.out_channels
            if name == "InceptionCScan_0":
                block = ScanRun(block, 2)
            self.add_module(name, block)
            if name == "InceptionC_3":
                self.AuxHead_0 = AuxHead(channels, num_classes,
                                         device=device)
        self.block_names = [name for name, _, _ in blocks]
        self.Dropout_0 = Dropout(0.5)
        self.head = nn.Linear(channels, num_classes, device=device)

    def init_weights(self, generator: torch.Generator) -> "InceptionV3":
        return lecun_init_(self, generator)

    @staticmethod
    def dropout_shapes(input_size: int) -> List[Tuple[int, ...]]:
        """A row's shape at the dropout, in the JAX layout."""
        return [(2048,)]

    def forward(self, x: torch.Tensor
                ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        if x.is_cuda and x.dtype == torch.float32:
            # cuDNN's f32 convolutions of the channels_last view put the
            # step's gradients 5x the CPU's rounding distance from f64;
            # of a contiguous NCHW input they meet it (ROADMAP queue 3
            # entry 10)
            x = x.contiguous()
        x = self.c(2, self.c(1, self.c(0, x)))
        x = F.max_pool2d(x, 3, 2)
        x = F.max_pool2d(self.c(4, self.c(3, x)), 3, 2)
        aux = None
        for name in self.block_names:
            if name == "InceptionCScan_0":
                x = self.InceptionCScan_0(
                    x, checkpoint=self.remat_blocks and remat.active(self))
            else:
                x = remat.run_block(self, getattr(self, name), x)
            if name == "InceptionC_3" and self.training:
                aux = self.AuxHead_0(x)
        x = self.Dropout_0(global_mean(x))
        x = dense(self.head, x).float()
        if self.training:
            return x, aux.float()
        return x
