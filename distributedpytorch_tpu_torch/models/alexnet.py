"""AlexNet (ref utils.py:51-58 wraps torchvision alexnet).

Counterpart of ``distributedpytorch_tpu/models/alexnet.py`` (:19-44): five
convs with the explicit paddings (2, 2) and (1, 1), three VALID 3x3/2 max
pools, the adaptive 6x6 pool, then dropout-4096-dropout-4096 and the
``head``.  Layer names are flax's (``Conv_0`` .. ``Conv_4``, ``Dense_0``,
``Dense_1``, ``head``), so a JAX params tree converts key by key.  Input
NHWC, convs on its channels_last NCHW view; the features are flattened in
NHWC order before ``Dense_0``, as the JAX model flattens them, so its rows
need no permutation.  Logits f32.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .common import adaptive_avg_pool
from .layers import Dropout, conv, dense, lecun_init_

# (in, out, kernel, stride, padding) of Conv_0 .. Conv_4; a max pool
# follows Conv_0, Conv_1 and Conv_4
_CONVS = ((3, 64, 11, 4, 2), (64, 192, 5, 1, 2), (192, 384, 3, 1, 1),
          (384, 256, 3, 1, 1), (256, 256, 3, 1, 1))
_POOL_AFTER = (0, 1, 4)


class AlexNet(nn.Module):
    def __init__(self, num_classes: int = 10,
                 dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        self.dtype = dtype
        for i, (ci, co, k, s, p) in enumerate(_CONVS):
            self.add_module(f"Conv_{i}", nn.Conv2d(ci, co, k, s, padding=p,
                                                   device=device))
        self.Dropout_0 = Dropout(0.5)
        self.Dense_0 = nn.Linear(256 * 6 * 6, 4096, device=device)
        self.Dropout_1 = Dropout(0.5)
        self.Dense_1 = nn.Linear(4096, 4096, device=device)
        self.head = nn.Linear(4096, num_classes, device=device)

    def init_weights(self, generator: torch.Generator) -> "AlexNet":
        return lecun_init_(self, generator)

    @staticmethod
    def dropout_shapes(input_size: int) -> List[Tuple[int, ...]]:
        """A row's shape at each dropout, in the JAX layout."""
        return [(256 * 6 * 6,), (4096,)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        for i in range(len(_CONVS)):
            x = torch.relu(conv(getattr(self, f"Conv_{i}"), x))
            if i in _POOL_AFTER:
                x = F.max_pool2d(x, 3, 2)
        x = adaptive_avg_pool(x, 6)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = self.Dropout_0(x)
        x = torch.relu(dense(self.Dense_0, x))
        x = self.Dropout_1(x)
        x = torch.relu(dense(self.Dense_1, x))
        return dense(self.head, x).float()
