"""2x2 / stride-2 max pooling with the gradient on the first maximum.

Counterpart of ``distributedpytorch_tpu/ops/pooling.py::max_pool_2x2``
(:35-70), whose custom VJP routes each window's gradient to its FIRST
maximal element in row-major window order, as select-and-scatter and
torch's ``MaxPool2d`` do.  ``F.max_pool2d`` keeps the first maximum it
meets (a strictly greater value replaces it) on the CPU and on CUDA, so
the port calls it; the tie cases are pinned against the JAX op in
``tests/test_torch_cnn.py`` and on the card in chip_smoke.py.  The layout
is torch's: (B, C, H, W), any memory format.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, H/2, W/2); H and W must be even."""
    h, w = x.shape[-2:]
    if h % 2 or w % 2:
        raise ValueError(f"max_pool_2x2 needs even H/W, got {h}x{w}")
    return F.max_pool2d(x, 2, 2)
