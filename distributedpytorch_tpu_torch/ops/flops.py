"""Model FLOPs for the MFU gauge, and the card's peaks.

Counterpart of ``distributedpytorch_tpu/ops/flops.py``: the train step's
model FLOPs are 3 x one eval forward (the backward costs about twice the
forward), per sample, counted at batch 8 (JAX ``train_flops_per_sample``,
:106-120), and the matmul/conv convention is the same: 2 x the
multiply-adds of every matmul and convolution, nothing else.  The count
is taken with ``torch.utils.flop_counter.FlopCounterMode`` over a
forward on the meta device (no memory, no kernel: the counterpart of
JAX's abstract trace), of the model's ``attention="full"`` form.  That
form is the model's FLOPs whatever kernel computes its attention: the
counter sees aten ops only, and the flash kernels run through ``ctypes``
(invisible to it on the card, their plain version counted on the CPU).
The JAX count of the flash vit steps into the ``pallas_call``'s one-block
body and so undercounts the flash model's attention; this count does not
copy that.

Peaks: keyed on ``torch.cuda.get_device_name()``, the H100's dense
datasheet rates per type (``peak_flops``) and its memory rate
(``peak_membw``); an unknown card or the CPU gives None, and the MFU
gauge is then written as a recorded null.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

# NVIDIA H100 Tensor Core GPU datasheet, dense (no sparsity) peak FLOP/s
# per type and HBM bytes/s, by a lowercased substring of the device name
# (torch.cuda.get_device_name): the SXM5 card reports "NVIDIA H100 80GB
# HBM3", the PCIe card "NVIDIA H100 PCIe".  The PCIe row comes first: its
# name holds no "hbm3", but keep the more specific key ahead.
PEAK_FLOPS = [
    ("h100 pcie", {"bf16": 756.5e12, "f16": 756.5e12, "tf32": 378e12,
                   "f32": 51.2e12}),
    ("h100 80gb hbm3", {"bf16": 989.4e12, "f16": 989.4e12,
                        "tf32": 494.7e12, "f32": 66.9e12}),
    ("h100 sxm", {"bf16": 989.4e12, "f16": 989.4e12, "tf32": 494.7e12,
                  "f32": 66.9e12}),
]
PEAK_HBM_BYTES = [
    ("h100 pcie", 2.0e12),
    ("h100 80gb hbm3", 3.35e12),
    ("h100 sxm", 3.35e12),
]

_DTYPE_LABELS = {
    "bfloat16": "bf16", "float32": "f32", "float16": "f16",
    "bf16": "bf16", "f32": "f32", "f16": "f16", "tf32": "tf32",
}

FLOP_COUNT_BATCH = 8        # the JAX engine's count batch (engine.py:178)


def dtype_label(dtype) -> str:
    """Short label ('bf16'/'f32'/'f16'/'tf32') of a torch dtype or a
    label; unknown names come back lowercased."""
    if isinstance(dtype, torch.dtype):
        name = str(dtype).replace("torch.", "")
    else:
        name = str(dtype)
    return _DTYPE_LABELS.get(name.lower(), name.lower())


def compute_peak_label(dtype) -> str:
    """The peak an MFU of a run computing in ``dtype`` divides by: its
    own label, but an f32 run whose matmuls or convolutions may take TF32
    (``torch.backends.cuda.matmul.allow_tf32`` or
    ``torch.backends.cudnn.allow_tf32``, the latter on by PyTorch's
    default) divides by the TF32 peak, the larger one, so the MFU is
    never inflated by a denominator below the rate the card may run."""
    label = dtype_label(dtype)
    if label == "f32" and (torch.backends.cuda.matmul.allow_tf32
                           or torch.backends.cudnn.allow_tf32):
        return "tf32"
    return label


def _lookup(table, device_kind):
    if not device_kind:
        return None
    kind = str(device_kind).lower()
    for key, value in table:
        if key in kind:
            return value
    return None


def peak_flops(device_kind, dtype="bf16") -> Optional[float]:
    """Dense peak FLOP/s of the card named ``device_kind`` at ``dtype``
    (a label or a torch dtype); None for an unknown card or type."""
    peaks = _lookup(PEAK_FLOPS, device_kind)
    return None if peaks is None else peaks.get(dtype_label(dtype))


def peak_membw(device_kind) -> Optional[float]:
    """Peak HBM bytes/s of the card named ``device_kind``; None when
    unknown (the CPU)."""
    return _lookup(PEAK_HBM_BYTES, device_kind)


def device_kind(device) -> Optional[str]:
    """``torch.cuda.get_device_name`` of a CUDA device, else None."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return torch.cuda.get_device_name(device)


def forward_flops(model: torch.nn.Module, batch: int,
                  input_size: int) -> float:
    """FLOPs of one eval forward of ``model`` (built on the meta device)
    at ``batch`` NHWC images of ``input_size``."""
    from torch.utils.flop_counter import FlopCounterMode

    x = torch.zeros((batch, input_size, input_size, 3), device="meta")
    model.eval()
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        model(x)
    return float(counter.get_total_flops())


def train_flops_per_sample(name: str, num_classes: int,
                           batch: int = FLOP_COUNT_BATCH,
                           moe_experts: int = 0) -> float:
    """Model FLOPs of one training step per sample, 3 x forward / batch,
    of the registry's model ``name`` in its ``attention="full"`` form
    (with ``moe_experts``, the MoE vit's: its router, dispatch, expert
    and combine products, as JAX counts them)."""
    from ..models.registry import get_model, get_model_input_size
    from ..precision import from_flags

    model = get_model(name, num_classes, from_flags("f32", False),
                      attention="full", device="meta",
                      moe_experts=moe_experts)
    return 3.0 * forward_flops(model, batch,
                               get_model_input_size(name)) / batch


def human_flops(flops: float) -> str:
    if flops <= 0:
        return "0"
    exp = min(int(math.log10(flops)) // 3, 6)
    unit = ["", "K", "M", "G", "T", "P", "E"][exp]
    return f"{flops / 10 ** (3 * exp):.2f} {unit}FLOP"
