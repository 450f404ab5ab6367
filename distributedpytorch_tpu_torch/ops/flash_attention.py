"""Flash attention forward: kernel K1, hand-written in CUDA for Hopper.

Counterpart of ``distributedpytorch_tpu/ops/flash_attention.py``
(``flash_attention`` -> ``_flash`` -> ``_flash_fwd`` -> the Pallas
``_fwd_kernel``, use_pos=False).  The kernel is ``csrc/flash_fwd.cu``;
``flash_attention_plain`` below repeats its blockwise math in PyTorch ops.

``flash_attention_fwd`` is the wrapper.  For a tensor on the CPU it runs
the plain version; for a CUDA tensor it launches the kernel or raises —
there is no fallback.  Public layout is the JAX package's: q, k, v and the
output are (B, S, H, D); the log-sum-exp comes back as (B*H, S) float32
for the backward kernels of a later slice.

Unlike the JAX wrapper, nothing is moved to (B*H, S, D) and S is not padded
to a block multiple: the kernel reads the (B, S, H, D) strides directly and
masks the ragged tail itself.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from . import build

# Key-tile rows of the plain version.  The kernel's tile is 64 rows at
# D <= 64 and 32 at D = 128; in f32 the tile only sets the order of sums.
BLOCK_K = 64
_NEG = -1e30          # finite masked-score sentinel, as in the TPU kernel
HEAD_DIMS = (32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_INT_MAX = 2 ** 31 - 1


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = False
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in PyTorch ops: online softmax over key tiles
    of ``BLOCK_K`` rows, f32 throughout, O cast to the input dtype.
    (B, S, H, D) q/k/v -> (o (B, S, H, D), lse (B*H, S) f32)."""
    b, s, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    qf = q.permute(0, 2, 1, 3).float() * scale          # (b, h, s, d)
    kf = k.permute(0, 2, 1, 3).float()
    vf = v.permute(0, 2, 1, 3).float()
    acc = torch.zeros((b, h, s, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, s, 1), _NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, s, 1), dtype=torch.float32, device=q.device)
    rows = torch.arange(s, device=q.device)[:, None]
    for k0 in range(0, s, BLOCK_K):
        kb = kf[:, :, k0:k0 + BLOCK_K]
        vb = vf[:, :, k0:k0 + BLOCK_K]
        sc = qf @ kb.transpose(-1, -2)                   # (b, h, s, bk)
        mask = None
        if causal:
            cols = torch.arange(k0, k0 + kb.shape[2], device=q.device)
            mask = cols[None, :] <= rows
            sc = torch.where(mask, sc, _NEG)
        m_new = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
        p = torch.exp(sc - m_new)
        if mask is not None:
            p = torch.where(mask, p, 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + p @ vb
        m = m_new
    l_safe = torch.clamp_min(l, 1e-30)
    o = (acc / l_safe).to(q.dtype).permute(0, 2, 1, 3).contiguous()
    lse = (m + torch.log(l_safe)).reshape(b * h, s)
    return o, lse


def _kernel_fn():
    lib = build.load("flash_fwd")
    fn = lib.dpt_flash_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 13
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"flash attention takes q, k, v of one (B, S, H, D) "
                         f"shape, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v devices differ: {q.device}, {k.device}, "
                         f"{v.device}")


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    b, s, h, d = q.shape
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"flash_fwd kernel takes float32 or bfloat16, "
                         f"got {q.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_fwd kernel takes head dim in {HEAD_DIMS}, "
                         f"got {d}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(3) != 1:
            raise ValueError(f"flash_fwd kernel needs the head dim of {name} "
                             f"contiguous, got strides {x.stride()}")
        if max(x.stride()) > _INT_MAX:
            raise ValueError(f"{name} strides {x.stride()} exceed int32")
    if b * h > 65535 or b * s * h * d > _INT_MAX:
        raise ValueError(f"flash_fwd kernel grid too large for {tuple(q.shape)}")
    o = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b * h, s), dtype=torch.float32, device=q.device)
    if s == 0 or b * h == 0:
        return o, lse
    fn = _kernel_fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                lse.data_ptr(), b, s, h, d,
                q.stride(0), q.stride(1), q.stride(2),
                k.stride(0), k.stride(1), k.stride(2),
                v.stride(0), v.stride(1), v.stride(2),
                1.0 / math.sqrt(d), int(bool(causal)),
                _DTYPE_CODES[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: CUDA error {rc} "
                           f"at q {tuple(q.shape)} {q.dtype}")
    flash_attention_fwd.launches += 1
    return o, lse


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, S, H, D) q/k/v -> (o, lse).  CPU tensors take the plain
    version; CUDA tensors launch the kernel (and count the launch in
    ``flash_attention_fwd.launches``) or raise."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cuda or cpu tensors, "
                         f"got {q.device}")
    return _launch(q, k, v, causal)


flash_attention_fwd.launches = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False) -> torch.Tensor:
    """Flash attention; q/k/v (B, S, H, D) -> (B, S, H, D), the same
    function as ``ops.attention.full_attention`` to float tolerance."""
    return flash_attention_fwd(q, k, v, causal)[0]
