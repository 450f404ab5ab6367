"""Flash attention: kernels K1 (forward), K2 and K3 (backward),
hand-written in CUDA for Hopper.

Counterpart of ``distributedpytorch_tpu/ops/flash_attention.py``
(``flash_attention`` -> the ``jax.custom_vjp`` ``_flash``, whose forward
``_flash_fwd`` runs the Pallas ``_fwd_kernel`` and whose backward
``_flash_bwd_impl`` runs ``_dq_kernel`` and ``_dkv_kernel``, use_pos=False).
The kernels are ``csrc/flash_fwd.cu`` (K1) and ``csrc/flash_bwd.cu`` (K2,
K3); ``flash_attention_plain`` and ``flash_attention_bwd_plain`` below
repeat their blockwise math in PyTorch ops.

``flash_attention_fwd``, ``flash_attention_dq`` and ``flash_attention_dkv``
are the kernels' wrappers.  For tensors on the CPU they run the plain
version; for CUDA tensors they launch the kernel (and count the launch) or
raise — there is no fallback.  ``FlashAttention`` is the autograd Function:
its forward is K1 and saves q, k, v, o and lse, its backward is K2 and K3.
Public layout is the JAX package's: q, k, v, the output and its gradient
are (B, S, H, D); the log-sum-exp is (B*H, S) float32.

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


# -- backward: K2 (dq) and K3 (dk, dv) ------------------------------------

def attention_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * O) in f32, from O as stored: (B, S, H, D) ->
    (B*H, S).  A torch op, as in the JAX package (``_flash_bwd_impl``
    computes it outside any Pallas kernel)."""
    b, s, h, _ = o.shape
    rows = (do.float() * o.float()).sum(dim=-1)          # (b, s, h)
    return rows.permute(0, 2, 1).reshape(b * h, s).contiguous()


def _bwd_blocks(q, k, v, do, lse, delta, causal
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernels' function in PyTorch ops: scores recomputed
    per key tile of ``BLOCK_K`` rows as (q . k) * scale (q not pre-scaled),
    p = exp(s - lse), ds = p * (dO V^T - delta), masked p and ds forced to
    0, f32 throughout, dq and dk scaled once at the end."""
    b, s, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    qf, kf, vf, dof = (x.permute(0, 2, 1, 3).float() for x in (q, k, v, do))
    lse4 = lse.reshape(b, h, s, 1)
    delta4 = delta.reshape(b, h, s, 1)
    dq = torch.zeros((b, h, s, d), dtype=torch.float32, device=q.device)
    dk = torch.zeros_like(dq)
    dv = torch.zeros_like(dq)
    rows = torch.arange(s, device=q.device)[:, None]
    for k0 in range(0, s, BLOCK_K):
        kb = kf[:, :, k0:k0 + BLOCK_K]
        vb = vf[:, :, k0:k0 + BLOCK_K]
        sc = (qf @ kb.transpose(-1, -2)) * scale          # (b, h, s, bk)
        mask = None
        if causal:
            cols = torch.arange(k0, k0 + kb.shape[2], device=q.device)
            mask = cols[None, :] <= rows
            sc = torch.where(mask, sc, _NEG)
        p = torch.exp(sc - lse4)
        dp = dof @ vb.transpose(-1, -2)
        ds = p * (dp - delta4)
        if mask is not None:
            p = torch.where(mask, p, 0.0)
            ds = torch.where(mask, ds, 0.0)
        dq += ds @ kb
        dk[:, :, k0:k0 + BLOCK_K] = ds.transpose(-1, -2) @ qf
        dv[:, :, k0:k0 + BLOCK_K] = p.transpose(-1, -2) @ dof

    def out(x, like):
        return x.to(like.dtype).permute(0, 2, 1, 3).contiguous()

    return out(dq * scale, q), out(dk * scale, k), out(dv, v)


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, o: torch.Tensor,
                              lse: torch.Tensor, do: torch.Tensor,
                              causal: bool = False
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """K2 and K3 in PyTorch ops: (B, S, H, D) q, k, v, o, dO and the
    (B*H, S) lse of the forward -> (dq, dk, dv) in the inputs' dtypes."""
    return _bwd_blocks(q, k, v, do, lse, attention_delta(o, do), causal)


def _bwd_kernel_fn(name: str):
    fn = getattr(build.load("flash_bwd"), name)
    if fn.argtypes is None:
        n_out = 1 if name == "dpt_flash_dq" else 2
        fn.argtypes = ([ctypes.c_void_p] * (6 + n_out) + [ctypes.c_int] * 4
                       + [ctypes.POINTER(ctypes.c_int), ctypes.c_float,
                          ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check_bwd(q, k, v, do, lse, delta) -> None:
    _check(q, k, v)
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError(f"dO must match q's shape, dtype and device: got "
                         f"{tuple(do.shape)} {do.dtype} {do.device} for q "
                         f"{tuple(q.shape)} {q.dtype} {q.device}")
    b, s, h, _ = q.shape
    for name, x in (("lse", lse), ("delta", delta)):
        if (x.shape != (b * h, s) or x.dtype != torch.float32
                or x.device != q.device or not x.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous (B*H, S) = "
                             f"{(b * h, s)} float32 tensor on {q.device}, "
                             f"got {tuple(x.shape)} {x.dtype} {x.device}")


def _launch_bwd(name: str, q, k, v, do, lse, delta, causal, outs,
                wrapper) -> None:
    """Launch ``name`` and count it in ``wrapper.launches`` once the
    launch returned 0; an empty problem launches (and counts) nothing."""
    b, s, h, d = q.shape
    kernel = name.replace("dpt_", "")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"{kernel} kernel takes float32 or bfloat16, "
                         f"got {q.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"{kernel} kernel takes head dim in {HEAD_DIMS}, "
                         f"got {d}")
    strides = []
    for xname, x in (("q", q), ("k", k), ("v", v), ("dO", do)):
        if x.stride(3) != 1:
            raise ValueError(f"{kernel} kernel needs the head dim of "
                             f"{xname} contiguous (unit stride), got "
                             f"strides {x.stride()}")
        if max(x.stride()) > _INT_MAX:
            raise ValueError(f"{xname} strides {x.stride()} exceed int32")
        strides += [x.stride(0), x.stride(1), x.stride(2)]
    if b * h > 65535 or b * s * h * d > _INT_MAX:
        raise ValueError(f"{kernel} kernel grid too large for "
                         f"{tuple(q.shape)}")
    if s == 0 or b * h == 0:
        return
    fn = _bwd_kernel_fn(name)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                lse.data_ptr(), delta.data_ptr(),
                *(x.data_ptr() for x in outs), b, s, h, d,
                (ctypes.c_int * 12)(*strides), 1.0 / math.sqrt(d),
                int(bool(causal)), _DTYPE_CODES[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {rc} "
                           f"at q {tuple(q.shape)} {q.dtype}")
    wrapper.launches += 1


def _device_kind(q: torch.Tensor) -> str:
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash attention runs on cuda or cpu tensors, "
                         f"got {q.device}")
    return q.device.type


def flash_attention_dq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       do: torch.Tensor, lse: torch.Tensor,
                       delta: torch.Tensor, causal: bool = False
                       ) -> torch.Tensor:
    """Kernel K2: dq, (B, S, H, D) in q's dtype.  CPU tensors take the
    plain version; CUDA tensors launch the kernel (and count the launch
    in ``flash_attention_dq.launches``) or raise."""
    _check_bwd(q, k, v, do, lse, delta)
    if _device_kind(q) == "cpu":
        return _bwd_blocks(q, k, v, do, lse, delta, causal)[0]
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch_bwd("dpt_flash_dq", q, k, v, do, lse, delta, causal, (dq,),
                flash_attention_dq)
    return dq


flash_attention_dq.launches = 0


def flash_attention_dkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        do: torch.Tensor, lse: torch.Tensor,
                        delta: torch.Tensor, causal: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel K3: (dk, dv), (B, S, H, D) in k's and v's dtype.  CPU
    tensors take the plain version; CUDA tensors launch the kernel (and
    count the launch in ``flash_attention_dkv.launches``) or raise."""
    _check_bwd(q, k, v, do, lse, delta)
    if _device_kind(q) == "cpu":
        return _bwd_blocks(q, k, v, do, lse, delta, causal)[1:]
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    _launch_bwd("dpt_flash_dkv", q, k, v, do, lse, delta, causal, (dk, dv),
                flash_attention_dkv)
    return dk, dv


flash_attention_dkv.launches = 0


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        causal: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward of ``flash_attention``: delta from the stored O, then
    K2 and K3."""
    delta = attention_delta(o, do)
    dq = flash_attention_dq(q, k, v, do, lse, delta, causal)
    dk, dv = flash_attention_dkv(q, k, v, do, lse, delta, causal)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """O = flash attention of (q, k, v): forward K1, backward K2 + K3.
    Under ``no_grad``/``inference_mode`` nothing is kept for a backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        o, lse = flash_attention_fwd(q, k, v, causal)
        ctx.causal = bool(causal)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        # the kernels need a unit stride on the head dim and q's dtype; an
        # incoming gradient of another layout or dtype is copied once
        if do.dtype != q.dtype:
            do = do.to(q.dtype)
        if do.stride(3) != 1:
            do = do.contiguous()
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, ctx.causal)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False) -> torch.Tensor:
    """Flash attention; q/k/v (B, S, H, D) -> (B, S, H, D), the same
    function as ``ops.attention.full_attention`` to float tolerance,
    differentiable through K2 and K3."""
    return FlashAttention.apply(q, k, v, causal)
