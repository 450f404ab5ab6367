"""The weight gradient of a 3x3 / stride-1 / SAME conv: kernel K5,
hand-written in CUDA for Hopper, and the conv whose backward uses it.

Counterpart of ``distributedpytorch_tpu/ops/conv.py``: ``conv3x3_dw``
(the Pallas ``_dw_kernel`` behind it is ``csrc/conv_dw.cu`` here),
``conv3x3_same`` (``jax.custom_vjp``: XLA forward, XLA dx, Pallas dW) and
the ``Conv3x3`` layer's call.  The public layout is the JAX package's:
``conv3x3_dw(x (B, H, W, Ci), dy (B, H, W, Co)) -> (3, 3, Ci, Co)`` f32,
and ``conv3x3_same(x NHWC, w HWIO)``.

``conv3x3_dw`` is the kernel's wrapper: for tensors on the CPU it runs
``conv3x3_dw_plain`` (nine shifted slices of the padded input contracted
with dy in f32); for CUDA tensors it launches K5 (and counts the launch in
``conv3x3_dw.launches``) or raises -- there is no fallback.  K5 has two
routes, both hand-written in ``csrc/conv_dw.cu``, and
``tensor_core_route`` is the rule between them: bf16 with channel counts
that are multiples of 8, 16-byte-aligned data and (b, h, w) strides that
are multiples of 8 -- the cnn's main path -- and float16 under the same
rules (the cnn under ``--precision f16``) run on the tensor cores (also
counted in ``conv3x3_dw.tensor_core_launches``); f32 and every other
16-bit call run the scalar kernel.  A route that fails raises; neither
gives way to the other.
``Conv3x3Same`` is the autograd Function the models use, in torch's
layouts (x NCHW, any memory format; weight OIHW): forward ``F.conv2d``,
dx through the stock transposed conv, dW through the wrapper.  As in the
JAX ``_conv_bwd``, dW is cast to the weight's dtype, so under bf16 the f32
sum is rounded to bf16 before it reaches the f32 master weight (under
float16 to float16, +-inf past 65504, as the JAX cast gives).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .. import costs
from . import build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
MMA_DTYPES = (torch.bfloat16, torch.float16)   # the tensor-core route's
_INT_MAX = 2 ** 31 - 1
TILE_ROWS = 32           # pixels per chunk of the scalar kernel (kTK)
MMA_CHUNK = 64           # pixels per chunk of the tensor-core kernel
MMA_TILES = (32, 64)     # its channel tiles (Ci and Co)
TARGET_BLOCKS = 264      # two blocks per SM of an H100 (132 SMs)


def hwio_to_oihw(w: torch.Tensor) -> torch.Tensor:
    """A JAX conv kernel (kh, kw, Ci, Co) as torch's weight (Co, Ci, kh,
    kw)."""
    return w.permute(3, 2, 0, 1)


def oihw_to_hwio(w: torch.Tensor) -> torch.Tensor:
    return w.permute(2, 3, 1, 0)


def conv3x3_dw_plain(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """The kernel's function in PyTorch ops, f32 throughout:
    dW[kh, kw] = x_pad[:, kh:kh+H, kw:kw+W, :]^T . dy over all pixels."""
    b, h, w, ci = x.shape
    co = dy.shape[-1]
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    dyf = dy.float().reshape(b * h * w, co)
    taps = [xp[:, kh:kh + h, kw:kw + w, :].reshape(b * h * w, ci).T @ dyf
            for kh in range(3) for kw in range(3)]
    return torch.stack(taps).reshape(3, 3, ci, co)


def _check(x: torch.Tensor, dy: torch.Tensor) -> None:
    if x.dim() != 4 or dy.dim() != 4 or x.shape[:3] != dy.shape[:3]:
        raise ValueError(f"conv3x3_dw takes x (B, H, W, Ci) and dy (B, H, W, "
                         f"Co) of one (B, H, W), got {tuple(x.shape)} and "
                         f"{tuple(dy.shape)}")
    if x.dtype not in _DTYPE_CODES or dy.dtype != x.dtype:
        raise ValueError(f"conv3x3_dw takes float32, bfloat16 or float16 x "
                         f"and dy of one dtype, got {x.dtype} and "
                         f"{dy.dtype}")
    if x.device != dy.device:
        raise ValueError(f"x and dy devices differ: {x.device}, {dy.device}")
    for name, t in (("x", x), ("dy", dy)):
        if t.shape[3] > 1 and t.stride(3) != 1:
            raise ValueError(f"conv3x3_dw needs the channel dim of {name} "
                             f"contiguous (unit stride), got strides "
                             f"{t.stride()}")


def _splits(n: int, tiles: int, chunk: int) -> tuple:
    """(splits, rows per split) of the B*H*W contraction: enough blocks
    for about ``TARGET_BLOCKS`` with ``tiles`` output tiles, each split a
    whole number of ``chunk``-pixel chunks.  A function of the shapes
    only, so the sum order (and the result's bits) is too."""
    splits = max(1, min(-(-TARGET_BLOCKS // tiles), -(-n // chunk)))
    per = -(-n // splits)
    per = -(-per // chunk) * chunk
    return -(-n // per), per


def split_plan(n: int, rows: int, cols: int) -> tuple:
    """The scalar kernel's (splits, rows per split) for a ``rows`` (9 *
    Ci) x ``cols`` (Co) output in tiles of 64 x 32, ``TILE_ROWS``-pixel
    chunks."""
    return _splits(n, -(-rows // 64) * -(-cols // 32), TILE_ROWS)


def mma_tile(c: int) -> int:
    """The tensor-core kernel's tile for ``c`` channels: the one of
    ``MMA_TILES`` that pads ``c`` least, the larger on a tie."""
    return min(reversed(MMA_TILES), key=lambda t: -(-c // t) * t)


def mma_plan(n: int, ci: int, co: int) -> tuple:
    """The tensor-core kernel's (Ci tile, Co tile, splits, rows per
    split): one block per tap, Ci tile, Co tile and split,
    ``MMA_CHUNK``-pixel chunks."""
    tci, tco = mma_tile(ci), mma_tile(co)
    tiles = 9 * -(-ci // tci) * -(-co // tco)
    return (tci, tco) + _splits(n, tiles, MMA_CHUNK)


def tensor_core_route(dtype: torch.dtype, ci: int, co: int, x_strides,
                      dy_strides, x_ptr: int, dy_ptr: int) -> bool:
    """The rule between K5's routes: True for the tensor-core kernel
    (bf16 or float16, Ci and Co multiples of 8, x and dy 16-byte aligned, their
    (b, h, w) strides multiples of 8, so every pixel's channel run is
    whole 16-byte copies), False for the scalar kernel."""
    return (dtype in MMA_DTYPES and ci % 8 == 0 and co % 8 == 0
            and x_ptr % 16 == 0 and dy_ptr % 16 == 0
            and all(s % 8 == 0 for s in (*x_strides[:3], *dy_strides[:3])))


def _kernel_fn(name: str, n_ints: int):
    fn = getattr(build.load("conv_dw"), name)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                       + [ctypes.POINTER(ctypes.c_int)]
                       + [ctypes.c_int] * n_ints + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _launch(x: torch.Tensor, dy: torch.Tensor,
            tensor_core=None) -> torch.Tensor:
    """One K5 launch on CUDA tensors: the route of ``tensor_core_route``
    unless ``tensor_core`` names one (a route the call does not fit
    raises)."""
    b, h, w, ci = x.shape
    co = dy.shape[-1]
    n = b * h * w
    if n > _INT_MAX or 9 * ci * co > _INT_MAX:
        raise ValueError(f"conv_dw kernel sizes too large for "
                         f"{tuple(x.shape)} x {tuple(dy.shape)}")
    strides = [x.stride(0), x.stride(1), x.stride(2),
               dy.stride(0), dy.stride(1), dy.stride(2)]
    if max(strides) > _INT_MAX:
        raise ValueError(f"conv_dw strides {strides} exceed int32")
    out = torch.empty((3, 3, ci, co), dtype=torch.float32, device=x.device)
    if n == 0 or ci == 0 or co == 0:
        return out.zero_()
    if tensor_core is None:
        tensor_core = tensor_core_route(x.dtype, ci, co, x.stride(),
                                        dy.stride(), x.data_ptr(),
                                        dy.data_ptr())
    if tensor_core:
        if x.dtype not in MMA_DTYPES:
            raise ValueError(f"the tensor-core kernel takes bfloat16 or "
                             f"float16, got {x.dtype}")
        tci, tco, splits, per = mma_plan(n, ci, co)
        args = (per, splits, tci, tco, _DTYPE_CODES[x.dtype])
        fn = _kernel_fn("dpt_conv3x3_dw_mma", 5)
    else:
        splits, per = split_plan(n, 9 * ci, co)
        args = (per, splits, _DTYPE_CODES[x.dtype])
        fn = _kernel_fn("dpt_conv3x3_dw", 3)
    ws = (torch.empty((splits, 9 * ci, co), dtype=torch.float32,
                      device=x.device) if splits > 1 else out)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), dy.data_ptr(), ws.data_ptr(), out.data_ptr(),
                b, h, w, ci, co, (ctypes.c_int * 6)(*strides), *args, stream)
    if rc != 0:
        route = "tensor-core" if tensor_core else "scalar"
        raise RuntimeError(f"conv_dw {route} kernel launch failed: CUDA "
                           f"error {rc} at x {tuple(x.shape)} dy "
                           f"{tuple(dy.shape)} {x.dtype}")
    conv3x3_dw.launches += 1
    conv3x3_dw.tensor_core_launches += int(tensor_core)
    return out


def conv3x3_dw(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """Kernel K5: x (B, H, W, Ci), dy (B, H, W, Co) -> dW (3, 3, Ci, Co)
    float32.  CPU tensors take the plain version; CUDA tensors launch the
    kernel of ``tensor_core_route``'s route (and count the launch in
    ``conv3x3_dw.launches``, and a tensor-core one also in
    ``conv3x3_dw.tensor_core_launches``) or raise."""
    _check(x, dy)
    costs.note_kernel("conv_dw", x, dy)
    if x.device.type == "cpu":
        return conv3x3_dw_plain(x, dy)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3_dw runs on cuda or cpu tensors, got "
                         f"{x.device}")
    return _launch(x, dy)


conv3x3_dw.launches = 0
conv3x3_dw.tensor_core_launches = 0


def _nhwc(t: torch.Tensor) -> torch.Tensor:
    """An NCHW tensor as (B, H, W, C) with a unit channel stride: a view
    for channels_last memory, one copy otherwise."""
    t = t.permute(0, 2, 3, 1)
    return t if t.stride(3) == 1 else t.contiguous()


class Conv3x3Same(torch.autograd.Function):
    """y = conv2d(x, w, padding=1) for x (B, Ci, H, W) and w (Co, Ci, 3, 3)
    of one dtype: forward ``F.conv2d``, dx the stock transposed conv, dW
    kernel K5 cast to ``w.dtype``."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return F.conv2d(x, w, padding=1)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.to(x.dtype)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = F.conv_transpose2d(dy, w, padding=1)
        if ctx.needs_input_grad[1]:
            dw = hwio_to_oihw(conv3x3_dw(_nhwc(x), _nhwc(dy))).to(w.dtype)
        return dx, dw


def conv3x3_same_nchw(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3x3 / stride-1 / SAME conv in torch's layouts, dW through K5."""
    if tuple(w.shape[2:]) != (3, 3):
        raise ValueError(f"conv3x3_same takes a 3x3 kernel, got "
                         f"{tuple(w.shape)}")
    return Conv3x3Same.apply(x, w)


def conv3x3_same(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The JAX package's ``conv3x3_same``: x (B, H, W, Ci), w HWIO (3, 3,
    Ci, Co) -> (B, H, W, Co); differentiable, dW through K5."""
    return conv3x3_same_nchw(x.permute(0, 3, 1, 2),
                             hwio_to_oihw(w)).permute(0, 2, 3, 1)
