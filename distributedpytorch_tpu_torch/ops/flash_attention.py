"""Flash attention: kernels K1 (forward), K2 and K3 (backward), and the
ring's positional kernels K4 (forward), K2p and K3p (backward),
hand-written in CUDA for Hopper.

Counterpart of ``distributedpytorch_tpu/ops/flash_attention.py``
(``flash_attention`` -> the ``jax.custom_vjp`` ``_flash``, whose forward
``_flash_fwd`` runs the Pallas ``_fwd_kernel`` and whose backward
``_flash_bwd_impl`` runs ``_dq_kernel`` and ``_dkv_kernel``, use_pos=False;
``flash_attention_partial``, the same three Pallas kernels with
use_pos=True, an f32 O and an lse output whose cotangent is folded into
delta).  The kernels are ``csrc/flash_fwd.cu`` (K1, K4) and
``csrc/flash_bwd.cu`` (K2, K3, K2p, K3p); ``flash_attention_plain``,
``flash_attention_bwd_plain``, ``flash_attention_partial_plain`` and
``flash_attention_partial_bwd_plain`` below repeat their blockwise math in
PyTorch ops.

``flash_attention_fwd``, ``flash_attention_dq``, ``flash_attention_dkv``,
``flash_attention_partial_fwd``, ``flash_attention_partial_dq`` and
``flash_attention_partial_dkv`` are the kernels' wrappers.  For tensors on
the CPU they run the plain version; for CUDA tensors they launch the
kernel (and count the launch) or raise — there is no fallback.  K2 also
computes delta = rowsum(dO * O), which the JAX package computes outside
its kernels, and returns it for K3; K2p likewise computes delta =
rowsum(dO * O) - dlse, the lse cotangent folded in.  Every kernel has two
routes, both hand-written: ``tensor_core_route`` sends bf16 or float16 at
D = 32 or 64 with 16-byte-aligned rows (the vit's main path and the ring's
shards)
to the tensor-core kernels of K1, K4 and K2/K3, and
``partial_tensor_core_route`` does the same for K2p/K3p, where K2p also
rounds the f32 dO to q's 16-bit type once for K3p (each wrapper also
counts these in ``tensor_core_launches``); every other call takes the
scalar kernels.  Every kernel takes float16 as well (the vit and its ring
under ``--precision f16``), on both routes: the tensor-core route runs the
same kernels on float16 ``mma.sync`` and keeps float16's range for dS
(``csrc/flash_bwd.cu``).  A route that fails raises, neither gives way to
the other.
``FlashAttention`` is the autograd Function of K1 (backward K2 and K3),
``FlashAttentionPartial`` that of K4 (backward K2p and K3p).
Public layout is the JAX package's: q, k, v, the output and its gradient
are (B, S, H, D); the log-sum-exp is (B*H, S) float32; positions are (S,)
int32.

Unlike the JAX wrapper, nothing is moved to (B*H, S, D) and S is not padded
to a block multiple: the kernel reads the (B, S, H, D) strides directly and
masks the ragged tail itself.
"""

from __future__ import annotations

import ctypes
import math
from typing import Callable, Optional, Tuple

import torch

from .. import costs
from . import build

# Key-tile rows of the plain version.  The kernel's tile is 64 rows at
# D <= 64 and 32 at D = 128; in f32 the tile only sets the order of sums.
BLOCK_K = 64
_NEG = -1e30          # finite masked-score sentinel, as in the TPU kernel
HEAD_DIMS = (32, 64, 128)
MMA_HEAD_DIMS = (32, 64)   # the tensor-core routes of K2/K3 and K2p/K3p
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# the 16-bit types of the tensor-core routes
MMA_DTYPES = (torch.bfloat16, torch.float16)
_INT_MAX = 2 ** 31 - 1


MaskFn = Callable[[int, int], Optional[torch.Tensor]]


def _causal_mask(s: int, causal: bool, device) -> MaskFn:
    """K1-K3's mask of the key tile [k0, k0 + bk): (S, bk) bool of the
    valid scores, key index <= row index, or None."""
    rows = torch.arange(s, device=device)[:, None]

    def mask(k0: int, bk: int) -> Optional[torch.Tensor]:
        if not causal:
            return None
        return torch.arange(k0, k0 + bk, device=device)[None, :] <= rows
    return mask


def _pos_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
              kv_valid: Optional[int]) -> MaskFn:
    """K4/K2p/K3p's mask of a key tile from GLOBAL positions (the TPU
    kernel's ``_pos_mask``): q_pos >= k_pos when causal, and k_pos <
    kv_valid; None when neither applies."""
    rows = q_pos.long()[:, None]

    def mask(k0: int, bk: int) -> Optional[torch.Tensor]:
        cols = k_pos[k0:k0 + bk].long()[None, :]
        out = None
        if causal:
            out = rows >= cols
        if kv_valid is not None:
            kvm = (cols < kv_valid).expand(rows.shape[0], -1)
            out = kvm if out is None else out & kvm
        return out
    return mask


def _fwd_blocks(q, k, v, mask_fn: MaskFn, out_dtype: torch.dtype,
                p_bf16: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernels' function in PyTorch ops: online softmax over
    key tiles of ``BLOCK_K`` rows, f32 throughout, masked scores at the
    -1e30 sentinel and their p forced to 0, O cast to ``out_dtype``.
    ``p_bf16`` rounds p to bf16 before the P V product, as the tensor-core
    K1 and K4 do (l still sums the f32 p): the tests hold that numerics
    against the JAX kernel; no wrapper passes it."""
    b, s, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    qf = q.permute(0, 2, 1, 3).float() * scale          # (b, h, s, d)
    kf = k.permute(0, 2, 1, 3).float()
    vf = v.permute(0, 2, 1, 3).float()
    acc = torch.zeros((b, h, s, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, s, 1), _NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, s, 1), dtype=torch.float32, device=q.device)
    for k0 in range(0, s, BLOCK_K):
        kb = kf[:, :, k0:k0 + BLOCK_K]
        vb = vf[:, :, k0:k0 + BLOCK_K]
        sc = qf @ kb.transpose(-1, -2)                   # (b, h, s, bk)
        mask = mask_fn(k0, kb.shape[2])
        if mask is not None:
            sc = torch.where(mask, sc, _NEG)
        m_new = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
        p = torch.exp(sc - m_new)
        if mask is not None:
            p = torch.where(mask, p, 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        if p_bf16:
            p = p.bfloat16().float()
        acc = acc * alpha + p @ vb
        m = m_new
    l_safe = torch.clamp_min(l, 1e-30)
    o = (acc / l_safe).to(out_dtype).permute(0, 2, 1, 3).contiguous()
    lse = (m + torch.log(l_safe)).reshape(b * h, s)
    return o, lse


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = False
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1's function in PyTorch ops, O in the input dtype.  (B, S, H, D)
    q/k/v -> (o (B, S, H, D), lse (B*H, S) f32)."""
    return _fwd_blocks(q, k, v, _causal_mask(q.shape[1], causal, q.device),
                       q.dtype)


def _kernel_fn(name: str = "dpt_flash_fwd"):
    """``dpt_flash_fwd`` (K1) or ``dpt_flash_fwd_pos`` (K4, which also
    takes the two position pointers and kv_valid), or their tensor-core
    ``_mma`` entry points, which take the same arguments."""
    fn = getattr(build.load("flash_fwd"), name)
    if fn.argtypes is None:
        n_ptr, n_int = (7, 14) if "_pos" in name else (5, 13)
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
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


Pos = Tuple[torch.Tensor, torch.Tensor, Optional[int]]


def _check_pos(q: torch.Tensor, q_pos: torch.Tensor, k_pos: torch.Tensor,
               kv_valid: Optional[int]) -> None:
    s = q.shape[1]
    for name, x in (("q_pos", q_pos), ("k_pos", k_pos)):
        if (x.shape != (s,) or x.dtype != torch.int32
                or x.device != q.device or not x.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous ({s},) int32 "
                             f"tensor on {q.device}, got {tuple(x.shape)} "
                             f"{x.dtype} {x.device}")
    if kv_valid is not None and not 0 <= kv_valid <= _INT_MAX:
        raise ValueError(f"kv_valid={kv_valid} is not an int32 position")


def _check_kernel_inputs(kernel: str, tensors) -> list:
    """The dtype, head-dim, stride and size limits of the kernels; returns
    the (batch, seq, head) strides of ``tensors`` ((name, tensor) pairs),
    flattened."""
    q = tensors[0][1]
    b, s, h, d = q.shape
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"{kernel} kernel takes float32, bfloat16 or "
                         f"float16, got {q.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"{kernel} kernel takes head dim in {HEAD_DIMS}, "
                         f"got {d}")
    strides = []
    for name, x in tensors:
        if x.stride(3) != 1:
            raise ValueError(f"{kernel} kernel needs the head dim of {name} "
                             f"contiguous (unit stride), got strides "
                             f"{x.stride()}")
        if max(x.stride()) > _INT_MAX:
            raise ValueError(f"{name} strides {x.stride()} exceed int32")
        strides += [x.stride(0), x.stride(1), x.stride(2)]
    if b * h > 65535 or b * s * h * d > _INT_MAX:
        raise ValueError(f"{kernel} kernel grid too large for "
                         f"{tuple(q.shape)}")
    return strides


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            causal: bool, pos: Optional[Pos] = None, wrapper=None,
            tensor_core: Optional[bool] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1, or K4 when ``pos`` = (q_pos, k_pos, kv_valid) is given (O in
    f32), on the route of ``tensor_core_route`` unless ``tensor_core``
    names one (forcing the tensor cores on a call that does not fit them
    raises); counts the launch on ``wrapper``, and a tensor-core one also
    in its ``tensor_core_launches``, once it returned 0."""
    b, s, h, d = q.shape
    name = "dpt_flash_fwd" if pos is None else "dpt_flash_fwd_pos"
    strides = _check_kernel_inputs(name[4:], (("q", q), ("k", k),
                                              ("v", v)))
    tensor_core = _pick_route(tensor_core, (q, k, v),
                              kernel="K1" if pos is None else "K4")
    o = torch.empty((b, s, h, d),
                    dtype=q.dtype if pos is None else torch.float32,
                    device=q.device)
    lse = torch.empty((b * h, s), dtype=torch.float32, device=q.device)
    if s == 0 or b * h == 0:
        return o, lse
    fn = _kernel_fn(name + "_mma" if tensor_core else name)
    extra = () if pos is None else (
        pos[0].data_ptr(), pos[1].data_ptr(),
        _INT_MAX if pos[2] is None else int(pos[2]))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                lse.data_ptr(), *extra, b, s, h, d, *strides,
                1.0 / math.sqrt(d), int(bool(causal)),
                _DTYPE_CODES[q.dtype], stream)
    if rc != 0:
        route = "tensor-core" if tensor_core else "scalar"
        raise RuntimeError(f"{name[4:]} {route} kernel launch failed: CUDA "
                           f"error {rc} at q {tuple(q.shape)} {q.dtype}")
    wrapper = wrapper or flash_attention_fwd
    wrapper.launches += 1
    if tensor_core:
        wrapper.tensor_core_launches += 1
    return o, lse


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel K1: (B, S, H, D) q/k/v -> (o, lse).  CPU tensors take the
    plain version; CUDA tensors launch the kernel of
    ``tensor_core_route``'s route (and count the launch in
    ``flash_attention_fwd.launches``, and a tensor-core one also in
    ``flash_attention_fwd.tensor_core_launches``) or raise."""
    _check(q, k, v)
    costs.note_kernel("flash_fwd", q, k, causal)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cuda or cpu tensors, "
                         f"got {q.device}")
    return _launch(q, k, v, causal)


flash_attention_fwd.launches = 0
flash_attention_fwd.tensor_core_launches = 0


# -- backward: K2 (dq) and K3 (dk, dv) ------------------------------------

def attention_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * O) in f32, from O as stored: (B, S, H, D) ->
    (B*H, S).  A torch op, as in the JAX package (``_flash_bwd_impl``
    computes it outside any Pallas kernel): the plain version of the delta
    that K2 computes, and the start of the ring's ``partial_delta``."""
    b, s, h, _ = o.shape
    rows = (do.float() * o.float()).sum(dim=-1)          # (b, s, h)
    return rows.permute(0, 2, 1).reshape(b * h, s).contiguous()


def _bwd_blocks(q, k, v, do, lse, delta, mask_fn: MaskFn,
                mask_dv: bool = True
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernels' function in PyTorch ops: scores recomputed
    per key tile of ``BLOCK_K`` rows as (q . k) * scale (q not pre-scaled),
    masked scores at the -1e30 sentinel, p = exp(s - lse), ds = p * (dO
    V^T - delta) forced to 0 where masked, f32 throughout, dq and dk
    scaled once at the end.  K3 forces the masked p to 0 before dv too
    (``mask_dv``); K3p does not, as the TPU ``_dkv_kernel`` does not."""
    b, s, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    qf, kf, vf, dof = (x.permute(0, 2, 1, 3).float() for x in (q, k, v, do))
    lse4 = lse.reshape(b, h, s, 1)
    delta4 = delta.reshape(b, h, s, 1)
    dq = torch.zeros((b, h, s, d), dtype=torch.float32, device=q.device)
    dk = torch.zeros_like(dq)
    dv = torch.zeros_like(dq)
    for k0 in range(0, s, BLOCK_K):
        kb = kf[:, :, k0:k0 + BLOCK_K]
        vb = vf[:, :, k0:k0 + BLOCK_K]
        sc = (qf @ kb.transpose(-1, -2)) * scale          # (b, h, s, bk)
        mask = mask_fn(k0, kb.shape[2])
        if mask is not None:
            sc = torch.where(mask, sc, _NEG)
        p = torch.exp(sc - lse4)
        dp = dof @ vb.transpose(-1, -2)
        ds = p * (dp - delta4)
        if mask is not None:
            if mask_dv:
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
    return _bwd_blocks(q, k, v, do, lse, attention_delta(o, do),
                       _causal_mask(q.shape[1], causal, q.device))


def _whole_16_byte_rows(strides, ptrs, itemsizes) -> bool:
    """Every tensor has a unit head stride, a 16-byte-aligned data pointer
    and (batch, seq, head) strides that are whole 16-byte pieces, so every
    row is whole 16-byte loads."""
    return (all(p % 16 == 0 for p in ptrs)
            and all(st[3] == 1 and all(x % (16 // n) == 0 for x in st[:3])
                    for st, n in zip(strides, itemsizes)))


def tensor_core_route(dtype: torch.dtype, d: int, strides, ptrs) -> bool:
    """The rule between the routes of K1, K4, K2 and K3: True for the
    tensor-core kernels (bf16 or float16; D in ``MMA_HEAD_DIMS``, every
    tensor with a
    unit head stride, (batch, seq, head) strides that are multiples of 8
    and a 16-byte-aligned data pointer, so every row is whole 16-byte
    copies), False for the scalar ones.  ``strides`` and ``ptrs``: those
    of q, k and v (K1, K4), and dO (K3), and O (K2)."""
    return (dtype in MMA_DTYPES and d in MMA_HEAD_DIMS
            and _whole_16_byte_rows(strides, ptrs, [2] * len(strides)))


def partial_tensor_core_route(dtypes, d: int, strides, ptrs) -> bool:
    """The rule between K2p's and K3p's routes: True for the tensor-core
    kernels, False for the scalar ones.  ``dtypes``, ``strides`` and
    ``ptrs``: those of q, k, v and dO, and O for K2p.  The tensor cores
    take bf16 or float16 q, k and v at D in ``MMA_HEAD_DIMS`` with K2p's dO
    and O in f32 (K4's O and its cotangent) or K3p's dO in q's type (the
    copy that K2p writes on this route), every tensor with a unit head
    stride, a 16-byte-aligned data pointer and (batch, seq, head) strides
    that are multiples of 8 in 16 bits or 4 in f32, so every row is whole
    16-byte loads.  dlse and the positions are contiguous on both routes (the
    wrappers' checks require it)."""
    dtypes = list(dtypes)
    rest = [torch.float32] * 2 if len(dtypes) == 5 else dtypes[:1]
    return (dtypes[0] in MMA_DTYPES and dtypes == dtypes[:1] * 3 + rest
            and d in MMA_HEAD_DIMS
            and _whole_16_byte_rows(strides, ptrs,
                                    [dt.itemsize for dt in dtypes]))


def _pick_route(tensor_core: Optional[bool], tensors,
                positional: bool = False, kernel: str = "K2/K3") -> bool:
    """The rule's route for ``tensors`` (q, k, v[, dO[, O]]) of ``kernel``
    (K1, K4: q, k, v; K2/K3), or with ``positional`` of K2p/K3p, or the
    one ``tensor_core`` forces; forcing the tensor cores on a call that
    does not fit them raises."""
    q = tensors[0]
    strides = [t.stride() for t in tensors]
    ptrs = [t.data_ptr() for t in tensors]
    if positional:
        fits = partial_tensor_core_route([t.dtype for t in tensors],
                                         q.shape[3], strides, ptrs)
    else:
        fits = tensor_core_route(q.dtype, q.shape[3], strides, ptrs)
    if tensor_core and not fits:
        what = ("K2p/K3p take bfloat16 or float16 q, k, v (K2p: float32 "
                "dO and O; K3p: dO in q's dtype)" if positional
                else f"{kernel} take{'' if '/' in kernel else 's'} "
                     f"bfloat16 or float16")
        raise ValueError(f"the tensor-core {what} at D in {MMA_HEAD_DIMS} "
                         f"with 16-byte-aligned rows; q {tuple(q.shape)} "
                         f"{q.dtype} does not fit")
    return fits if tensor_core is None else bool(tensor_core)


def _bwd_kernel_fn(name: str):
    """An entry point of ``csrc/flash_bwd.cu``: the input pointers (six;
    K2p's seven: q, k, v, dO, O, lse, dlse), the ``_pos`` entry points'
    two position pointers and kv_valid, then the outputs (delta and dq for
    K2 and K2p, dk and dv for K3 and K3p; K2p's tensor-core route also
    the 16-bit dO)."""
    fn = getattr(build.load("flash_bwd"), name)
    if fn.argtypes is None:
        dq_pos = name.startswith("dpt_flash_dq_pos")
        n_in = 7 if dq_pos else 6
        n_out = 3 if name == "dpt_flash_dq_pos_mma" else 2
        pos = ([ctypes.c_void_p] * 2 + [ctypes.c_int]
               if "_pos" in name else [])
        fn.argtypes = ([ctypes.c_void_p] * n_in + pos
                       + [ctypes.c_void_p] * n_out + [ctypes.c_int] * 4
                       + [ctypes.POINTER(ctypes.c_int), ctypes.c_float,
                          ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check_bwd(q, k, v, do, rows, do_dtypes=None, o=None,
               o_dtype=None) -> None:
    """``rows``: (name, tensor) pairs of the (B*H, S) f32 row vectors (a
    None tensor, a zero dlse, is left out); ``do_dtypes``: dO's dtypes,
    q's by default (K2p: float32; K3p: float32, or q's dtype on the
    tensor-core route); ``o``: the forward's output (K2, K2p), of q's
    dtype or ``o_dtype`` (K2p: float32)."""
    _check(q, k, v)
    for name, x, dts in (("dO", do, do_dtypes or (q.dtype,)),
                         ("O", o, (o_dtype or q.dtype,))):
        if x is not None and (x.shape != q.shape or x.dtype not in dts
                              or x.device != q.device):
            raise ValueError(f"{name} must match q's shape and device, "
                             f"with dtype in {[str(d) for d in dts]}: got "
                             f"{tuple(x.shape)} {x.dtype} {x.device} for q "
                             f"{tuple(q.shape)} {q.dtype} {q.device}")
    b, s, h, _ = q.shape
    for name, x in rows:
        if x is not None and (x.shape != (b * h, s)
                              or x.dtype != torch.float32
                              or x.device != q.device
                              or not x.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous (B*H, S) = "
                             f"{(b * h, s)} float32 tensor on {q.device}, "
                             f"got {tuple(x.shape)} {x.dtype} {x.device}")


_STRIDED = ("q", "k", "v", "dO", "O")


def _launch_bwd(name: str, ins, outs, causal, wrapper, n_strided: int = 4,
                pos: Optional[Pos] = None, tensor_core: bool = False) -> None:
    """Launch ``name`` (its ``_mma`` entry point when ``tensor_core``) on
    the tensors ``ins`` in the entry point's order (None for a null
    pointer: K2p's zero dlse), of which the first ``n_strided`` (q, k, v,
    dO and, for K2 and K2p, O) are read through their strides, writing
    ``outs``; K2p/K3p take ``pos`` = (q_pos, k_pos, kv_valid).  Counts the
    launch in ``wrapper.launches``, and a tensor-core one in
    ``wrapper.tensor_core_launches``, once it returned 0; an empty problem
    launches (and counts) nothing."""
    q = ins[0]
    b, s, h, d = q.shape
    kernel = name.replace("dpt_", "")
    strides = _check_kernel_inputs(kernel, tuple(zip(_STRIDED,
                                                     ins[:n_strided])))
    if s == 0 or b * h == 0:
        return
    fn = _bwd_kernel_fn(name + "_mma" if tensor_core else name)
    extra = () if pos is None else (
        pos[0].data_ptr(), pos[1].data_ptr(),
        _INT_MAX if pos[2] is None else int(pos[2]))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(*(None if x is None else x.data_ptr() for x in ins), *extra,
                *(x.data_ptr() for x in outs), b, s, h, d,
                (ctypes.c_int * len(strides))(*strides), 1.0 / math.sqrt(d),
                int(bool(causal)), _DTYPE_CODES[q.dtype], stream)
    if rc != 0:
        route = "tensor-core" if tensor_core else "scalar"
        raise RuntimeError(f"{kernel} {route} kernel launch failed: CUDA "
                           f"error {rc} at q {tuple(q.shape)} {q.dtype}")
    wrapper.launches += 1
    if tensor_core:
        wrapper.tensor_core_launches += 1


def _device_kind(q: torch.Tensor) -> str:
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash attention runs on cuda or cpu tensors, "
                         f"got {q.device}")
    return q.device.type


def _dq_launch(q, k, v, o, do, lse, causal: bool = False,
               tensor_core: Optional[bool] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One K2 launch on CUDA tensors: (dq, delta), on the route of
    ``tensor_core_route`` unless ``tensor_core`` names one."""
    b, s, h, _ = q.shape
    tensor_core = _pick_route(tensor_core, (q, k, v, do, o))
    delta = torch.empty((b * h, s), dtype=torch.float32, device=q.device)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch_bwd("dpt_flash_dq", (q, k, v, do, o, lse), (delta, dq), causal,
                flash_attention_dq, n_strided=5, tensor_core=tensor_core)
    return dq, delta


def _dkv_launch(q, k, v, do, lse, delta, causal: bool = False,
                tensor_core: Optional[bool] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One K3 launch on CUDA tensors: (dk, dv), on the route of
    ``tensor_core_route`` unless ``tensor_core`` names one."""
    tensor_core = _pick_route(tensor_core, (q, k, v, do))
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    _launch_bwd("dpt_flash_dkv", (q, k, v, do, lse, delta), (dk, dv),
                causal, flash_attention_dkv, tensor_core=tensor_core)
    return dk, dv


def flash_attention_dq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
                       causal: bool = False
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel K2: (dq (B, S, H, D) in q's dtype, delta = rowsum(dO * O)
    (B*H, S) f32, which K3 takes).  CPU tensors take the plain version;
    CUDA tensors launch the kernel of ``tensor_core_route``'s route (and
    count the launch in ``flash_attention_dq.launches``, and a
    tensor-core one also in ``flash_attention_dq.tensor_core_launches``)
    or raise."""
    _check_bwd(q, k, v, do, (("lse", lse),), o=o)
    costs.note_kernel("flash_dq", q, k, causal)
    if _device_kind(q) == "cpu":
        delta = attention_delta(o, do)
        return _bwd_blocks(q, k, v, do, lse, delta,
                           _causal_mask(q.shape[1], causal, q.device))[0], \
            delta
    return _dq_launch(q, k, v, o, do, lse, causal)


flash_attention_dq.launches = 0
flash_attention_dq.tensor_core_launches = 0


def flash_attention_dkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        do: torch.Tensor, lse: torch.Tensor,
                        delta: torch.Tensor, causal: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel K3: (dk, dv), (B, S, H, D) in k's and v's dtype, from K2's
    delta.  CPU tensors take the plain version; CUDA tensors launch the
    kernel of ``tensor_core_route``'s route (and count the launch in
    ``flash_attention_dkv.launches``, and a tensor-core one also in
    ``flash_attention_dkv.tensor_core_launches``) or raise."""
    _check_bwd(q, k, v, do, (("lse", lse), ("delta", delta)))
    costs.note_kernel("flash_dkv", q, k, causal)
    if _device_kind(q) == "cpu":
        return _bwd_blocks(q, k, v, do, lse, delta,
                           _causal_mask(q.shape[1], causal, q.device))[1:]
    return _dkv_launch(q, k, v, do, lse, delta, causal)


flash_attention_dkv.launches = 0
flash_attention_dkv.tensor_core_launches = 0


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        causal: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward of ``flash_attention``: K2, which also gives delta
    from the stored O, then K3."""
    dq, delta = flash_attention_dq(q, k, v, o, do, lse, causal)
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
        # incoming gradient of another layout or dtype is copied once (a
        # float16 cast of an f32 gradient past 65504 is +-inf, as the JAX
        # custom_vjp's cotangent in the primal's dtype is)
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


# -- the ring's per-step kernels: K4 forward, K2p and K3p backward ----------

def flash_attention_partial_plain(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, q_pos: torch.Tensor,
                                  k_pos: torch.Tensor, causal: bool = False,
                                  kv_valid: Optional[int] = None
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4's function in PyTorch ops: ``flash_attention_plain`` masked by
    global positions, O in f32.  (B, S, H, D) q/k/v, (S,) positions ->
    (o (B, S, H, D) f32, lse (B*H, S) f32).  A row whose keys are all
    masked gives O = 0 and lse = -1e30."""
    return _fwd_blocks(q, k, v, _pos_mask(q_pos, k_pos, causal, kv_valid),
                       torch.float32)


def flash_attention_partial_fwd(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, q_pos: torch.Tensor,
                                k_pos: torch.Tensor, causal: bool = False,
                                kv_valid: Optional[int] = None
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel K4: (o f32, lse) of q against one K/V block, masked by the
    (S,) int32 global positions of q's rows and k's keys and by
    ``kv_valid`` (keys at positions >= kv_valid; None for none).  CPU
    tensors take the plain version; CUDA tensors launch the kernel of
    ``tensor_core_route``'s route (and count the launch in
    ``flash_attention_partial_fwd.launches``, and a tensor-core one also
    in ``flash_attention_partial_fwd.tensor_core_launches``) or raise."""
    _check(q, k, v)
    _check_pos(q, q_pos, k_pos, kv_valid)
    costs.note_kernel("flash_fwd_pos", q, k, causal)
    if _device_kind(q) == "cpu":
        return flash_attention_partial_plain(q, k, v, q_pos, k_pos, causal,
                                             kv_valid)
    return _launch(q, k, v, causal, (q_pos, k_pos, kv_valid),
                   flash_attention_partial_fwd)


flash_attention_partial_fwd.launches = 0
flash_attention_partial_fwd.tensor_core_launches = 0


def partial_delta(o: torch.Tensor, do: torch.Tensor,
                  dlse: Optional[torch.Tensor]) -> torch.Tensor:
    """delta = rowsum(dO * O) - dlse, (B*H, S) f32: the lse cotangent
    folded into delta, as ``_flash_bwd_impl`` folds it (d lse / d s_j =
    p_j, so the backward kernels run unchanged).  Torch ops: the plain
    version of the delta that K2p computes."""
    delta = attention_delta(o, do)
    return delta if dlse is None else (delta - dlse.float()).contiguous()


def _partial_bwd_blocks(q, k, v, do, lse, delta, q_pos, k_pos, causal,
                        kv_valid):
    """K2p and K3p's function from delta: ``_bwd_blocks`` with the
    positional mask and, as in the TPU ``_dkv_kernel``, the masked p not
    forced to 0 before dv (it is exp(-1e30 - lse), 0 unless the whole row
    is masked, lse = -1e30)."""
    return _bwd_blocks(q, k, v, do, lse, delta,
                       _pos_mask(q_pos, k_pos, causal, kv_valid),
                       mask_dv=False)


def flash_attention_partial_bwd_plain(q, k, v, o, lse, do, dlse, q_pos, k_pos,
                                      causal: bool = False,
                                      kv_valid: Optional[int] = None
                                      ) -> Tuple[torch.Tensor, torch.Tensor,
                                                 torch.Tensor]:
    """K2p and K3p in PyTorch ops: the backward of K4 for the cotangents
    dO (f32, of O) and dlse (of lse; None for zero) -> (dq, dk, dv) in the
    inputs' dtypes."""
    return _partial_bwd_blocks(q, k, v, do, lse, partial_delta(o, do, dlse),
                               q_pos, k_pos, causal, kv_valid)


def _dq_pos_launch(q, k, v, o, do, lse, dlse, q_pos, k_pos, causal: bool,
                   kv_valid: Optional[int],
                   tensor_core: Optional[bool] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One K2p launch on CUDA tensors: (dq, delta, the dO that K3p reads:
    the copy in q's dtype that the tensor-core route writes, or the f32
    dO), on
    the route of ``partial_tensor_core_route`` unless ``tensor_core``
    names one."""
    b, s, h, _ = q.shape
    tensor_core = _pick_route(tensor_core, (q, k, v, do, o), positional=True)
    delta = torch.empty((b * h, s), dtype=torch.float32, device=q.device)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    outs, do_k3 = (delta, dq), do
    if tensor_core:
        do_k3 = torch.empty(q.shape, dtype=q.dtype, device=q.device)
        outs += (do_k3,)
    _launch_bwd("dpt_flash_dq_pos", (q, k, v, do, o, lse, dlse), outs,
                causal, flash_attention_partial_dq, n_strided=5,
                pos=(q_pos, k_pos, kv_valid), tensor_core=tensor_core)
    return dq, delta, do_k3


def flash_attention_partial_dq(q, k, v, o, do, lse, dlse, q_pos, k_pos,
                               causal: bool = False,
                               kv_valid: Optional[int] = None
                               ) -> Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """Kernel K2p: (dq of K4 (B, S, H, D) in q's dtype, delta =
    rowsum(dO * O) - dlse (B*H, S) f32, the dO that K3p takes) from K4's
    f32 O and lse and the f32 cotangents dO and dlse (None for zero).
    CPU tensors take the plain version (``partial_delta``, then
    ``_partial_bwd_blocks``) and return dO as given.  CUDA tensors launch
    the kernel of ``partial_tensor_core_route``'s route (and count the
    launch in ``flash_attention_partial_dq.launches``, and a tensor-core
    one also in ``flash_attention_partial_dq.tensor_core_launches``) or
    raise; the tensor-core route also writes dO rounded to q's dtype and
    returns that, the scalar one returns the f32 dO."""
    _check_bwd(q, k, v, do, (("lse", lse), ("dlse", dlse)),
               (torch.float32,), o=o, o_dtype=torch.float32)
    _check_pos(q, q_pos, k_pos, kv_valid)
    costs.note_kernel("flash_dq_pos", q, k, causal)
    if _device_kind(q) == "cpu":
        delta = partial_delta(o, do, dlse)
        dq = _partial_bwd_blocks(q, k, v, do, lse, delta, q_pos, k_pos,
                                 causal, kv_valid)[0]
        return dq, delta, do
    return _dq_pos_launch(q, k, v, o, do, lse, dlse, q_pos, k_pos, causal,
                          kv_valid)


flash_attention_partial_dq.launches = 0
flash_attention_partial_dq.tensor_core_launches = 0


def flash_attention_partial_dkv(q, k, v, do, lse, delta, q_pos, k_pos,
                                causal: bool = False,
                                kv_valid: Optional[int] = None
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel K3p: (dk, dv) of K4 in k's and v's dtype, from K2p's delta
    and the dO that K2p returned.  CPU tensors take the plain version.
    CUDA tensors launch the kernel (and count the launch in
    ``flash_attention_partial_dkv.launches``, and a tensor-core one also
    in ``flash_attention_partial_dkv.tensor_core_launches``) or raise: a
    16-bit dO (K2p's copy) takes the tensor cores, and raises where the call
    does not fit them; an f32 dO takes the scalar kernel."""
    _check_bwd(q, k, v, do, (("lse", lse), ("delta", delta)),
               (torch.float32, q.dtype))
    _check_pos(q, q_pos, k_pos, kv_valid)
    costs.note_kernel("flash_dkv_pos", q, k, causal)
    if _device_kind(q) == "cpu":
        return _partial_bwd_blocks(q, k, v, do, lse, delta, q_pos, k_pos,
                                   causal, kv_valid)[1:]
    tensor_core = _pick_route(do.dtype != torch.float32, (q, k, v, do),
                              positional=True)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    _launch_bwd("dpt_flash_dkv_pos", (q, k, v, do, lse, delta), (dk, dv),
                causal, flash_attention_partial_dkv,
                pos=(q_pos, k_pos, kv_valid), tensor_core=tensor_core)
    return dk, dv


flash_attention_partial_dkv.launches = 0
flash_attention_partial_dkv.tensor_core_launches = 0


def flash_attention_partial_bwd(q, k, v, o, lse, do, dlse, q_pos, k_pos,
                                causal: bool = False,
                                kv_valid: Optional[int] = None
                                ) -> Tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]:
    """The backward of ``flash_attention_partial``: K2p, which also gives
    delta and the dO that K3p reads, then K3p; on CUDA tensors nothing
    runs between the two launches."""
    dq, delta, do_k3 = flash_attention_partial_dq(
        q, k, v, o, do, lse, dlse, q_pos, k_pos, causal, kv_valid)
    dk, dv = flash_attention_partial_dkv(q, k, v, do_k3, lse, delta, q_pos,
                                         k_pos, causal, kv_valid)
    return dq, dk, dv


class FlashAttentionPartial(torch.autograd.Function):
    """(o, lse) = K4 of (q, k, v) at the given positions; the backward
    takes both cotangents and runs K2p + K3p.  The integer positions take
    no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, k_pos, causal: bool,
                kv_valid: Optional[int]):
        o, lse = flash_attention_partial_fwd(q, k, v, q_pos, k_pos, causal,
                                             kv_valid)
        ctx.causal = bool(causal)
        ctx.kv_valid = kv_valid
        ctx.save_for_backward(q, k, v, o, lse, q_pos, k_pos)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse, q_pos, k_pos = ctx.saved_tensors
        # K2p reads an f32 dO with a unit stride on the head dim and a
        # contiguous dlse; a cotangent of another layout is copied once
        do = do.float()
        if do.stride(3) != 1:
            do = do.contiguous()
        if dlse is not None:
            dlse = dlse.float().contiguous()
        dq, dk, dv = flash_attention_partial_bwd(
            q, k, v, o, lse, do, dlse, q_pos, k_pos, ctx.causal,
            ctx.kv_valid)
        return dq, dk, dv, None, None, None, None


def flash_attention_partial(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, q_pos: torch.Tensor,
                            k_pos: torch.Tensor, causal: bool = False,
                            kv_valid: Optional[int] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Partial flash attention over one K/V block with GLOBAL positions
    (the JAX ``flash_attention_partial``): (o f32, lse (B*H, S) f32), the
    softmax-normalised result and the log-sum-exp over this block's keys.
    Partials over disjoint key blocks merge exactly
    (``ops.attention._merge_partials``); differentiable in q, k, v through
    both outputs."""
    return FlashAttentionPartial.apply(q, k, v, q_pos, k_pos, causal,
                                       kv_valid)
