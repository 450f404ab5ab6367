"""The port's flash-attention backward (kernels K2 and K3 through the
``FlashAttention`` autograd Function, their plain version on the CPU) held
against ``jax.grad`` of the JAX package's Pallas flash attention, which
runs here in Pallas interpret mode.  Inputs and the output gradient come
from numpy with a seed and go to both sides.  Tolerances: 5e-5 in f32 (the
same f32 math in another summation order), 2e-2 relative to the largest
gradient in bf16 (one bf16 rounding of each gradient, and bf16 inputs)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedpytorch_tpu.ops import flash_attention as jfa
from distributedpytorch_tpu_torch.ops import flash_attention as tfa
from distributedpytorch_tpu_torch.ops.attention import full_attention

B, H = 2, 2


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several workers on one machine: this file's torch
    ops keep to two threads, so that timing-sensitive tests on the other
    workers are not starved of cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _inputs(s, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, s, H, d)).astype(np.float32)
            for _ in range(4)]                            # q, k, v, dO


def _jax_grads(q, k, v, w, causal, dtype=jnp.float32):
    def loss(q, k, v):
        o = jfa.flash_attention(q, k, v, causal=causal)
        return jnp.sum(o.astype(jnp.float32) * w)

    args = [jnp.asarray(x, dtype) for x in (q, k, v)]
    grads = jax.grad(loss, argnums=(0, 1, 2))(*args)
    return [np.asarray(g, np.float32) for g in grads]


def _port_grads(q, k, v, w, causal, dtype=torch.float32):
    ts = [torch.from_numpy(x).to(dtype).requires_grad_() for x in (q, k, v)]
    o = tfa.flash_attention(*ts, causal)
    assert o.dtype == dtype
    (o.float() * torch.from_numpy(w)).sum().backward()
    return [t.grad.float().numpy() for t in ts]


@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s", [49, 128, 200])
def test_backward_matches_jax_grad_f32(s, causal, d):
    q, k, v, w = _inputs(s, d, seed=s * 7 + d + causal)
    want = _jax_grads(q, k, v, w, causal)
    got = _port_grads(q, k, v, w, causal)
    for name, g, wg in zip("qkv", got, want):
        assert g.shape == (B, s, H, d), name
        np.testing.assert_allclose(g, wg, atol=5e-5, rtol=0, err_msg=name)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s", [49, 128])
def test_backward_matches_jax_grad_bf16(s, causal):
    q, k, v, w = _inputs(s, 32, seed=11 + s)
    want = _jax_grads(q, k, v, w, causal, jnp.bfloat16)
    got = _port_grads(q, k, v, w, causal, torch.bfloat16)
    for name, g, wg in zip("qkv", got, want):
        scale = np.abs(wg).max()
        assert np.abs(g - wg).max() <= 2e-2 * scale, name


@pytest.mark.parametrize("causal", [False, True])
def test_backward_matches_autograd_of_full_attention(causal):
    q, k, v, w = _inputs(77, 64, seed=5)
    flash = _port_grads(q, k, v, w, causal)
    ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    (full_attention(*ts, causal) * torch.from_numpy(w)).sum().backward()
    for name, g, t in zip("qkv", flash, ts):
        np.testing.assert_allclose(g, t.grad.numpy(), atol=5e-5, rtol=0,
                                   err_msg=name)


def test_kernel_wrappers_on_cpu_match_the_plain_backward():
    q, k, v, w = (torch.from_numpy(x) for x in _inputs(130, 32, seed=2))
    o, lse = tfa.flash_attention_fwd(q, k, v, True)
    want = tfa.flash_attention_bwd_plain(q, k, v, o, lse, w, True)
    dq, delta = tfa.flash_attention_dq(q, k, v, o, w, lse, True)
    assert torch.equal(delta, tfa.attention_delta(o, w))
    dk, dv = tfa.flash_attention_dkv(q, k, v, w, lse, delta, True)
    for got, ref in zip((dq, dk, dv), want):
        assert torch.equal(got, ref)
    # delta is rowsum(dO * O) per (b*h, s) row
    want_delta = torch.einsum("bshd,bshd->bhs", w, o).reshape(B * H, 130)
    np.testing.assert_allclose(delta.numpy(), want_delta.numpy(), atol=1e-5)


def test_cpu_tensors_leave_every_kernel_counter_unchanged():
    q, k, v, w = (torch.from_numpy(x).requires_grad_()
                  for x in _inputs(49, 32, seed=3))
    counters = (tfa.flash_attention_fwd, tfa.flash_attention_dq,
                tfa.flash_attention_dkv)
    before = [c.launches for c in counters]
    (tfa.flash_attention(q, k, v) * w.detach()).sum().backward()
    assert q.grad is not None and k.grad is not None and v.grad is not None
    assert [c.launches for c in counters] == before


@pytest.mark.parametrize("name,wrapper", [
    ("dpt_flash_dq", tfa.flash_attention_dq),
    ("dpt_flash_dkv", tfa.flash_attention_dkv)])
def test_an_empty_problem_is_not_counted_as_a_launch(name, wrapper):
    """The launch helper returns before reaching the card when S = 0, and
    counts a launch only after one: the counters stay as they were, on
    either route."""
    q = torch.zeros((1, 0, 4, 32))
    lse = torch.zeros((4, 0))
    n_strided = 5 if name == "dpt_flash_dq" else 4
    for tensor_core in (False, True):
        before = (wrapper.launches, wrapper.tensor_core_launches)
        tfa._launch_bwd(name, (q, q, q, q, q, lse), (lse, q), False, wrapper,
                        n_strided, tensor_core=tensor_core)
        assert (wrapper.launches, wrapper.tensor_core_launches) == before


def test_gradient_flows_into_strided_qkv_views():
    """The vit's q, k, v are views into one projection; their gradients
    land in the projection's gradient."""
    rng = np.random.default_rng(4)
    qkv = torch.from_numpy(rng.standard_normal((B, 49, 3 * H * 32))
                           .astype(np.float32)).requires_grad_()
    w = torch.from_numpy(rng.standard_normal((B, 49, H, 32))
                         .astype(np.float32))
    q, k, v = (t.reshape(B, 49, H, 32) for t in qkv.split(H * 32, dim=-1))
    assert not q.is_contiguous()
    (tfa.flash_attention(q, k, v) * w).sum().backward()
    ref = qkv.detach().clone().requires_grad_()
    rq, rk, rv = (t.reshape(B, 49, H, 32) for t in ref.split(H * 32, dim=-1))
    (full_attention(rq, rk, rv) * w).sum().backward()
    np.testing.assert_allclose(qkv.grad.numpy(), ref.grad.numpy(),
                               atol=5e-5, rtol=0)


def test_inference_mode_forward_keeps_nothing_and_runs():
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(49, 32, seed=6))
    with torch.inference_mode():
        o = tfa.flash_attention(q, k, v)
    assert o.grad_fn is None
    np.testing.assert_allclose(o.numpy(), full_attention(q, k, v).numpy(),
                               atol=1e-5)


def test_backward_wrappers_check_their_inputs():
    q = torch.zeros((1, 49, 4, 32))
    lse = torch.zeros((4, 49))
    with pytest.raises(ValueError, match="dO must match"):
        tfa.flash_attention_dq(q, q, q, q, q[:, :48], lse)
    with pytest.raises(ValueError, match="O must match"):
        tfa.flash_attention_dq(q, q, q, q.double(), q, lse)
    with pytest.raises(ValueError, match="lse must be a contiguous"):
        tfa.flash_attention_dkv(q, q, q, q, lse[:, :48], lse)
    meta = torch.empty((1, 49, 4, 32), device="meta")
    mlse = torch.empty((4, 49), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tfa.flash_attention_dq(meta, meta, meta, meta, meta, mlse)


def test_plain_backward_scales_the_product_not_q():
    """s = (q . k) * scale, as the JAX backward kernels compute it: the
    plain dq equals the analytic softmax gradient at a single key block."""
    q, k, v, w = (torch.from_numpy(x) for x in _inputs(20, 32, seed=8))
    o, lse = tfa.flash_attention_plain(q, k, v)
    dq, _, _ = tfa.flash_attention_bwd_plain(q, k, v, o, lse, w)
    scale = 1.0 / math.sqrt(32)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    p = torch.softmax(s, dim=-1)
    dp = torch.einsum("bqhd,bkhd->bhqk", w, v)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    want = torch.einsum("bhqk,bkhd->bqhd", ds, k) * scale
    np.testing.assert_allclose(dq.numpy(), want.numpy(), atol=5e-5)


# -- K2's delta and the route rule ------------------------------------------

DELTA_S, DELTA_D = 49, 32


@pytest.fixture(scope="module")
def jax_forward():
    """One causal forward of the JAX package's Pallas flash attention
    (interpret mode) and the inputs it ran on, shared by this section."""
    q, k, v, do = _inputs(DELTA_S, DELTA_D, seed=21)
    o = jfa.flash_attention(*(jnp.asarray(x) for x in (q, k, v)),
                            causal=True)
    return q, k, v, do, np.asarray(o, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k2_delta_matches_the_jax_formula(jax_forward, dtype):
    """The delta that ``flash_attention_dq`` returns is
    ``_flash_bwd_impl``'s jnp.sum(do.astype(f32) * o.astype(f32), -1) on
    the JAX forward's O, laid out (B*H, S)."""
    q, k, v, do, o = jax_forward
    jdt = getattr(jnp, dtype)
    jo, jdo = jnp.asarray(o, jdt), jnp.asarray(do, jdt)
    want = jnp.sum(jdo.astype(jnp.float32) * jo.astype(jnp.float32), -1)
    want = np.asarray(want).transpose(0, 2, 1).reshape(B * H, DELTA_S)
    tdt = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(x).to(tdt) for x in (q, k, v))
    to = torch.from_numpy(np.array(jo.astype(jnp.float32))).to(tdt)
    tdo = torch.from_numpy(np.array(jdo.astype(jnp.float32))).to(tdt)
    _, lse = tfa.flash_attention_plain(tq, tk, tv, True)
    _, delta = tfa.flash_attention_dq(tq, tk, tv, to, tdo, lse, True)
    assert delta.shape == (B * H, DELTA_S) and delta.dtype == torch.float32
    np.testing.assert_allclose(delta.numpy(), want, rtol=1e-5, atol=1e-6)


def _route_case(case):
    """(dtype, q, k, v, dO, O) of one route-rule case."""
    b, s, h = 2, 49, 4
    d = 128 if case == "bf16 D=128" else 64 if case == "bf16 D=64" else 32
    dtype = torch.float32 if case == "f32 D=32" else torch.bfloat16
    # q, k, v as views into one (B, S, 3*H*D) projection, as in the vit
    qkv = torch.zeros((b, s, 3 * h * d), dtype=dtype)
    q, k, v = (t.reshape(b, s, h, d) for t in qkv.split(h * d, dim=-1))
    do = torch.zeros((b, s, h, d), dtype=dtype)
    if case == "bf16 dO one element off":
        do = torch.zeros(b * s * h * d + 1, dtype=dtype)[1:].view(b, s, h, d)
    return dtype, (q, k, v, do, torch.zeros_like(do))


@pytest.mark.parametrize("case,want", [
    ("bf16 D=32", True), ("bf16 D=64", True), ("f32 D=32", False),
    ("bf16 D=128", False), ("bf16 dO one element off", False)])
def test_tensor_core_route_rule(case, want):
    """bf16 at D = 32 or 64 on 16-byte-aligned views (the vit's q, k, v
    slice one projection) takes the tensor cores; f32, D = 128 and a view
    offset by one element take the scalar kernels, for K2 (with O) and K3
    alike."""
    dtype, tensors = _route_case(case)
    d = tensors[0].shape[3]
    for ts in (tensors, tensors[:4]):
        got = tfa.tensor_core_route(dtype, d, [t.stride() for t in ts],
                                    [t.data_ptr() for t in ts])
        assert got is want
    if not want:
        with pytest.raises(ValueError, match="tensor-core K2/K3"):
            tfa._pick_route(True, tensors)
    assert tfa._pick_route(False, tensors) is False
    assert tfa._pick_route(None, tensors) is want
