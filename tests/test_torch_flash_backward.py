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
    delta = tfa.attention_delta(o, w)
    want = tfa.flash_attention_bwd_plain(q, k, v, o, lse, w, True)
    dq = tfa.flash_attention_dq(q, k, v, w, lse, delta, True)
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
    counts a launch only after one: the counter stays as it was."""
    q = torch.zeros((1, 0, 4, 32))
    lse = torch.zeros((4, 0))
    before = wrapper.launches
    tfa._launch_bwd(name, q, q, q, q, lse, lse, False, (q,), wrapper)
    assert wrapper.launches == before


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
        tfa.flash_attention_dq(q, q, q, q[:, :48], lse, lse)
    with pytest.raises(ValueError, match="lse must be a contiguous"):
        tfa.flash_attention_dkv(q, q, q, q, lse[:, :48], lse)
    meta = torch.empty((1, 49, 4, 32), device="meta")
    mlse = torch.empty((4, 49), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tfa.flash_attention_dq(meta, meta, meta, meta, mlse, mlse)


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
