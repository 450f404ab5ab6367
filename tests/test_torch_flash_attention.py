"""The port's flash-attention forward (kernel K1's plain version on the
CPU) held against the JAX package's Pallas flash kernel, which runs here
in Pallas interpret mode: outputs and the per-row log-sum-exp, causal and
bidirectional, ragged and block-aligned S.  Inputs come from numpy with a
seed and go to both sides.  Tolerances: 1e-5 in f32 (the same f32 math in
another summation order), 2e-2 in bf16 (one bf16 rounding of O)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedpytorch_tpu.ops import flash_attention as jfa
from distributedpytorch_tpu_torch.ops import flash_attention as tfa
from distributedpytorch_tpu_torch.ops.attention import full_attention

B, H = 2, 2


def _qkv(s, d, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, s, H, d)).astype(np.float32)
            for _ in range(3)]


def _jax_lse(q, k, v, causal):
    """lse[:, :, 0] of the JAX _flash_fwd on the wrapper's padded
    (B*H, S_pad, D) layout, sliced back to (B*H, S)."""
    b, s, h, d = q.shape
    block = jfa.BLOCK
    s_pad = -(-s // block) * block

    def to_bh(x):
        x = jnp.moveaxis(jnp.asarray(x), 2, 1).reshape(b * h, s, d)
        return jnp.pad(x, ((0, 0), (0, s_pad - s), (0, 0)))

    _, lse = jfa._flash_fwd(to_bh(q), to_bh(k), to_bh(v), causal,
                            s if s_pad != s else None, block)
    return np.asarray(lse)[:, :s, 0]


@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s", [49, 128, 200])
def test_plain_matches_jax_flash_f32(s, causal, d):
    q, k, v = _qkv(s, d, seed=s + d)
    want_o = np.asarray(jfa.flash_attention(
        *(jnp.asarray(x) for x in (q, k, v)), causal=causal))
    want_lse = _jax_lse(q, k, v, causal)
    got_o, got_lse = tfa.flash_attention_fwd(
        *(torch.from_numpy(x) for x in (q, k, v)), causal)
    assert got_o.shape == (B, s, H, d) and got_lse.shape == (B * H, s)
    np.testing.assert_allclose(got_o.numpy(), want_o, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got_lse.numpy(), want_lse, atol=1e-5, rtol=0)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s", [49, 128])
def test_plain_matches_jax_flash_bf16(s, causal):
    q, k, v = _qkv(s, 32, seed=7)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    want = np.asarray(jfa.flash_attention(jq, jk, jv, causal=causal),
                      np.float32)
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    got = tfa.flash_attention(tq, tk, tv, causal)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=2e-2, rtol=0)


@pytest.mark.parametrize("causal", [False, True])
def test_cpu_tensor_takes_plain_path_without_counting(causal):
    q, k, v = (torch.from_numpy(x) for x in _qkv(49, 32, seed=3))
    before = tfa.flash_attention_fwd.launches
    o, lse = tfa.flash_attention_fwd(q, k, v, causal)
    assert tfa.flash_attention_fwd.launches == before
    po, plse = tfa.flash_attention_plain(q, k, v, causal)
    assert torch.equal(o, po) and torch.equal(lse, plse)
    np.testing.assert_allclose(o.numpy(), full_attention(q, k, v, causal)
                               .numpy(), atol=1e-5, rtol=0)


def test_plain_lse_is_logsumexp_of_scaled_scores():
    q, k, v = (torch.from_numpy(x) for x in _qkv(200, 64, seed=5))
    _, lse = tfa.flash_attention_plain(q, k, v)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(64)
    want = torch.logsumexp(scores, dim=-1).reshape(B * H, 200)
    np.testing.assert_allclose(lse.numpy(), want.numpy(), atol=1e-5, rtol=0)


def test_plain_works_on_strided_qkv_views():
    """The vit hands the wrapper views into one qkv projection."""
    rng = np.random.default_rng(11)
    qkv = torch.from_numpy(rng.standard_normal((B, 49, 3 * H * 32))
                           .astype(np.float32))
    q, k, v = (t.reshape(B, 49, H, 32) for t in qkv.split(H * 32, dim=-1))
    assert not q.is_contiguous()
    o = tfa.flash_attention(q, k, v)
    np.testing.assert_allclose(
        o.numpy(), tfa.flash_attention(q.contiguous(), k.contiguous(),
                                       v.contiguous()).numpy(), atol=0)


def test_non_cpu_non_cuda_tensor_raises_instead_of_falling_back():
    q = torch.empty((1, 49, 4, 32), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tfa.flash_attention_fwd(q, q, q)


def test_mismatched_shapes_raise():
    q = torch.zeros((1, 49, 4, 32))
    with pytest.raises(ValueError, match="one \\(B, S, H, D\\) shape"):
        tfa.flash_attention_fwd(q, q[:, :48], q)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_plain_on_card(dtype):
    """K1 on the card against its plain version (chip_smoke.py runs the
    full shape list); needs an NVIDIA GPU and nvcc."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    gen = torch.Generator(device="cuda").manual_seed(0)
    dt = getattr(torch, dtype)
    for b, s, h, d, causal in ((64, 49, 4, 32, False), (2, 200, 2, 64, True),
                               (2, 1000, 2, 128, False)):
        qkv = torch.randn((b, s, 3 * h * d), generator=gen,
                          device="cuda").to(dt)
        q, k, v = (t.reshape(b, s, h, d) for t in qkv.split(h * d, dim=-1))
        before = tfa.flash_attention_fwd.launches
        o, lse = tfa.flash_attention_fwd(q, k, v, causal)
        torch.cuda.synchronize()
        assert tfa.flash_attention_fwd.launches == before + 1
        po, plse = tfa.flash_attention_plain(q, k, v, causal)
        tol = 2e-5 if dt == torch.float32 else 2e-2
        assert (o.float() - po.float()).abs().max().item() <= tol
        assert (lse - plse).abs().max().item() <= 1e-4
