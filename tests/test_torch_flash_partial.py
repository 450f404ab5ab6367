"""The ring's per-step kernels: K4 (``flash_attention_partial``) and its
backward K2p/K3p, through the port's ``FlashAttentionPartial`` (their
plain versions on the CPU), held against the JAX package's
``flash_attention_partial`` and its ``jax.vjp`` with both cotangents (dO
and dlse), in Pallas interpret mode with the adaptive block that
``_ring_jitted`` gives a CPU shard (the shard length rounded up to 8).
The JAX side takes the shard padded to that block, the padding's
positions at ``_FAR``, as ``_ring_local_flash`` pads it; the port takes
the same padded tensors and positions, so the ``_FAR`` rows are compared
too.  Inputs, dO and dlse come from numpy with a seed.

Tolerances: f32 inputs, 1e-5 on O and lse (the same f32 math in other key
tiles: the TPU kernel's block of 32 against the port's 64) and 5e-5 on
the gradients; bf16 inputs, the same on O and lse (both widen bf16
exactly and compute in f32) and 2e-2 of the largest gradient (one bf16
rounding of each gradient).  A fully masked row gives O = 0 and lse =
-1e30 in both, and its dO reaches dv of every masked key in both (the TPU
``_dkv_kernel`` does not mask p again before dv)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedpytorch_tpu.ops import attention as jax_attention
from distributedpytorch_tpu.ops import flash_attention as jfa
from distributedpytorch_tpu_torch.ops import attention as tattention
from distributedpytorch_tpu_torch.ops import flash_attention as tfa

B, H, D = 2, 2, 32
S_LOCAL = 25                        # the vit's shard on a ring of two
BLOCK = -(-S_LOCAL // 8) * 8        # _ring_jitted's interpret-mode block
FAR = jax_attention._FAR


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _positions(block: int) -> np.ndarray:
    """Global positions of ring block ``block`` of S_LOCAL tokens, padded
    to BLOCK with _FAR."""
    pos = np.full(BLOCK, FAR, np.int32)
    pos[:S_LOCAL] = block * S_LOCAL + np.arange(S_LOCAL)
    return pos


# (name, q block, k block, causal, kv_valid)
CASES = [
    ("rank1_q_vs_rank0_kv", 1, 0, False, 49),      # the vit ring, M = 2
    ("rank1_q_vs_own_kv", 1, 1, False, 49),        # key 49 is padding
    ("causal_future_block", 0, 1, True, 50),       # every row fully masked
    ("causal_diagonal_block", 1, 1, True, 50),
    ("causal_past_block", 1, 0, True, 50),
    ("padded_keys_only", 0, 2, False, 50),         # keys 50.. all masked
]


def _inputs(seed: int, dtype):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, BLOCK, H, D)).astype(np.float32)
               for _ in range(3))
    for x in (q, k, v):
        x[:, S_LOCAL:] = 0.0        # the ring's zero padding
    do = rng.standard_normal((B, BLOCK, H, D)).astype(np.float32)
    dlse = rng.standard_normal((B * H, BLOCK)).astype(np.float32)
    if dtype == "bfloat16":          # both sides see the same bf16 values
        q, k, v = (np.asarray(torch.from_numpy(x).bfloat16().float())
                   for x in (q, k, v))
    return q, k, v, do, dlse


def _to_bh(x):
    """(B, S, H, D) -> the JAX kernels' (B*H, S, D)."""
    return np.ascontiguousarray(x.transpose(0, 2, 1, 3).reshape(
        B * H, BLOCK, D))


def _from_bh(x):
    return np.asarray(x, np.float32).reshape(B, H, BLOCK, D).transpose(
        0, 2, 1, 3)


def _jax(q, k, v, do, dlse, q_pos, k_pos, causal, kv_valid, dtype):
    jdt = getattr(jnp, dtype)
    qp, kp = jnp.asarray(q_pos), jnp.asarray(k_pos)

    def fn(a, b, c):
        return jfa.flash_attention_partial(a, b, c, qp, kp, causal,
                                           kv_valid, BLOCK)

    args = [jnp.asarray(_to_bh(x), jdt) for x in (q, k, v)]
    (o, lse), vjp = jax.vjp(fn, *args)
    dq, dk, dv = vjp((jnp.asarray(_to_bh(do)), jnp.asarray(dlse)))
    return (_from_bh(o), np.asarray(lse),
            [_from_bh(np.asarray(g, np.float32)) for g in (dq, dk, dv)])


def _port(q, k, v, do, dlse, q_pos, k_pos, causal, kv_valid, dtype):
    tdt = getattr(torch, dtype)
    ts = [torch.from_numpy(x).to(tdt).requires_grad_() for x in (q, k, v)]
    o, lse = tfa.flash_attention_partial(
        *ts, torch.from_numpy(q_pos), torch.from_numpy(k_pos), causal,
        kv_valid)
    assert o.dtype == torch.float32 and lse.shape == (B * H, BLOCK)
    ((o * torch.from_numpy(do)).sum()
     + (lse * torch.from_numpy(dlse)).sum()).backward()
    assert all(t.grad.dtype == tdt for t in ts)
    return (o.detach().numpy(), lse.detach().numpy(),
            [t.grad.float().numpy() for t in ts])


@pytest.fixture(scope="module")
def results():
    """Both sides of every case, in both dtypes."""
    out = {}
    for i, (name, qb, kb, causal, kv_valid) in enumerate(CASES):
        for dtype in ("float32", "bfloat16"):
            args = _inputs(i, dtype) + (_positions(qb), _positions(kb),
                                        causal, kv_valid, dtype)
            out[(name, dtype)] = (_jax(*args), _port(*args), args)
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_k4_output_and_lse_match_jax(results, name, dtype):
    (jo, jlse, _), (po, plse, _), _ = results[(name, dtype)]
    np.testing.assert_allclose(po, jo, atol=1e-5, rtol=0)
    np.testing.assert_allclose(plse, jlse, atol=1e-5, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_k2p_k3p_gradients_match_jax_vjp(results, name, dtype):
    (_, _, jgrads), (_, _, pgrads), _ = results[(name, dtype)]
    for g, w, what in zip(pgrads, jgrads, ("dq", "dk", "dv")):
        if dtype == "float32":
            np.testing.assert_allclose(g, w, atol=5e-5, rtol=0,
                                       err_msg=what)
        else:
            assert np.abs(g - w).max() <= 2e-2 * np.abs(w).max(), what


def test_fully_masked_rows_give_zero_output_and_the_sentinel_lse(results):
    """The real rows of a causal future block (the _FAR padding rows see
    every key below kv_valid)."""
    (jo, jlse, jgrads), (po, plse, pgrads), _ = \
        results[("causal_future_block", "float32")]
    real = slice(0, S_LOCAL)
    assert not po[:, real].any() and not jo[:, real].any()
    lse_real = plse.reshape(B, H, BLOCK)[:, :, real]
    assert (lse_real == np.float32(-1e30)).all()
    assert (jlse.reshape(B, H, BLOCK)[:, :, real] == lse_real).all()
    # their dq is 0, and their dO reaches dv (p = exp(0) = 1 there)
    assert not pgrads[0][:, real].any() and pgrads[2].any()
    np.testing.assert_allclose(pgrads[2], jgrads[2], atol=5e-5, rtol=0)


def test_merge_of_fully_masked_partials_adds_exactly_nothing():
    """A causal future block (lse = -1e30) merged into a real partial gets
    the weight 0: the merge returns the real partial, and no gradient
    reaches the masked partial."""
    rng = np.random.default_rng(3)
    o = torch.from_numpy(rng.standard_normal((B, 8, H, D)).astype(
        np.float32)).requires_grad_()
    lse = torch.from_numpy(rng.standard_normal((B * H, 8)).astype(
        np.float32)).requires_grad_()
    o_m = torch.zeros((B, 8, H, D), requires_grad=True)
    lse_m = torch.full((B * H, 8), -1e30, requires_grad=True)
    mo, mlse = tattention._merge_partials(o, lse, o_m, lse_m)
    assert torch.equal(mo, o) and torch.equal(mlse, lse)
    (mo.sum() + mlse.sum()).backward()
    assert not o_m.grad.any() and not lse_m.grad.any()


def test_wrappers_on_cpu_equal_the_plain_versions_and_count_nothing(results):
    q, k, v, do, dlse, q_pos, k_pos, causal, kv_valid, _ = \
        results[("rank1_q_vs_own_kv", "float32")][2]
    q, k, v, do, dlse = (torch.from_numpy(x) for x in (q, k, v, do, dlse))
    qp, kp = torch.from_numpy(q_pos), torch.from_numpy(k_pos)
    counters = (tfa.flash_attention_partial_fwd, tfa.flash_attention_partial_dq,
                tfa.flash_attention_partial_dkv)
    before = [c.launches for c in counters]
    o, lse = tfa.flash_attention_partial_fwd(q, k, v, qp, kp, causal,
                                             kv_valid)
    po, plse = tfa.flash_attention_partial_plain(q, k, v, qp, kp, causal,
                                                 kv_valid)
    assert torch.equal(o, po) and torch.equal(lse, plse)
    delta = tfa.partial_delta(o, do, dlse)
    want = tfa.flash_attention_partial_bwd_plain(q, k, v, o, lse, do, dlse,
                                                 qp, kp, causal, kv_valid)
    dq = tfa.flash_attention_partial_dq(q, k, v, do, lse, delta, qp, kp,
                                        causal, kv_valid)
    dk, dv = tfa.flash_attention_partial_dkv(q, k, v, do, lse, delta, qp, kp,
                                             causal, kv_valid)
    for got, ref in zip((dq, dk, dv), want):
        assert torch.equal(got, ref)
    assert [c.launches for c in counters] == before
    # delta = rowsum(dO * O) - dlse, per (b*h, s) row
    want_delta = (torch.einsum("bshd,bshd->bhs", do, o).reshape(B * H, -1)
                  - dlse)
    np.testing.assert_allclose(delta.numpy(), want_delta.numpy(), atol=1e-5)


def test_partial_wrappers_check_positions_and_do():
    q = torch.zeros((1, 8, 2, 32))
    pos = torch.arange(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="q_pos must be a contiguous"):
        tfa.flash_attention_partial_fwd(q, q, q, pos[:7], pos)
    with pytest.raises(ValueError, match="k_pos must be a contiguous"):
        tfa.flash_attention_partial_fwd(q, q, q, pos, pos.long())
    lse = torch.zeros((2, 8))
    with pytest.raises(ValueError, match="dO must match"):
        tfa.flash_attention_partial_dq(q.bfloat16(), q.bfloat16(),
                                       q.bfloat16(), q.bfloat16(), lse, lse,
                                       pos, pos)


def test_k1_plain_is_the_positional_plain_at_identity_positions():
    """K4 with positions 0..S-1 and no kv_valid is K1 in f32: the same
    blocks, masks and sums."""
    rng = np.random.default_rng(9)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, 70, H, D)).astype(
        np.float32)) for _ in range(3))
    pos = torch.arange(70, dtype=torch.int32)
    for causal in (False, True):
        o, lse = tfa.flash_attention_plain(q, k, v, causal)
        po, plse = tfa.flash_attention_partial_plain(q, k, v, pos, pos,
                                                     causal)
        assert torch.equal(o, po) and torch.equal(lse, plse)
