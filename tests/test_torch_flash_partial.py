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
``_dkv_kernel`` does not mask p again before dv).  K4's tensor-core
numerics (p rounded to bf16 before the P V product) are held to the JAX
kernel at chip_smoke.py's ``TOL_O_POS_TC``, 2e-2 on O (the rounding moves
O by at most about 2^-9 max|v|, and the ring casts its merged O to bf16
anyway), and 1e-4 on lse (``TOL_LSE``: the rounding leaves lse alone)."""

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


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_k4_tensor_core_numerics_match_jax(results, name):
    """The plain version with the tensor-core route's rounding of p
    (``_fwd_blocks(p_bf16=True)``) on the bf16 shard against the JAX
    kernel: O within 2e-2, lse within 1e-4, and a row whose keys are all
    masked gives O = 0 and lse = -1e30 exactly."""
    (jo, jlse, _), _, args = results[(name, "bfloat16")]
    q, k, v, _, _, q_pos, k_pos, causal, kv_valid, _ = args
    tq, tk, tv = (torch.from_numpy(x).bfloat16() for x in (q, k, v))
    qp, kp = torch.from_numpy(q_pos), torch.from_numpy(k_pos)
    o, lse = tfa._fwd_blocks(tq, tk, tv,
                             tfa._pos_mask(qp, kp, causal, kv_valid),
                             torch.float32, p_bf16=True)
    np.testing.assert_allclose(o.numpy(), jo, atol=2e-2, rtol=0)
    np.testing.assert_allclose(lse.numpy(), jlse, atol=1e-4, rtol=0)
    keep = np.ones((BLOCK, BLOCK), bool)
    if causal:
        keep &= q_pos[:, None] >= k_pos[None, :]
    if kv_valid is not None:
        keep &= (k_pos < kv_valid)[None, :]
    dead = ~keep.any(axis=1)
    assert not o.numpy()[:, dead].any()
    assert (lse.numpy().reshape(B, H, BLOCK)[:, :, dead]
            == np.float32(-1e30)).all()


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
    before = [(c.launches, c.tensor_core_launches) for c in counters]
    o, lse = tfa.flash_attention_partial_fwd(q, k, v, qp, kp, causal,
                                             kv_valid)
    po, plse = tfa.flash_attention_partial_plain(q, k, v, qp, kp, causal,
                                                 kv_valid)
    assert torch.equal(o, po) and torch.equal(lse, plse)
    want = tfa.flash_attention_partial_bwd_plain(q, k, v, o, lse, do, dlse,
                                                 qp, kp, causal, kv_valid)
    dq, delta, do_k3 = tfa.flash_attention_partial_dq(
        q, k, v, o, do, lse, dlse, qp, kp, causal, kv_valid)
    assert do_k3 is do               # the plain version reads the f32 dO
    assert torch.equal(delta, tfa.partial_delta(o, do, dlse))
    dk, dv = tfa.flash_attention_partial_dkv(q, k, v, do_k3, lse, delta, qp,
                                             kp, causal, kv_valid)
    both = tfa.flash_attention_partial_bwd(q, k, v, o, lse, do, dlse, qp, kp,
                                           causal, kv_valid)
    for got, again, ref in zip((dq, dk, dv), both, want):
        assert torch.equal(got, ref) and torch.equal(again, ref)
    # bf16 at the vit's shard would take the tensor cores on the card
    tfa.flash_attention_partial_fwd(q.bfloat16(), k.bfloat16(),
                                    v.bfloat16(), qp, kp, causal, kv_valid)
    assert [(c.launches, c.tensor_core_launches)
            for c in counters] == before
    # delta = rowsum(dO * O) - dlse, per (b*h, s) row
    want_delta = (torch.einsum("bshd,bshd->bhs", do, o).reshape(B * H, -1)
                  - dlse)
    np.testing.assert_allclose(delta.numpy(), want_delta.numpy(), atol=1e-5)


def test_partial_wrappers_check_positions_and_do():
    q = torch.zeros((1, 8, 2, 32))
    qb = q.bfloat16()
    pos = torch.arange(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="q_pos must be a contiguous"):
        tfa.flash_attention_partial_fwd(q, q, q, pos[:7], pos)
    with pytest.raises(ValueError, match="k_pos must be a contiguous"):
        tfa.flash_attention_partial_fwd(q, q, q, pos, pos.long())
    lse = torch.zeros((2, 8))
    # K2p takes K4's f32 O and its f32 cotangent, and a contiguous dlse
    with pytest.raises(ValueError, match="dO must match"):
        tfa.flash_attention_partial_dq(qb, qb, qb, q, qb, lse, None, pos,
                                       pos)
    with pytest.raises(ValueError, match="O must match"):
        tfa.flash_attention_partial_dq(qb, qb, qb, qb, q, lse, None, pos,
                                       pos)
    with pytest.raises(ValueError, match="dlse must be a contiguous"):
        tfa.flash_attention_partial_dq(qb, qb, qb, q, q, lse,
                                       torch.zeros((8, 2)).t(), pos, pos)
    # K3p takes the f32 dO or K2p's bf16 copy
    with pytest.raises(ValueError, match="dO must match"):
        tfa.flash_attention_partial_dkv(qb, qb, qb, q.double(), lse, lse,
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


# -- K2p/K3p's two routes --------------------------------------------------

def _route_case(case):
    """K2p's tensors (q, k, v, the f32 dO and O) and K3p's (q, k, v and
    the bf16 dO that K2p's tensor-core route writes) of one route-rule
    case, at the vit's ring shard."""
    b, s, h = 2, S_LOCAL, 4
    d = 128 if case == "bf16 D=128" else 64 if case == "bf16 D=64" else 32
    dtype = torch.float32 if case == "f32 D=32" else torch.bfloat16
    # q, k, v as views into one (B, S, 3*H*D) projection, as in the vit
    qkv = torch.zeros((b, s, 3 * h * d), dtype=dtype)
    q, k, v = (t.reshape(b, s, h, d) for t in qkv.split(h * d, dim=-1))
    n = b * s * h * d
    off = int(case == "dO one element off")
    do = torch.zeros(n + off)[off:].view(b, s, h, d)
    do16 = torch.zeros(n + off, dtype=torch.bfloat16)[off:].view(b, s, h, d)
    return (q, k, v, do, torch.zeros_like(do)), (q, k, v, do16)


@pytest.mark.parametrize("case,want", [
    ("bf16 D=32", True), ("bf16 D=64", True), ("f32 D=32", False),
    ("bf16 D=128", False), ("dO one element off", False)])
def test_partial_tensor_core_route_rule(case, want):
    """bf16 q, k, v at D = 32 or 64 on the vit's views, with K2p's f32 dO
    and O (or K3p's bf16 dO) on 16-byte-aligned rows, take the tensor
    cores; f32, D = 128 and a dO offset by one element take the scalar
    kernels; forcing the tensor cores on a misfit raises."""
    for ts in _route_case(case):
        got = tfa.partial_tensor_core_route(
            [t.dtype for t in ts], ts[0].shape[3], [t.stride() for t in ts],
            [t.data_ptr() for t in ts])
        assert got is want
        assert tfa._pick_route(None, ts, positional=True) is want
        assert tfa._pick_route(False, ts, positional=True) is False
        if not want:
            with pytest.raises(ValueError, match="tensor-core K2p/K3p"):
                tfa._pick_route(True, ts, positional=True)
    # K2p reads dO in f32 and K3p in bf16: the other dtype does not fit
    k2p, k3p = _route_case(case)
    assert not tfa._pick_route(None, k2p[:3] + (k3p[3], k2p[4]),
                               positional=True)
    assert not tfa._pick_route(None, k3p[:3] + (k2p[3],), positional=True)


@pytest.mark.parametrize("with_dlse", [True, False])
def test_k2p_delta_matches_the_jax_formula(results, with_dlse):
    """The delta that ``flash_attention_partial_dq`` returns is
    ``_flash_bwd_impl``'s rowsum(dO * O) - dlse, in jnp on the JAX
    forward's O; without dlse (None) it is rowsum(dO * O)."""
    (jo, jlse, _), _, args = results[("rank1_q_vs_rank0_kv", "float32")]
    q, k, v, do, dlse, q_pos, k_pos, causal, kv_valid, _ = args
    want = jnp.sum(jnp.asarray(_to_bh(do)) * jnp.asarray(_to_bh(jo)), -1)
    if with_dlse:
        want = want - jnp.asarray(dlse)
    t = torch.from_numpy
    _, delta, _ = tfa.flash_attention_partial_dq(
        t(q), t(k), t(v), t(np.ascontiguousarray(jo)), t(do),
        t(np.array(jlse)), t(dlse) if with_dlse else None, t(q_pos),
        t(k_pos), causal, kv_valid)
    assert delta.shape == (B * H, BLOCK) and delta.dtype == torch.float32
    np.testing.assert_allclose(delta.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("name", ["rank1_q_vs_rank0_kv",
                                  "causal_future_block"])
def test_plain_backward_of_a_bf16_rounded_do_matches_jax(results, name):
    """The tensor-core K2p rounds dO to bf16 for the products dO V^T and
    P^T dO: the plain backward fed that rounded dO stays within 2e-2 of
    the largest gradient of JAX's VJP (of the f32 dO), at the vit's shard
    and where every real row is masked (dv there is the sum of dO)."""
    (_, _, jgrads), _, args = results[(name, "bfloat16")]
    q, k, v, do, dlse, q_pos, k_pos, causal, kv_valid, _ = args
    tq, tk, tv = (torch.from_numpy(x).bfloat16() for x in (q, k, v))
    qp, kp = torch.from_numpy(q_pos), torch.from_numpy(k_pos)
    o, lse = tfa.flash_attention_partial_plain(tq, tk, tv, qp, kp, causal,
                                               kv_valid)
    do16 = torch.from_numpy(do).bfloat16().float()
    grads = tfa.flash_attention_partial_bwd_plain(
        tq, tk, tv, o, lse, do16, torch.from_numpy(dlse), qp, kp, causal,
        kv_valid)
    for g, w, what in zip(grads, jgrads, ("dq", "dk", "dv")):
        assert np.abs(g.float().numpy() - w).max() \
            <= 2e-2 * np.abs(w).max(), what
