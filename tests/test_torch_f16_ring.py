"""``--precision f16`` on the ring (``--attention ring_flash``): the ring's
kernels K4, K2p and K3p in float16 (their plain versions, which the
wrappers run on the CPU) against the JAX package's
``flash_attention_partial`` in Pallas interpret mode, with the non-finite
pattern of the backward at a dO near float16's range; then one f16 step
of the narrow vit at the loss scale 2^15 on two gloo ranks with
``ring_flash --model-parallel 2`` (``tests/_torch_ring_child.py``)
against one process with ``flash`` and against the JAX ring step in f16
on a mesh of two CPU devices, and a forced overflow on one model rank,
which must skip the step on both.  Inputs come from numpy with a seed.

Tolerances: 5e-3 relative to the largest value for the kernels' float16
outputs and gradients (one float16 rounding of each, 2^-11, of sums in
another order; ``test_torch_f16.py``'s rule for K1-K3), 1e-5 on K4's
f32 lse.  The step's parameter updates are held at 1e-2 of each
tensor's largest update (float16 rounds at the same points in every
world, but the ring splits the sums over the tokens, and the two
frameworks order them differently), the loss at 1e-3; XLA on the CPU sums a half-precision
bias gradient in half precision (ROADMAP queue 3 entry 2), so the dense
layers' biases are held to the port's one-process step only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedpytorch_tpu import runtime as jax_runtime
from distributedpytorch_tpu.data import augment as jax_augment
from distributedpytorch_tpu.models.vit import ViT as JaxViT
from distributedpytorch_tpu.ops import attention as jax_attention
from distributedpytorch_tpu.ops import losses as jax_losses
from distributedpytorch_tpu.precision import PRESETS as JAX_PRESETS
from distributedpytorch_tpu.train.engine import Engine as JaxEngine
from distributedpytorch_tpu.train.engine import (
    make_optimizer as jax_make_optimizer)
from distributedpytorch_tpu_torch.models import convert
from distributedpytorch_tpu_torch.ops import flash_attention as tfa
from tests.test_torch_flash_partial import (BLOCK, CASES, S_LOCAL, _jax,
                                            _port, _positions)
from tests.test_torch_ring import NARROW, _run_world

TOL_F16 = 5e-3
TOL_LSE = 1e-5
TOL_UPDATE = 1e-2
TOL_LOSS = 1e-3
F16_INF_AT = 65520.0        # float16 rounds a magnitude from here to inf
B, H, D = 2, 2, 32


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# -- K4, K2p, K3p in float16 --------------------------------------------------

def _inputs(seed: int, qk_std: float = 1.0, do_std: float = 1.0):
    """q, k, v rounded to float16 (both sides see the same values), the
    ring's zero padding past S_LOCAL; f32 cotangents dO and dlse."""
    rng = np.random.default_rng(seed)
    q, k = (rng.standard_normal((B, BLOCK, H, D)) * qk_std
            for _ in range(2))
    v = rng.standard_normal((B, BLOCK, H, D))
    q, k, v = (x.astype(np.float16).astype(np.float32) for x in (q, k, v))
    for x in (q, k, v):
        x[:, S_LOCAL:] = 0.0
    do = np.clip(rng.standard_normal((B, BLOCK, H, D)) * do_std,
                 -60000, 60000).astype(np.float32)
    dlse = rng.standard_normal((B * H, BLOCK)).astype(np.float32)
    return q, k, v, do, dlse


# the cases of test_torch_flash_partial, and the first one at a dO near
# float16's range (the loss scale's), where dS overflows float16
F16_CASES = [c + (1.0, 1.0) for c in CASES] + [
    ("overflow",) + CASES[0][1:] + (3.0, 2.0 ** 14)]


@pytest.fixture(scope="module", params=F16_CASES, ids=[c[0] for c in
                                                        F16_CASES])
def f16_case(request):
    """(name, the JAX outputs, the port's, the port's backward in f32)."""
    name, qb, kb, causal, kv_valid, qk_std, do_std = request.param
    i = [c[0] for c in F16_CASES].index(name)
    q, k, v, do, dlse = _inputs(40 + i, qk_std, do_std)
    args = (q, k, v, do, dlse, _positions(qb), _positions(kb), causal,
            kv_valid, "float16")
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    o, lse = tfa.flash_attention_partial_plain(
        tq, tk, tv, torch.from_numpy(args[5]), torch.from_numpy(args[6]),
        causal, kv_valid)
    delta = tfa.partial_delta(o, torch.from_numpy(do),
                              torch.from_numpy(dlse))
    ref32 = tfa._partial_bwd_blocks(
        tq, tk, tv, torch.from_numpy(do), lse, delta,
        torch.from_numpy(args[5]), torch.from_numpy(args[6]), causal,
        kv_valid)
    return name, _jax(*args), _port(*args), ref32


def test_f16_ring_kernels_match_jax_interpret(f16_case):
    """K4's O (f32) and lse, and K2p/K3p's dq, dk, dv (float16 on both
    sides) within TOL_F16 of the JAX kernels' largest value where both
    are finite."""
    _, (jo, jlse, jgrads), (o, lse, grads), _ = f16_case
    assert _rel(o, jo) <= TOL_F16
    assert _rel(lse, jlse) <= TOL_LSE
    for g, w in zip(grads, jgrads):
        fin = np.isfinite(g) & np.isfinite(w)
        assert fin.any()
        assert _rel(np.where(fin, g, 0), np.where(fin, w, 0)) <= TOL_F16


def test_f16_ring_backward_overflows_where_jax_does(f16_case):
    """Each gradient element is finite exactly where the JAX kernel's is,
    but within TOL_F16 x the largest value of 65520; only the overflow
    case has non-finite elements."""
    name, (_, _, jgrads), (_, _, grads), ref32 = f16_case
    for g, w, r in zip(grads, jgrads, ref32):
        a = r.abs().numpy()
        band = TOL_F16 * a.max()
        held = (a >= F16_INF_AT + band) | (a < F16_INF_AT - band)
        assert (np.isfinite(g) == np.isfinite(w))[held].all()
        assert np.isfinite(g).all() == (name != "overflow")


def test_f16_ring_wrappers_take_float16_on_the_cpu():
    """The float16 ring wrappers run the plain versions on the CPU and
    count no launch; K2p returns the f32 dO for K3p there."""
    q, k, v, do, dlse = (torch.from_numpy(x) for x in _inputs(3))
    q, k, v = (x.half() for x in (q, k, v))
    pos = torch.from_numpy(_positions(1)), torch.from_numpy(_positions(0))
    counts = [f.launches for f in (tfa.flash_attention_partial_fwd,
                                   tfa.flash_attention_partial_dq,
                                   tfa.flash_attention_partial_dkv)]
    o, lse = tfa.flash_attention_partial_fwd(q, k, v, *pos, False, 49)
    dq, delta, do_k3 = tfa.flash_attention_partial_dq(q, k, v, o, do, lse,
                                                      dlse, *pos, False, 49)
    dk, dv = tfa.flash_attention_partial_dkv(q, k, v, do_k3, lse, delta,
                                             *pos, False, 49)
    assert o.dtype == torch.float32 and do_k3 is do
    assert dq.dtype == dk.dtype == dv.dtype == torch.float16
    assert counts == [f.launches for f in (
        tfa.flash_attention_partial_fwd, tfa.flash_attention_partial_dq,
        tfa.flash_attention_partial_dkv)]


@pytest.mark.parametrize("dtype,want", [("float16", True),
                                        ("bfloat16", True),
                                        ("float32", False)])
def test_partial_route_rule_takes_float16(dtype, want):
    """K2p's and K3p's tensor cores take float16 q, k, v like bf16 (K2p
    with the f32 dO and O, K3p with the dO in q's dtype)."""
    dt = getattr(torch, dtype)
    q = torch.zeros((2, 25, 4, 32), dtype=dt)
    k2p = (q, q, q, torch.zeros(q.shape), torch.zeros(q.shape))
    k3p = (q, q, q, torch.zeros(q.shape, dtype=dt))
    for ts in (k2p, k3p):
        assert tfa._pick_route(None, ts, positional=True) is want
    mixed = (q, q, q, torch.zeros(q.shape, dtype=torch.bfloat16
                                  if dtype == "float16" else torch.float16))
    assert tfa._pick_route(None, mixed, positional=True) is False


# -- one f16 step of the narrow vit on the ring -------------------------------

def _batch():
    rng = np.random.default_rng(31)
    images = rng.integers(0, 256, (8, 28, 28), dtype=np.uint8)
    labels = rng.integers(0, 10, 8).astype(np.int32)
    valid = np.ones(8, bool)
    valid[-2:] = False
    return images, labels, valid, jax.random.PRNGKey(310)


@pytest.fixture(scope="module")
def f16_worlds(tmp_path_factory):
    """The JAX ring step in f16 on two devices, and the port's worlds on
    its initial parameters: ``ring_flash`` on 2 ranks, ``flash`` in one
    process, and ``ring_flash`` on 2 ranks with rank 1's first step
    overflowing, then a second finite step."""
    mesh = jax_runtime.make_mesh(data_parallel=1, model_parallel=2,
                                 devices=jax.devices()[:2])
    prec = JAX_PRESETS["f16"]
    model = JaxViT(dtype=prec.compute_dtype, num_classes=10,
                   attention_fn=jax_attention.make_ring_attention(
                       mesh, use_flash=True), **NARROW)
    tx = jax_make_optimizer("SGD", 1e-3, 0.9, 0.1, 2, False)
    engine = JaxEngine(model, "vit", jax_losses.cross_entropy, tx, 0.13,
                       0.31, 28, precision=prec)
    state = engine.init_state(jax.random.PRNGKey(3))
    init = convert.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                          state.params))
    images, labels, valid, key = _batch()
    draws = [np.asarray(x) for x in
             jax_augment._sample_affine_batch(key, 8, 28, 28)]
    state, m = jax.jit(engine._train_step_keys)(
        state, jnp.asarray(images), jnp.asarray(labels),
        jnp.asarray(valid), key, key)
    want = {"params": convert.params_from_jax(jax.tree_util.tree_map(
        np.asarray, state.params)), "loss": float(m["loss"]),
        "scale": float(state.loss_scale.scale),
        "good_steps": int(state.loss_scale.good_steps)}
    step = (images, labels, valid, draws)
    base = dict(arch=NARROW, seed=0, precision="f16",
                params={k: v.numpy() for k, v in init.items()})
    tmp = tmp_path_factory.mktemp("f16ring")
    ring = _run_world(tmp, "ring", 2, "vit",
                      dict(base, attention="ring_flash", steps=[step]),
                      "--model-parallel", "2")
    flash = _run_world(tmp, "flash", 1, "vit",
                       dict(base, attention="flash", steps=[step]))[0]
    skip = _run_world(tmp, "skip", 2, "vit",
                      dict(base, attention="ring_flash",
                           steps=[step, step], overflow=(0, 1)),
                      "--model-parallel", "2")
    return init, want, ring, flash, skip


def _dense_bias(name: str) -> bool:
    return name.endswith(".bias") and not name.startswith(("norm",
                                                           "blocks.0.ln",
                                                           "blocks.1.ln"))


def test_f16_ring_step_equals_one_process_flash(f16_worlds):
    """Both ranks end equal; their update is the one-process flash
    step's, every parameter within TOL_UPDATE of its largest update; the
    same loss, scale and counts; the ring launched K4/K2p/K3p (their
    plain versions' counters stay 0 on the CPU: no launch) and no K1."""
    init, _, ring, flash, _ = f16_worlds
    for k, v in ring[1]["state"].items():
        assert torch.equal(v, ring[0]["state"][k]), k
    for name, p0 in init.items():
        got = ring[0]["state"][name] - p0
        want = flash["state"][name] - p0
        assert _rel(got, want) <= TOL_UPDATE, name
    assert abs(ring[0]["metrics"][0][0] - flash["metrics"][0][0]) <= \
        TOL_LOSS * abs(flash["metrics"][0][0])
    assert ring[0]["metrics"][0][1:] == flash["metrics"][0][1:]
    for r in ring + [flash]:
        assert r["counters"] == (1, 1)
        assert r["loss_scale"] == {"scale": 2.0 ** 15, "good_steps": 1}


def test_f16_ring_step_takes_the_jax_decision(f16_worlds):
    """The JAX ring's f16 step: the same skip decision and scale, the
    loss within TOL_LOSS, every update but the dense biases' within
    TOL_UPDATE of its largest."""
    init, want, ring, _, _ = f16_worlds
    assert ring[0]["loss_scale"] == {"scale": want["scale"],
                                     "good_steps": want["good_steps"]}
    assert abs(ring[0]["metrics"][0][0] - want["loss"]) <= \
        TOL_LOSS * abs(want["loss"])
    for name, p0 in init.items():
        if _dense_bias(name):
            continue
        assert _rel(ring[0]["state"][name] - p0,
                    want["params"][name] - p0) <= TOL_UPDATE, name


def test_overflow_on_one_model_rank_skips_the_step_on_both(f16_worlds):
    """Rank 1's first step overflows: both ranks skip it (DDP's mean
    carries the inf to rank 0), halve the scale and keep their
    parameters; the second, finite step applies on both, as the
    one-step ring applies its first."""
    init, _, ring, _, skip = f16_worlds
    for r in skip:
        assert r["counters"] == (2, 1)
        assert r["loss_scale"] == {"scale": 2.0 ** 14, "good_steps": 1}
        # only rank 1's loss overflowed; rank 0 skips on its gradients
        assert np.isfinite(r["metrics"][0][0]) == (r["rank"] == 0)
        assert np.isfinite(r["metrics"][1][0])
    for k, v in skip[1]["state"].items():
        assert torch.equal(v, skip[0]["state"][k]), k
    for name, p0 in init.items():
        assert not torch.equal(skip[0]["state"][name], p0) or \
            torch.equal(ring[0]["state"][name], p0), name
        assert _rel(skip[0]["state"][name] - p0,
                    ring[0]["state"][name] - p0) <= TOL_UPDATE, name
