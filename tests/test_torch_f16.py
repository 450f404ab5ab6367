"""``--precision f16`` in the port held against the JAX package: kernels
K1, K2, K3 (their plain versions, which the wrappers run on the CPU) and
K5 on float16 inputs against the JAX Pallas kernels in interpret mode,
with the non-finite pattern of the backward at a dO near float16's range;
then one f16 train step at the loss scale 2^15 of the narrow vit with
flash attention and of the mlp against the JAX f16 step.  Inputs come
from numpy with a seed; the JAX side runs on the CPU.

Tolerances: 5e-3 relative to the largest value for the kernels' float16
outputs (one float16 rounding of each output, 2^-11, of sums in another
order) and 1e-5 for K5's f32 dW; 1e-2 relative to each parameter's
largest gradient for the train step (float16 rounds at the same points in
both frameworks).  XLA on the CPU sums a half-precision bias gradient in
half precision (ROADMAP queue 3 entry 2), so the biases of dense layers
are held to the f32 step's gradient instead, at the same tolerance.
"""

import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedpytorch_tpu.data import augment as jax_augment
from distributedpytorch_tpu.models.simple import MLP as JaxMLP
from distributedpytorch_tpu.models.vit import ViT as JaxViT
from distributedpytorch_tpu.ops import conv as jconv
from distributedpytorch_tpu.ops import flash_attention as jfa
from distributedpytorch_tpu.ops import losses as jax_losses
from distributedpytorch_tpu.precision import PRESETS as JAX_PRESETS
from distributedpytorch_tpu.train.engine import Engine as JaxEngine
from distributedpytorch_tpu.train.engine import (
    make_optimizer as jax_make_optimizer)
from distributedpytorch_tpu_torch.models import convert
from distributedpytorch_tpu_torch.models.simple import MLP
from distributedpytorch_tpu_torch.models.vit import ViT
from distributedpytorch_tpu_torch.ops import conv
from distributedpytorch_tpu_torch.ops import flash_attention as tfa
from distributedpytorch_tpu_torch.ops import losses
from distributedpytorch_tpu_torch.precision import PRESETS
from distributedpytorch_tpu_torch.train.engine import (Engine, TrainState,
                                                       make_optimizer)

TOL_F16 = 5e-3
TOL_DW = 1e-5
TOL_STEP = 1e-2
F16_INF_AT = 65520.0        # float16 rounds a magnitude from here to inf
NARROW = dict(num_classes=10, dim=64, depth=2, heads=2)
MEAN, STD = 0.13, 0.31


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# -- K1, K2, K3 ---------------------------------------------------------------

def _attn_inputs(b, s, h, d, seed, qk_std=1.0, do_std=1.0):
    rng = np.random.default_rng(seed)
    q, k = (rng.standard_normal((b, s, h, d)) * qk_std for _ in range(2))
    v = rng.standard_normal((b, s, h, d))
    do = np.clip(rng.standard_normal((b, s, h, d)) * do_std, -60000, 60000)
    return [x.astype(np.float16) for x in (q, k, v, do)]


@pytest.fixture(scope="module", params=[
    ("vit", 2, 49, 4, 32, False, 1.0, 1.0),
    ("causal", 2, 128, 2, 64, True, 1.0, 1.0),
    ("dO near f16's range", 2, 49, 4, 32, False, 2.0, 2.0 ** 14)],
    ids=["vit", "causal", "overflow"])
def attention_case(request):
    """(the case, the JAX outputs (O, dq, dk, dv) of the Pallas kernels in
    interpret mode, the port's plain versions' (O, lse, dq, dk, dv), the
    port's backward in f32 before its float16 cast)."""
    name, b, s, h, d, causal, qk_std, do_std = request.param
    q, k, v, do = _attn_inputs(b, s, h, d, 7 + s, qk_std, do_std)
    o, vjp = jax.vjp(lambda q, k, v: jfa.flash_attention(q, k, v,
                                                         causal=causal),
                     *(jnp.asarray(x) for x in (q, k, v)))
    want = [np.asarray(o)] + [np.asarray(g) for g in vjp(jnp.asarray(do))]
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    to, lse = tfa.flash_attention_fwd(tq, tk, tv, causal)
    got = (to, lse) + tfa.flash_attention_bwd(tq, tk, tv, to, lse, tdo,
                                              causal)
    ref32 = tfa._bwd_blocks(tq.float(), tk.float(), tv.float(), tdo.float(),
                            lse, tfa.attention_delta(to, tdo),
                            tfa._causal_mask(s, causal, tq.device))
    return request.param, want, got, ref32


def test_f16_kernels_match_jax_interpret(attention_case):
    """O and the gradients come back float16 on both sides, within
    TOL_F16 of the JAX kernels' largest value where both are finite, and
    K1's lse is the f32 log-sum-exp."""
    _, want, got, _ = attention_case
    o, lse, dq, dk, dv = got
    assert lse.dtype == torch.float32
    for name, g, w in zip(("o", "dq", "dk", "dv"), (o, dq, dk, dv), want):
        assert g.dtype == torch.float16 and w.dtype == np.float16, name
        g = g.float().numpy()
        w = w.astype(np.float32)
        fin = np.isfinite(g) & np.isfinite(w)
        assert fin.any(), name
        assert _rel(np.where(fin, g, 0), np.where(fin, w, 0)) <= TOL_F16, name


def test_f16_backward_overflows_where_jax_does(attention_case):
    """Each gradient element is finite exactly where the JAX kernel's is,
    except within TOL_F16 x the largest value of 65520, where either
    rounding may fall to inf (none is near it at these inputs but the
    overflow case's few).  The overflow case has non-finite elements on
    both sides; the others have none."""
    (name, *_), want, got, ref32 = attention_case
    for g, w, r in zip(got[2:], want[1:], ref32):
        a = r.abs().numpy()
        band = TOL_F16 * a.max()
        held = (a >= F16_INF_AT + band) | (a < F16_INF_AT - band)
        g_fin, w_fin = torch.isfinite(g).numpy(), np.isfinite(w)
        assert (g_fin == w_fin)[held].all()
        assert g_fin.all() == (name != "dO near f16's range")


def test_cpu_wrappers_take_float16_without_counting():
    q, k, v, do = (torch.from_numpy(x) for x in
                   _attn_inputs(1, 49, 2, 32, 3))
    counts = (tfa.flash_attention_fwd.launches,
              tfa.flash_attention_dq.launches,
              tfa.flash_attention_dkv.launches)
    o = tfa.flash_attention(q.requires_grad_(), k, v)
    o.float().sum().backward()
    assert o.dtype == q.grad.dtype == torch.float16
    assert counts == (tfa.flash_attention_fwd.launches,
                      tfa.flash_attention_dq.launches,
                      tfa.flash_attention_dkv.launches)


def test_ring_kernels_refuse_float16_on_the_card():
    """The ring's K4, K2p and K3p take float16 like K1-K3 (``--precision
    f16`` with a ring): the checks that run before the device is touched
    pass a float16 meta tensor, and float32 or bfloat16 as before."""
    q = torch.empty((1, 49, 2, 32), dtype=torch.float16, device="meta")
    for kernel in ("flash_fwd_pos", "flash_dq_pos", "flash_dkv_pos",
                   "flash_fwd"):
        tfa._check_kernel_inputs(kernel, (("q", q),))
    with pytest.raises(ValueError, match="float32, bfloat16 or float16, "
                                         "got torch.float64"):
        tfa._check_kernel_inputs("flash_fwd_pos",
                                 (("q", q.to(torch.float64)),))


# -- K5 -----------------------------------------------------------------------

def test_f16_conv_dw_matches_jax_interpret():
    """The cnn's second conv shape at batch 4 in float16: dW (f32) within
    TOL_DW of the JAX kernel's, and the conv's weight gradient cast to
    float16 as the JAX ``_conv_bwd`` casts it."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((4, 14, 14, 32)).astype(np.float16)
    dy = rng.standard_normal((4, 14, 14, 64)).astype(np.float16)
    want = np.asarray(jconv.conv3x3_dw(jnp.asarray(x), jnp.asarray(dy)))
    got = conv.conv3x3_dw(torch.from_numpy(x), torch.from_numpy(dy))
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), want) <= TOL_DW
    w = torch.from_numpy(rng.standard_normal((3, 3, 32, 64)).astype(
        np.float16)).requires_grad_()
    y = conv.conv3x3_same(torch.from_numpy(x), w)
    y.backward(torch.from_numpy(dy))
    assert w.grad.dtype == torch.float16
    assert torch.equal(w.grad, got.to(torch.float16))


# -- one f16 train step -------------------------------------------------------

def _batch(seed, b=8):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (b, 28, 28), dtype=np.uint8)
    labels = rng.integers(0, 10, b).astype(np.int32)
    valid = np.ones(b, bool)
    valid[-2:] = False
    return images, labels, valid


def _jax_model(name, preset):
    dtype = JAX_PRESETS[preset].compute_dtype
    if name == "vit":
        return JaxViT(dtype=dtype, attention_fn=jfa.flash_attention,
                      **NARROW)
    return JaxMLP(dtype=dtype)


def _port_model(name, preset):
    dtype = PRESETS[preset].compute_dtype
    if name == "vit":
        return ViT(dtype=dtype, attention_fn=tfa.flash_attention, **NARROW)
    return MLP(dtype=dtype)


def _jax_step(name, preset, init):
    """(grads as a port state_dict, the step's new JAX state) of one JAX
    step on ``init``'s params, the loss scale of the preset."""
    tx = jax_make_optimizer("SGD", 1e-3, 0.9, 0.1, 2, False)
    engine = JaxEngine(_jax_model(name, preset), name,
                       jax_losses.cross_entropy, tx, MEAN, STD, 28,
                       precision=JAX_PRESETS[preset])
    state = engine.init_state(jax.random.PRNGKey(0)).replace(params=init)
    images, labels, valid = _batch(1)
    key = jax.random.PRNGKey(11)
    imgs = jax_augment.train_transform(key, jnp.asarray(images), MEAN, STD,
                                       28, out_dtype=engine.compute_dtype)
    grads, *_ = engine._grads_and_metrics(
        state, imgs, jnp.asarray(labels), jnp.asarray(valid, jnp.float32),
        None)
    new_state, metrics = jax.jit(engine._train_step_keys)(
        state, jnp.asarray(images), jnp.asarray(labels), jnp.asarray(valid),
        key, key)
    to_port = (convert.params_from_jax if name == "vit" else
               lambda p: convert.cnn_params_from_jax(p, None))
    return to_port(_np(grads)), new_state, float(metrics["loss"])


@pytest.fixture(scope="module", params=["vit", "mlp"])
def f16_step(request):
    name = request.param
    init_model = _jax_model(name, "f32")
    init = init_model.init(jax.random.PRNGKey(0),
                           jnp.zeros((2, 28, 28, 3)))["params"]
    want, jstate, jloss = _jax_step(name, "f16", init)
    want_f32, _, _ = _jax_step(name, "f32", init)
    model = _port_model(name, "f16")
    model.load_state_dict(convert.params_from_jax(_np(init)) if name == "vit"
                          else convert.cnn_params_from_jax(_np(init), None))
    engine = Engine(model, losses.cross_entropy, MEAN, STD, 28,
                    PRESETS["f16"], "cpu", optimizer="SGD",
                    steps_per_epoch=2)
    state = TrainState(model, make_optimizer("SGD", model),
                       loss_scale=engine.fresh_loss_scale())
    images, labels, valid = _batch(1)
    affine = [torch.from_numpy(np.array(x)) for x in
              jax_augment._sample_affine_batch(jax.random.PRNGKey(11), 8,
                                               28, 28)]
    _, m = engine.train_step_affine(
        state, torch.from_numpy(images), torch.from_numpy(labels).long(),
        torch.from_numpy(valid), affine)
    grads = {n: p.grad for n, p in model.named_parameters()}
    return name, want, want_f32, jstate, jloss, state, grads, m


def test_f16_step_takes_the_jax_skip_decision(f16_step):
    """The loss scale 2^15 of both; the same decision to apply the update
    (the same scale after the step) and the same unscaled loss."""
    _, _, _, jstate, jloss, state, _, m = f16_step
    assert float(jstate.loss_scale.scale) == state.loss_scale.scale
    assert int(jstate.loss_scale.good_steps) == state.loss_scale.good_steps
    assert state.updates == (1 if state.loss_scale.good_steps else 0)
    assert abs(m["loss"].item() - jloss) <= TOL_STEP * abs(jloss)


def _dense_bias(name: str) -> bool:
    return name.endswith(".bias") and not re.search(r"ln\d|norm", name)


def test_f16_step_gradients_match_jax(f16_step):
    """Every gradient (f32, unscaled) within TOL_STEP of the JAX f16 step's
    relative to its largest value; a dense bias of the JAX step is summed
    in half precision by XLA on the CPU, so it is held to the f32 step's
    gradient instead."""
    name, want, want_f32, _, _, state, grads, _ = f16_step
    assert set(grads) == set(want)
    for key, w in want.items():
        g = grads[key]
        assert g.dtype == torch.float32 and torch.isfinite(g).all(), key
        ref = want_f32[key] if _dense_bias(key) else w
        assert _rel(g.numpy(), ref.numpy()) <= TOL_STEP, (key, name)
    assert math.isfinite(state.loss_scale.scale)
