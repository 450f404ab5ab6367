"""The port's alexnet, vgg and squeezenet held against the JAX package's
flax modules, and the zoo's shared pieces: ``adaptive_avg_pool`` in both
branches, the zoo's max and average pools (ties included), the dropout
layer, the registry's widths and errors.

The models run at tests/test_zoo_train.py's size (64 px, batch 2) with
the registry's widths, on one flax init (tests/_torch_zoo_jax.py): the
train-mode logits with JAX's dropout masks, every parameter's gradient,
the BatchNorm running statistics after the step, and the eval-mode
logits with those statistics.  Tolerances, relative to each tensor's
largest value, are ``_torch_zoo_jax.check_against_flax``'s: f32 1e-4,
bf16 5e-2 (biases 1e-1), f64 on both sides 1e-6.  vgg's bf16 gradients
at batch 2 are rounding-dominated in both frameworks (each about 40%
from the f64 gradient at the median, ROADMAP queue 3 entry 8): there the
port must be as close to the f64 step as the JAX bf16 one is.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from distributedpytorch_tpu.models import get_model as jax_get_model
from distributedpytorch_tpu.models.common import (
    adaptive_avg_pool as jax_adaptive_avg_pool)
from distributedpytorch_tpu.models.squeezenet import _max_pool_ceil
from distributedpytorch_tpu_torch.models import registry
from distributedpytorch_tpu_torch.models.common import adaptive_avg_pool
from distributedpytorch_tpu_torch.models.layers import (Dropout,
                                                        dropout_layers,
                                                        set_dropout_masks)
from distributedpytorch_tpu_torch.models.squeezenet import max_pool_ceil
from distributedpytorch_tpu_torch.precision import PRESETS

from tests import _torch_zoo_jax as Z

# (model, dtype) held to the f64 step against JAX's own distance from it
CONDITIONED = {("vgg", "bfloat16")}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["alexnet", "vgg", "squeezenet"])
def test_logits_grads_and_bn_stats_match_flax(name, dtype):
    Z.check_against_flax(name, dtype, (name, dtype) in CONDITIONED)


@pytest.mark.parametrize("name", ["alexnet", "vgg", "squeezenet"])
def test_f64_step_equals_flax_in_x64(name):
    Z.check_against_flax(name, "float64")


def test_dropout_masks_reach_the_layers_in_call_order():
    """The captured JAX masks have the shapes ``dropout_shapes`` names;
    a model's forward with other masks gives other logits, and eval mode
    ignores them."""
    for name in ("alexnet", "vgg", "squeezenet"):
        masks = Z.reference(name, "float32")["masks"]
        model = registry.get_model(name, 10, PRESETS["f32"], device="cpu")
        assert [tuple(m.shape[1:]) for m in masks] == \
            [tuple(s) for s in model.dropout_shapes(Z.SIZES[name])]
        assert len(dropout_layers(model)) == len(masks)
    _, logits, _, _ = Z.port_step("alexnet", "float32")
    flipped = [~np.asarray(m) for m in Z.reference("alexnet",
                                                   "float32")["masks"]]
    _, other, _, eval_logits = Z.port_step("alexnet", "float32", flipped)
    assert not torch.allclose(logits, other)
    assert Z.rel(eval_logits, Z.reference("alexnet", "float32")["eval"]) \
        <= 1e-4


@pytest.mark.parametrize("size", [64, 65, 224, 227])
def test_squeezenet_dropout_shape_is_the_map_jax_drops(size):
    """The feature map at squeezenet's dropout, from ``dropout_shapes``,
    equals the one flax drops (traced abstractly), odd sizes included."""
    model = jax_get_model("squeezenet", 10, half_precision=False)
    masks = []

    def apply(x):
        variables = model.init({"params": jax.random.PRNGKey(0),
                                "dropout": jax.random.PRNGKey(1)}, x,
                               train=True)
        with fnn.intercept_methods(Z.capture_dropout(masks)):
            return model.apply(variables, x, train=True,
                               rngs={"dropout": jax.random.PRNGKey(2)})

    jax.eval_shape(apply, jax.ShapeDtypeStruct((1, size, size, 3),
                                               jnp.float32))
    port = registry.get_model("squeezenet", 10, PRESETS["f32"],
                              device="cpu")
    assert [tuple(m.shape[1:]) for m in masks] == \
        port.dropout_shapes(size)


def test_dropout_layer_is_flax_dropout_with_the_given_mask():
    """where(mask, x / keep, 0) in train mode (bf16 exact, as flax
    divides by 0.5), the identity in eval mode; a train-mode call
    without a mask is refused; an NHWC mask is permuted to the NCHW
    view."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((2, 3, 4, 5)).astype(
        np.float32)).to(torch.bfloat16)
    mask_nhwc = rng.random((2, 4, 5, 3)) < 0.5
    layer = Dropout(0.5)
    holder = torch.nn.Sequential(layer)
    with pytest.raises(ValueError, match="needs its keep mask"):
        holder(x)
    set_dropout_masks(holder, [torch.from_numpy(mask_nhwc)])
    y = holder(x)
    want = jnp.where(jnp.asarray(mask_nhwc),
                     jnp.asarray(x.permute(0, 2, 3, 1).float().numpy(),
                                 jnp.bfloat16) / 0.5, 0)
    np.testing.assert_array_equal(
        y.permute(0, 2, 3, 1).float().numpy(),
        np.asarray(want.astype(jnp.float32)))
    with pytest.raises(ValueError, match="1 dropout masks for 2"):
        set_dropout_masks(torch.nn.Sequential(Dropout(), Dropout()),
                          [torch.from_numpy(mask_nhwc)])
    holder.eval()
    assert holder(x) is x
    set_dropout_masks(holder, None)
    assert layer.mask is None


# -- adaptive_avg_pool -----------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hw,out", [
    ((6, 6), 6), ((12, 18), 6), ((14, 14), 7), ((17, 17), 1),
    ((1, 1), 6), ((2, 2), 7), ((3, 5), 7), ((13, 13), 6), ((10, 15), 7),
    ((9, 4), 3)],
    ids=["identity", "divisor", "vgg224x2", "aux-mean", "alexnet64",
         "vgg64", "up-ragged", "down", "down-ragged", "mixed"])
def test_adaptive_avg_pool_matches_jax(hw, out, dtype):
    """Both branches against the JAX function on the NHWC view: the
    equal-window mean and ``jax.image.resize``'s bilinear resize (up, and
    antialiased down), forward and gradient.  f32 1e-6; bf16 at bf16's
    rounding of the result (JAX resizes with weights rounded to bf16)."""
    rng = np.random.default_rng(sum(hw) + out)
    x = rng.standard_normal((2,) + hw + (3,)).astype(np.float32)
    g = rng.standard_normal((2, out, out, 3)).astype(np.float32)
    jdt = getattr(jnp, dtype)
    y, vjp = jax.vjp(lambda t: jax_adaptive_avg_pool(t, out),
                     jnp.asarray(x, jdt))
    (want_dx,) = vjp(jnp.asarray(g, jdt))
    xt = torch.from_numpy(x).to(getattr(torch, dtype)).permute(
        0, 3, 1, 2).requires_grad_()
    yt = adaptive_avg_pool(xt, out)
    yt.backward(torch.from_numpy(g).to(yt.dtype).permute(0, 3, 1, 2))
    tol = 1e-6 if dtype == "float32" else 2e-2
    assert yt.dtype == xt.dtype and yt.shape == (2, 3, out, out)
    assert Z.rel(yt.detach().permute(0, 2, 3, 1).float(),
                 np.asarray(y.astype(jnp.float32))) <= tol
    assert Z.rel(xt.grad.permute(0, 2, 3, 1).float(),
                 np.asarray(want_dx.astype(jnp.float32))) <= tol


# -- the zoo's pools, ties included --------------------------------------

def _tied(shape, seed):
    rng = np.random.default_rng(seed)
    x = np.maximum(rng.standard_normal(shape), 0.0).astype(np.float32)
    x[:, ::3, :, :] = 1.0
    x[:, :, 1::4, :] = 0.5
    return x


POOLS = {
    # name: (JAX op on NHWC, port op on NCHW)
    "ceil": (_max_pool_ceil, max_pool_ceil),
    "valid3x3": (lambda t: fnn.max_pool(t, (3, 3), strides=(2, 2)),
                 lambda t: F.max_pool2d(t, 3, 2)),
    "avg_same": (lambda t: fnn.avg_pool(t, (3, 3), strides=(1, 1),
                                        padding=[(1, 1), (1, 1)]),
                 lambda t: F.avg_pool2d(t, 3, 1, padding=1)),
    "avg2x2": (lambda t: fnn.avg_pool(t, (2, 2), strides=(2, 2)),
               lambda t: F.avg_pool2d(t, 2)),
    "avg5x5/3": (lambda t: fnn.avg_pool(t, (5, 5), strides=(3, 3)),
                 lambda t: F.avg_pool2d(t, 5, 3)),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("size", [13, 14, 27, 54])
@pytest.mark.parametrize("pool", list(POOLS))
def test_zoo_pools_match_flax_with_ties(pool, size, dtype):
    """squeezenet's ceil-mode 3x3/2 max pool (the JAX one pads the
    bottom/right with -inf), alexnet's and inception's VALID 3x3/2 max
    pool, inception's padded 3x3/1 average pool (padding counted) and
    its aux head's 5x5/3 one, densenet's 2x2/2 average pool: forward and
    gradient at odd and even sizes.  Max pools bit-exact (the gradient
    on the first maximum), average pools 1e-6 in f32 and at bf16's
    rounding in bf16 (torch's CPU pool sums in f32)."""
    jax_op, port_op = POOLS[pool]
    x = _tied((2, size, size, 3), size)
    jdt = getattr(jnp, dtype)
    y, vjp = jax.vjp(jax_op, jnp.asarray(x, jdt))
    g = np.random.default_rng(size + 1).standard_normal(y.shape).astype(
        np.float32)
    (want_dx,) = vjp(jnp.asarray(g, jdt))
    xt = torch.from_numpy(x).to(getattr(torch, dtype)).permute(
        0, 3, 1, 2).requires_grad_()
    yt = port_op(xt)
    yt.backward(torch.from_numpy(g).to(yt.dtype).permute(0, 3, 1, 2))
    got_y = yt.detach().permute(0, 2, 3, 1).float().numpy()
    got_dx = xt.grad.permute(0, 2, 3, 1).float().numpy()
    want_y = np.asarray(y.astype(jnp.float32))
    want_dx = np.asarray(want_dx.astype(jnp.float32))
    assert got_y.shape == want_y.shape
    if pool in ("ceil", "valid3x3"):
        np.testing.assert_array_equal(got_y, want_y)
        np.testing.assert_array_equal(got_dx, want_dx)
    else:
        tol = 1e-6 if dtype == "float32" else 1e-2
        assert Z.rel(got_y, want_y) <= tol
        assert Z.rel(got_dx, want_dx) <= tol


# -- registry --------------------------------------------------------------

@pytest.mark.parametrize("name", ["alexnet", "vgg", "squeezenet",
                                  "densenet", "inception"])
def test_registry_builds_the_full_width_zoo(name):
    """The JAX registry's parameter and batch_stats counts (from an
    abstract init at the JAX input size), the same names, and the JAX
    input size; dropout and aux-logit models are the JAX sets."""
    size = registry.get_model_input_size(name)
    jmodel = jax_get_model(name, 10)
    shapes = jax.eval_shape(
        lambda: jmodel.init({"params": jax.random.PRNGKey(0),
                             "dropout": jax.random.PRNGKey(1)},
                            jnp.zeros((1, size, size, 3)), train=True))
    model = registry.get_model(name, 10, PRESETS["bf16"], device="cpu")
    flat = {".".join(k.key for k in path): leaf.shape for path, leaf in
            jax.tree_util.tree_leaves_with_path(shapes["params"])}
    assert sum(int(np.prod(s)) for s in flat.values()) == \
        sum(p.numel() for p in model.parameters())
    assert sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(
        shapes.get("batch_stats", {}))) == \
        sum(b.numel() for b in model.buffers())
    modules = {n.rsplit(".", 1)[0] for n, _ in model.named_parameters()}
    assert modules == {k.rsplit(".", 1)[0] for k in flat}
    assert size == (299 if name == "inception" else 224)
    from distributedpytorch_tpu.models import registry as jax_registry

    assert registry.DROPOUT_MODELS == jax_registry.DROPOUT_MODELS
    assert registry.AUX_LOGIT_MODELS == jax_registry.AUX_LOGIT_MODELS


@pytest.mark.parametrize("name,kwargs", [
    ("alexnet", {"pallas_dw": True}),
    ("vgg", {"attention": "flash"}),
    ("inception", {"attention": "ring"}),
    ("densenet", {"attention": "ring_flash"}),
], ids=["alexnet-dw", "vgg-flash", "inception-ring", "densenet-ring_flash"])
def test_zoo_registry_errors_are_the_jax_ones(name, kwargs):
    with pytest.raises(ValueError) as want:
        jax_get_model(name, 10, **kwargs)
    with pytest.raises(ValueError) as got:
        registry.get_model(name, 10, PRESETS["bf16"], device="cpu", **kwargs)
    assert str(got.value) == str(want.value)
