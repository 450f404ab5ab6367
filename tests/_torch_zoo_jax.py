"""The JAX side of the zoo's parity tests (tests/test_torch_zoo*.py): one
flax init per model, one jitted train-mode forward and backward per
dtype with the dropout masks captured, and the port's model run on the
same variables, input and masks.

The masks are JAX's own: ``flax.linen.intercept_methods`` wraps
``nn.Dropout.__call__``, calls it on ``ones_like(x)`` (which gives
mask / keep) and returns ``x * that``, which is what the layer returns.
The mask bits depend only on the dropout key and the module path, so the
captured masks are those of any apply with the same key.
"""

import functools
import re

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import torch

from distributedpytorch_tpu.models import get_model as jax_get_model
from distributedpytorch_tpu_torch.models import convert, registry
from distributedpytorch_tpu_torch.models.layers import set_dropout_masks
from distributedpytorch_tpu_torch.precision import PRESETS, PrecisionPolicy

# tests/test_zoo_train.py's sizes: 64 px, and 299 for inception, whose aux
# head needs a 17x17 map
SIZES = {"alexnet": 64, "vgg": 64, "squeezenet": 64, "densenet": 64,
         "inception": 299}
BATCH = 2
CLASS_W = np.linspace(-1.0, 1.0, 10).astype(np.float32)
AUX_W = np.linspace(1.0, -0.5, 10).astype(np.float32)
DROPOUT_KEY = 7
JAX_DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
              "float64": jnp.float64}
F64 = PrecisionPolicy(name="f64", param_dtype=torch.float32,
                      compute_dtype=torch.float64,
                      accum_dtype=torch.float64)
POLICIES = {"float32": PRESETS["f32"], "bfloat16": PRESETS["bf16"],
            "float64": F64}
# relative to each tensor's largest value: f32, the same math in another
# summation order; bf16, bf16 rounding at the same points; f64 on both
# sides (f32 parameters), where only the f32 parameters and logits round
TOL = {"float32": 1e-4, "bfloat16": 5e-2, "float64": 1e-6}
# XLA on the CPU sums bf16 bias gradients over the batch in bf16
# (ROADMAP queue 3 entry 2)
BIAS_TOL_BF16 = 1e-1
# a conv bias whose gradient a train-mode BatchNorm cancels: zero up to
# rounding, so held at the scale of its conv's weight gradient
ZERO_GRAD = {"vgg": re.compile(r"Conv_\d+\.bias")}
# how much further from the f64 step than the JAX one a conditioned
# check lets the port be
CONDITIONED_FACTOR = 2.0


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def capture_dropout(masks: list, inject=None):
    """An interceptor that appends each dropout's keep mask to ``masks``
    and returns what the layer returns; with ``inject`` (a list of masks)
    it applies those instead of drawing."""
    def interceptor(next_fun, args, kwargs, context):
        if isinstance(context.module, fnn.Dropout) \
                and context.method_name == "__call__":
            if inject is not None:
                keep = 1.0 - context.module.rate
                mask = jnp.asarray(inject[len(masks)])
                scaled = jnp.where(mask, 1.0 / keep, 0.0).astype(
                    args[0].dtype)
            else:
                scaled = next_fun(jnp.ones_like(args[0]), *args[1:],
                                  **kwargs)
            masks.append(scaled != 0)
            return args[0] * scaled
        return next_fun(*args, **kwargs)
    return interceptor


def jax_model(name: str, dtype: str):
    return jax_get_model(name, 10, half_precision=False).clone(
        dtype=JAX_DTYPES[dtype])


@functools.lru_cache(maxsize=None)
def init(name: str):
    """(f32 variables as numpy, the NHWC input) of ``name``."""
    size = SIZES[name]
    x = np.random.default_rng(0).standard_normal(
        (BATCH, size, size, 3)).astype(np.float32)
    model = jax_model(name, "float32")
    variables = jax.jit(lambda x: model.init(
        {"params": jax.random.PRNGKey(0),
         "dropout": jax.random.PRNGKey(1)}, x, train=True))(x)
    return _np(variables), x


def _loss(out):
    if isinstance(out, tuple):
        return jnp.sum(out[0] * CLASS_W) + jnp.sum(out[1] * AUX_W)
    return jnp.sum(out * CLASS_W)


@functools.lru_cache(maxsize=None)
def reference(name: str, dtype: str) -> dict:
    """flax's train-mode forward and backward of ``_loss`` on ``init``'s
    variables and input in ``dtype`` (float64 under JAX's x64 mode, with
    the f32 params computed in f64 and the float32 run's masks, since x64
    draws other bits), then the eval-mode forward with the
    moved statistics: logits, aux logits (or None), grads and
    batch_stats as port state_dict entries, the masks and the eval
    logits, all numpy."""
    variables, x = init(name)
    stats = variables.get("batch_stats", {})
    model = jax_model(name, dtype)
    inject = (reference(name, "float32")["masks"] if dtype == "float64"
              else None)
    with jax.enable_x64(dtype == "float64"):
        xj = jnp.asarray(x, JAX_DTYPES[dtype])

        def loss(params):
            masks = []
            with fnn.intercept_methods(capture_dropout(masks, inject)):
                out, upd = model.apply(
                    {"params": params, "batch_stats": stats}, xj,
                    train=True, mutable=["batch_stats"],
                    rngs={"dropout": jax.random.PRNGKey(DROPOUT_KEY)})
            return _loss(out), (out, upd.get("batch_stats", {}), masks)

        (_, (out, new_stats, masks)), grads = jax.jit(
            jax.value_and_grad(loss, has_aux=True))(variables["params"])
        eval_out = jax.jit(lambda p, s: model.apply(
            {"params": p, "batch_stats": s} if s else {"params": p}, xj,
            train=False))(variables["params"], new_stats)
        out, new_stats, masks, grads, eval_out = _np(
            (out, new_stats, masks, grads, eval_out))
    logits, aux = out if isinstance(out, tuple) else (out, None)
    return {"logits": logits.astype(np.float64),
            "aux": None if aux is None else aux.astype(np.float64),
            "grads": convert.cnn_params_from_jax(grads, new_stats or None),
            "masks": masks, "eval": eval_out.astype(np.float64)}


def port_step(name: str, dtype: str, masks=None) -> tuple:
    """The port's model on ``init``'s variables: the train-mode forward
    with ``masks`` (JAX's by default) and the backward of the same loss,
    then the eval-mode forward.  Returns (model, logits, aux or None,
    eval logits)."""
    variables, x = init(name)
    model = registry.get_model(name, 10, POLICIES[dtype], device="cpu")
    model.load_state_dict(convert.cnn_params_from_jax(
        variables["params"], variables.get("batch_stats") or None))
    model.train()
    if masks is None:
        masks = reference(name, "float32")["masks"]
    set_dropout_masks(model, [torch.from_numpy(np.array(m)) for m in masks])
    out = model(torch.from_numpy(x))
    logits, aux = out if isinstance(out, tuple) else (out, None)
    loss = (logits * torch.from_numpy(CLASS_W).to(logits.dtype)).sum()
    if aux is not None:
        loss = loss + (aux * torch.from_numpy(AUX_W).to(aux.dtype)).sum()
    loss.backward()
    model.eval()
    with torch.no_grad():
        eval_out = model(torch.from_numpy(x))
    return (model, logits.detach(), None if aux is None else aux.detach(),
            eval_out)


def rel(got, want) -> float:
    got = torch.as_tensor(np.asarray(got), dtype=torch.float64)
    want = torch.as_tensor(np.asarray(want), dtype=torch.float64)
    return (got - want).abs().max().item() / max(
        want.abs().max().item(), 1e-30)


def errors(name: str, got: dict, want: dict) -> dict:
    """{entry: error relative to its largest wanted value}, a zero-gradient
    bias relative to its conv's weight gradient."""
    out = {}
    zero = ZERO_GRAD.get(name)
    for key, g in got.items():
        if zero is not None and zero.fullmatch(key):
            scale = torch.as_tensor(want[key.replace(".bias", ".weight")])
            out[key] = ((torch.as_tensor(g) - torch.as_tensor(want[key]))
                        .abs().max() / scale.abs().max()).item()
        else:
            out[key] = rel(g, want[key])
    return out


def check_against_flax(name: str, dtype: str,
                       conditioned: bool = False) -> dict:
    """The port's step against flax's in ``dtype``: logits, aux and eval
    logits, every gradient and BatchNorm statistic within ``TOL``.  With
    ``conditioned`` (a step whose rounding dominates at this size), a
    logit tensor outside ``TOL`` of JAX's must be no further from the
    f64 step than CONDITIONED_FACTOR times JAX's distance, and so must
    the gradients and statistics at their median and largest error.
    Returns the port's errors against JAX."""
    ref = reference(name, dtype)
    model, logits, aux, eval_logits = port_step(name, dtype)
    tol = TOL[dtype]
    assert logits.dtype == torch.float32 and logits.shape == (BATCH, 10)
    assert (aux is None) == (ref["aux"] is None)
    outs = {"logits": logits, "eval": eval_logits}
    if aux is not None:
        outs["aux"] = aux
    grads = {n: p.grad for n, p in model.named_parameters()}
    stats = dict(model.named_buffers())
    assert all(g is not None and g.dtype == torch.float32
               for g in grads.values())
    assert all(b.dtype == torch.float32 for b in stats.values())
    assert set(grads) | set(stats) == set(ref["grads"])
    found = {}
    truth = reference(name, "float64") if conditioned else None
    for key, err in errors(name, outs, ref).items():
        found[key] = err
        if err > tol:
            assert conditioned, (key, err)
            assert rel(outs[key], truth[key]) <= CONDITIONED_FACTOR * rel(
                ref[key], truth[key]), key
    for group in (grads, stats):
        errs = errors(name, group, ref["grads"])
        found.update(errs)
        if conditioned:
            port = np.array(list(errors(name, group,
                                        truth["grads"]).values()))
            jax_ = np.array(list(errors(
                name, {k: ref["grads"][k] for k in group},
                truth["grads"]).values()))
            if len(port):
                assert np.median(port) <= CONDITIONED_FACTOR * np.median(jax_)
                assert port.max() <= CONDITIONED_FACTOR * jax_.max()
            continue
        for key, err in errs.items():
            bias = dtype == "bfloat16" and key.endswith(".bias")
            assert err <= (BIAS_TOL_BF16 if bias else tol), (key, err)
    return found
