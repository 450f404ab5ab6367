"""``--scan-layers`` in the port (``models/scan.py``) held against the JAX
package's (``models/scan.py``, ``tests/test_scan_layers.py``) on the CPU.
The same numpy inputs go through both; JAX's flash attention runs in
Pallas interpret mode, the port's kernels as their plain versions.

  * The stacked vit (dim 32, depth 3, heads 2) against JAX's
    ``ViT(scan_layers=True)`` on JAX's weights, under full and flash
    attention (and the port's under ``--remat blocks``): f32 logits
    within 1e-5, every gradient of sum(logits * w) within JAX's
    ``_grads_match`` rule, 2e-4 x max(|g|, 1); in bf16 by
    ``check_against_flax``'s conditioned rule (within 5e-2 of JAX's bf16
    or no further from the f32 result than twice JAX's distance, the
    gradients at their median and largest error).
  * The block runs against JAX's own runners at small widths, train and
    eval mode, on random weights and statistics: ``scan_vgg_run`` (16
    channels), ``scan_dense_block`` (2 layers, an 8-channel entry, growth
    4, the padded norm biases positive so that the mask matters) and
    ``scan_run`` of ``InceptionC`` (768 channels, 5x5, batch 2): outputs
    and moved statistics within 1e-5 of the largest value, gradients by
    the same rule, the padded rows' gradients exactly zero.
  * Layout conversion against JAX's ``convert_layout`` on the same random
    trees (params, ``batch_stats`` and Adam's two moments), for all four
    families in both directions, the port's models built on the meta
    device: the same tensors, and the port's converted names are its
    scanned (or plain) model's.
  * A JAX ``run_train --scan-layers`` vit file: the port's ``test -f``
    with and without the flag equals JAX's ``run_test``; ``train -f``
    loads JAX's Adam moments (converted for the plain model) and trains
    on; the serving restore's logits equal JAX's eval.  A JAX-written
    scanned densenet file restores and resumes in process.
  * At ``--model-parallel 2`` a rank's parameter elements of the scanned
    vit and densenet equal JAX's ``state_sharding``; the scanned densenet
    stacks two blocks' norm statistics past the 2^14 floor, which JAX
    shards and the port keeps whole (ROADMAP queue 3 entry 31).  Under
    ``--tensor-parallel`` the scanned vit's shards are the unrolled
    one's, shifted past the stack axis.
  * JAX's registry errors (another model, ``--pipeline-parallel``,
    ``--moe-experts``, in JAX's order) and ``--use-pretrained``'s merge
    error under the flag, word for word.
"""

import copy
import functools
import math
import re

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from distributedpytorch_tpu import parallel as jax_parallel
from distributedpytorch_tpu import runtime as jax_runtime
from distributedpytorch_tpu.models import pretrained as jax_pretrained
from distributedpytorch_tpu.models import registry as jax_registry
from distributedpytorch_tpu.models import scan as jax_scan
from distributedpytorch_tpu.models.inception import (
    InceptionC as JaxInceptionC)
from distributedpytorch_tpu.models.vit import ViT as JaxViT
from distributedpytorch_tpu.ops.flash_attention import (
    flash_attention as jax_flash)
from distributedpytorch_tpu_torch import checkpoint as ckpt
from distributedpytorch_tpu_torch import cli as tcli
from distributedpytorch_tpu_torch import config as tconfig
from distributedpytorch_tpu_torch import parallel, runtime
from distributedpytorch_tpu_torch.models import (convert, pretrained,
                                                 registry, scan)
from distributedpytorch_tpu_torch.models.inception import InceptionC
from distributedpytorch_tpu_torch.models.vit import ViT
from distributedpytorch_tpu_torch.ops.attention import full_attention
from distributedpytorch_tpu_torch.ops.flash_attention import flash_attention
from distributedpytorch_tpu_torch.precision import PRESETS
from distributedpytorch_tpu_torch.train.engine import Engine
from distributedpytorch_tpu_torch.ops import losses

from tests import _torch_zoo_jax as Z

NARROW = dict(num_classes=10, dim=32, depth=3, heads=2)
CLASS_W = np.linspace(-1.0, 1.0, 10).astype(np.float32)
TOL_F32 = 1e-5          # f32 outputs and statistics: the same math
TOL_GRAD = 2e-4         # JAX's _grads_match: 2e-4 x max(|g|, 1)
TOL_BF16 = 5e-2
FULL = PRESETS["f32"]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _rel(got, want) -> float:
    got = torch.as_tensor(np.asarray(got), dtype=torch.float64)
    want = torch.as_tensor(np.asarray(want), dtype=torch.float64)
    return (got - want).abs().max().item() / max(want.abs().max().item(),
                                                 1e-30)


def _grads_match(got: dict, want: dict) -> None:
    """JAX's ``_grads_match``: each gradient within 2e-4 x max(|g|, 1)
    of the other's."""
    assert set(got) == set(want)
    for key, g in want.items():
        g = torch.as_tensor(np.asarray(g), dtype=torch.float64)
        err = (torch.as_tensor(got[key], dtype=torch.float64) - g).abs()
        assert err.max().item() <= TOL_GRAD * max(g.abs().max().item(),
                                                  1.0), key


# -- the stacked vit against JAX's ViT(scan_layers=True) ---------------------

@pytest.fixture(scope="module")
def jax_vit():
    """JAX's scanned vit's f32 params and the input, and its logits and
    gradients of sum(logits * w) in f32 and bf16, full and flash."""
    x = np.random.default_rng(0).standard_normal(
        (3, 28, 28, 3)).astype(np.float32)
    params = _np(JaxViT(dtype=jnp.float32, scan_layers=True, **NARROW).init(
        jax.random.PRNGKey(0), jnp.asarray(x), False)["params"])
    out = {}
    for attention in ("full", "flash"):
        for dtype in ("float32", "bfloat16"):
            model = JaxViT(dtype=getattr(jnp, dtype), scan_layers=True,
                           attention_fn=(jax_flash if attention == "flash"
                                         else None), **NARROW)

            def loss(p, model=model):
                logits = model.apply({"params": p}, jnp.asarray(x), True)
                return jnp.sum(logits * CLASS_W), logits

            (_, logits), grads = jax.value_and_grad(loss, has_aux=True)(
                params)
            out[attention, dtype] = (np.asarray(logits),
                                     convert.params_from_jax(_np(grads)))
    return x, params, out


def _port_vit(params, attention: str, dtype, remat_blocks: bool = False):
    model = ViT(dtype=dtype, device="cpu", scan_layers=True,
                attention_fn=(flash_attention if attention == "flash"
                              else full_attention), **NARROW)
    model.load_state_dict(convert.params_from_jax(params))
    model.remat_blocks = remat_blocks
    return model


def _port_vit_step(model, x):
    model.train()
    logits = model(torch.from_numpy(x))
    (logits * torch.from_numpy(CLASS_W)).sum().backward()
    return logits.detach(), {n: p.grad for n, p in model.named_parameters()}


@pytest.mark.parametrize("remat_blocks", [False, True],
                         ids=["none", "remat_blocks"])
@pytest.mark.parametrize("attention", ["full", "flash"])
def test_stacked_vit_matches_jax_in_f32(jax_vit, attention, remat_blocks):
    x, params, ref = jax_vit
    want_logits, want_grads = ref[attention, "float32"]
    model = _port_vit(params, attention, torch.float32, remat_blocks)
    assert model.state_dict()["blocks.block.qkv.weight"].shape == (3, 96, 32)
    logits, grads = _port_vit_step(model, x)
    np.testing.assert_allclose(logits.numpy(), want_logits, atol=TOL_F32,
                               rtol=0)
    _grads_match(grads, want_grads)


@pytest.mark.parametrize("attention", ["full", "flash"])
def test_stacked_vit_matches_jax_in_bf16(jax_vit, attention):
    """bf16 by the conditioned rule: JAX's f32 result is the truth."""
    x, params, ref = jax_vit
    truth_logits, truth = ref[attention, "float32"]
    jax_logits, jax_grads = ref[attention, "bfloat16"]
    logits, grads = _port_vit_step(
        _port_vit(params, attention, torch.bfloat16), x)
    assert logits.dtype == torch.float32
    if _rel(logits, jax_logits) > TOL_BF16:
        assert _rel(logits, truth_logits) <= Z.CONDITIONED_FACTOR * _rel(
            jax_logits, truth_logits)
    port = np.array([_rel(grads[k], truth[k]) for k in truth])
    jax_ = np.array([_rel(jax_grads[k], truth[k]) for k in truth])
    assert np.median(port) <= Z.CONDITIONED_FACTOR * np.median(jax_)
    assert port.max() <= Z.CONDITIONED_FACTOR * jax_.max()


# -- the block runs against JAX's runners -------------------------------------

class _JaxRun(fnn.Module):
    """One of JAX's scan runners as a module of its own."""

    kind: str

    @fnn.compact
    def __call__(self, x, train: bool):
        if self.kind == "vgg":
            return jax_scan.scan_vgg_run(2, 16, jnp.float32, train,
                                         name="ConvScan_0")(x)
        if self.kind == "dense":
            return jax_scan.scan_dense_block(2, 8, 4, 2, jnp.float32, train,
                                             name="DenseBlockScan_0")(x)
        return jax_scan.scan_run(JaxInceptionC, 2,
                                 dict(channels_7x7=160, dtype=jnp.float32),
                                 train, name="InceptionCScan_0")(x)


# kind -> (the port's run, its scanned name, input NHWC shape)
RUNS = {
    "vgg": (lambda: scan.VGGScan(2, 16), "ConvScan_0", (2, 6, 6, 16)),
    "dense": (lambda: scan.DenseBlockScan(2, 8, 4, 2), "DenseBlockScan_0",
              (2, 5, 5, 8)),
    "inception": (lambda: scan.ScanRun(InceptionC(768, 160), 2),
                  "InceptionCScan_0", (2, 5, 5, 768)),
}


def _random_like(tree, rng, positive: bool = False):
    """Random values of ``tree``'s shapes: variances (and, with
    ``positive``, every leaf) in [0.5, 1.5), the rest normal / 4."""
    def one(path, v):
        key = jax.tree_util.keystr(path)
        if positive or "var" in key or "scale" in key:
            return rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        return (rng.standard_normal(v.shape) / 4).astype(np.float32)

    return jax.tree_util.tree_map_with_path(one, tree)


@pytest.mark.parametrize("kind", list(RUNS))
def test_block_runs_match_jax_runners(kind):
    build, name, shape = RUNS[kind]
    rng = np.random.default_rng(1)
    x = rng.standard_normal(shape).astype(np.float32)
    jmodel = _JaxRun(kind)
    variables = _np(jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x), True))
    params = _random_like(variables["params"], rng)
    stats = _random_like(variables["batch_stats"], rng)
    if kind == "dense":
        # relu(bias) > 0 past each step's valid width: only the mask
        # keeps those channels out of the 1x1 conv
        norm = params[name]["BatchNorm_0"]
        norm["bias"] = np.abs(norm["bias"]) + 0.5
    w = rng.standard_normal(np.asarray(
        jmodel.apply({"params": params, "batch_stats": stats},
                     jnp.asarray(x), False)).shape).astype(np.float32)

    def loss(p):
        y, moved = jmodel.apply({"params": p, "batch_stats": stats},
                                jnp.asarray(x), True,
                                mutable=["batch_stats"])
        return jnp.sum(y * w), (y, moved["batch_stats"])

    (_, (want, moved)), grads = jax.value_and_grad(loss, has_aux=True)(
        params)
    # the eval after the step: the statistics it moved
    want_eval = jmodel.apply({"params": params, "batch_stats": moved},
                             jnp.asarray(x), False)

    def port_names(sd):
        return {k[len(name) + 1:]: v for k, v in sd.items()}

    run = build()
    run.load_state_dict(port_names(convert.cnn_params_from_jax(params,
                                                               stats)))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    run.train()
    y = run(xt)
    (y * torch.from_numpy(w).permute(0, 3, 1, 2)).sum().backward()
    assert _rel(y.detach().permute(0, 2, 3, 1), want) <= TOL_F32
    got_stats = {k: v for k, v in run.state_dict().items()
                 if "running" in k}
    want_stats = port_names(convert.cnn_params_from_jax(
        grads, _np(moved)))
    for key, v in got_stats.items():
        assert _rel(v, want_stats[key]) <= TOL_F32, key
    got_grads = {n: p.grad for n, p in run.named_parameters()}
    _grads_match(got_grads, {k: v for k, v in want_stats.items()
                             if "running" not in k})
    if kind == "dense":
        for i in range(2):
            c_i = 8 + 4 * i
            assert not got_grads["BatchNorm_0.weight"][i, c_i:].any()
            assert not got_grads["BatchNorm_0.bias"][i, c_i:].any()
            assert not got_grads["Conv_0.weight"][i, :, c_i:].any()
    run.eval()
    with torch.no_grad():
        got_eval = run(xt).permute(0, 2, 3, 1)
    assert _rel(got_eval, want_eval) <= TOL_F32


def test_dense_run_under_remat_equals_its_plain_step():
    """The dense run with each step checkpointed: the same output,
    gradients and statistics (moved once)."""
    x = torch.randn(2, 8, 5, 5, generator=torch.Generator().manual_seed(3))
    base = scan.DenseBlockScan(3, 8, 4, 2)
    out = []
    for checkpoint in (False, True):
        run = copy.deepcopy(base)
        run.train()
        y = run(x, checkpoint=checkpoint)
        y.square().sum().backward()
        out.append((y.detach(), {n: p.grad for n, p in
                                 run.named_parameters()},
                    {k: v.clone() for k, v in run.named_buffers()}))
    (y0, g0, s0), (y1, g1, s1) = out
    assert torch.equal(y0, y1)
    assert all(torch.equal(g0[k], g1[k]) for k in g0)
    assert all(torch.equal(s0[k], s1[k]) for k in s0)


# -- layout conversion against JAX's convert_layout ---------------------------

# name -> (input size, the plain layout, the scanned one, modules left
# out: vgg's large pass-through layers, and inception's aux head, which
# flax builds in train mode only)
FAMILIES = {
    "vit": (28, "blocks", "scan", ()),
    "vgg": (32, "vgg_layers", "vgg_scan", ("Dense_0", "Dense_1")),
    "densenet": (32, "dense_layers", "dense_scan", ()),
    "inception": (299, "inception_blocks", "inception_scan",
                  ("AuxHead_0",)),
}


def _jax_state(name: str, scan_layers: bool, rng) -> dict:
    """A random state dict of JAX's model (params, batch_stats and Adam's
    mu and nu), from ``jax.eval_shape``."""
    size, _, _, leave_out = FAMILIES[name]
    model = jax_registry.get_model(name, 10, scan_layers=scan_layers)
    shapes = jax.eval_shape(functools.partial(model.init, train=False),
                            jax.random.PRNGKey(0),
                            jnp.zeros((1, size, size, 3), jnp.float32))
    shapes = serialization.to_state_dict(shapes)
    params = {k: v for k, v in shapes["params"].items()
              if k not in leave_out}
    state = {"params": _random_like(params, rng),
             "mu": _random_like(params, rng),
             "nu": _random_like(params, rng, positive=True)}
    if "batch_stats" in shapes:
        state["batch_stats"] = _random_like(shapes["batch_stats"], rng)
    return state


def _port_state(name: str, state: dict) -> dict:
    """JAX's state as the port names it: the params with their running
    statistics, and each moment by parameter name."""
    stats = state.get("batch_stats")

    def one(tree):
        if name == "vit":
            return convert.params_from_jax(tree)
        return convert.cnn_params_from_jax(tree, stats)
    out = {"params": one(state["params"])}
    for key in ("mu", "nu"):
        out[key] = {k: v for k, v in one(state[key]).items()
                    if "running" not in k}
    return out


@pytest.mark.parametrize("name", list(FAMILIES))
def test_layout_conversion_matches_jax(name):
    _, plain, scanned, _ = FAMILIES[name]
    rng = np.random.default_rng(2)
    for src, dst, scan_layers in ((plain, scanned, False),
                                  (scanned, plain, True)):
        state = _jax_state(name, scan_layers, rng)
        assert jax_scan.params_layout(state["params"]) == src
        want = _port_state(name, _np(jax_scan.convert_layout(state, dst)))
        got = _port_state(name, state)
        assert scan.params_layout(got["params"]) == src
        for key in ("params", "mu", "nu"):
            moved = scan.convert_layout(got[key], dst)
            assert scan.params_layout(moved) == dst
            assert set(moved) == set(want[key])
            for k, v in moved.items():
                assert torch.equal(v, want[key][k]), (src, key, k)
        # the names and shapes are the port's model's in that layout
        model = registry.get_model(name, 10, FULL, device="meta",
                                   scan_layers=not scan_layers)
        shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()
                  if k.split(".", 1)[0] not in FAMILIES[name][3]}
        assert shapes == {k: tuple(v.shape) for k, v in
                          scan.convert_layout(got["params"], dst).items()}
        back = scan.convert_layout(scan.convert_layout(got["params"], dst),
                                   src)
        if name != "densenet" or src == plain:
            # a scanned densenet's padding does not survive the trip
            assert all(torch.equal(back[k], v)
                       for k, v in got["params"].items())


def test_cross_family_and_vit_transitive_conversion():
    """A target of another family raises JAX's error; the scanned vit
    reaches the pipeline's stacked layout through 'blocks' and back."""
    with pytest.raises(ValueError) as want:
        jax_scan.convert_layout({"ConvScan_0": {}}, "dense_scan")
    with pytest.raises(ValueError, match=f"^{re.escape(str(want.value))}$"):
        scan.convert_layout({"ConvScan_0.Conv_0.weight": torch.zeros(2)},
                            "dense_scan")
    model = ViT(device="cpu", scan_layers=True, **NARROW).init_weights(
        torch.Generator().manual_seed(0))
    sd = model.state_dict()
    stacked = scan.convert_layout(sd, "stacked")
    assert scan.params_layout(stacked) == "stacked"
    assert stacked["qkv_kernel"].shape == (3, 32, 96)
    back = scan.convert_layout(stacked, "scan")
    assert list(back) != [] and all(torch.equal(back[k], v)
                                    for k, v in sd.items())
    assert [scan.scan_layout_for(x) for x in
            ("blocks", "stacked", "scan", "vgg_layers", "dense_scan",
             "inception_blocks", None)] == [
        jax_scan.scan_layout_for(x) for x in
        ("blocks", "stacked", "scan", "vgg_layers", "dense_scan",
         "inception_blocks", None)]
    assert scan.KNOWN_LAYOUTS == jax_scan.KNOWN_LAYOUTS


# -- placement at --model-parallel 2 ---------------------------------------

def _fake_mesh(m: int = 0) -> runtime.Mesh:
    """A model axis of 2 with no process groups: enough to split."""
    return runtime.Mesh(1, 2, 0, m, (0, 1))


@pytest.mark.parametrize("name", ["vit", "densenet"])
def test_per_rank_elements_are_jaxs_state_sharding(name):
    """A rank's elements of each parameter equal JAX's shard shape under
    ``state_sharding`` on a model axis of 2; JAX also shards the scanned
    densenet's stacked norm statistics of blocks 2 and 3 ((24, 1024) and
    (16, 1024)), which the port, placing no buffer, holds whole."""
    size = 28 if name == "vit" else 32
    model = jax_registry.get_model(name, 10, scan_layers=True)
    shapes = jax.eval_shape(functools.partial(model.init, train=False),
                            jax.random.PRNGKey(0),
                            jnp.zeros((1, size, size, 3), jnp.float32))
    tree = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                  shapes)
    mesh = jax_runtime.make_mesh(model_parallel=2, devices=jax.devices()[:2])
    sharding = jax_parallel.state_sharding(tree, mesh)
    counts = jax.tree_util.tree_map(
        lambda leaf, sh: np.full(leaf.shape, math.prod(
            sh.shard_shape(leaf.shape)), np.float32), tree, sharding)
    stats = counts.get("batch_stats", {})
    want = (convert.params_from_jax(counts["params"]) if name == "vit"
            else convert.cnn_params_from_jax(counts["params"], stats))
    port = registry.get_model(name, 10, FULL, device="meta",
                              mesh=_fake_mesh(), scan_layers=True)
    parallel.place(port, _fake_mesh())
    got = {k: p.numel() for k, p in port.named_parameters()}
    assert got == {k: int(want[k].flatten()[0]) for k in got}
    assert sum(got.values()) < sum(want[k].numel() for k in got)
    jax_sharded = sorted(k for k, v in want.items() if "running" in k
                         and int(v.flatten()[0]) < v.numel())
    assert jax_sharded == ([] if name == "vit" else [
        f"DenseBlockScan_{b}.BatchNorm_0.running_{s}"
        for b in (2, 3) for s in ("mean", "var")])
    buffers = dict(port.named_buffers())
    assert all(buffers[k].numel() == want[k].numel() for k in jax_sharded)


def test_tensor_parallel_shards_of_the_stacked_vit():
    """``local_shards`` of the scanned vit: the unrolled one's shards
    past the stack axis, and a rank's elements the unrolled one's."""
    out = {}
    for scan_layers in (False, True):
        model = registry.get_model("vit", 10, FULL, device="meta",
                                   mesh=_fake_mesh(), tensor_parallel=True,
                                   scan_layers=scan_layers)
        parallel.place(model, _fake_mesh())
        out[scan_layers] = (parallel.placement_of(model).shards,
                            sum(p.numel() for p in model.parameters()))
    (plain, n_plain), (stacked, n_stacked) = out[False], out[True]
    assert n_plain == n_stacked
    local = {k: v for k, v in plain.items() if not v.gathered}
    assert {k for k, v in stacked.items() if not v.gathered} == {
        re.sub(r"^blocks\.0\.", "blocks.block.", k) for k in local
        if k.startswith("blocks.0.")}
    for k, v in local.items():
        if k.startswith("blocks.0."):
            s = stacked[re.sub(r"^blocks\.0\.", "blocks.block.", k)]
            assert (s.dim, s.groups) == (v.dim + 1, v.groups)


# -- the registry's and --use-pretrained's errors -----------------------------

def _error(fn, *args, **kwargs) -> str:
    with pytest.raises(ValueError) as e:
        fn(*args, **kwargs)
    return str(e.value)


@pytest.mark.parametrize("name,kw", [
    ("cnn", dict(pipeline_parallel=True, moe_experts=4)),
    ("resnet", {}),
    ("vit", dict(pipeline_parallel=True, moe_experts=4)),
    ("vit", dict(moe_experts=4)),
])
def test_registry_refuses_as_jax(name, kw):
    want = _error(jax_registry.get_model, name, 10, scan_layers=True, **kw)
    got = _error(registry.get_model, name, 10, FULL, device="meta",
                 scan_layers=True, **kw)
    assert got == want


@pytest.mark.parametrize("name", ["vgg", "densenet", "inception"])
def test_use_pretrained_under_the_flag_is_refused_as_jax(name, tmp_path):
    """The torchvision keys do not name the stacked run: the merge fails
    as JAX's ``convert_state_dict`` fails on its scanned model."""
    from tests._torch_zoo import TORCH_ZOO

    sd = TORCH_ZOO[name](num_classes=10).state_dict()
    size = Z.SIZES[name]
    model = jax_registry.get_model(name, 10, scan_layers=True)
    shapes = jax.eval_shape(functools.partial(model.init, train=False),
                            jax.random.PRNGKey(0),
                            jnp.zeros((1, size, size, 3), jnp.float32))
    tree = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                  shapes)
    want = _error(jax_pretrained.convert_state_dict, name,
                  {k: v.numpy() for k, v in sd.items()}, tree["params"],
                  tree.get("batch_stats", {}))
    path = tmp_path / f"{name}.pth"
    torch.save(sd, path)
    port = registry.get_model(name, 10, FULL, device="cpu",
                              scan_layers=True)
    assert _error(pretrained.load_pretrained, name, str(path), port) == want
    if name == "densenet":
        argv = ["train", "-d", str(tmp_path / "d"), "--rsl_path",
                str(tmp_path / "rsl"), "--device", "cpu", "--debug",
                "--synthetic-fallback", "--model", name, "--scan-layers",
                "--use-pretrained", "--pretrained-path", str(path)]
        assert _error(tcli.run_train, tconfig.config_from_argv(argv)) \
            == want


# -- JAX-written scanned files ------------------------------------------------

@pytest.fixture(scope="module")
def jax_vit_file(tmp_path_factory):
    """JAX's ``run_train --scan-layers`` of the vit (f32, Adam, one epoch
    of the synthetic debug split) and its ``run_test`` of the file."""
    from distributedpytorch_tpu.cli import run_test, run_train
    from distributedpytorch_tpu.config import Config

    tmp = tmp_path_factory.mktemp("jaxscan")
    data, rsl = str(tmp / "data"), str(tmp / "jax")
    common = dict(data_path=data, dataset="synthetic", debug=True,
                  half_precision=False)
    run_train(Config(action="train", rsl_path=rsl, model_name="vit",
                     batch_size=8, nb_epochs=1, scan_layers=True,
                     optimizer="adam", **common))
    path = f"{rsl}/checkpoint-synthetic-vit-000.ckpt"
    result = run_test(Config(action="test", rsl_path=str(tmp / "jaxtest"),
                             checkpoint_file=path, **common))
    return tmp, data, path, result


def _argv(action, tmp, data, *extra):
    return [action, "-d", data, "--rsl_path", str(tmp), "--dataset",
            "synthetic", "--debug", "--precision", "f32", "--device",
            "cpu", *extra]


@pytest.mark.parametrize("flag", [[], ["--scan-layers"]],
                         ids=["plain", "scan"])
def test_port_tests_a_jax_scanned_file_as_jax(jax_vit_file, flag):
    tmp, data, path, want = jax_vit_file
    got = tcli.run_test(tconfig.config_from_argv(_argv(
        "test", tmp / f"test{len(flag)}", data, "-f", path, *flag)))
    assert got["model_name"] == "vit"
    np.testing.assert_allclose(got["test_loss"], want["test_loss"],
                               rtol=1e-5)
    # JAX's accuracy is an f32 count over 200 rows
    assert got["test_acc"] == pytest.approx(float(want["test_acc"]),
                                            abs=1e-6)
    log = (tmp / f"test{len(flag)}" / "test.log").read_text()
    assert ("checkpoint params converted: scan -> blocks block layout"
            in log) == (not flag)


@pytest.mark.parametrize("scan_layers", [True, False],
                         ids=["scan", "plain"])
def test_port_resumes_and_serves_a_jax_scanned_file(jax_vit_file,
                                                    scan_layers):
    """The file's Adam moments (converted for the plain model) become the
    optimizer's state; the serving restore's logits equal JAX's eval of
    the file's params; ``train -f`` goes on to the next epoch."""
    from distributedpytorch_tpu.models.vit import ViT as JViT

    tmp, data, path, _ = jax_vit_file
    with open(path, "rb") as f:
        jstate = serialization.msgpack_restore(f.read())["state"]
    mu = convert.params_from_jax(_np(jstate["opt_state"]["0"]["mu"]))
    params = jstate["params"]
    layout = "scan" if scan_layers else "blocks"
    mu = scan.convert_layout(mu, layout)
    model = registry.get_model("vit", 10, FULL, device="cpu",
                               scan_layers=scan_layers)
    engine = Engine(model, losses.cross_entropy, 0.5, 0.25, 28, FULL,
                    "cpu", optimizer="adam")
    state = engine.init_state(torch.Generator().manual_seed(0))
    ckpt.load_checkpoint(path, model, state.optimizer, train_state=state)
    names = parallel.optimizer_names(model, state.optimizer)
    osd = state.optimizer.state_dict()["state"]
    assert {names[i]: st["exp_avg"] for i, st in osd.items()}.keys() == \
        mu.keys()
    for i, st in osd.items():
        assert torch.equal(st["exp_avg"], mu[names[i]]), names[i]
    x = np.random.default_rng(4).standard_normal(
        (4, 28, 28, 3)).astype(np.float32)
    want = np.asarray(JViT(dtype=jnp.float32, scan_layers=True).apply(
        {"params": params}, jnp.asarray(x), False))
    served = registry.get_model("vit", 10, FULL, device="cpu",
                                scan_layers=scan_layers)
    assert ckpt.restore_for_serving(path, served) == 0
    served.eval()
    with torch.no_grad():
        np.testing.assert_allclose(served(torch.from_numpy(x)).numpy(),
                                   want, atol=TOL_F32, rtol=0)
    if scan_layers:
        result = tcli.run_train(tconfig.config_from_argv(_argv(
            "train", tmp / "resume", data, "--model", "vit", "-b", "8",
            "-e", "2", "--optimizer", "adam", "--scan-layers", "-f",
            path)))
        assert [h["epoch"] for h in result["history"]] == [1]


def test_a_jax_scanned_densenet_file_restores_and_resumes(tmp_path):
    """JAX's scanned densenet121 state (random statistics and Adam
    moments) in its file: the port's scanned and plain models restore it
    with JAX's eval logits, and resume its moments."""
    from distributedpytorch_tpu import checkpoint as jax_ckpt
    from distributedpytorch_tpu.ops import losses as jax_losses
    from distributedpytorch_tpu.precision import PRESETS as JAX_PRESETS
    from distributedpytorch_tpu.train.engine import Engine as JaxEngine
    from distributedpytorch_tpu.train.engine import (
        make_optimizer as jax_make_optimizer)

    jmodel = jax_registry.get_model("densenet", 10, half_precision=False,
                                    scan_layers=True)
    tx = jax_make_optimizer("adam", 1e-3, 0.9, 0.1, 1, False)
    jengine = JaxEngine(jmodel, "densenet", jax_losses.cross_entropy, tx,
                        0.5, 0.25, 64, precision=JAX_PRESETS["f32"])
    state = jengine.init_state(jax.random.PRNGKey(4))
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    state = state.replace(
        batch_stats=_random_like(_np(state.batch_stats), rng),
        opt_state=jax.tree_util.tree_map(
            lambda v: (rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
                       if np.ndim(v) else v), state.opt_state))
    path = str(tmp_path / "bestmodel-mnist-densenet.ckpt")
    jax_ckpt.save_checkpoint(path, "densenet", state, epoch=3,
                             best_valid_loss=0.5)
    want = np.asarray(jmodel.apply({"params": state.params,
                                    "batch_stats": state.batch_stats},
                                   jnp.asarray(x), train=False))
    nu = convert.cnn_params_from_jax(_np(state.opt_state[0].nu),
                                     _np(state.batch_stats))
    for scan_layers in (True, False):
        model = registry.get_model("densenet", 10, FULL, device="cpu",
                                   scan_layers=scan_layers)
        assert ckpt.restore_for_serving(path, model) == 3
        model.eval()
        with torch.no_grad():
            assert _rel(model(torch.from_numpy(x)), want) <= 1e-4
        engine = Engine(model, losses.cross_entropy, 0.5, 0.25, 64, FULL,
                        "cpu", optimizer="adam")
        tstate = engine.init_state(torch.Generator().manual_seed(0))
        ckpt.load_checkpoint(path, model, tstate.optimizer,
                             train_state=tstate)
        want_nu = scan.convert_layout(
            {k: v for k, v in nu.items() if "running" not in k},
            "dense_scan" if scan_layers else "dense_layers")
        names = parallel.optimizer_names(model, tstate.optimizer)
        for i, st in tstate.optimizer.state_dict()["state"].items():
            assert torch.equal(st["exp_avg_sq"], want_nu[names[i]]), \
                names[i]
