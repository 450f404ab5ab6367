"""JAX-written checkpoints of the zoo read by the port: for each of the
five models, a JAX ``Engine`` init (its BatchNorm statistics moved off
their initial (0, 1)) saved by the JAX checkpoint writer is restored by
the port's ``serve``/``test`` restore, and the port's eval logits equal
the flax model's on the same input (f32, 1e-4 of the largest logit; 64
px, and 299 for inception).  A file in the ``--scan-layers`` layout is
read into the scanned model and, converted, into the plain one, with the
same logits; into a model of another family it is refused, never
half-loaded.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedpytorch_tpu import checkpoint as jax_ckpt
from distributedpytorch_tpu.models import get_model as jax_get_model
from distributedpytorch_tpu.ops import losses as jax_losses
from distributedpytorch_tpu.precision import PRESETS as JAX_PRESETS
from distributedpytorch_tpu.train.engine import Engine as JaxEngine
from distributedpytorch_tpu.train.engine import (
    make_optimizer as jax_make_optimizer)
from distributedpytorch_tpu_torch import checkpoint as ckpt
from distributedpytorch_tpu_torch.models import registry
from distributedpytorch_tpu_torch.precision import PRESETS

from tests import _torch_zoo_jax as Z


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jax_file(name, path, **model_kw):
    """A JAX Engine's state of ``name``, statistics moved, saved with the
    JAX writer; returns the JAX model and state."""
    jmodel = jax_get_model(name, 10, half_precision=False, **model_kw)
    tx = jax_make_optimizer("adam", 1e-3, 0.9, 0.1, 1, False)
    engine = JaxEngine(jmodel, name, jax_losses.cross_entropy, tx, 0.5,
                       0.25, Z.SIZES[name], precision=JAX_PRESETS["f32"])
    state = engine.init_state(jax.random.PRNGKey(4))
    rng = np.random.default_rng(5)
    # no optimizer state: test and serve read params and batch_stats, and
    # vgg's Adam moments would add 1 GB to the file
    state = state.replace(opt_state=(), batch_stats=jax.tree_util.tree_map(
        lambda v: jnp.asarray(rng.uniform(0.5, 1.5, v.shape), v.dtype)
        * (v + 0.1), state.batch_stats))
    jax_ckpt.save_checkpoint(str(path), name, state, epoch=3,
                             best_valid_loss=0.5)
    return jmodel, state


@pytest.mark.parametrize("name", ["alexnet", "vgg", "squeezenet",
                                  "densenet", "inception"])
def test_jax_written_checkpoint_restores_with_equal_logits(name, tmp_path):
    path = tmp_path / f"bestmodel-mnist-{name}.ckpt"
    jmodel, state = _jax_file(name, path)
    x = np.random.default_rng(6).standard_normal(
        (2, Z.SIZES[name], Z.SIZES[name], 3)).astype(np.float32)
    variables = {"params": state.params}
    if jax.tree_util.tree_leaves(state.batch_stats):
        variables["batch_stats"] = state.batch_stats
    want = np.asarray(jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(
        variables, x))

    assert ckpt.get_checkpoint_model_name(str(path)) == name
    model = registry.get_model(name, 10, PRESETS["f32"], device="cpu")
    assert ckpt.restore_for_serving(str(path), model) == 3
    model.eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    path.unlink()
    assert Z.rel(got, want) <= 1e-4
    if name in ("vgg", "densenet", "inception"):
        stats = [b for n, b in model.named_buffers() if "running_var" in n]
        assert stats and not torch.allclose(stats[0], torch.ones(1))


def test_scan_layout_checkpoint_is_refused(tmp_path):
    """vgg written with --scan-layers (its ConvScan_0) restores into the
    port's scanned vgg as it is and into the plain one converted
    (vgg_scan -> vgg_layers), both with the flax model's eval logits; a
    model of another family refuses it with JAX's ``convert_layout``
    error and loads nothing of it."""
    from distributedpytorch_tpu.models import scan as jax_scan

    path = tmp_path / "bestmodel-mnist-vgg.ckpt"
    jmodel, state = _jax_file("vgg", path, scan_layers=True)
    x = np.random.default_rng(6).standard_normal(
        (2, Z.SIZES["vgg"], Z.SIZES["vgg"], 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(
        {"params": state.params, "batch_stats": state.batch_stats}, x))
    assert ckpt.read_checkpoint(str(path))["state"]["params"][
        "ConvScan_0.Conv_0.weight"].shape == (2, 512, 512, 3, 3)
    for scan_layers in (True, False):
        model = registry.get_model("vgg", 10, PRESETS["f32"], device="cpu",
                                   scan_layers=scan_layers)
        assert ckpt.restore_for_serving(str(path), model) == 3
        model.eval()
        with torch.no_grad():
            assert Z.rel(model(torch.from_numpy(x)), want) <= 1e-4
    model = registry.get_model("densenet", 10, PRESETS["f32"], device="cpu")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with pytest.raises(ValueError) as jax_error:
        jax_scan.convert_layout({"ConvScan_0": {}}, "dense_layers")
    with pytest.raises(ValueError, match=re.escape(
            f"{path}: {jax_error.value}")):
        ckpt.restore_for_serving(str(path), model)
    path.unlink()
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
