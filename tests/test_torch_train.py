"""The port's training slice held against the JAX package's: the sampler,
the train-time augmentation with the JAX draws injected, the losses and
metrics, the gradients of one train step, the optimizers, a 3-step SGD
trajectory, ``test -f`` on a JAX-written checkpoint, and the entry points
(file names, log formats, resume, the torn-head fallback, refusals, the
no-GPU refusal).  Inputs come from numpy with a seed and go to both sides;
the JAX side runs on the CPU.  Tolerances are stated where they are used.
"""

import os
import re
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributedpytorch_tpu.data import augment as jax_augment
from distributedpytorch_tpu.data.sampler import ShardedSampler as JaxSampler
from distributedpytorch_tpu.models.vit import ViT as JaxViT
from distributedpytorch_tpu.ops import losses as jax_losses
from distributedpytorch_tpu.ops.metrics import (
    per_example_correct as jax_correct)
from distributedpytorch_tpu.precision import PRESETS as JAX_PRESETS
from distributedpytorch_tpu.train.engine import Engine as JaxEngine
from distributedpytorch_tpu.train.engine import (
    make_optimizer as jax_make_optimizer)
from distributedpytorch_tpu_torch import checkpoint as ckpt
from distributedpytorch_tpu_torch import cli as tcli
from distributedpytorch_tpu_torch import config as tconfig
from distributedpytorch_tpu_torch import utils
from distributedpytorch_tpu_torch.data import augment
from distributedpytorch_tpu_torch.data.sampler import ShardedSampler
from distributedpytorch_tpu_torch.models import convert, registry
from distributedpytorch_tpu_torch.models.vit import ViT
from distributedpytorch_tpu_torch.ops import losses
from distributedpytorch_tpu_torch.ops.attention import full_attention
from distributedpytorch_tpu_torch.ops.flash_attention import flash_attention
from distributedpytorch_tpu_torch.ops.metrics import per_example_correct
from distributedpytorch_tpu_torch.precision import PRESETS
from distributedpytorch_tpu_torch.train.engine import (
    Engine, TrainState, learning_rate_at, make_optimizer)

NARROW = dict(num_classes=10, dim=64, depth=2, heads=2)
MEAN, STD = 0.13, 0.31


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several workers on one machine: this file's torch
    ops keep to two threads, so that timing-sensitive tests on the other
    workers are not starved of cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# -- sampler ---------------------------------------------------------------

@pytest.mark.parametrize("n,b,epoch,shuffle", [
    (200, 64, 0, True), (200, 64, 3, True), (54000, 64, 1, True),
    (10, 64, 0, True), (128, 64, 2, True), (6000, 64, 0, False)])
def test_sampler_matches_jax(n, b, epoch, shuffle):
    want = JaxSampler(n, 1, 0, b, shuffle=shuffle, seed=1234)
    got = ShardedSampler(n, 1, 0, b, shuffle=shuffle, seed=1234)
    assert len(got) == len(want)
    for w, g in zip(want.epoch_indices(epoch), got.epoch_indices(epoch)):
        np.testing.assert_array_equal(g, w)
    idx, valid = got.epoch_indices(epoch)
    # every real row counted once; wraparound duplicates masked
    assert sorted(idx[valid].tolist()) == list(range(n))


def test_epoch_numpy_rng_matches_jax():
    from distributedpytorch_tpu import utils as jax_utils

    np.testing.assert_array_equal(
        utils.epoch_numpy_rng(7, 3).permutation(50),
        jax_utils.epoch_numpy_rng(7, 3).permutation(50))


def test_step_generator_is_a_function_of_seed_epoch_step():
    def draw(seed, epoch, step):
        return torch.rand(5, generator=utils.step_generator(
            seed, epoch, step, "cpu"))

    assert torch.equal(draw(1, 2, 3), draw(1, 2, 3))
    assert not torch.equal(draw(1, 2, 3), draw(1, 2, 4))
    assert not torch.equal(draw(1, 2, 3), draw(1, 3, 3))
    assert not torch.equal(draw(1, 2, 3), draw(2, 2, 3))


def test_get_duration_matches_jax():
    from distributedpytorch_tpu import utils as jax_utils

    for a, b in ((0.0, 59.9), (3.0, 3725.5), (10.0, 10.0)):
        assert utils.get_duration(a, b) == jax_utils.get_duration(a, b)


# -- augmentation ----------------------------------------------------------

def _jax_draws(key, b, h, w):
    return [torch.from_numpy(np.array(x)) for x in
            jax_augment._sample_affine_batch(key, b, h, w)]


@pytest.mark.parametrize("shape", [(6, 28, 28), (4, 32, 32, 3)],
                         ids=["gray28", "rgb32"])
@pytest.mark.parametrize("mean,std", [(0.0, 1.0), (MEAN, STD)])
def test_train_transform_with_jax_draws_matches_jax(shape, mean, std):
    """1e-5 in pixel units ([0, 1]): the source coordinates differ by an
    f32 rounding of cos/sin between the two frameworks; the normalization
    divides that error by std as well, so it is held to 1e-5 * (1 / std)."""
    imgs = np.random.default_rng(0).integers(0, 256, shape, dtype=np.uint8)
    key = jax.random.PRNGKey(5)
    want = np.asarray(jax_augment.train_transform(
        key, jnp.asarray(imgs), mean, std, 28))
    affine = _jax_draws(key, shape[0], shape[1], shape[2])
    got = augment.train_transform(torch.from_numpy(imgs), mean, std, 28,
                                  affine)
    assert got.shape == (shape[0], 28, 28, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5 / std, rtol=0)


def test_affine_formulas_match_jax():
    key = jax.random.PRNGKey(9)
    u = np.array(jax.random.uniform(key, (16, 5)))
    want = jax_augment._sample_affine_batch(key, 16, 28, 28)
    got = augment.affine_from_uniform(torch.from_numpy(u), 28, 28)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-6)


def test_sample_affine_batch_is_seeded_and_in_range():
    a = augment.sample_affine_batch(torch.Generator().manual_seed(1), 256,
                                    28, 28)
    b = augment.sample_affine_batch(torch.Generator().manual_seed(1), 256,
                                    28, 28)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    theta, y0, x0, ch, cw = a
    assert theta.abs().max() <= np.deg2rad(5.0) + 1e-6
    assert (ch >= 1).all() and (ch <= 28).all() and (cw <= 28).all()
    assert (y0 >= 0).all() and (y0 + ch <= 28 + 1e-4).all()
    assert (x0 >= 0).all() and (x0 + cw <= 28 + 1e-4).all()


def test_identity_affine_is_the_eval_transform():
    """No rotation, the full image as the crop: the warp reduces to the
    identity resample, so it equals the eval transform."""
    imgs = torch.from_numpy(np.random.default_rng(2).integers(
        0, 256, (3, 28, 28), dtype=np.uint8))
    ones = torch.ones(3)
    affine = (0 * ones, 0 * ones, 0 * ones, 28 * ones, 28 * ones)
    np.testing.assert_allclose(
        augment.train_transform(imgs, MEAN, STD, 28, affine).numpy(),
        augment.eval_transform(imgs, MEAN, STD, 28).numpy(), atol=1e-5)


# -- losses and metrics ------------------------------------------------------

@pytest.mark.parametrize("name", ["cross_entropy", "weighted_cross_entropy",
                                  "focal_loss"])
@pytest.mark.parametrize("weighted", [False, True])
def test_losses_match_jax(name, weighted):
    if name == "weighted_cross_entropy" and not weighted:
        with pytest.raises(ValueError, match="requires class weights"):
            losses.get_loss_fn(name, None)
        return
    rng = np.random.default_rng(3)
    logits = (rng.standard_normal((32, 10)) * 3).astype(np.float32)
    labels = rng.integers(0, 10, 32).astype(np.int32)
    cw = rng.uniform(0.5, 2.0, 10).astype(np.float32) if weighted else None
    want = jax_losses.get_loss_fn(name, cw, 2.0)(jnp.asarray(logits),
                                                 jnp.asarray(labels))
    got = losses.get_loss_fn(name, cw, 2.0)(
        torch.from_numpy(logits).to(torch.bfloat16).float(),
        torch.from_numpy(labels).long())
    want_bf = jax_losses.get_loss_fn(name, cw, 2.0)(
        jnp.asarray(logits).astype(jnp.bfloat16).astype(jnp.float32),
        jnp.asarray(labels))
    for g, w in zip(got, want_bf):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-5)
    assert len(want) == 2


def test_losses_upcast_bf16_logits():
    logits = torch.randn((8, 10), generator=torch.Generator().manual_seed(0))
    labels = torch.arange(8) % 10
    numer, denom = losses.cross_entropy(logits.to(torch.bfloat16), labels)
    assert numer.dtype == torch.float32 and denom.dtype == torch.float32


def test_per_example_correct_matches_jax_with_ties():
    logits = np.array([[1, 3, 3, 0], [2, 2, 2, 2], [0, 0, 5, 5],
                       [4, 1, 0, 4]], np.float32)
    labels = np.array([1, 0, 3, 0], np.int32)
    want = np.asarray(jax_correct(jnp.asarray(logits), jnp.asarray(labels)))
    got = per_example_correct(torch.from_numpy(logits),
                              torch.from_numpy(labels).long())
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, [1, 1, 0, 1])   # first max wins


# -- one train step's gradients -----------------------------------------------

def _jax_engine(dtype, tx=None, steps_per_epoch=2):
    prec = JAX_PRESETS["f32" if dtype == "float32" else "bf16"]
    model = JaxViT(dtype=prec.compute_dtype, **NARROW)
    tx = tx or jax_make_optimizer("SGD", 1e-3, 0.9, 0.1, steps_per_epoch,
                                  False)
    return JaxEngine(model, "vit", jax_losses.cross_entropy, tx, MEAN, STD,
                     28, precision=prec)


def _port_state(jax_state, dtype, attention, optimizer="SGD",
                steps_per_epoch=2):
    policy = PRESETS["f32" if dtype == "float32" else "bf16"]
    model = ViT(dtype=policy.compute_dtype, device="cpu",
                attention_fn=(flash_attention if attention == "flash"
                              else full_attention), **NARROW)
    model.load_state_dict(convert.params_from_jax(_np_tree(jax_state.params)))
    engine = Engine(model, losses.cross_entropy, MEAN, STD, 28, policy,
                    "cpu", optimizer=optimizer,
                    steps_per_epoch=steps_per_epoch)
    return engine, TrainState(model, make_optimizer(optimizer, model))


def _batch(seed, b=8):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (b, 28, 28), dtype=np.uint8)
    labels = rng.integers(0, 10, b).astype(np.int32)
    valid = np.ones(b, bool)
    valid[-2:] = False                  # wraparound rows are masked out
    return images, labels, valid


def _step_grads(dtype, attention):
    """(JAX grads, port grads, JAX loss, port metrics) of one train step
    of the narrow vit on the same batch and affine draws; the JAX side
    runs ``jax.grad`` of its Engine's loss with full attention."""
    jengine = _jax_engine(dtype)
    jstate = jengine.init_state(jax.random.PRNGKey(0))
    images, labels, valid = _batch(1)
    key = jax.random.PRNGKey(11)
    imgs = jax_augment.train_transform(
        key, jnp.asarray(images), MEAN, STD, 28,
        out_dtype=jengine.compute_dtype)
    jgrads, _, jloss, _ = jengine._grads_and_metrics(
        jstate, imgs, jnp.asarray(labels),
        jnp.asarray(valid, jnp.float32), None)
    engine, state = _port_state(jstate, dtype, attention)
    _, m = engine.train_step_affine(
        state, torch.from_numpy(images), torch.from_numpy(labels).long(),
        torch.from_numpy(valid), _jax_draws(key, 8, 28, 28))
    grads = {n: p.grad for n, p in state.model.named_parameters()}
    return (convert.params_from_jax(_np_tree(jgrads)), grads, float(jloss),
            m)


def _rel(g, w) -> float:
    return (g - w).abs().max().item() / max(w.abs().max().item(), 1e-12)


@pytest.fixture(scope="module")
def f32_step_grads():
    return {att: _step_grads("float32", att) for att in ("flash", "full")}


# The bias of a bf16 dense layer (and of the patch embedding) gets the sum
# over batch x tokens of a bf16 gradient.  XLA on the CPU sums it in bf16:
# up to 10% off the f32 gradient at this size, where torch's sum (f32
# accumulation) stays within 1.4% (test below).  Those are held to the f32
# gradient instead of to the JAX bf16 one.
def _bf16_summed_bias(name: str) -> bool:
    return name.endswith(".bias") and not re.search(r"ln\d|norm", name)


@pytest.mark.parametrize("attention", ["flash", "full"])
def test_step_gradients_match_jax_f32(f32_step_grads, attention):
    """1e-4 relative to each parameter's largest gradient: the same f32
    math in another summation order."""
    want, grads, jloss, m = f32_step_grads[attention]
    assert abs(m["loss"].item() - jloss) <= 1e-5
    assert m["valid"].item() == 6.0
    assert set(grads) == set(want)
    for name, w in want.items():
        assert grads[name].dtype == torch.float32, name
        assert _rel(grads[name], w) <= 1e-4, name


@pytest.mark.parametrize("attention", ["flash", "full"])
def test_step_gradients_match_jax_bf16(f32_step_grads, attention):
    """5e-2 relative to each parameter's largest gradient, against the
    JAX bf16 gradient and against the f32 one (bf16 rounds at the same
    points in both frameworks: casts at use, products rounded to bf16,
    f32 master params get the f32 cast of the bf16 gradient)."""
    want, grads, jloss, m = _step_grads("bfloat16", attention)
    want_f32 = f32_step_grads[attention][0]
    assert abs(m["loss"].item() - jloss) <= 5e-2
    for name, w in want.items():
        assert grads[name].dtype == torch.float32, name
        assert _rel(grads[name], want_f32[name]) <= 5e-2, name
        if not _bf16_summed_bias(name):
            assert _rel(grads[name], w) <= 5e-2, name


def test_jax_cpu_sums_bf16_bias_gradients_in_bf16(f32_step_grads):
    """A fault of the reference on the CPU, kept in ROADMAP queue 3: its
    bf16 bias gradients are further from the f32 gradient than the
    port's, by up to 10% of the largest value (the port's: under 1.4%)."""
    want, grads, _, _ = _step_grads("bfloat16", "full")
    want_f32 = f32_step_grads["full"][0]
    biases = [n for n in want if _bf16_summed_bias(n)]
    jax_err = max(_rel(want[n], want_f32[n]) for n in biases)
    port_err = max(_rel(grads[n], want_f32[n]) for n in biases)
    assert port_err < 2e-2 < 5e-2 < jax_err


# -- optimizers ---------------------------------------------------------------

class _Params(torch.nn.Module):
    def __init__(self, arrays):
        super().__init__()
        self.a = torch.nn.Parameter(torch.from_numpy(arrays["a"].copy()))
        self.b = torch.nn.Parameter(torch.from_numpy(arrays["b"].copy()))


@pytest.mark.parametrize("name", ["adam", "SGD"])
def test_optimizer_matches_optax_given_identical_grads(name):
    """Three updates, crossing the staircase's epoch boundary (2 steps per
    epoch) for SGD; 1e-6 in f32."""
    rng = np.random.default_rng(4)
    params = {"a": rng.standard_normal((5, 3)).astype(np.float32),
              "b": rng.standard_normal(7).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(3)]
    tx = jax_make_optimizer(name, 1e-3, 0.9, 0.1, 2, False)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state = tx.init(jp)
    for g in grads:
        updates, opt_state = tx.update({k: jnp.asarray(v)
                                        for k, v in g.items()},
                                       opt_state, jp)
        jp = optax.apply_updates(jp, updates)

    module = _Params(params)
    engine = Engine(module, None, 0.0, 1.0, 28, PRESETS["f32"], "cpu",
                    optimizer=name, steps_per_epoch=2)
    state = TrainState(module, make_optimizer(name, module))
    for g in grads:
        module.a.grad = torch.from_numpy(g["a"])
        module.b.grad = torch.from_numpy(g["b"])
        engine.apply_gradients(state)
    assert state.step == 3
    for k in ("a", "b"):
        np.testing.assert_allclose(getattr(module, k).detach().numpy(),
                                   np.asarray(jp[k]), atol=1e-6, rtol=0)


def test_staircase_lr_at_an_epoch_boundary_reached_by_resume():
    """The rate is a function of the update count alone: a run resumed at
    the boundary and an uninterrupted one use the same rate there."""
    schedule = optax.exponential_decay(1e-3, 844, 0.1, staircase=True)
    for step in (0, 843, 844, 845, 1688, 2000):
        assert learning_rate_at("SGD", step, 1e-3, 0.1, 844) == \
            pytest.approx(float(schedule(step)), rel=1e-6)
        assert learning_rate_at("adam", step, 1e-3, 0.1, 844) == 1e-3


def test_feature_extract_trains_the_head_only():
    model = ViT(dtype=torch.float32, device="cpu", **NARROW).init_weights(
        torch.Generator().manual_seed(0))
    mask = registry.trainable_mask(model)
    assert {n for n, lab in mask.items() if lab == "head"} == \
        {"head.weight", "head.bias"}
    engine = Engine(model, losses.cross_entropy, MEAN, STD, 28,
                    PRESETS["f32"], "cpu", feature_extract=True)
    state = engine.init_state(torch.Generator().manual_seed(0))
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    images, labels, valid = _batch(2)
    engine.train_step(state, torch.from_numpy(images),
                      torch.from_numpy(labels).long(),
                      torch.from_numpy(valid),
                      torch.Generator().manual_seed(3))
    for name, p in model.named_parameters():
        changed = not torch.equal(p, before[name])
        assert changed == (mask[name] == "head"), name


# -- a 3-step SGD trajectory ---------------------------------------------------

def test_sgd_trajectory_matches_jax():
    """Three SGD steps (momentum 0.9, staircase at 2 steps an epoch) of the
    narrow vit in f32 from identical init, batches and draws: params
    within 1e-5 of the JAX ones."""
    jengine = _jax_engine("float32")
    jstate = jengine.init_state(jax.random.PRNGKey(1))
    engine, state = _port_state(jstate, "float32", "flash")
    step = jax.jit(jengine._train_step_keys)
    for i in range(3):
        images, labels, valid = _batch(10 + i)
        key = jax.random.PRNGKey(100 + i)
        jstate, _ = step(jstate, jnp.asarray(images), jnp.asarray(labels),
                         jnp.asarray(valid), key, key)
        engine.train_step_affine(
            state, torch.from_numpy(images),
            torch.from_numpy(labels).long(), torch.from_numpy(valid),
            _jax_draws(key, 8, 28, 28))
    want = convert.params_from_jax(_np_tree(jstate.params))
    got = state.model.state_dict()
    assert state.step == int(jstate.step) == 3
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), atol=1e-5,
                                   rtol=0, err_msg=name)


# -- entry points ----------------------------------------------------------

def _train_argv(tmp, *extra):
    return ["train", "-d", str(tmp / "data"), "--rsl_path", str(tmp / "rsl"),
            "--model", "vit", "--attention", "flash", "--device", "cpu",
            "--debug", "--synthetic-fallback", *extra]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """`train --device cpu --debug -e 2 --synthetic-fallback --telemetry`
    (keeping both rolling files, for the resume tests)."""
    tmp = tmp_path_factory.mktemp("train")
    assert tcli.main(_train_argv(tmp, "-e", "2", "--keep-ckpts", "2",
                                 "--telemetry")) == 0
    return tmp


def test_train_writes_the_jax_file_names_and_log_lines(trained):
    rsl = trained / "rsl"
    names = set(os.listdir(rsl))
    assert {"checkpoint-mnist-vit-000.ckpt", "checkpoint-mnist-vit-001.ckpt",
            "bestmodel-mnist-vit.ckpt", "ckpt-lineage.json",
            "test.log"} <= names
    log = (rsl / "test.log").read_text()
    for pattern in (
            r"process: 0/1, world size: 1",
            r"batch size: 64/replica \(64 global\), prefetch: 2",
            r"====================== epoch   1 ======================",
            r"====================== epoch   2 ======================",
            r"epoch:000 nb batches:0002 mean train loss:\d+\.\d{5}",
            r"[* ] Epoch: 001  \| Duration: \d{3}m \d{2}s  \| Overall "
            r"duration: \d+\.\d{2}h",
            r"  Train       \| Loss: \d+\.\d{5}       \| Acc: \d+\.\d{2}%",
            r"  Validation  \| Loss: \d+\.\d{5}       \| Acc: \d+\.\d{2}%",
            r"  Throughput  \| [\d,]+ samples/s/chip \(1 chip\)",
            r"epoch:0001: model saved to .*checkpoint-mnist-vit-001\.ckpt",
            r"train: kernel launches flash_fwd 0, flash_dq 0, flash_dkv 0, "
            r"conv_dw 0 over 8 train steps and 8 eval batches",
            # every kernel has a tensor-core route; the CPU takes none
            r"train: tensor-core launches flash_fwd 0, flash_dq 0, "
            r"flash_dkv 0, conv_dw 0 over 8 train steps and 8 eval batches",
            r"train: ring tensor-core launches flash_fwd_pos 0, "
            r"flash_dq_pos 0, flash_dkv_pos 0 over 8 train steps"):
        assert re.search(pattern, log), pattern
    payload = ckpt.read_checkpoint(str(rsl / "checkpoint-mnist-vit-001.ckpt"))
    assert payload["format_version"] == 3 and payload["epoch"] == 1
    assert set(payload["state"]) == {"params", "opt_state", "step",
                                     "updates", "loss_scale"}
    assert payload["state"]["step"] == payload["state"]["updates"] == 8
    assert payload["state"]["loss_scale"] is None     # bf16 scales no loss


def test_train_telemetry_reads_with_the_jax_report(trained):
    """run_start, precision_policy, the epoch/train_pass/eval_pass spans
    and the throughput gauge, in the JAX package's JSONL schema."""
    import json

    from distributedpytorch_tpu import telemetry as jax_telemetry

    report = jax_telemetry.report(str(trained / "rsl"))
    for span in ("epoch", "train_pass", "eval_pass"):
        assert re.search(rf"\n  {span} +2 ", report), span
    assert "throughput:" in report and "samples/s/chip" in report
    lines = [json.loads(line) for line in
             (trained / "rsl" / "telemetry" / "rank0.jsonl").read_text()
             .splitlines()]
    events = {r["name"]: r.get("attrs", {}) for r in lines
              if r["kind"] == "event"}
    assert events["run_start"]["action"] == "train"
    assert events["precision_policy"]["compute_dtype"] == "bfloat16"
    assert events["precision_policy"]["param_dtype"] == "float32"


def test_keep_ckpts_one_rotates_the_previous_file(tmp_path):
    for epoch in range(3):
        path = ckpt.checkpoint_path(str(tmp_path), "mnist", "vit", epoch)
        ckpt.rotate_checkpoint(str(tmp_path), "mnist", "vit", epoch, keep=1)
        with open(path, "wb") as f:
            f.write(b"x")
    assert ckpt.list_checkpoints(str(tmp_path), "mnist", "vit") == [
        ckpt.checkpoint_path(str(tmp_path), "mnist", "vit", 2)]
    assert ckpt.list_checkpoints(str(tmp_path), "mnist", "vit")[0].endswith(
        "checkpoint-mnist-vit-002.ckpt")


def test_resume_from_epoch_one_equals_the_uninterrupted_run(trained,
                                                            tmp_path):
    first = "checkpoint-mnist-vit-000.ckpt"
    (tmp_path / "rsl").mkdir()
    shutil.copy(trained / "rsl" / first, tmp_path / "rsl" / first)
    data = str(trained / "data")
    argv = _train_argv(tmp_path, "-e", "2", "-f",
                       str(tmp_path / "rsl" / first))
    argv[2] = data
    assert tcli.main(argv) == 0
    log = (tmp_path / "rsl" / "test.log").read_text()
    assert "epoch:0001: model loaded from" in log
    assert "epoch   1 =" not in log and "epoch   2 =" in log
    last = "checkpoint-mnist-vit-001.ckpt"
    a = ckpt.read_checkpoint(str(trained / "rsl" / last))["state"]
    b = ckpt.read_checkpoint(str(tmp_path / "rsl" / last))["state"]
    assert a["step"] == b["step"] == 8
    for k, v in a["params"].items():
        assert torch.equal(v, b["params"][k]), k
    for pid, st in a["opt_state"]["state"].items():
        for k, v in st.items():
            assert torch.equal(v, b["opt_state"]["state"][pid][k]), (pid, k)


def test_torn_head_falls_back_loudly_to_the_earlier_snapshot(trained,
                                                             tmp_path,
                                                             caplog):
    rsl = tmp_path / "rsl"
    shutil.copytree(trained / "rsl", rsl)
    head = rsl / "checkpoint-mnist-vit-001.ckpt"
    head.write_bytes(head.read_bytes()[: head.stat().st_size // 2])
    model = ViT(dtype=torch.bfloat16, device="cpu")
    optimizer = make_optimizer("adam", model)
    with caplog.at_level("ERROR"):
        epoch, best, step = ckpt.load_checkpoint_with_fallback(
            str(head), model, optimizer, str(rsl), "mnist", "vit")
    assert (epoch, step) == (1, 4)
    assert any("CHECKPOINT REJECTED" in r.message and "falling back" in
               r.message for r in caplog.records)
    want = ckpt.read_checkpoint(str(rsl / "checkpoint-mnist-vit-000.ckpt"))
    for k, v in want["state"]["params"].items():
        assert torch.equal(model.state_dict()[k], v), k


def test_test_subcommand_on_the_port_checkpoint(trained):
    argv = ["test", "-d", str(trained / "data"), "--rsl_path",
            str(trained / "rsl_test"), "--device", "cpu", "--debug",
            "--synthetic-fallback", "-f",
            str(trained / "rsl" / "bestmodel-mnist-vit.ckpt")]
    result = tcli.run_test(tconfig.config_from_argv(argv))
    assert result["model_name"] == "vit" and 0 <= result["test_acc"] <= 1
    log = (trained / "rsl_test" / "test.log").read_text()
    assert re.search(r"Time: \d+m \d+s, Acc: \d+\.\d{2}%", log)


def test_test_on_a_jax_written_checkpoint_gives_the_jax_accuracy(tmp_path):
    """A full-width vit initialised and saved by the JAX package: the
    port's `test` in f32 counts the same correct rows as the JAX
    `run_test`."""
    from distributedpytorch_tpu import checkpoint as jax_ckpt
    from distributedpytorch_tpu import utils as jax_utils
    from distributedpytorch_tpu.cli import _build_engine, run_test
    from distributedpytorch_tpu.config import Config
    from distributedpytorch_tpu.data.datasets import load_dataset

    path = str(tmp_path / "bestmodel-synthetic-vit.ckpt")
    cfg = Config(action="test", data_path=str(tmp_path / "data"),
                 rsl_path=str(tmp_path / "jax"), dataset="synthetic",
                 model_name="vit", debug=True, half_precision=False,
                 checkpoint_file=path, flightrec=False)
    dataset = load_dataset("synthetic", cfg.data_path, cfg.seed, debug=True)
    engine = _build_engine(cfg, "vit", dataset, steps_per_epoch=1)
    state = engine.init_state(jax_utils.root_key(3))
    jax_ckpt.save_checkpoint(path, "vit", state, epoch=0,
                             best_valid_loss=1.0)
    want = run_test(cfg)["test_acc"]

    argv = ["test", "-d", str(tmp_path / "data"), "--rsl_path",
            str(tmp_path / "port"), "--dataset", "synthetic", "--debug",
            "--no-bf16", "--device", "cpu", "--attention", "flash",
            "-f", path]
    got = tcli.run_test(tconfig.config_from_argv(argv))["test_acc"]
    assert 0.0 < want < 1.0
    assert abs(got - want) < 1e-6      # the same count of 200 rows
    # train -f takes it too (its optax state converted); at -e 1 the
    # resumed run has no epoch left to train
    result = tcli.run_train(tconfig.config_from_argv(
        ["train", "-d", str(tmp_path / "data"), "--rsl_path",
         str(tmp_path / "resume"), "--dataset", "synthetic", "--debug",
         "--model", "vit", "--device", "cpu", "-e", "1", "-f", path]))
    assert result["history"] == [] and int(result["state"].step) == 0
    assert "model loaded from" in (tmp_path / "resume" / "test.log"
                                   ).read_text()


REFUSED = [
    # ported: refused only where the JAX package refuses them; f16 on the
    # ring, --ckpt-async, --epochs-per-dispatch, --data-mode stream, the
    # streaming loader's flags, --remat, the observability and
    # compile-cache flags, and the fault, health and elastic ones are
    # taken
    (["--grad-accum", "3"], "--grad-accum"),
    (["--precision", "f16", "--attention", "ring_flash", "--model-parallel",
      "2"], "--precision f16"),
    (["--precision", "bf16_full", "--no-bf16"], "--precision bf16_full"),
    (["--epochs-per-dispatch", "2"], "--epochs-per-dispatch"),
    (["--data-mode", "stream"], "--data-mode stream"),
    (["--producer-threads", "2"], "--producer-threads"),
    (["--device-prefetch", "1"], "--device-prefetch"),
    (["--ckpt-async"], "--ckpt-async"),
    (["--aot-warmup"], "--aot-warmup"),
    (["--profile"], "--profile"),
    (["--anomaly-capture"], "--anomaly-capture"),
    (["--anomaly-window", "8"], "--anomaly-window"),
    (["--compilation-cache-dir", "/x"], "--compilation-cache-dir"),
    (["--no-compile-cache"], "--no-compile-cache"),
    (["--use-pretrained"], "--use-pretrained"),
    (["--elastic"], "--elastic"),
    (["--elastic-join"], "--elastic-join"),
    (["--health-timeout", "5"], "--health-timeout"),
    (["--max-reconfigures", "1"], "--max-reconfigures"),
    (["--fault-plan", "data.read:ioerror:0"], "--fault-plan"),
    (["--metrics-port", "9100"], "--metrics-port"),
    (["--flightrec"], "--flightrec"),
    (["--ckpt-format", "orbax"], "--ckpt-format orbax"),
    (["--model-parallel", "2"], "--model-parallel"),
    (["--seq-parallel", "2"], "--seq-parallel"),
    (["--tensor-parallel"], "--tensor-parallel"),
    (["--pipeline-parallel"], "--pipeline-parallel"),
    (["--pipeline-microbatches", "2"], "--pipeline-microbatches"),
    (["--moe-experts", "4"], "--moe-experts"),
    (["--scan-layers"], "--scan-layers"),
    (["--remat", "full"], "--remat full"),
    (["--attention", "ring"], "--attention ring"),
]


# Refusals whose message is not "not ported yet: FLAG": a ring or
# --tensor-parallel without --model-parallel >= 2 fails as the JAX
# package fails it (train: run_train's check; test: the registry's), and --use-pretrained is ported
# and refused as the JAX package refuses it (train: a vit has no
# torchvision converter; test: its weights come from -f).  --grad-accum K
# that does not divide the batch and --no-bf16 against another preset
# fail with the JAX messages.  None: the flag is ported and taken (test
# takes --grad-accum, --ckpt-async and --epochs-per-dispatch and ignores
# them, as the JAX test does; f16 on the ring trains and tests; both take
# --data-mode stream, --producer-threads, --device-prefetch, --remat and
# the observability and compile-cache flags; test ignores --aot-warmup,
# --profile and --metrics-port as the JAX test does; both take
# --moe-experts, tests/test_torch_moe.py; both take --model-parallel,
# which places the state over 'model', tests/test_torch_parallel.py).
REFUSED_MESSAGES = {
    "--grad-accum": {
        "train": re.escape(
            "--grad-accum must be >= 1 and divide the per-replica batch "
            "size (64); got 3"),
        "test": None},
    "--precision f16": dict.fromkeys(("train", "test"), None),
    "--epochs-per-dispatch": dict.fromkeys(("train", "test"), None),
    "--precision bf16_full": dict.fromkeys(("train", "test"), re.escape(
        "--no-bf16 conflicts with --precision bf16_full: --no-bf16 is the "
        "legacy alias for --precision f32; drop one")),
    "--ckpt-async": dict.fromkeys(("train", "test"), None),
    "--data-mode stream": dict.fromkeys(("train", "test"), None),
    "--producer-threads": dict.fromkeys(("train", "test"), None),
    "--device-prefetch": dict.fromkeys(("train", "test"), None),
    "--remat full": dict.fromkeys(("train", "test"), None),
    **{flag: dict.fromkeys(("train", "test"), None) for flag in (
        "--aot-warmup", "--profile", "--anomaly-capture",
        "--anomaly-window", "--compilation-cache-dir", "--no-compile-cache",
        "--metrics-port", "--flightrec")},
    **{flag: dict.fromkeys(("train", "test"), None) for flag in (
        "--elastic", "--health-timeout", "--max-reconfigures",
        "--fault-plan", "--moe-experts")},
    "--elastic-join": {
        "train": re.escape(
            "--elastic-join requires --elastic: a joiner becomes a normal "
            "elastic member and must keep reconfiguring with its world"),
        "test": None},
    "--use-pretrained": {
        "train": re.escape(
            "use_pretrained is not supported for 'vit' (supported: resnet, "
            "alexnet, vgg, squeezenet, densenet, inception)"),
        "test": re.escape(
            "--use-pretrained is not applicable to the test subcommand: "
            "weights come from -f FILE")},
    # ported: the state placed over 'model' (tests/test_torch_parallel.py)
    "--model-parallel": dict.fromkeys(("train", "test"), None),
    # ported (tests/test_torch_pipeline.py), and refused as the JAX
    # package refuses them: train without a model axis, or the seq axis
    # without the ring pipeline, by run_train's checks (cli.py:731-767);
    # test's seq axis by its guard (:1347-1358), its pipeline without a
    # model axis by the registry once the checkpoint's model is built;
    # test takes --pipeline-microbatches, as the JAX test does
    "--pipeline-parallel": {
        "train": re.escape(
            "--attention ring/flash/ring_flash, --tensor-parallel and "
            "--pipeline-parallel require --model vit, are mutually "
            "exclusive (except --pipeline-parallel + --attention ring with "
            "--seq-parallel >= 2), and (except single-chip flash) need "
            "--model-parallel >= 2; got model='vit', model_parallel=1, "
            "attention='full', tensor_parallel=False, "
            "pipeline_parallel=True"),
        "test": None},
    "--seq-parallel": {
        "train": re.escape(
            "--seq-parallel >= 2 is the ring x pipeline composition's "
            "third mesh axis: it requires --pipeline-parallel with "
            "--attention ring (for plain sequence parallelism use "
            "--attention ring, which rings over the 'model' axis); got "
            "seq_parallel=2, attention='full', pipeline_parallel=False"),
        "test": re.escape(
            "--seq-parallel >= 2 is the ring x pipeline composition's "
            "third mesh axis: it requires --pipeline-parallel with "
            "--attention ring; got seq_parallel=2, attention='full', "
            "pipeline_parallel=False")},
    "--pipeline-microbatches": {
        "train": re.escape(
            "--pipeline-microbatches requires --pipeline-parallel (it sets "
            "the GPipe M)"),
        "test": None},
    # ported, and refused without a model axis as the JAX package does
    # (train: run_train's check; test: the registry's)
    "--tensor-parallel": {
        "train": re.escape(
            "--attention ring/flash/ring_flash, --tensor-parallel and "
            "--pipeline-parallel require --model vit, are mutually "
            "exclusive (except --pipeline-parallel + --attention ring with "
            "--seq-parallel >= 2), and (except single-chip flash) need "
            "--model-parallel >= 2; got model='vit', model_parallel=1, "
            "attention='full', tensor_parallel=True, "
            "pipeline_parallel=False"),
        "test": re.escape(
            "--tensor-parallel (head/hidden axes) uses the mesh's 'model' "
            "axis: pass --model-parallel >= 2 (and a mesh)")},
    "--attention ring": {
        "train": re.escape(
            "--attention ring/flash/ring_flash, --tensor-parallel and "
            "--pipeline-parallel require --model vit, are mutually "
            "exclusive (except --pipeline-parallel + --attention ring with "
            "--seq-parallel >= 2), and (except single-chip flash) need "
            "--model-parallel >= 2; got model='vit', model_parallel=1, "
            "attention='ring', tensor_parallel=False, "
            "pipeline_parallel=False"),
        "test": re.escape(
            "--attention ring (token axis) uses the mesh's 'model' axis: "
            "pass --model-parallel >= 2 (and a mesh)")},
}


@pytest.mark.parametrize("action", ["train", "test"])
@pytest.mark.parametrize("extra,flag", REFUSED, ids=[f for _, f in REFUSED])
def test_refused_flag_fails_loudly(action, extra, flag):
    argv = [action, "-d", "/nonexistent", "--device", "cpu"]
    if action == "test":
        argv += ["-f", "/nonexistent.ckpt"]
    else:
        argv += ["--model", "vit"]
    argv += extra
    message = REFUSED_MESSAGES.get(flag, {}).get(action,
                                                 f"not ported yet: {flag}")
    if message is None:
        cfg = tconfig.config_from_argv(argv)
        default = dict(grad_accum=1, ckpt_async=False, epochs_per_dispatch=1,
                       precision=None, data_mode="auto", producer_threads=1,
                       device_prefetch=0, remat="none", aot_warmup=False,
                       profile=False, anomaly_capture=False,
                       anomaly_window=32, compilation_cache_dir=None,
                       no_compile_cache=False, metrics_port=0,
                       flightrec=True, elastic=False, elastic_join=False,
                       health_timeout=0.0, max_reconfigures=3,
                       fault_plan=None, moe_experts=0, model_parallel=1,
                       pipeline_parallel=False, pipeline_microbatches=0)
        changed = {"--grad-accum": {"grad_accum": 3},
                   "--ckpt-async": {"ckpt_async": True},
                   "--epochs-per-dispatch": {"epochs_per_dispatch": 2},
                   "--precision f16": {"precision": "f16",
                                       "model_parallel": 2},
                   "--data-mode stream": {"data_mode": "stream"},
                   "--producer-threads": {"producer_threads": 2},
                   "--device-prefetch": {"device_prefetch": 1},
                   "--remat full": {"remat": "full"},
                   "--aot-warmup": {"aot_warmup": True},
                   "--profile": {"profile": True},
                   "--anomaly-capture": {"anomaly_capture": True},
                   "--anomaly-window": {"anomaly_window": 8},
                   "--compilation-cache-dir": {"compilation_cache_dir": "/x"},
                   "--no-compile-cache": {"no_compile_cache": True},
                   "--metrics-port": {"metrics_port": 9100},
                   "--flightrec": {},
                   "--elastic": {"elastic": True},
                   "--elastic-join": {"elastic_join": True},
                   "--health-timeout": {"health_timeout": 5.0},
                   "--max-reconfigures": {"max_reconfigures": 1},
                   "--fault-plan": {
                       "fault_plan": "data.read:ioerror:0"},
                   "--moe-experts": {"moe_experts": 4},
                   "--model-parallel": {"model_parallel": 2},
                   "--pipeline-parallel": {"pipeline_parallel": True},
                   "--pipeline-microbatches": {
                       "pipeline_microbatches": 2}}[flag]
        assert {k: getattr(cfg, k) for k in default} == \
            {**default, **changed}
        return
    with pytest.raises(ValueError, match=f"^{message}$"):
        tconfig.config_from_argv(argv)
    assert tcli.main(argv) == 1


def test_train_defaults_follow_the_jax_cli():
    """The JAX defaults, the model (resnet) included."""
    from distributedpytorch_tpu.config import config_from_argv as jax_argv

    want = jax_argv(["train", "-d", "/d"])
    got = tconfig.config_from_argv(["train", "-d", "/d"])
    assert got.model_name == want.model_name == "resnet"
    for field in ("batch_size", "nb_epochs", "optimizer", "loss",
                  "learning_rate", "momentum", "lr_step_gamma",
                  "focal_gamma", "seed", "keep_ckpts", "data_mode",
                  "feature_extract", "telemetry", "rsl_path", "log_file",
                  "dataset", "attention", "half_precision"):
        assert getattr(got, field) == getattr(want, field), field
    assert (got.action, got.device) == ("train", "cuda")


def test_a_multi_process_launch_is_refused(tmp_path, monkeypatch):
    """A multi-process launch without the env:// rendezvous variables is
    refused before anything runs (torchrun sets them all;
    tests/test_torch_ddp.py runs a complete one), for ``serve``'s world of
    replicas as for ``train`` (tests/test_torch_serve_world.py runs a
    complete one)."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.delenv("RANK", raising=False)
    with pytest.raises(ValueError, match="multi-process launch: RANK is "
                                         "not set"):
        tcli.run_train(tconfig.config_from_argv(_train_argv(tmp_path)))
    assert not (tmp_path / "rsl").exists()
    with pytest.raises(ValueError, match="multi-process launch: RANK is "
                                         "not set"):
        tcli.run_serve(tconfig.config_from_argv(
            ["serve", "-d", str(tmp_path), "-f", "/x.ckpt", "--device",
             "cpu", "--rsl_path", str(tmp_path / "rsl")]))
    assert not (tmp_path / "rsl").exists()


def test_train_without_device_cpu_refuses_to_run_without_gpu(tmp_path,
                                                             monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [a for a in _train_argv(tmp_path) if a not in ("--device", "cpu")]
    cfg = tconfig.config_from_argv(argv)
    assert cfg.device == "cuda"
    with pytest.raises(ValueError, match="no CUDA device is available"):
        tcli.run_train(cfg)
    assert not (tmp_path / "rsl").exists()   # nothing ran


def test_chip_smoke_and_the_ddp_child_import_no_jax():
    """The scripts that run the port outside pytest (chip_smoke.py and the
    two rank children it shares with the CPU tests) import neither JAX nor
    the JAX package (the card's machine has no JAX)."""
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import importlib.util, sys\n"
        "for name, path in (('chip_smoke', 'chip_smoke.py'),\n"
        "                   ('ddp_child', 'tests/_torch_ddp_child.py'),\n"
        "                   ('ring_child', 'tests/_torch_ring_child.py')):\n"
        "    spec = importlib.util.spec_from_file_location(name, path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'optax',\n"
        "              'distributedpytorch_tpu'))\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_new_modules_are_in_the_purity_walk():
    """test_torch_serve.py::test_port_imports_no_jax imports every module
    that pkgutil walks; the training slice's modules are among them."""
    import pkgutil

    import distributedpytorch_tpu_torch as p

    names = {m.name for m in pkgutil.walk_packages(p.__path__,
                                                   p.__name__ + ".")}
    for mod in ("data.sampler", "data.pipeline", "data.augment",
                "ops.losses", "ops.metrics", "ops.flash_attention",
                "train.engine", "checkpoint", "cli", "utils", "ops.conv",
                "ops.pooling", "models.norm", "models.layers",
                "models.simple", "models.resnet", "runtime"):
        assert f"distributedpytorch_tpu_torch.{mod}" in names, mod
