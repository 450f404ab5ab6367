"""``--epochs-per-dispatch K`` in the port: the sync-free step, the
chunked driver and its refusals.

  * The step reads nothing back from the device: a skipped f16 update is
    a ``torch.where`` over the state before and after the optimizer's
    step, the counters and the loss scale are device tensors, SGD's
    learning rate is computed on the device.  Three steps of a BatchNorm
    resnet (bf16 with Adam; f32 with SGD across the staircase's epoch
    boundary; f16 with Adam and the second step's loss forced to
    overflow) are held bit for bit against the same steps with the
    host-side tail this replaced (the skip decision read to the host and
    the update not run, the learning rate a Python float).
  * ``train --epochs-per-dispatch 2 -e 4 --device cpu`` against the JAX
    package's ``run_train`` with the same flag: the per-epoch log lines,
    the rolling checkpoint once a chunk, and the best file written with
    the chunk's final state whenever an epoch of the chunk improved; and
    against the port's own ``-e 4`` one epoch at a time: the same log
    lines and the same final rolling checkpoint, byte for byte (the CPU
    runs the same step eagerly with the chunk's cadence).
  * The refusals: K < 1 with the JAX message, and K > 1 on ``cuda`` in a
    world whose launch takes gloo, before any work on the device.
"""

import os
import re

import numpy as np
import pytest
import torch

from distributedpytorch_tpu_torch import checkpoint as ckpt
from distributedpytorch_tpu_torch import cli as tcli
from distributedpytorch_tpu_torch import config as tconfig
from distributedpytorch_tpu_torch.models.resnet import ResNet
from distributedpytorch_tpu_torch.ops import losses
from distributedpytorch_tpu_torch.precision import PRESETS, all_finite, \
    cast_grads
from distributedpytorch_tpu_torch.train.engine import (Engine,
                                                       init_optimizer_state)

MEAN, STD = 0.45, 0.2


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


class HostTailEngine(Engine):
    """The update tail with host reads: the skip decision as a Python
    bool (a skipped step runs no optimizer step at all) and the learning
    rate of the host's update count."""

    def apply_gradients(self, state, scale=None):
        params = list(state.model.parameters())
        init_optimizer_state(state.optimizer)
        with torch.no_grad():
            if scale is not None:
                for p in params:
                    if p.grad is not None:
                        p.grad.div_(scale)
            cast_grads(params)
            finite = True
            if state.loss_scale is not None:
                finite = bool(all_finite(p.grad for p in params))
                state.loss_scale.assign(state.loss_scale.adjust(
                    finite, self.precision.loss_scale_growth))
            if finite:
                if self.optimizer_name == "SGD":
                    self._sgd_update(state.optimizer, torch.tensor(
                        self.lr(int(state.updates)), dtype=torch.float64))
                else:
                    state.optimizer.step()
                state.updates.add_(1)
            state.step.add_(1)
        return torch.tensor(finite)


def _batch(i):
    rng = np.random.default_rng(60 + i)
    images = torch.from_numpy(rng.integers(0, 256, (8, 28, 28),
                                           dtype=np.uint8))
    labels = torch.from_numpy(rng.integers(0, 10, 8)).long()
    valid = torch.ones(8, dtype=torch.bool)
    valid[-2:] = False
    return images, labels, valid


def _blowup(loss_fn):
    def loss(logits, labels):
        numer, denom = loss_fn(logits, labels)
        return numer * float("inf"), denom
    return loss


def _three_steps(cls, precision, optimizer, overflow_step):
    model = ResNet((1, 1), width=8,
                   dtype=PRESETS[precision].compute_dtype)
    engine = cls(model, losses.cross_entropy, MEAN, STD, 32,
                 PRESETS[precision], "cpu", optimizer=optimizer,
                 steps_per_epoch=2)
    state = engine.init_state(torch.Generator().manual_seed(5))
    finite = []
    for i in range(3):
        engine.loss_fn = (_blowup(losses.cross_entropy) if i == overflow_step
                          else losses.cross_entropy)
        engine.train_step(state, *_batch(i),
                          torch.Generator().manual_seed(70 + i))
        finite.append(bool(all_finite(p.grad for p in model.parameters())))
    return state, finite


@pytest.mark.parametrize("precision,optimizer,overflow_step", [
    ("bf16", "adam", None), ("f32", "SGD", None), ("f16", "adam", 1)],
    ids=["bf16-adam", "f32-SGD", "f16-adam-skip"])
def test_sync_free_step_equals_the_host_tail(precision, optimizer,
                                             overflow_step):
    got, finite = _three_steps(Engine, precision, optimizer, overflow_step)
    want, _ = _three_steps(HostTailEngine, precision, optimizer,
                           overflow_step)
    assert finite == [i != overflow_step for i in range(3)]
    for (k, v), w in zip(got.model.state_dict().items(),
                         want.model.state_dict().values()):
        assert torch.equal(v, w), k
    got_opt = got.optimizer.state_dict()["state"]
    want_opt = want.optimizer.state_dict()["state"]
    assert got_opt.keys() == want_opt.keys()
    for i, st in got_opt.items():
        for name, t in st.items():
            assert torch.equal(t, want_opt[i][name]), (i, name)
    skipped = int(overflow_step is not None)
    assert (int(got.step), int(got.updates)) == \
        (int(want.step), int(want.updates)) == (3, 3 - skipped)
    if precision == "f16":
        assert got.loss_scale.to_dict() == want.loss_scale.to_dict() == \
            {"scale": 2.0 ** 14, "good_steps": 1}


# -- the chunked driver -------------------------------------------------------

EPOCH_LINE = re.compile(r"([* ]) Epoch: (\d{3})")


def _port_train(tmp_path, name, k, model="mlp", *extra):
    rsl = tmp_path / name
    argv = ["train", "-d", str(tmp_path / "data"), "--rsl_path", str(rsl),
            "--dataset", "synthetic", "--model", model, "--debug", "-b", "8",
            "-e", "4", "--device", "cpu", "--epochs-per-dispatch", str(k),
            *extra]
    return tcli.run_train(tconfig.config_from_argv(argv)), rsl


def _jax_train(tmp_path):
    from distributedpytorch_tpu.cli import run_train
    from distributedpytorch_tpu.config import Config

    rsl = tmp_path / "jax"
    result = run_train(Config(
        action="train", data_path=str(tmp_path / "data"),
        rsl_path=str(rsl), dataset="synthetic", model_name="mlp",
        batch_size=8, nb_epochs=4, debug=True, epochs_per_dispatch=2))
    return result, rsl


def _cadence(result, rsl):
    """What the chunked driver decides: the epochs logged in order, the
    files left, the rolling file's epoch, and the best file's epoch (the
    last epoch of the last chunk that improved the best loss)."""
    log = (rsl / "test.log").read_text()
    epochs = [int(m.group(2)) for m in EPOCH_LINE.finditer(log)]
    files = sorted(f for f in os.listdir(rsl) if f.endswith(".ckpt"))
    best, improved_chunk = float("inf"), None
    for h in result["history"]:
        if h["valid_loss"] < best:
            best, improved_chunk = h["valid_loss"], h["epoch"] // 2
    best_file = [f for f in files if f.startswith("bestmodel")][0]
    return {"epochs": epochs, "files": [re.sub(r"-(mlp)", "", f)
                                        for f in files],
            "rolling_epoch": ckpt.read_checkpoint(
                str(rsl / files[-1]))["epoch"],
            "best_epoch": ckpt.read_checkpoint(str(rsl / best_file))["epoch"],
            "best_rule": 2 * improved_chunk + 1,
            "line_kinds": [re.sub(r"[\d.,%]+", "N", line.split(" - ")[-1])
                           for line in log.splitlines()
                           if "| Loss:" in line or "Epoch:" in line]}


def test_chunked_train_follows_the_jax_cadence(tmp_path):
    port = _cadence(*_port_train(tmp_path, "port", 2))
    jax = _cadence(*_jax_train(tmp_path))
    assert port["epochs"] == jax["epochs"] == [1, 2, 3, 4]
    assert port["files"] == jax["files"] == [
        "bestmodel-synthetic.ckpt", "checkpoint-synthetic-003.ckpt"]
    assert port["rolling_epoch"] == jax["rolling_epoch"] == 3
    assert port["best_epoch"] == port["best_rule"]
    assert jax["best_epoch"] == jax["best_rule"]
    assert len(port["line_kinds"]) == len(jax["line_kinds"]) == 12
    for got, want in zip(port["line_kinds"], jax["line_kinds"]):
        assert got.strip("* ") == want.strip("* ")


@pytest.mark.parametrize("model,extra", [
    ("cnn", ()), ("mlp", ("--precision", "f16", "--optimizer", "SGD"))],
    ids=["cnn-bf16-adam", "mlp-f16-SGD"])
def test_chunked_train_equals_epoch_at_a_time(tmp_path, model, extra):
    one, rsl1 = _port_train(tmp_path, "k1", 1, model, *extra)
    two, rsl2 = _port_train(tmp_path, "k2", 2, model, *extra)
    keep = re.compile(r"\| (Loss|Acc)|mean train loss|loss scale")

    def lines(rsl):
        return [line.split(" - ")[-1] for line in
                (rsl / "test.log").read_text().splitlines()
                if keep.search(line)]

    assert lines(rsl1) == lines(rsl2) and len(lines(rsl1)) >= 8
    name = f"checkpoint-synthetic-{model}-003.ckpt"
    assert (rsl1 / name).read_bytes() == (rsl2 / name).read_bytes()
    assert [h["valid_loss"] for h in one["history"]] == \
        [h["valid_loss"] for h in two["history"]]


# -- refusals -----------------------------------------------------------------

@pytest.mark.parametrize("k", [0, -1])
def test_fewer_than_one_epoch_a_dispatch_fails_as_in_jax(k, tmp_path):
    argv = ["train", "-d", str(tmp_path), "--device", "cpu",
            "--epochs-per-dispatch", str(k)]
    with pytest.raises(ValueError, match=re.escape(
            f"--epochs-per-dispatch must be >= 1, got {k}")):
        tconfig.config_from_argv(argv)
    assert tcli.main(argv) == 1


def test_chunks_over_gloo_on_the_card_are_refused_first(monkeypatch,
                                                        tmp_path):
    """Two ranks sharing a card run gloo, whose collectives a CUDA Graph
    cannot capture: refused at parse time, before the device is asked
    for (this machine has none, and the message is not the missing
    card's); one epoch a dispatch and the CPU are taken."""
    for name, value in (("WORLD_SIZE", "2"), ("RANK", "0"),
                        ("LOCAL_RANK", "0"), ("LOCAL_WORLD_SIZE", "2"),
                        ("MASTER_ADDR", "127.0.0.1"),
                        ("MASTER_PORT", "29999")):
        monkeypatch.setenv(name, value)
    argv = ["train", "-d", str(tmp_path), "--epochs-per-dispatch", "2"]
    with pytest.raises(ValueError, match=re.escape(
            "not ported yet: --epochs-per-dispatch 2 over gloo")):
        tconfig.config_from_argv(argv)
    assert tcli.main(argv) == 1
    assert tconfig.config_from_argv(argv[:3]).epochs_per_dispatch == 1
    cfg = tconfig.config_from_argv(argv + ["--device", "cpu"])
    assert cfg.epochs_per_dispatch == 2
