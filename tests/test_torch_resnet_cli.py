"""The default model, resnet18 at 224, through the port's entry points on
the CPU: ``train`` with no ``--model`` trains it (2 epochs of the debug
subset), ``test -f`` on its best model equals an in-process eval of the
same file, and a run resumed from its epoch-1 rolling file is
bit-identical to the uninterrupted one (parameters, BatchNorm statistics
and optimizer state).  No JAX: the parity of the resnet against the flax
model is in ``tests/test_torch_cnn.py`` and ``test_torch_cnn_train.py``.
"""

import re
import shutil

import pytest
import torch

from distributedpytorch_tpu_torch import checkpoint as ckpt
from distributedpytorch_tpu_torch import cli as tcli
from distributedpytorch_tpu_torch import config as tconfig
from distributedpytorch_tpu_torch.data.datasets import load_dataset
from distributedpytorch_tpu_torch.data.pipeline import ResidentLoader
from distributedpytorch_tpu_torch.models import get_model
from distributedpytorch_tpu_torch.ops import losses
from distributedpytorch_tpu_torch.precision import PRESETS
from distributedpytorch_tpu_torch.train.engine import Engine, TrainState


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _train_argv(tmp, *extra):
    return ["train", "-d", str(tmp / "data"), "--rsl_path", str(tmp / "rsl"),
            "--device", "cpu", "--debug", "--synthetic-fallback", "-b", "16",
            *extra]


@pytest.fixture(scope="module")
def trained_resnet(tmp_path_factory):
    """``train`` with no ``--model``: the default resnet, 2 epochs, both
    rolling files kept."""
    tmp = tmp_path_factory.mktemp("resnet")
    assert tcli.main(_train_argv(tmp, "-e", "2", "--keep-ckpts", "2")) == 0
    return tmp


def test_default_train_is_resnet_and_test_reads_it(trained_resnet):
    rsl = trained_resnet / "rsl"
    log = (rsl / "test.log").read_text()
    assert re.search(r"process: 0/1, world size: 1\n", log)
    assert re.search(r"train: kernel launches flash_fwd 0, flash_dq 0, "
                     r"flash_dkv 0, conv_dw 0 over 26 train steps and 26 "
                     r"eval batches", log)
    best = str(rsl / "bestmodel-mnist-resnet.ckpt")
    payload = ckpt.read_checkpoint(best)
    assert payload["model_name"] == "resnet"
    assert "BasicBlock_7.BatchNorm_1.running_var" in payload["state"][
        "params"]
    argv = ["test", "-d", str(trained_resnet / "data"), "--rsl_path",
            str(trained_resnet / "rsl_test"), "--device", "cpu", "--debug",
            "--synthetic-fallback", "-b", "16", "-f", best]
    result = tcli.run_test(tconfig.config_from_argv(argv))
    assert result["model_name"] == "resnet"
    # an in-process eval of the same file counts the same rows
    ds = load_dataset("mnist", str(trained_resnet / "data"), 1234,
                      debug=True, synthetic_fallback=True)
    model = get_model("resnet", 10, PRESETS["bf16"], device="cpu")
    ckpt.restore_for_serving(best, model)
    engine = Engine(model, losses.cross_entropy, ds.mean, ds.std, 224,
                    PRESETS["bf16"], "cpu")
    correct = n = 0.0
    for images, labels, valid in ResidentLoader(
            ds.splits["test"], 16, False, 1234, "cpu").epoch(0):
        m = engine.eval_step(TrainState(model, None), images, labels, valid)
        correct += m["correct"].item()
        n += m["valid"].item()
    assert result["test_acc"] == correct / n


def test_resnet_resume_is_bit_identical(trained_resnet, tmp_path):
    first = "checkpoint-mnist-resnet-000.ckpt"
    (tmp_path / "rsl").mkdir()
    shutil.copy(trained_resnet / "rsl" / first, tmp_path / "rsl" / first)
    argv = _train_argv(tmp_path, "-e", "2", "-f",
                       str(tmp_path / "rsl" / first))
    argv[2] = str(trained_resnet / "data")
    assert tcli.main(argv) == 0
    last = "checkpoint-mnist-resnet-001.ckpt"
    a = ckpt.read_checkpoint(str(trained_resnet / "rsl" / last))["state"]
    b = ckpt.read_checkpoint(str(tmp_path / "rsl" / last))["state"]
    assert a["step"] == b["step"] == 26
    assert any(k.endswith("running_mean") for k in a["params"])
    for k, v in a["params"].items():
        assert torch.equal(v, b["params"][k]), k
    for pid, st in a["opt_state"]["state"].items():
        for k, v in st.items():
            assert torch.equal(v, b["opt_state"]["state"][pid][k]), (pid, k)


@pytest.mark.parametrize("model,attention", [("cnn", "flash"),
                                             ("resnet", "ring"),
                                             ("mlp", "ring_flash")])
def test_attention_on_a_model_without_attention_is_the_jax_error(
        model, attention):
    """The JAX registry's message (``registry.py:200-206``), at parse
    time, and the CLI exits 1."""
    argv = ["train", "-d", "/nonexistent", "--model", model, "--attention",
            attention, "--device", "cpu"]
    with pytest.raises(ValueError, match=(
            f"^--attention {attention} applies to the attention model "
            f"family only \\(--model vit\\); '{model}' has no attention$")):
        tconfig.config_from_argv(argv)
    assert tcli.main(argv) == 1
