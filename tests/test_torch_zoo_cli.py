"""``--use-pretrained`` and the zoo through the port's entry points, on the
CPU.

* For each of the six architectures the JAX converter supports, a
  seeded random-weight torch model with torchvision's key names
  (tests/_torch_zoo.py, BatchNorm statistics randomised) saved with
  ``torch.save`` goes through the port's ``load_pretrained``: its eval
  logits equal the torch model's with the port's fresh head copied in
  (f32, 1e-4 of the largest logit, at the registry's 224 / 299), the
  loaded state equals what the JAX package's ``load_pretrained`` makes of
  the same file on the same fresh trees (bit for bit), and the heads keep
  their fresh initialisation.  The loader's errors are the JAX ones.
* ``train``, ``test -f`` and ``serve`` of squeezenet with ``--debug
  --device cpu``; ``train --use-pretrained --feature-extract`` leaves the
  backbone as loaded and moves the head; the refusals this slice copies
  from the JAX CLI, word for word.
"""

import json
import os
import re
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest
import torch

from distributedpytorch_tpu.models import pretrained as jax_pretrained
from distributedpytorch_tpu_torch import checkpoint as ckpt
from distributedpytorch_tpu_torch import cli as tcli
from distributedpytorch_tpu_torch import config as tconfig
from distributedpytorch_tpu_torch.data.datasets import load_dataset
from distributedpytorch_tpu_torch.models import convert, pretrained, registry
from distributedpytorch_tpu_torch.precision import PRESETS
from distributedpytorch_tpu_torch.train.engine import Predictor

from tests import _torch_zoo_jax as Z
from tests._subproc import REPO, free_port
from tests._torch_zoo import TORCH_ZOO, randomize_bn_stats

# where each torch model keeps the classifier the reference replaces
TORCH_HEAD = {"resnet": "fc", "alexnet": "classifier.6",
              "vgg": "classifier.6", "squeezenet": "classifier.1",
              "densenet": "classifier", "inception": "fc"}
PORT_HEADS = ("head.", "AuxHead_0.aux_head.")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _torch_file(name, path, seed=42):
    torch.manual_seed(seed)
    tmodel = TORCH_ZOO[name](num_classes=10)
    randomize_bn_stats(tmodel, seed=7)
    torch.save(tmodel.state_dict(), str(path))
    return tmodel.eval()


def _fresh(name):
    model = registry.get_model(name, 10, PRESETS["f32"], device="cpu")
    return model.init_weights(torch.Generator().manual_seed(3))


@pytest.mark.parametrize("name", sorted(TORCH_ZOO))
def test_load_pretrained_gives_the_torch_logits_and_the_jax_trees(
        name, tmp_path):
    path = tmp_path / f"{name}.pth"
    tmodel = _torch_file(name, path)
    model = _fresh(name)
    fresh = {k: v.clone() for k, v in model.state_dict().items()}
    params, stats = convert.cnn_params_to_jax(fresh)
    want = convert.cnn_params_from_jax(*jax_pretrained.load_pretrained(
        name, str(path), params, stats))
    pretrained.load_pretrained(name, str(path), model)
    path.unlink()       # vgg's file is 0.5 GB
    got = model.state_dict()
    assert set(got) == set(want)
    for k, v in got.items():
        assert torch.equal(v, want[k]), k
        if k.startswith(PORT_HEADS):
            assert torch.equal(v, fresh[k]), k     # the head stays fresh
    assert not torch.equal(got["Conv_0.weight" if name != "inception" else
                               "BasicConv_0.Conv_0.weight"],
                           fresh["Conv_0.weight" if name != "inception" else
                                 "BasicConv_0.Conv_0.weight"])

    head = tmodel.get_submodule(TORCH_HEAD[name])
    with torch.no_grad():
        head.weight.copy_(got["head.weight"].reshape(head.weight.shape))
        head.bias.copy_(got["head.bias"])
        size = registry.get_model_input_size(name)
        x = np.random.default_rng(3).standard_normal(
            (2, size, size, 3)).astype(np.float32)
        ref = tmodel(torch.from_numpy(x).permute(0, 3, 1, 2))
        model.eval()
        out = model(torch.from_numpy(x))
    assert Z.rel(out, ref) <= 1e-4


def test_load_pretrained_accepts_a_wrapped_and_prefixed_state_dict(
        tmp_path):
    tmodel = _torch_file("squeezenet", tmp_path / "plain.pth")
    sd = {f"module.{k}": v for k, v in tmodel.state_dict().items()}
    torch.save({"state_dict": sd, "epoch": 3}, str(tmp_path / "w.pth"))
    a, b = _fresh("squeezenet"), _fresh("squeezenet")
    pretrained.load_pretrained("squeezenet", str(tmp_path / "plain.pth"), a)
    pretrained.load_pretrained("squeezenet", str(tmp_path / "w.pth"), b)
    for k, v in a.state_dict().items():
        assert torch.equal(v, b.state_dict()[k]), k


def _jax_error(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


@pytest.mark.parametrize("case", ["unsupported", "no-path", "shape",
                                  "missing-key", "not-a-dict", "unreadable"])
def test_load_pretrained_errors_are_the_jax_ones(case, tmp_path):
    name, path = "resnet", tmp_path / "w.pth"
    tmodel = _torch_file(name, path)
    if case == "unsupported":
        name = "cnn"
    elif case == "no-path":
        path = None
    elif case == "shape":
        sd = tmodel.state_dict()
        sd["conv1.weight"] = sd["conv1.weight"][:, :1]
        torch.save(sd, str(path))
    elif case == "missing-key":
        sd = tmodel.state_dict()
        del sd["layer2.0.bn1.running_mean"]
        torch.save(sd, str(path))
    elif case == "not-a-dict":
        torch.save(torch.zeros(3), str(path))
    else:
        path.write_bytes(b"not a torch file")
    model = _fresh(name)
    params, stats = convert.cnn_params_to_jax(model.state_dict())
    want = _jax_error(lambda: jax_pretrained.load_pretrained(
        name, path and str(path), params, stats))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    got = _jax_error(lambda: pretrained.load_pretrained(
        name, path and str(path), model))
    assert got == want
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k


# -- the entry points --------------------------------------------------------

def _argv(action, tmp, *extra):
    argv = [action, "-d", str(tmp / "data"), "--rsl_path",
            str(tmp / f"rsl-{action}"), "--device", "cpu", "--debug",
            "--synthetic-fallback", *extra]
    return argv + (["-b", "32"] if action != "serve" else [])


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """``train --model squeezenet --debug -e 1`` and its best file."""
    tmp = tmp_path_factory.mktemp("squeezenet")
    argv = _argv("train", tmp, "--model", "squeezenet", "-e", "1")
    result = tcli.run_train(tconfig.config_from_argv(argv))
    return tmp, result, tmp / "rsl-train" / "bestmodel-mnist-squeezenet.ckpt"


def test_train_and_test_a_zoo_model_on_the_cpu(trained):
    tmp, result, best = trained
    log = (tmp / "rsl-train" / "test.log").read_text()
    assert re.search(r"train: kernel launches flash_fwd 0, flash_dq 0, "
                     r"flash_dkv 0, conv_dw 0 over 7 train steps and 7 "
                     r"eval batches", log)
    assert np.isfinite(result["history"][0]["train_loss"])
    assert ckpt.get_checkpoint_model_name(str(best)) == "squeezenet"
    got = tcli.run_test(tconfig.config_from_argv(
        _argv("test", tmp, "-f", str(best))))
    assert got["model_name"] == "squeezenet" and 0 <= got["test_acc"] <= 1
    assert "Acc: " in (tmp / "rsl-test" / "test.log").read_text()


def _post(port, image):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/predict",
                                 data=json.dumps({"image": image}).encode())
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def test_serve_answers_from_a_zoo_checkpoint(trained):
    """``serve`` of the squeezenet file: three answers over HTTP, each the
    in-process predict step's at bucket 1."""
    tmp, _, best = trained
    port = free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "distributedpytorch_tpu_torch",
         *_argv("serve", tmp, "-f", str(best), "--serve-port", str(port),
                "--serve-buckets", "1", "--serve-max-requests", "3")],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env={**os.environ, "OMP_NUM_THREADS": "2"})
    ds = load_dataset("mnist", str(tmp / "data"), 1234, debug=True,
                      synthetic_fallback=True)
    images = ds.splits["test"].images[:3]
    try:
        answers, deadline = [], time.monotonic() + 120
        for img in images:
            while True:
                try:
                    answers.append(_post(port, img.tolist()))
                    break
                except OSError:
                    if proc.poll() is not None \
                            or time.monotonic() > deadline:
                        raise
                    time.sleep(0.2)
        out, _ = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, out
    assert "stopped after answering 3 requests" in out
    model = registry.get_model("squeezenet", ds.nb_classes, PRESETS["bf16"],
                               device="cpu")
    ckpt.restore_for_serving(str(best), model)
    pred = Predictor(model, ds.mean, ds.std, 224, PRESETS["bf16"], "cpu")
    for img, answer in zip(images, answers):
        label, conf = pred.predict_step(img[None])
        assert answer["label"] == int(label[0]) and answer["bucket"] == 1
        assert abs(answer["confidence"] - float(conf[0])) <= 1e-4


def test_train_use_pretrained_feature_extract_moves_only_the_head(tmp_path):
    path = tmp_path / "squeezenet.pth"
    _torch_file("squeezenet", path)
    argv = _argv("train", tmp_path, "--model", "squeezenet", "-e", "1",
                 "--use-pretrained", "--pretrained-path", str(path),
                 "--feature-extract")
    result = tcli.run_train(tconfig.config_from_argv(argv))
    log = (tmp_path / "rsl-train" / "test.log").read_text()
    assert f"pretrained backbone loaded from {path}" in log
    loaded = _fresh("squeezenet")
    pretrained.load_pretrained("squeezenet", str(path), loaded)
    after = result["state"].model.state_dict()
    for k, v in loaded.state_dict().items():
        if k.startswith("head."):
            assert not torch.equal(after[k], v), k
        else:
            assert torch.equal(after[k], v), k


def test_remat_and_scan_layers_stay_refused_for_the_zoo(tmp_path):
    """--remat and --scan-layers are ported and taken (their steps:
    tests/test_torch_remat.py, tests/test_torch_scan.py); --scan-layers
    stays refused on a zoo model with no homogeneous block run, with the
    JAX registry's message where the model is built, after the data is
    read."""
    from distributedpytorch_tpu.models import registry as jax_registry

    argv = _argv("train", tmp_path, "--model", "densenet", "--remat",
                 "blocks")
    assert tconfig.config_from_argv(argv).remat == "blocks"
    argv = _argv("train", tmp_path, "--model", "densenet", "--scan-layers")
    assert tconfig.config_from_argv(argv).scan_layers
    with pytest.raises(ValueError) as want:
        jax_registry.get_model("resnet", 10, scan_layers=True)
    argv = _argv("train", tmp_path, "--model", "resnet", "--scan-layers")
    with pytest.raises(ValueError, match=f"^{re.escape(str(want.value))}$"):
        tcli.run_train(tconfig.config_from_argv(argv))
    assert "Number of training examples" in (
        tmp_path / "rsl-train" / "test.log").read_text()


@pytest.mark.parametrize("case", ["test", "serve", "resume", "no-path",
                                  "unsupported"])
def test_use_pretrained_refusals_are_the_jax_ones(case, tmp_path):
    """``--use-pretrained`` on ``test`` and ``serve`` (JAX cli.py:1340-1344,
    :1495-1497), with ``-f`` on ``train`` (:692-699), without a path and on
    an architecture with no converter (``validate_request``): refused
    before anything runs, with the JAX message, and ``main`` exits 1."""
    from distributedpytorch_tpu import cli as jax_cli
    from distributedpytorch_tpu.config import config_from_argv as jax_argv

    extra = ["--use-pretrained", "--pretrained-path", str(tmp_path / "w")]
    if case in ("test", "serve"):
        argv = _argv(case, tmp_path, "-f", str(tmp_path / "c.ckpt"), *extra)
        run = {"test": jax_cli.run_test, "serve": jax_cli.run_serve}[case]
        want = _jax_error(lambda: run(jax_argv(
            [a for a in argv if a not in ("--device", "cpu")])))
    elif case == "resume":
        argv = _argv("train", tmp_path, "--model", "vgg", "-f",
                     str(tmp_path / "c.ckpt"), *extra)
        want = ("--use-pretrained cannot be combined with -f/--file resume: "
                "all weights come from the checkpoint")
    else:
        model = "vgg" if case == "no-path" else "cnn"
        argv = _argv("train", tmp_path, "--model", model, "--use-pretrained")
        want = _jax_error(lambda: jax_pretrained.validate_request(model,
                                                                  None))
    with pytest.raises(ValueError) as got:
        tconfig.config_from_argv(argv)
    assert str(got.value) == want
    assert tcli.main(argv) == 1
    assert not (tmp_path / f"rsl-{argv[0]}").exists()
