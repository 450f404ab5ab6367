"""``--scan-layers`` in the port against the port's own unrolled models:
the stacked runs must compute what the unrolled blocks compute, from
the same weights, launch for launch.

  * A scanned model and an unrolled one from the same generator hold the
    same weights (the vit, densenet121 and inception_v3).
  * Three SGD and three Adam steps (the engine's train step, its affine
    and dropout draws from one generator) of the scanned model equal the
    unrolled model's after converting the scanned state to the plain
    layout: bit for bit in f32 for the vit (flash attention, the
    kernels' plain versions here, and under ``--remat blocks``), vgg11_bn
    and inception_v3; densenet121 in f64 compute to 1e-6 of each
    tensor's largest value (its 1x1 convs sum the zero padding in
    another order; ROADMAP queue 3 entry 8).
  * Through the CLI: ``train --scan-layers`` writes the scan layout, which
    ``test -f`` without the flag converts and scores alike, and a plain
    file tests under ``--scan-layers``; a ``train -f`` resumes across the
    flag.
  * Two gloo ranks, one ring at M = 2 (``ring_flash``: K4/K2p/K3p's plain
    versions): three steps of the scanned narrow vit equal the unrolled
    one's, with the same kernel launches.
"""

import numpy as np
import pytest
import torch

from distributedpytorch_tpu_torch import checkpoint as ckpt
from distributedpytorch_tpu_torch import cli as tcli
from distributedpytorch_tpu_torch import config as tconfig
from distributedpytorch_tpu_torch.data import augment
from distributedpytorch_tpu_torch.models import registry, scan
from distributedpytorch_tpu_torch.ops import losses
from distributedpytorch_tpu_torch.precision import PRESETS, PrecisionPolicy
from distributedpytorch_tpu_torch.train.engine import Engine
from tests.test_torch_ring import NARROW, _run_world, _steps

F64 = PrecisionPolicy(name="f64", param_dtype=torch.float32,
                      compute_dtype=torch.float64,
                      accum_dtype=torch.float64)
TOL_F64 = 1e-6
MEAN, STD = 0.13, 0.31
# name -> (registry name, attention, input size, policy, remat); f32
# cases must be bit for bit
CASES = {
    "vit": ("vit", "flash", 28, PRESETS["f32"], "none"),
    "vit_remat": ("vit", "flash", 28, PRESETS["f32"], "blocks"),
    "vgg": ("vgg", "full", 32, PRESETS["f32"], "none"),
    "inception": ("inception", "full", 299, PRESETS["f32"], "none"),
    "densenet": ("densenet", "full", 64, F64, "none"),
}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _rel(got, want) -> float:
    got, want = got.double(), want.double()
    return (got - want).abs().max().item() / max(want.abs().max().item(),
                                                 1e-30)


def _model(case: str, scan_layers: bool):
    name, attention, _, policy, remat = CASES[case]
    return registry.get_model(name, 10, policy, attention=attention,
                              device="cpu", remat=remat,
                              scan_layers=scan_layers)


@pytest.mark.parametrize("case", ["vit", "densenet", "inception"])
def test_scanned_init_is_the_unrolled_draws_stacked(case):
    plain = _model(case, False).init_weights(
        torch.Generator().manual_seed(0))
    scanned = _model(case, True).init_weights(
        torch.Generator().manual_seed(0))
    want = plain.state_dict()
    layout = scan.params_layout(want)
    got = scan.convert_layout(scanned.state_dict(), layout)
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def _batch(b: int, seed: int):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.integers(0, 256, (b, 28, 28),
                                          dtype=np.uint8)),
            torch.from_numpy(rng.integers(0, 10, b)),
            torch.ones(b, dtype=torch.bool))


@pytest.fixture(scope="module")
def vgg_weights() -> dict:
    """Random plain-layout weights of vgg11_bn, drawn once: its
    130M-parameter lecun draw takes seconds a model, and the draws'
    equality is the init test's, on the three cheaper models."""
    model = _model("vgg", False)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for name, p in model.named_parameters():
            scale = (p[0].numel() ** -0.5 if p.dim() > 1 else 0.0)
            p.normal_(0.0, scale or 1.0, generator=gen)
            if "BatchNorm" in name and name.endswith("weight"):
                p.abs_().add_(0.5)
            elif p.dim() == 1:
                p.mul_(0.1)
    return {k: v.clone() for k, v in model.state_dict().items()}


def _train(case: str, scan_layers: bool, optimizer: str,
           initial: dict = None) -> tuple:
    """Three steps of ``case`` from seed 0's weights (or ``initial``, a
    plain-layout state dict, converted for the scanned model): (the state
    dict in the plain layout, the steps' losses)."""
    name, _, size, policy, remat = CASES[case]
    model = _model(case, scan_layers)
    engine = Engine(model, losses.cross_entropy, MEAN, STD, size, policy,
                    "cpu", optimizer=optimizer, steps_per_epoch=2,
                    remat=remat)
    if initial is not None:
        def init_weights(generator):
            model.load_state_dict(scan.convert_layout(
                initial, scan.params_layout(model.state_dict())))
            return model

        model.init_weights = init_weights
    state = engine.init_state(torch.Generator().manual_seed(0))
    found = []
    for i in range(3):
        _, m = engine.train_step(state, *_batch(2, 30 + i),
                                 torch.Generator().manual_seed(40 + i))
        found.append(m["loss"].item())
    sd = model.state_dict()
    layout = scan.params_layout(sd)
    plain = scan.convert_layout(sd, scan.scan_layout_for(layout)) \
        if scan_layers else sd
    return {k: v.clone() for k, v in plain.items()}, found


@pytest.mark.parametrize("optimizer", ["SGD", "adam"])
@pytest.mark.parametrize("case", list(CASES))
def test_scanned_steps_equal_the_unrolled_steps(case, optimizer, request):
    initial = request.getfixturevalue("vgg_weights") if case == "vgg" \
        else None
    want, want_losses = _train(case, False, optimizer, initial)
    got, got_losses = _train(case, True, optimizer, initial)
    assert set(got) == set(want)
    if CASES[case][3] is F64:
        assert np.allclose(got_losses, want_losses, rtol=TOL_F64, atol=0)
        for k, v in want.items():
            assert _rel(got[k], v) <= TOL_F64, k
        return
    assert got_losses == want_losses
    for k, v in want.items():
        assert torch.equal(got[k], v), k


# -- through the CLI ----------------------------------------------------------

def _argv(action, tmp, rsl, *extra):
    return [action, "-d", str(tmp / "data"), "--rsl_path", str(tmp / rsl),
            "--device", "cpu", "--debug", "--synthetic-fallback",
            "--precision", "f32", *extra]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """``train --model vit --attention flash -e 1`` with and without
    --scan-layers, and their best files."""
    tmp = tmp_path_factory.mktemp("scancli")
    out = {}
    for flag in ([], ["--scan-layers"]):
        rsl = f"train{len(flag)}"
        tcli.run_train(tconfig.config_from_argv(_argv(
            "train", tmp, rsl, "--model", "vit", "--attention", "flash",
            "-b", "32", "-e", "1", *flag)))
        out[bool(flag)] = str(tmp / rsl / "bestmodel-mnist-vit.ckpt")
    return tmp, out


@pytest.mark.parametrize("written", [True, False],
                         ids=["scan_file", "plain_file"])
def test_a_file_tests_alike_across_the_flag(trained, written):
    tmp, files = trained
    path = files[written]
    params = ckpt.read_checkpoint(path)["state"]["params"]
    assert scan.params_layout(params) == ("scan" if written else "blocks")
    results = []
    for flag in ([], ["--scan-layers"]):
        rsl = f"test-{written}-{len(flag)}"
        results.append(tcli.run_test(tconfig.config_from_argv(_argv(
            "test", tmp, rsl, "-f", path, *flag))))
        log = (tmp / rsl / "test.log").read_text()
        converted = bool(flag) != written
        assert ("checkpoint params converted: "
                f"{'scan -> blocks' if written else 'blocks -> scan'}"
                " block layout" in log) == converted
    assert results[0]["test_loss"] == pytest.approx(results[1]["test_loss"],
                                                    rel=1e-6)
    assert results[0]["test_acc"] == results[1]["test_acc"]


def test_train_resumes_across_the_flag(trained):
    """A rolling file of the scanned run resumes a plain one (moments
    converted) and goes on to the next epoch."""
    tmp, _ = trained
    path = str(tmp / "train1" / "checkpoint-mnist-vit-000.ckpt")
    result = tcli.run_train(tconfig.config_from_argv(_argv(
        "train", tmp, "resume", "--model", "vit", "--attention", "flash",
        "-b", "32", "-e", "2", "-f", path)))
    assert [h["epoch"] for h in result["history"]] == [1]
    log = (tmp / "resume" / "test.log").read_text()
    assert "checkpoint params converted: scan -> blocks block layout" in log
    opt = result["state"].optimizer.state_dict()["state"]
    assert opt and all(bool(t.abs().sum() > 0) for st in opt.values()
                       for t in st.values() if t.dim())


# -- the ring at M = 2 --------------------------------------------------------

def test_scanned_ring_flash_steps_equal_the_unrolled_ring(tmp_path):
    steps = []
    for i, (images, labels, valid, _key) in enumerate(_steps()):
        draws = [t.numpy() for t in augment.sample_affine_batch(
            torch.Generator().manual_seed(i), 8, 28, 28)]
        steps.append((images, labels, valid, draws))
    specs = [dict(arch=dict(NARROW, scan_layers=scan_layers),
                  attention="ring_flash", seed=0, params=None, steps=steps)
             for scan_layers in (False, True)]
    ranks = _run_world(tmp_path, "scan-ring", 2, "vit", specs,
                       "--model-parallel", "2")
    for plain, scanned in ranks:
        assert scanned["metrics"] == plain["metrics"]
        assert scanned["launches"] == plain["launches"]
        assert scanned["launches"]["flash_fwd_pos"] == 0   # CPU: plain
        got = scan.convert_layout(scanned["state"], "blocks")
        assert set(got) == set(plain["state"])
        for k, v in plain["state"].items():
            assert torch.equal(got[k], v), k
