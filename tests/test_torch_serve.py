"""The port's serving path held against the JAX package's: the eval
transform, the datasets, the predict step on a checkpoint the JAX package
wrote, the port's own checkpoint file and lineage ledger, an HTTP round
trip through ``python -m distributedpytorch_tpu_torch serve --device
cpu``, ``/admin/reload`` without a swap function, the refusal of every
flag that is not ported yet, the no-GPU refusal, and the purity of the
port's imports.  Inputs come from numpy
with a seed and go to both sides."""

import json
import os
import re
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedpytorch_tpu.data import augment as jax_augment
from distributedpytorch_tpu.data import datasets as jax_datasets
from distributedpytorch_tpu.data import io as jax_io
from distributedpytorch_tpu_torch import checkpoint as ckpt
from distributedpytorch_tpu_torch import config as tconfig
from distributedpytorch_tpu_torch import cli as tcli
from distributedpytorch_tpu_torch.data import augment, datasets, io
from distributedpytorch_tpu_torch.models import get_model
from distributedpytorch_tpu_torch.precision import PRESETS
from distributedpytorch_tpu_torch.train.engine import Predictor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- eval transform and data --------------------------------------------

@pytest.mark.parametrize("shape", [(5, 28, 28), (5, 32, 32, 3)],
                         ids=["gray28to28", "rgb32to28"])
def test_eval_transform_matches_jax(shape):
    imgs = np.random.default_rng(0).integers(0, 256, shape, dtype=np.uint8)
    want = np.asarray(jax_augment.eval_transform(
        jnp.asarray(imgs), 0.13, 0.31, 28))
    got = augment.eval_transform(torch.from_numpy(imgs), 0.13, 0.31, 28)
    assert got.shape == (5, 28, 28, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_eval_transform_28_is_identity_then_normalize():
    imgs = np.random.default_rng(1).integers(0, 256, (2, 28, 28),
                                             dtype=np.uint8)
    got = augment.eval_transform(torch.from_numpy(imgs), 0.0, 1.0, 28,
                                 out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    want = (imgs.astype(np.float32) / 255.0)[..., None].repeat(3, -1)
    np.testing.assert_array_equal(
        got.float().numpy(),
        torch.from_numpy(want).to(torch.bfloat16).float().numpy())


@pytest.mark.parametrize("kw", [{}, {"class_sep": 0.45, "noise": 70.0}],
                         ids=["synthetic", "synthetic_hard"])
def test_make_synthetic_matches_jax(kw):
    want = jax_io.make_synthetic(num_train=300, num_test=50, seed=3, **kw)
    got = io.make_synthetic(num_train=300, num_test=50, seed=3, **kw)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)


def test_load_dataset_matches_jax_with_fallback_and_debug(tmp_path):
    want = jax_datasets.load_dataset("mnist", str(tmp_path), 1234,
                                     debug=True, synthetic_fallback=True)
    got = datasets.load_dataset("mnist", str(tmp_path), 1234, debug=True,
                                synthetic_fallback=True)
    assert (got.mean, got.std, got.nb_classes) == \
        (want.mean, want.std, want.nb_classes)
    for split in ("train", "valid", "test"):
        np.testing.assert_array_equal(got.splits[split].images,
                                      want.splits[split].images)
        np.testing.assert_array_equal(got.splits[split].labels,
                                      want.splits[split].labels)
    with pytest.raises(ValueError, match="--synthetic-fallback"):
        datasets.load_dataset("mnist", str(tmp_path), 1234)


# -- predict step on a JAX-written checkpoint ---------------------------

@pytest.fixture(scope="module")
def jax_vit_checkpoint(tmp_path_factory):
    """A full-width vit initialised and saved by the JAX package (msgpack
    .ckpt + lineage ledger), with its own predictions on test images."""
    from distributedpytorch_tpu import checkpoint as jax_ckpt
    from distributedpytorch_tpu import utils
    from distributedpytorch_tpu.cli import _build_engine
    from distributedpytorch_tpu.config import Config

    rsl = tmp_path_factory.mktemp("jaxckpt")
    dataset = jax_datasets.load_dataset("synthetic", str(rsl), 1234,
                                        debug=True)
    images = dataset.splits["test"].images[:6]
    out = {"path": str(rsl / "bestmodel-synthetic-vit.ckpt"),
           "dataset": dataset, "images": images}
    for prec in ("f32", "bf16"):
        cfg = Config(action="serve", data_path=str(rsl), rsl_path=str(rsl),
                     dataset="synthetic", model_name="vit", precision=prec,
                     half_precision=prec == "bf16")
        engine = _build_engine(cfg, "vit", dataset, steps_per_epoch=1)
        state = engine.init_state(utils.root_key(7))
        if prec == "f32":
            jax_ckpt.save_checkpoint(out["path"], "vit", state, epoch=3,
                                     best_valid_loss=0.5)
        labels, confs = engine.predict_step(state, images)
        out[prec] = (np.asarray(labels), np.asarray(confs))
    return out


@pytest.mark.parametrize("prec,tol", [("f32", 1e-5), ("bf16", 2e-2)])
def test_predict_step_on_jax_checkpoint_matches_jax(jax_vit_checkpoint,
                                                    prec, tol):
    ref = jax_vit_checkpoint
    assert ckpt.get_checkpoint_model_name(ref["path"]) == "vit"
    assert ckpt.verify_checkpoint(ref["path"]) is None   # JAX's ledger
    policy = PRESETS[prec]
    ds = ref["dataset"]
    model = get_model("vit", ds.nb_classes, policy, attention="flash",
                      device="cpu")
    assert ckpt.restore_for_serving(ref["path"], model) == 3
    pred = Predictor(model, ds.mean, ds.std, 28, policy, "cpu")
    labels, confs = pred.predict_step(ref["images"])
    want_labels, want_confs = ref[prec]
    assert labels.dtype == torch.int32 and labels.shape == (6,)
    np.testing.assert_allclose(confs.numpy(), want_confs, atol=tol, rtol=0)
    # a label may differ only on a near-tie: top-2 margin within tol
    with torch.no_grad():
        probs = torch.softmax(model(augment.eval_transform(
            torch.from_numpy(ref["images"]), ds.mean, ds.std, 28,
            out_dtype=policy.compute_dtype)), dim=-1).numpy()
    top2 = np.sort(probs, axis=-1)[:, -2:]
    near_tie = top2[:, 1] - top2[:, 0] <= tol
    assert not ((labels.numpy() != want_labels) & ~near_tie).any()


def test_predict_step_padded_rows_are_inert(jax_vit_checkpoint):
    ref = jax_vit_checkpoint
    model = get_model("vit", 10, PRESETS["f32"], device="cpu")
    ckpt.restore_for_serving(ref["path"], model)
    pred = Predictor(model, 0.5, 0.25, 28, PRESETS["f32"], "cpu")
    images = ref["images"][:3]
    padded = np.zeros((8,) + images.shape[1:], images.dtype)
    padded[:3] = images
    la, ca = pred.predict_step(images)
    lb, cb = pred.predict_step(padded)
    assert torch.equal(la, lb[:3])
    np.testing.assert_allclose(ca.numpy(), cb[:3].numpy(), atol=1e-6)


def test_jax_checkpoint_without_msgpack_names_the_package(
        jax_vit_checkpoint, monkeypatch):
    monkeypatch.setitem(sys.modules, "msgpack", None)
    with pytest.raises(ValueError, match="'msgpack' package"):
        ckpt.read_checkpoint(jax_vit_checkpoint["path"])


def test_jax_checkpoint_of_a_model_not_ported_is_refused(tmp_path):
    """Every model of the registry is read; a layout that is not ported
    (a vgg written with --scan-layers stacks its last convs as
    ConvScan_0) is refused by name."""
    from flax import serialization

    path = tmp_path / "bestmodel-mnist-vgg.ckpt"
    path.write_bytes(serialization.msgpack_serialize(
        {"format_version": 1, "model_name": "vgg", "epoch": 0,
         "loss": 0.0,
         "state": {"params": {
             "Conv_0": {"kernel": np.zeros((3, 3, 3, 8), np.float32)},
             "ConvScan_0": {"Conv_0": {"kernel": np.zeros(
                 (2, 3, 3, 8, 8), np.float32)}}}}}))
    with pytest.raises(ValueError, match="^not ported yet: --scan-layers "
                                         "checkpoint layout"):
        ckpt.get_checkpoint_model_name(str(path))


# -- the port's own checkpoint ------------------------------------------

def _port_checkpoint(path, seed=0):
    model = get_model("vit", 10, PRESETS["bf16"], device="cpu")
    model.init_weights(torch.Generator().manual_seed(seed))
    ckpt.save_checkpoint(str(path), "vit", model, epoch=2,
                         best_valid_loss=0.25)
    return model


def test_port_checkpoint_round_trip_and_lineage(tmp_path):
    path = tmp_path / "bestmodel-mnist-vit.ckpt"
    model = _port_checkpoint(path)
    ledger = json.loads((tmp_path / "ckpt-lineage.json").read_text())
    assert [r["file"] for r in ledger["records"]] == [path.name]
    assert ckpt.verify_checkpoint(str(path)) is None
    info = ckpt.lineage_info(str(path))
    assert info["sha256"] == ledger["records"][0]["sha256"]
    payload = ckpt.read_checkpoint(str(path))
    assert set(payload) == {"format_version", "model_name", "epoch", "loss",
                            "state"}
    other = get_model("vit", 10, PRESETS["bf16"], device="cpu")
    assert ckpt.restore_for_serving(str(path), other) == 2
    for (k, a), (_, b) in zip(model.state_dict().items(),
                              other.state_dict().items()):
        assert torch.equal(a, b), k


def test_port_checkpoint_corruption_is_refused(tmp_path):
    path = tmp_path / "bestmodel-mnist-vit.ckpt"
    _port_checkpoint(path)
    blob = bytearray(path.read_bytes())
    blob[len(blob) // 2] ^= 0xFF
    path.write_bytes(bytes(blob))
    assert "checksum mismatch" in ckpt.verify_checkpoint(str(path))
    with pytest.raises(ValueError, match="corrupt checkpoint"):
        ckpt.restore_for_serving(str(path), get_model(
            "vit", 10, PRESETS["bf16"], device="cpu"))


def test_orbax_directory_is_not_ported(tmp_path):
    with pytest.raises(ValueError, match="not ported yet: orbax"):
        ckpt.read_checkpoint(str(tmp_path))


# -- the CLI ------------------------------------------------------------

def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _post(port, image):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/predict",
                                 data=json.dumps({"image": image}).encode())
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, json.loads(r.read())


def test_http_round_trip_on_cpu(tmp_path):
    """``serve --device cpu --attention flash``: three requests answered,
    the process exits 0, its telemetry reads with the JAX package's
    report."""
    from distributedpytorch_tpu import telemetry as jax_telemetry

    path = tmp_path / "rsl" / "bestmodel-mnist-vit.ckpt"
    _port_checkpoint(path)
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "distributedpytorch_tpu_torch", "serve",
         "-d", str(tmp_path / "data"), "--rsl_path", str(tmp_path / "rsl"),
         "-f", str(path), "--synthetic-fallback", "--debug",
         "--attention", "flash", "--device", "cpu",
         "--serve-port", str(port), "--serve-buckets", "1,4",
         "--serve-max-requests", "3"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env={**os.environ, "JAX_PLATFORMS": "cpu"})
    try:
        ds = datasets.load_dataset("mnist", str(tmp_path / "data"), 1234,
                                   debug=True, synthetic_fallback=True)
        deadline = time.monotonic() + 120
        answers = []
        for img in ds.splits["test"].images[:3]:
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
    assert [s for s, _ in answers] == [200, 200, 200]
    assert all(0 <= b["label"] < 10 and 0 < b["confidence"] <= 1
               for _, b in answers)
    assert "stopped after answering 3 requests" in out
    # CPU: the plain path, no launch on either route
    assert "flash_fwd launches 0 (0 in warm-up), 0 on the tensor cores" \
        in out
    report = jax_telemetry.report(str(tmp_path / "rsl"))
    assert "serving: 3 requests — 3 answered" in report


def test_tier_answers_a_burst_of_concurrent_connections():
    """64 clients connecting at once all reach admit(): the listener's
    accept backlog covers the queue bound (at socketserver's default
    backlog of 5 the kernel resets part of such a burst)."""
    import threading

    from distributedpytorch_tpu_torch.serving import ServingTier

    def infer(arr):
        return (np.zeros(arr.shape[0], np.int32),
                np.full(arr.shape[0], 0.5))

    tier = ServingTier(infer, (4, 4), np.uint8, (1, 64), max_queue=128,
                       max_latency_s=0.2, port=0, request_timeout_s=30.0,
                       max_requests=64)
    tier.start()
    dispatcher = threading.Thread(target=tier.run, daemon=True)
    dispatcher.start()
    barrier = threading.Barrier(64)
    results = []

    def client():
        barrier.wait(timeout=30)
        try:
            results.append(_post(tier.port, np.zeros((4, 4), int).tolist()))
        except OSError as e:
            results.append((None, repr(e)))

    clients = [threading.Thread(target=client) for _ in range(64)]
    try:
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=60)
    finally:
        tier.close()
        dispatcher.join(timeout=10)
    assert not dispatcher.is_alive()
    assert [s for s, _ in results] == [200] * 64, results[:3]


def test_admin_reload_without_swap_fn_answers_501():
    """A tier with no swap function answers /admin/reload with 501 and
    one line naming the missing seam, and keeps answering /predict."""
    import threading

    from distributedpytorch_tpu_torch.serving import ServingTier

    tier = ServingTier(lambda arr: (np.zeros(arr.shape[0], np.int32),
                                    np.full(arr.shape[0], 0.5)),
                       (4, 4), np.uint8, (1,), max_queue=4,
                       max_latency_s=0.01, port=0, max_requests=1)
    tier.start()
    dispatcher = threading.Thread(target=tier.run, daemon=True)
    dispatcher.start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{tier.port}/admin/reload",
            data=json.dumps({"checkpoint": "x.ckpt"}).encode())
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=30)
        assert e.value.code == 501
        assert json.loads(e.value.read()) == {
            "error": "no swap_fn installed (stub tier or a replica without "
                     "hot-swap)"}
        status, body = _post(tier.port, np.zeros((4, 4), int).tolist())
        dispatcher.join(timeout=10)
    finally:
        tier.close()
    assert status == 200 and body["confidence"] == 0.5


def test_close_waits_for_the_last_answers_records(tmp_path, monkeypatch):
    """A /predict handler writes its trace record after its answer;
    close() returns only once it has, so a replica that exits right after
    close() keeps the records of its last batch."""
    import threading

    from distributedpytorch_tpu_torch import tracing
    from distributedpytorch_tpu_torch.serving import ServingTier

    rsl = str(tmp_path)
    tracer = tracing.configure(rsl, True, 0)
    write = tracer._write

    def slow_write(*args, **kwargs):
        time.sleep(0.5)
        write(*args, **kwargs)

    monkeypatch.setattr(tracer, "_write", slow_write)
    tier = ServingTier(lambda arr: (np.zeros(arr.shape[0], np.int32),
                                    np.full(arr.shape[0], 0.5)),
                       (4, 4), np.uint8, (1,), max_queue=4,
                       max_latency_s=0.01, port=0, max_requests=1)
    tier.start()
    answers = []
    client = threading.Thread(target=lambda: answers.append(
        _post(tier.port, np.zeros((4, 4), int).tolist())))
    try:
        client.start()
        tier.run()
        client.join(timeout=30)
        tier.close()
        records = tracing.load_records(rsl)
    finally:
        tier.close()
        tracing.configure(rsl, False, 0)
    assert [status for status, _ in answers] == [200]
    assert [r["outcome"] for r in records] == ["answered"]


def test_failed_batch_records_land_before_its_count(tmp_path, monkeypatch):
    """A batch whose infer raises has its requests' trace records on disk
    by the time ``serve/failed`` counts them, so a collector that fires on
    the counter names every request of that batch in its bundle."""
    import threading

    from distributedpytorch_tpu_torch import telemetry, tracing
    from distributedpytorch_tpu_torch.serving import ServingTier

    def infer(arr):
        raise OSError("injected")

    rsl = str(tmp_path)
    tel = telemetry.configure(rsl, True, 0)
    tracing.configure(rsl, True, 0)
    seen = []
    counter = tel.counter

    class Probe:
        def __init__(self, inner):
            self.inner = inner

        def add(self, n=1):
            seen.append((n, sum(r["outcome"] == "failed"
                                for r in tracing.load_records(rsl))))
            self.inner.add(n)

    monkeypatch.setattr(tel, "counter", lambda name: Probe(counter(name))
                        if name == "serve/failed" else counter(name))
    tier = ServingTier(infer, (4, 4), np.uint8, (1,), max_queue=4,
                       max_latency_s=0.01, port=0, max_requests=1)
    tier.start()
    dispatcher = threading.Thread(target=tier.run, daemon=True)
    dispatcher.start()
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(tier.port, np.zeros((4, 4), int).tolist())
        dispatcher.join(timeout=10)
    finally:
        tier.close()
        tracing.configure(rsl, False, 0)
        telemetry.configure(rsl, False, 0)
    assert e.value.code == 500
    assert seen == [(1, 1)]
    [rec] = tracing.load_records(rsl)
    assert rec["outcome"] == "failed" and rec["status"] == 500
    assert not dispatcher.is_alive()


NOT_PORTED = [
    (["--attention", "ring"], "--attention ring"),
    (["--attention", "ring_flash"], "--attention ring_flash"),
    (["--moe-experts", "4"], "--moe-experts"),
    (["--tensor-parallel"], "--tensor-parallel"),
    (["--pipeline-parallel"], "--pipeline-parallel"),
    (["--model-parallel", "2"], "--model-parallel"),
    (["--seq-parallel", "2"], "--seq-parallel"),
    (["--scan-layers"], "--scan-layers"),
    # ported: taken, as the JAX serve parser takes it
    (["--remat", "blocks"], "--remat blocks"),
    # ported: taken, a replica of an elastic world with its exporter and
    # flight recorder (--elastic-join needs --elastic)
    (["--elastic"], "--elastic"),
    (["--elastic-join"], "--elastic-join"),
    (["--elastic-dir", "/x"], "--elastic-dir"),
    (["--metrics-port", "9100"], "--metrics-port"),
    (["--flightrec"], "--flightrec"),
    # ported: taken, its serve.* sites live
    (["--fault-plan", "data.read:ioerror:0"], "--fault-plan"),
    (["--ckpt-format", "orbax"], "--ckpt-format orbax"),
    # ported presets, refused as the JAX package refuses them
    (["--precision", "bf16_full", "--no-bf16"], "--precision bf16_full"),
    (["--precision", "f16", "--no-bf16"], "--precision f16"),
]


@pytest.mark.parametrize("extra,flag", NOT_PORTED,
                         ids=[f for _, f in NOT_PORTED])
def test_flag_not_ported_fails_loudly(extra, flag, capsys):
    """Each flag fails with one line; --model-parallel,
    --tensor-parallel, --pipeline-parallel and --seq-parallel with the JAX
    serve's message (they do not apply to a replica), --precision against
    --no-bf16
    with the JAX conflict, --elastic-join without --elastic with the JAX
    run_serve's, every other one as not ported yet; --remat is ported and
    taken (nothing of serve reads it), and so are --fault-plan (the serve.*
    sites fire under it), --elastic, --elastic-dir, --metrics-port and
    --flightrec (the world of replicas, tests/test_torch_serve_world.py)
    and --moe-experts (the replica's MoE vit, tests/test_torch_moe.py)."""
    argv = ["serve", "-d", "/nonexistent", "-f", "/nonexistent.ckpt",
            "--device", "cpu"] + extra
    taken = {"--remat blocks": ("remat", "blocks"),
             "--fault-plan": ("fault_plan", "data.read:ioerror:0"),
             "--elastic": ("elastic", True),
             "--elastic-dir": ("elastic_dir", "/x"),
             "--metrics-port": ("metrics_port", 9100),
             "--flightrec": ("flightrec", True),
             "--moe-experts": ("moe_experts", 4)}
    if flag in taken:
        field, value = taken[flag]
        assert getattr(tconfig.config_from_argv(argv), field) == value
        return
    message = f"not ported yet: {flag}"
    if flag == "--elastic-join":
        # taken, and refused without --elastic as the JAX run_serve does
        message = re.escape(
            "--elastic-join requires --elastic: a joining replica becomes "
            "a normal elastic member and must keep reconfiguring with its "
            "world")
    if flag.startswith("--precision"):
        message = re.escape(
            f"--no-bf16 conflicts with {flag}: --no-bf16 is the legacy "
            f"alias for --precision f32; drop one")
    if flag in ("--model-parallel", "--tensor-parallel",
                "--pipeline-parallel", "--seq-parallel"):
        message = re.escape(
            "serve runs replica-local data-parallel inference; "
            "--model-parallel/--tensor-parallel/--pipeline-parallel/"
            "--seq-parallel do not apply (model-parallel-trained "
            "checkpoints convert at load)")
    with pytest.raises(ValueError, match=f"^{message}$"):
        tconfig.config_from_argv(argv)
    assert tcli.main(argv) == 1


def test_ported_flags_parse():
    cfg = tconfig.config_from_argv(
        ["serve", "-d", "/d", "-f", "/c.ckpt", "--attention", "flash",
         "--precision", "f32", "--model", "vit", "--no-flightrec"])
    assert (cfg.attention, cfg.device, cfg.model_name) == \
        ("flash", "cuda", "vit")
    assert cfg.precision_policy().compute_dtype == torch.float32


def test_cli_without_device_cpu_refuses_to_run_without_gpu(tmp_path,
                                                           monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tconfig.config_from_argv(
        ["serve", "-d", str(tmp_path), "-f", str(tmp_path / "c.ckpt"),
         "--synthetic-fallback", "--rsl_path", str(tmp_path / "rsl")])
    assert cfg.device == "cuda"
    with pytest.raises(ValueError, match="no CUDA device is available"):
        tcli.run_serve(cfg)
    assert not (tmp_path / "rsl").exists()   # nothing ran


def test_port_imports_no_jax():
    """Every module of the port imports without jax, flax or the JAX
    package appearing in sys.modules."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import distributedpytorch_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'optax',\n"
        "              'distributedpytorch_tpu'))\n"
        "assert not bad, bad\n"
        "print(' '.join(n for n in sys.modules if n.startswith(p.__name__)))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    imported = set(proc.stdout.split())
    assert len(imported) >= 20
    for name in ("ops.conv", "ops.pooling", "models.layers", "models.norm",
                 "models.simple", "models.resnet", "runtime", "train.engine",
                 "models.alexnet", "models.vgg", "models.squeezenet",
                 "models.densenet", "models.inception", "models.common",
                 "models.pretrained", "deadline", "slo", "fleet",
                 "serving.controller", "serving.rollout",
                 "serving.frontdoor", "sim.engine", "models.moe"):
        assert f"distributedpytorch_tpu_torch.{name}" in imported, name
