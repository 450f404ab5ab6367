"""``--ckpt-async``, the checkpoint's format 3 and the lifted refusals of
the port's CLI.  ``AsyncSaver`` as the JAX package's (FIFO jobs, a
background error re-raised on the caller's thread, degrade mode and its
``ckpt_async_degraded`` event, ``close()`` retiring the thread); a file
written asynchronously byte-identical to the synchronous one; ``train
--ckpt-async`` writing the same files as a synchronous run and resuming
bit for bit; the loss scale across checkpoints by the JAX rule (an f16
file into a run that scales no loss drops the scale, a file without one
into an f16 run keeps the fresh 2^15); format-2 files still read; and
``train --device cpu`` taking ``--precision f16|bf16_full``,
``--grad-accum`` and ``--ckpt-async``, and f16 on a ring.
"""

import json
import os
import re
import threading

import pytest
import torch

from distributedpytorch_tpu_torch import checkpoint as ckpt
from distributedpytorch_tpu_torch import cli as tcli
from distributedpytorch_tpu_torch import config as tconfig
from distributedpytorch_tpu_torch import telemetry
from distributedpytorch_tpu_torch.models import registry
from distributedpytorch_tpu_torch.precision import PRESETS, LossScaleState
from distributedpytorch_tpu_torch.ops import losses
from distributedpytorch_tpu_torch.train.engine import Engine


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# -- AsyncSaver ---------------------------------------------------------------

def test_jobs_run_in_submission_order():
    saver = ckpt.AsyncSaver()
    gate = threading.Event()
    done = []
    saver.submit(lambda: (gate.wait(5), done.append(0)))
    for i in range(1, 20):
        saver.submit(lambda i=i: done.append(i))
    assert saver.in_flight
    gate.set()
    saver.wait()
    assert done == list(range(20)) and not saver.in_flight
    saver.close()


def test_a_background_error_is_raised_on_the_callers_thread():
    saver = ckpt.AsyncSaver()

    def fail():
        raise OSError("disk full")

    saver.submit(fail)
    with pytest.raises(OSError, match="disk full"):
        saver.wait()
    saver.wait()                # raised once, then cleared
    saver.submit(fail)
    with pytest.raises(OSError, match="disk full"):
        saver.close()
    with pytest.raises(ValueError, match="on_error"):
        ckpt.AsyncSaver(on_error="ignore")


def test_degrade_mode_logs_an_event_and_goes_synchronous(tmp_path):
    tel = telemetry.configure(str(tmp_path), True, rank=0)
    try:
        saver = ckpt.AsyncSaver(on_error="degrade")

        def fail():
            raise OSError("disk full")

        saver.submit(fail)
        saver.wait()            # not raised in degrade mode
        assert saver.degraded
        ran_on = []
        saver.submit(lambda: ran_on.append(threading.current_thread()))
        assert ran_on == [threading.current_thread()]   # synchronous now
        saver.close()
    finally:
        tel.close()
    events = [json.loads(line) for line in
              (tmp_path / "telemetry" / "rank0.jsonl").read_text()
              .splitlines()]
    degraded = [e for e in events if e.get("name") == "ckpt_async_degraded"]
    assert len(degraded) == 1 and "disk full" in degraded[0]["attrs"]["error"]


def test_close_retires_the_worker_thread():
    saver = ckpt.AsyncSaver()
    saver.submit(lambda: None)
    thread = saver._thread
    assert thread is not None and thread.is_alive()
    saver.close()
    thread.join(timeout=5)
    assert not thread.is_alive() and saver._thread is None
    saver.close()               # idempotent


# -- the file -----------------------------------------------------------------

def _trained_state(policy="f16", steps=2):
    model = registry.get_model("mlp", 10, PRESETS[policy], device="cpu")
    engine = Engine(model, losses.cross_entropy, 0.13, 0.31, 28,
                    PRESETS[policy], "cpu", optimizer="adam")
    state = engine.init_state(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    for _ in range(steps):
        images = torch.randint(0, 256, (8, 28, 28), dtype=torch.uint8,
                               generator=gen)
        labels = torch.randint(0, 10, (8,), generator=gen)
        engine.train_step(state, images, labels, torch.ones(8, dtype=bool),
                          gen)
    return engine, state


def _save(state, path, saver=None):
    args = (str(path), "mlp", state.model, 1, 0.5, state.optimizer,
            state.step, state.updates, state.loss_scale)
    if saver is None:
        ckpt.save_checkpoint(*args)
    else:
        ckpt.save_checkpoint_async(saver, *args)


def test_an_async_file_is_byte_identical_to_the_sync_one(tmp_path):
    _, state = _trained_state()
    _save(state, tmp_path / "sync" / "a.ckpt")
    saver = ckpt.AsyncSaver()
    _save(state, tmp_path / "async" / "a.ckpt", saver)
    # the snapshot is taken: a later in-place update does not reach it
    with torch.no_grad():
        for p in state.model.parameters():
            p.add_(1.0)
    saver.close()
    sync = (tmp_path / "sync" / "a.ckpt").read_bytes()
    assert (tmp_path / "async" / "a.ckpt").read_bytes() == sync
    payload = ckpt.read_checkpoint(str(tmp_path / "async" / "a.ckpt"))
    assert payload["format_version"] == ckpt.FORMAT_VERSION == 3
    assert payload["state"]["loss_scale"] == state.loss_scale.to_dict() \
        == {"scale": 32768.0, "good_steps": 2}
    assert payload["state"]["updates"] == payload["state"]["step"] == 2


@pytest.mark.parametrize("saved,restored", [("f16", "f32"), ("f32", "f16"),
                                            ("f16", "f16")])
def test_the_loss_scale_across_checkpoints_follows_jax(saved, restored,
                                                       tmp_path):
    _, state = _trained_state(saved)
    if state.loss_scale is not None:
        state.loss_scale = LossScaleState(4096.0, 7)
    _save(state, tmp_path / "a.ckpt")
    engine, fresh = _trained_state(restored, steps=0)
    ckpt.load_checkpoint(str(tmp_path / "a.ckpt"), fresh.model,
                         fresh.optimizer, train_state=fresh)
    want = {("f16", "f32"): None,
            ("f32", "f16"): LossScaleState(2.0 ** 15, 0),
            ("f16", "f16"): LossScaleState(4096.0, 7)}[(saved, restored)]
    assert fresh.loss_scale == want
    assert fresh.updates == state.updates == 2


def test_a_format_2_file_still_resumes(tmp_path):
    """A file of the previous format (no update count, no loss scale):
    its update count is its step (no step of it was skipped) and an f16
    run keeps its fresh scale."""
    _, state = _trained_state("f32", steps=3)
    payload = {"format_version": 2, "model_name": "mlp", "epoch": 0,
               "loss": 0.25,
               "state": {"params": state.model.state_dict(),
                         "opt_state": state.optimizer.state_dict(),
                         "step": 3}}
    path = str(tmp_path / "v2.ckpt")
    torch.save(payload, path)
    _, fresh = _trained_state("f16", steps=0)
    epoch, best, step = ckpt.load_checkpoint(path, fresh.model,
                                             fresh.optimizer,
                                             train_state=fresh)
    assert (epoch, best, step, fresh.updates) == (1, 0.25, 3, 3)
    assert fresh.loss_scale == LossScaleState(2.0 ** 15, 0)
    for k, v in state.model.state_dict().items():
        assert torch.equal(fresh.model.state_dict()[k], v), k


# -- the CLI ------------------------------------------------------------------

def _argv(tmp_path, rsl, *extra):
    return ["train", "-d", str(tmp_path / "data"), "--rsl_path",
            str(tmp_path / rsl), "--model", "cnn", "--device", "cpu",
            "--debug", "--synthetic-fallback", "--keep-ckpts", "2", *extra]


def _ckpt_files(rsl):
    return {n: (rsl / n).read_bytes() for n in sorted(os.listdir(rsl))
            if n.endswith(".ckpt")}


def test_train_ckpt_async_writes_the_sync_files_and_resumes(tmp_path):
    """``train -e 2`` with and without ``--ckpt-async``: the same files,
    byte for byte, and a resume from the async run's epoch-1 file, itself
    with ``--ckpt-async``, ends on the uninterrupted run's state bit for
    bit."""
    sync = tcli.run_train(tconfig.config_from_argv(
        _argv(tmp_path, "sync", "-e", "2")))
    run = tcli.run_train(tconfig.config_from_argv(
        _argv(tmp_path, "async", "-e", "2", "--ckpt-async")))
    files = _ckpt_files(tmp_path / "async")
    assert sorted(files) == ["bestmodel-mnist-cnn.ckpt",
                             "checkpoint-mnist-cnn-000.ckpt",
                             "checkpoint-mnist-cnn-001.ckpt"]
    assert files == _ckpt_files(tmp_path / "sync")
    for k, v in sync["state"].model.state_dict().items():
        assert torch.equal(run["state"].model.state_dict()[k], v), k
    resumed = tcli.run_train(tconfig.config_from_argv(
        _argv(tmp_path, "async", "-e", "2", "--ckpt-async", "-f",
              str(tmp_path / "async" / "checkpoint-mnist-cnn-000.ckpt"))))
    assert len(resumed["history"]) == 1
    assert resumed["state"].step == sync["state"].step
    for k, v in sync["state"].model.state_dict().items():
        assert torch.equal(resumed["state"].model.state_dict()[k], v), k
    log = (tmp_path / "async" / "test.log").read_text()
    assert "model loaded from" in log


@pytest.mark.parametrize("extra", [
    ["--precision", "f16", "--grad-accum", "2", "--ckpt-async"],
    ["--precision", "bf16_full", "--grad-accum", "4"]],
    ids=["f16+grad-accum+ckpt-async", "bf16_full+grad-accum"])
def test_train_takes_the_ported_flags(extra, tmp_path):
    argv = _argv(tmp_path, "rsl", "-e", "1", "--model", "mlp", *extra)
    assert tcli.main(argv) == 0
    log = (tmp_path / "rsl" / "test.log").read_text()
    assert "Validation  | Loss:" in log
    assert bool(re.search(r"train: loss scale \d+ after \d+ steps, \d+ "
                          r"skipped on non-finite gradients", log)) == (
        "f16" in extra)
    payload = ckpt.read_checkpoint(str(tmp_path / "rsl" /
                                       "bestmodel-mnist-mlp.ckpt"))
    dtypes = {v.dtype for v in payload["state"]["params"].values()}
    assert dtypes == {torch.bfloat16 if "bf16_full" in extra
                      else torch.float32}


def test_precision_policy_event_names_the_grad_accum(tmp_path):
    argv = _argv(tmp_path, "rsl", "-e", "1", "--model", "mlp",
                 "--grad-accum", "2", "--telemetry")
    assert tcli.main(argv) == 0
    events = {e["name"]: e.get("attrs", {}) for e in map(
        json.loads, open(tmp_path / "rsl" / "telemetry" / "rank0.jsonl"))
        if e["kind"] == "event"}
    assert events["precision_policy"]["grad_accum"] == 2
    assert events["precision_policy"]["preset"] == "bf16"


@pytest.mark.parametrize("action", ["train", "test"])
@pytest.mark.parametrize("attention", ["ring", "ring_flash"])
def test_f16_with_a_ring_is_not_ported_yet(action, attention, tmp_path):
    """f16 on the ring is ported: the flags parse into the config."""
    argv = [action, "-d", str(tmp_path), "--device", "cpu", "--precision",
            "f16", "--attention", attention, "--model-parallel", "2"]
    argv += ["-f", str(tmp_path / "c.ckpt")] if action == "test" else \
        ["--model", "vit"]
    cfg = tconfig.config_from_argv(argv)
    assert (cfg.precision, cfg.attention, cfg.model_parallel) == (
        "f16", attention, 2)
