"""The port's streaming loader (``--data-mode stream``) held against the
JAX package's ``ShardedLoader`` and against the port's resident loader.

  * Byte-identical batches, values and order, to JAX's ``ShardedLoader``
    on a one-device CPU mesh and to the port's ``ResidentLoader``, from
    the same seeded numpy split, for every combination of ``prefetch``
    {0, 2}, ``producer_threads`` {0, 1, 3} and ``device_prefetch`` {0, 2}.
  * Two gloo ranks (``tests/_torch_ring_child.py loader``), with and
    without ``--model-parallel 2``: each rank's batches are its data
    shard's block of the JAX global batch.
  * A producer's failure re-raises at its step and no thread outlives an
    epoch (JAX ``tests/test_threaded_producer.py:61-95``,
    ``tests/test_device_prefetch.py:69-124``); the telemetry counters
    carry JAX's names.
  * The CLI: ``train --data-mode stream`` (and ``auto`` over a small cap)
    gives the resident run's losses and parameters bit for bit on the
    CPU; ``--epochs-per-dispatch 2`` on a streamed run fails with JAX's
    message, word for word.
  * A read-only split is copied into the resident loader (ROADMAP queue 3
    entry 22).
"""

import itertools
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch

from distributedpytorch_tpu import runtime as jax_runtime
from distributedpytorch_tpu import telemetry as jax_telemetry
from distributedpytorch_tpu.data.datasets import Split as JaxSplit
from distributedpytorch_tpu.data.pipeline import (
    ShardedLoader as JaxShardedLoader)
from distributedpytorch_tpu_torch import cli as tcli
from distributedpytorch_tpu_torch import config as tconfig
from distributedpytorch_tpu_torch import telemetry
from distributedpytorch_tpu_torch.data.datasets import Split
from distributedpytorch_tpu_torch.data.pipeline import (ResidentLoader,
                                                        ShardedLoader)
from tests.test_torch_ring import _run_world

BATCH, SEED, EPOCHS = 8, 7, (0, 1)
SETTINGS = list(itertools.product((0, 2), (0, 1, 3), (0, 2)))
SETTING_IDS = [f"prefetch{p}-threads{t}-device{d}" for p, t, d in SETTINGS]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def restore_telemetry():
    yield
    telemetry._active = telemetry.Telemetry(enabled=False)
    jax_telemetry._active = jax_telemetry.Telemetry(enabled=False)


def _arrays(n=131, seed=0):
    """A split of ``n`` rows (not a multiple of the batch: the last batch
    wraps around) from a numpy seed."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n, 28, 28), dtype=np.uint8),
            rng.integers(0, 10, n).astype(np.int32))


def _batches(loader, epoch):
    return [tuple(np.asarray(t) for t in batch)
            for batch in loader.epoch(epoch)]


@pytest.fixture(scope="module")
def jax_batches():
    """JAX ``ShardedLoader``'s epochs on a one-device mesh."""
    mesh = jax_runtime.make_mesh(devices=jax.devices()[:1])
    loader = JaxShardedLoader(JaxSplit(*_arrays()), mesh, BATCH,
                              shuffle=True, seed=SEED, prefetch=0)
    return {e: _batches(loader, e) for e in EPOCHS}


@pytest.mark.parametrize("prefetch,threads,device_prefetch", SETTINGS,
                         ids=SETTING_IDS)
def test_streamed_batches_equal_jax_and_resident(jax_batches, prefetch,
                                                 threads, device_prefetch):
    split = Split(*_arrays())
    stream = ShardedLoader(split, BATCH, True, SEED, "cpu",
                           prefetch=prefetch, producer_threads=threads,
                           device_prefetch=device_prefetch)
    resident = ResidentLoader(split, BATCH, True, SEED, "cpu")
    assert len(stream) == len(resident) == len(jax_batches[0]) == 17
    for epoch in EPOCHS:
        got = list(stream.epoch(epoch))
        want = list(resident.epoch(epoch))
        assert len(got) == len(want) == len(jax_batches[epoch])
        for g, w, j in zip(got, want, jax_batches[epoch]):
            assert [t.dtype for t in g] == [torch.uint8, torch.int64,
                                            torch.bool]
            for gt, wt, jt in zip(g, w, j):
                assert torch.equal(gt, wt)
                np.testing.assert_array_equal(gt.numpy(), jt)


def test_cli_defaults_and_negative_values_follow_jax():
    """The CLI defaults are JAX's (prefetch 2, one producer thread, no
    transfer thread); a library construction has no producer thread; a
    value below 0 means 0, as JAX's max(0, ...)."""
    from distributedpytorch_tpu.config import config_from_argv as jax_argv

    for action in ("train", "test", "serve"):
        argv = [action, "-d", "/d"] + (["-f", "/c"] if action != "train"
                                       else [])
        want, got = jax_argv(argv), tconfig.config_from_argv(argv)
        assert (got.data_mode, got.prefetch, got.producer_threads,
                got.device_prefetch, got.remat) == (
            want.data_mode, want.prefetch, want.producer_threads,
            want.device_prefetch, want.remat) == ("auto", 2, 1, 0, "none")
    loader = ShardedLoader(Split(*_arrays()), BATCH, True, SEED, "cpu")
    assert (loader.prefetch, loader.producer_threads,
            loader.device_prefetch) == (2, 0, 0)
    loader = ShardedLoader(Split(*_arrays()), BATCH, True, SEED, "cpu",
                           prefetch=-1, producer_threads=-2,
                           device_prefetch=-3)
    assert (loader.prefetch, loader.producer_threads,
            loader.device_prefetch) == (0, 0, 0)
    assert len(_batches(loader, 0)) == 17


# -- two ranks ---------------------------------------------------------------

@pytest.mark.parametrize("model_parallel", [1, 2])
def test_rank_shards_are_the_jax_global_batch_blocks(model_parallel,
                                                     tmp_path):
    """Rank r of 2 streams block r of the JAX global batch (2 x 8 rows on
    a data mesh of 2); at --model-parallel 2 both ranks stream the whole
    global batch, the JAX (1, 2) mesh's one data shard."""
    images, labels = _arrays(97, seed=3)
    settings = [(2, 1, 0), (0, 3, 2)]
    mesh = jax_runtime.make_mesh(data_parallel=2 // model_parallel,
                                 model_parallel=model_parallel,
                                 devices=jax.devices()[:2])
    want = _batches(JaxShardedLoader(JaxSplit(images, labels), mesh, BATCH,
                                     shuffle=True, seed=SEED, prefetch=0), 1)
    spec = dict(images=images, labels=labels, batch=BATCH, seed=SEED,
                epoch=1, settings=settings)
    got = _run_world(tmp_path, f"loader-mp{model_parallel}", 2, "loader",
                     spec, "--model-parallel", str(model_parallel))
    for rank, result in enumerate(got):
        rows = (slice(None) if model_parallel == 2
                else slice(rank * BATCH, (rank + 1) * BATCH))
        for batches in result["batches"]:
            assert len(batches) == len(want) == 7
            for g, w in zip(batches, want):
                for gt, wt in zip(g, w):
                    np.testing.assert_array_equal(gt, wt[rows])


# -- failures, threads, telemetry ----------------------------------------------

@pytest.mark.parametrize("threads,device_prefetch", [(2, 0), (0, 2),
                                                     (2, 2)])
def test_producer_failure_reraises_at_its_step(threads, device_prefetch):
    loader = ShardedLoader(Split(*_arrays(128)), 2, True, SEED, "cpu",
                           producer_threads=threads,
                           device_prefetch=device_prefetch)
    orig = loader._host_batch

    def failing(per_rank, step):
        if step == 5:
            raise RuntimeError("corrupt shard")
        return orig(per_rank, step)

    loader._host_batch = failing
    got = []
    with pytest.raises(RuntimeError, match="corrupt shard"):
        for batch in loader.epoch(0):
            got.append(batch)
    # every batch before the failure was delivered in order
    assert len(got) == 5


def _settle(before):
    deadline = time.monotonic() + 10
    while set(threading.enumerate()) - before \
            and time.monotonic() < deadline:
        time.sleep(0.01)
    return set(threading.enumerate())


@pytest.mark.parametrize("threads,device_prefetch", [(2, 0), (2, 2)])
def test_no_thread_outlives_an_epoch(threads, device_prefetch):
    loader = ShardedLoader(Split(*_arrays(128)), 2, True, SEED, "cpu",
                           producer_threads=threads,
                           device_prefetch=device_prefetch)
    before = set(threading.enumerate())
    for epoch in range(3):
        for _ in loader.epoch(epoch):
            pass
    # a partly consumed epoch: the generator's close() reaps its threads
    it = loader.epoch(3)
    next(it)
    it.close()
    assert _settle(before) == before
    # release() stops, drains and joins an epoch in flight
    it = loader.epoch(4)
    next(it)
    assert loader._active_runs
    loader.release()
    assert loader._active_runs == []
    assert _settle(before) == before
    it.close()


def test_stress_more_threads_than_cores_keeps_the_stream():
    """Eight producers and a transfer thread, the interpreter switching
    threads every 10 us: three epochs are still the resident loader's
    batches in order, and every thread is joined."""
    split = Split(*_arrays(97, seed=5))
    resident = ResidentLoader(split, 2, True, SEED, "cpu")
    before = set(threading.enumerate())
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for device_prefetch in (0, 2):
            stream = ShardedLoader(split, 2, True, SEED, "cpu", prefetch=1,
                                   producer_threads=8,
                                   device_prefetch=device_prefetch)
            for epoch in range(3):
                got = list(stream.epoch(epoch))
                want = list(resident.epoch(epoch))
                assert len(got) == len(want) == 49
                for g, w in zip(got, want):
                    assert all(torch.equal(a, b) for a, b in zip(g, w))
    finally:
        sys.setswitchinterval(interval)
    assert _settle(before) == before


def test_telemetry_counters_carry_the_jax_names(restore_telemetry,
                                                tmp_path):
    """Every setting's counters and histograms, on both sides, under the
    same names."""
    images, labels = _arrays()
    mesh = jax_runtime.make_mesh(devices=jax.devices()[:1])
    tel = telemetry.configure(str(tmp_path / "port"), True, rank=0)
    jax_tel = jax_telemetry.Telemetry(enabled=True,
                                      rsl_path=str(tmp_path / "jax"))
    jax_telemetry._active = jax_tel
    for prefetch, threads, device_prefetch in [(0, 0, 0), (2, 0, 0),
                                               (2, 3, 0), (2, 1, 2)]:
        kw = dict(prefetch=prefetch, producer_threads=threads,
                  device_prefetch=device_prefetch)
        _batches(ShardedLoader(Split(images, labels), BATCH, True, SEED,
                               "cpu", **kw), 0)
        _batches(JaxShardedLoader(JaxSplit(images, labels), mesh, BATCH,
                                  shuffle=True, seed=SEED, **kw), 0)
    assert sorted(tel._counters) == sorted(jax_tel._counters) == [
        "data/batches", "data/device_wait_s", "data/queue_depth_sum",
        "data/starved_steps", "data/wait_s", "data/warmup_s"]
    assert sorted(tel._histograms) == sorted(jax_tel._histograms)
    assert tel.counter("data/batches").value == 4 * 17


# -- the CLI -------------------------------------------------------------------

def _train(tmp_path, name, *extra):
    return tcli.run_train(tconfig.config_from_argv(
        ["train", "-d", str(tmp_path / "data"), "--rsl_path",
         str(tmp_path / name), "--dataset", "synthetic", "--debug",
         "--model", "cnn", "--device", "cpu", "-e", "2", *extra]))


@pytest.fixture(scope="module")
def resident_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("resident")
    return _train(tmp, "resident", "--data-mode", "resident")


@pytest.mark.parametrize("extra", [
    ["--data-mode", "stream"],
    ["--data-mode", "stream", "--producer-threads", "3",
     "--device-prefetch", "2"],
    ["--data-mode", "stream", "--prefetch", "0", "--producer-threads", "0"],
    ["--data-mode", "auto", "cap"]],
    ids=["stream", "stream-threads3-device2", "stream-sync", "auto-capped"])
def test_streamed_train_equals_resident(resident_run, extra, tmp_path,
                                        monkeypatch):
    """Per-epoch losses and accuracies, final parameters and BatchNorm-free
    state bit for bit; ``auto`` over a cap below the split's bytes
    streams."""
    if extra[-1] == "cap":
        extra = extra[:-1]
        monkeypatch.setattr(tcli, "RESIDENT_MAX_BYTES", 1000)
    made = []
    make = tcli._make_loader

    def spy(*args, **kwargs):
        made.append(make(*args, **kwargs))
        return made[-1]

    monkeypatch.setattr(tcli, "_make_loader", spy)
    got = _train(tmp_path, "stream", *extra)
    assert [type(ld) for ld in made] == [ShardedLoader, ShardedLoader]
    assert got["history"] and [
        {k: v for k, v in h.items() if k != "train_s"}
        for h in got["history"]] == [
        {k: v for k, v in h.items() if k != "train_s"}
        for h in resident_run["history"]]
    want = resident_run["state"].model.state_dict()
    for key, v in got["state"].model.state_dict().items():
        assert torch.equal(v, want[key]), key
    log = (tmp_path / "stream" / "test.log").read_text()
    assert f"prefetch: {_prefetch_of(extra)}" in log


def _prefetch_of(extra):
    return extra[extra.index("--prefetch") + 1] if "--prefetch" in extra \
        else 2


def test_auto_within_the_budget_stays_resident(monkeypatch):
    """On the CPU the cap alone is the budget; a card's budget is also at
    most 30% of its memory."""
    split = Split(*_arrays())
    cfg = tconfig.config_from_argv(["train", "-d", "/d", "--device", "cpu"])
    mesh = tcli.runtime.make_mesh(1)
    cpu = torch.device("cpu")
    assert tcli._resident_budget_bytes(cpu) == tconfig.RESIDENT_MAX_BYTES
    assert isinstance(tcli._make_loader(cfg, split, True, cpu, mesh),
                      ResidentLoader)
    monkeypatch.setattr(tcli.runtime, "device_memory_limit",
                        lambda device: 10 ** 9)
    assert tcli._resident_budget_bytes(cpu) == 3 * 10 ** 8
    monkeypatch.setattr(tcli, "RESIDENT_MAX_BYTES", split.images.nbytes - 1)
    assert isinstance(tcli._make_loader(cfg, split, True, cpu, mesh),
                      ShardedLoader)


def _jax_stream_dispatch_message(tmp_path):
    from distributedpytorch_tpu import cli as jax_cli
    from distributedpytorch_tpu.config import config_from_argv as jax_argv

    cfg = jax_argv(["train", "-d", str(tmp_path / "jdata"), "--rsl_path",
                    str(tmp_path / "jrsl"), "--dataset", "synthetic",
                    "--debug", "--model", "mlp", "--data-mode", "stream",
                    "--epochs-per-dispatch", "2", "-e", "2"])
    with pytest.raises(ValueError) as err:
        jax_cli.run_train(cfg)
    return str(err.value)


@pytest.mark.parametrize("how", ["stream", "auto-capped"])
def test_streamed_epochs_per_dispatch_fails_with_the_jax_message(
        how, tmp_path, monkeypatch):
    want = _jax_stream_dispatch_message(tmp_path)
    assert want == tconfig.STREAM_DISPATCH_MESSAGE
    argv = ["train", "-d", str(tmp_path / "data"), "--rsl_path",
            str(tmp_path / "rsl"), "--dataset", "synthetic", "--debug",
            "--model", "mlp", "--device", "cpu", "--epochs-per-dispatch",
            "2", "-e", "2"]
    if how == "stream":
        with pytest.raises(ValueError) as err:
            tconfig.config_from_argv(argv + ["--data-mode", "stream"])
        assert str(err.value) == want
        assert tcli.main(argv + ["--data-mode", "stream"]) == 1
        return
    monkeypatch.setattr(tcli, "RESIDENT_MAX_BYTES", 1000)
    made = []
    monkeypatch.setattr(tcli, "_make_loader",
                        lambda *a, **k: made.append(a))
    with pytest.raises(ValueError) as err:
        tcli.run_train(tconfig.config_from_argv(argv))
    assert str(err.value) == want and made == []


def test_resident_loader_copies_a_read_only_split():
    """A read-only split (as a memory-mapped corpus comes) is copied, not
    wrapped (ROADMAP queue 3 entry 22): no "not writable" UserWarning, and
    on the CPU, where ``.to()`` returns the same tensor, writing into the
    loader's images leaves the split's untouched, as the JAX loader's
    ``device_put`` copy does."""
    import warnings

    rng = np.random.default_rng(SEED)
    images = rng.integers(0, 256, (20, 6, 6), dtype=np.uint8)
    images.flags.writeable = False
    split = Split(images, rng.integers(0, 10, 20).astype(np.int32))
    before = images.copy()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        loader = ResidentLoader(split, BATCH, True, SEED, "cpu")
    loader.images += 1
    np.testing.assert_array_equal(split.images, before)
    np.testing.assert_array_equal(loader.images.numpy(), before + 1)
