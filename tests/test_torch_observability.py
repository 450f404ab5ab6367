"""The port's observability held against the JAX package's: the goodput
ledger and the anomaly detector fed the same call sequences on a fake
clock, the JAX readers (``flightrec.load_dumps``, ``telemetry.report``,
``goodput.report``, ``timeline.build_timeline``) on the port's files, the
exporter's sized backlog, an anomaly capture on the CPU, and one CPU
``train`` with every flag (``--telemetry --profile --aot-warmup
--anomaly-capture --metrics-port``) byte-identical in its epoch lines
and rolling file to the run without them."""

import json
import os
import re
import socket
import threading
import time
import urllib.request

import pytest
import torch

from distributedpytorch_tpu import flightrec as jax_flightrec
from distributedpytorch_tpu import goodput as jax_goodput
from distributedpytorch_tpu import telemetry as jax_telemetry
from distributedpytorch_tpu import timeline as jax_timeline
from distributedpytorch_tpu_torch import cli as tcli
from distributedpytorch_tpu_torch import config as tconfig
from distributedpytorch_tpu_torch import (flightrec, goodput, roofline,
                                          telemetry, timeline)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several workers on one machine: this file's torch
    ops keep to two threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


class FakeClock:
    """perf_counter, monotonic and time all read ``now``."""

    def __init__(self, monkeypatch):
        self.now = 1000.0
        for name in ("perf_counter", "monotonic", "time"):
            monkeypatch.setattr(time, name, lambda: self.now)

    def tick(self, dt):
        self.now += dt


def _ledger_calls(mod, clock, rsl):
    """One call sequence into ``mod.GoodputLedger``: a compile, a
    checkpoint window with a nested retry, two step loops, reconciles,
    the close; returns (the document, the report)."""
    clock.now = 1000.0
    led = mod.GoodputLedger(enabled=True, rsl_path=rsl, rank=0, world=1)
    clock.tick(0.5)
    led.add("compile", 0.5)
    for epoch in range(2):
        led.begin_steps()
        prev = clock.now
        for step in range(3):
            clock.tick(0.01 * (step + 1))           # waiting on the loader
            t0 = clock.now
            clock.tick(0.1)                         # the step's dispatch
            led.step(clock.now - t0, t0 - prev)
            prev = clock.now
        led.end_steps()
        with led.timed("compute"):
            clock.tick(0.05)
        with led.timed("ckpt_blocking"):
            clock.tick(0.2)
            led.add("retry_backoff", 0.05)
        clock.tick(0.03)                            # unattributed
        led.reconcile(epoch)
    clock.tick(0.07)
    led.close()
    doc = json.load(open(os.path.join(rsl, "goodput.json")))
    return doc, mod.report(rsl)


def test_goodput_ledger_equals_jax(tmp_path, monkeypatch):
    clock = FakeClock(monkeypatch)
    ours = _ledger_calls(goodput, clock, str(tmp_path / "port"))
    theirs = _ledger_calls(jax_goodput, clock, str(tmp_path / "jax"))
    assert ours[0] == theirs[0]
    assert ours[1].replace(str(tmp_path / "port"), "R") == \
        theirs[1].replace(str(tmp_path / "jax"), "R")
    cats = ours[0]["categories"]
    assert cats["retry_backoff"] == pytest.approx(0.1)
    assert sum(cats.values()) == pytest.approx(ours[0]["wall_s"])


# step times: a window of 8 steady steps, jitter, one straggler, a slow
# loader, then a retry burst
STEPS = ([0.10, 0.11, 0.10, 0.09, 0.10, 0.11, 0.10, 0.10, 0.12, 0.10,
          0.95, 0.10, 0.10, 0.11, 0.10]
         + [0.10] * 6 + [0.70, 0.10, 0.10])
WAITS = {21: 0.6}
RETRIES = {18: 4}


def _judged(mod):
    det = mod.AnomalyDetector(trace_dir="/nonexistent", window=8,
                              max_captures=0)
    out = []
    for i, step_s in enumerate(STEPS):
        for _ in range(RETRIES.get(i, 0)):
            det.note_retry()
        trig = det.observe_step(epoch=0, step=i, step_s=step_s,
                                wait_s=WAITS.get(i, 0.0))
        if trig is not None:
            out.append((i, trig))
    return out, det.anomalies


def test_anomaly_detector_triggers_as_jax():
    ours = _judged(flightrec)
    assert ours == _judged(jax_flightrec)
    assert [t for _, t in ours[0]] == ["step_time", "retry_burst",
                                       "step_time"]


def test_an_anomaly_capture_on_the_cpu(tmp_path):
    """A straggler trips the port's detector: a torch.profiler capture of
    the next steps lands with its manifest, the roofline reads it with
    --from-anomaly, and the JAX reader loads the recorder's dump."""
    rsl = str(tmp_path)
    rec = flightrec.FlightRecorder(enabled=True, rsl_path=rsl, rank=0)
    det = flightrec.attach_detector(
        rec, trace_dir=os.path.join(rsl, "anomaly_traces"), window=4,
        capture_steps=2, max_captures=1, min_excess_s=0.0)
    a = torch.randn(32, 32)
    for i, step_s in enumerate([0.01] * 5 + [1.0] + [0.01] * 4):
        a = a @ a.t() / 32
        flightrec.observe_step(rec, epoch=0, step=i, step_s=step_s)
    rec.close()
    capture = os.path.join(rsl, "anomaly_traces", "capture-0")
    manifest = json.load(open(os.path.join(capture, "manifest.json")))
    assert (manifest["step"], manifest["trigger"]["trigger"]) == \
        (5, "step_time")
    assert det.captures_started == 1
    assert roofline.anomaly_capture_dirs(rsl) == [capture]
    text = roofline.run_cli(rsl, from_anomaly=True, emit_events=False)
    assert "anomaly capture 0: trigger step_time at epoch 0 step 5" in text
    dumps = jax_flightrec.load_dumps(rsl)
    assert dumps == flightrec.load_dumps(rsl)
    names = [r.get("name") for r in dumps[0]["records"]
             if r["kind"] == "event"]
    assert names == ["anomaly"]
    assert sum(r["kind"] == "step" for r in dumps[0]["records"]) == 10


def test_the_exporter_answers_a_burst_of_scrapes(tmp_path):
    """The listener's backlog is sized: 64 connections opened at once are
    all answered (socketserver's backlog of 5 resets some)."""
    tel = telemetry.configure(str(tmp_path), True, rank=0)
    goodput.configure(str(tmp_path), True)
    exp = goodput.start_exporter(0, rank=0, world_size_fn=lambda: 3)
    try:
        assert exp._server.request_queue_size == goodput.EXPORTER_BACKLOG
        tel.gauge("throughput/mfu").set(0.25)
        tel.histogram("step/dispatch_s").observe(0.01)
        exp.note_step()
        port = exp.port
        socks = [socket.create_connection(("127.0.0.1", port), timeout=10)
                 for _ in range(64)]
        answers = []

        def ask(s):
            s.sendall(b"GET /metrics HTTP/1.0\r\n\r\n")
            answers.append(s.makefile("rb").read())
            s.close()

        threads = [threading.Thread(target=ask, args=(s,)) for s in socks]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert len(answers) == 64
        assert all(b"dpt_throughput_mfu 0.25" in a for a in answers)
        health = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{port}/healthz", timeout=10).read())
        assert (health["status"], health["world_size"]) == ("ok", 3)
        assert health["last_step_age_s"] is not None
    finally:
        goodput.stop_exporter()
        goodput.get().close()
        tel.close()


FLAGS = ["--telemetry", "--profile", "--aot-warmup", "--anomaly-capture"]


def _argv(tmp, rsl, *extra):
    return ["train", "-d", str(tmp / "data"), "--rsl_path", str(tmp / rsl),
            "--model", "vit", "--attention", "flash", "--device", "cpu",
            "--debug", "--synthetic-fallback", "-e", "2", "-b", "128", *extra]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The flagged vit flash train (its exporter scraped while it runs)
    and the plain one, on the CPU."""
    tmp = tmp_path_factory.mktemp("obs")
    port = _free_port()
    scraped = {}
    done = threading.Event()

    def scrape():
        while not done.is_set() and len(scraped) < 2:
            for path in ("/metrics", "/healthz"):
                try:
                    scraped.setdefault(path, urllib.request.urlopen(
                        f"http://127.0.0.1:{port}{path}",
                        timeout=2).read().decode())
                except OSError:
                    pass
            time.sleep(0.05)

    thread = threading.Thread(target=scrape, daemon=True)
    thread.start()
    try:
        flagged = tcli.main(_argv(tmp, "flagged", *FLAGS, "--metrics-port",
                                  str(port)))
    finally:
        done.set()
        thread.join(10)
    plain = tcli.main(_argv(tmp, "plain"))
    return tmp, (flagged, plain), scraped


def _lines(path):
    keep = re.compile(r"\| (Loss|Acc)|mean train loss|launches")
    return [line.split(" - ")[-1] for line in open(path)
            if keep.search(line)]


def test_the_flagged_run_equals_the_plain_one(runs):
    tmp, rcs, scraped = runs
    assert rcs == (0, 0)
    flagged, plain = tmp / "flagged", tmp / "plain"
    assert _lines(flagged / "test.log") == _lines(plain / "test.log")
    assert len(_lines(flagged / "test.log")) > 8
    assert (flagged / "checkpoint-mnist-vit-001.ckpt").read_bytes() == \
        (plain / "checkpoint-mnist-vit-001.ckpt").read_bytes()
    # the flight recorder is on by default, in both
    assert sorted(os.listdir(plain)) == [
        "bestmodel-mnist-vit.ckpt", "checkpoint-mnist-vit-001.ckpt",
        "ckpt-lineage.json", "flightrec-rank0.json", "test.log"]
    assert {"costs.json", "goodput.json", "roofline.json", "trace",
            "telemetry"} <= set(os.listdir(flagged))
    assert "dpt_up 1" in scraped.get("/metrics", "")
    assert json.loads(scraped.get("/healthz", "{}")).get("status") == "ok"


def test_jax_readers_agree_with_the_port_on_its_run(runs):
    tmp, _, _ = runs
    rsl = str(tmp / "flagged")
    assert jax_telemetry.report(rsl) == telemetry.report(rsl)
    assert json.loads(jax_telemetry.json_report(rsl)) == \
        json.loads(telemetry.json_report(rsl))
    assert jax_goodput.report(rsl) == goodput.report(rsl)
    assert jax_flightrec.load_dumps(rsl) == flightrec.load_dumps(rsl)
    ours, theirs = timeline.build_timeline(rsl), \
        jax_timeline.build_timeline(rsl)
    assert json.dumps(ours, sort_keys=True, default=float) == \
        json.dumps(theirs, sort_keys=True, default=float)


def test_the_run_records_its_costs_gauges_and_roofline(runs):
    tmp, _, _ = runs
    rsl = tmp / "flagged"
    events = [json.loads(line) for line in
              open(rsl / "telemetry" / "rank0.jsonl")]
    gauges = {e["name"]: e for e in events if e["kind"] == "gauge"}
    assert gauges["compile/cache_hit"]["value"] == 1.0   # nothing to build
    assert gauges["compile/warmup_s"]["value"] > 0
    mfu = gauges["throughput/mfu"]
    assert mfu["value"] is None
    assert mfu["attrs"] == {"epoch": 1, "peak_dtype": "bf16",
                            "reason": "unknown_peak"}
    costs = json.loads((rsl / "costs.json").read_text())["programs"]
    per_sample = costs["train_flops_per_sample"]["flops_per_sample"]
    assert per_sample == 247_776_768
    assert costs["train_step"]["flops"] == 128 * per_sample
    assert costs["flash_fwd_mma_kernel"]["shape"] == [128, 49, 4, 32]
    assert {"flash_dq_kernel", "flash_dkv_mma_kernel"} <= set(costs)
    rep = json.loads((rsl / "roofline.json").read_text())
    assert rep["n_ops"] > 10 and 0 < rep["coverage"] <= 1
    assert rep["ops"][0]["module"] == "cpu"
    hists = [e for e in events if e["kind"] == "histogram"]
    assert [h["name"] for h in hists] == ["step/dispatch_s"]
    assert hists[0]["count"] == 4
    assert any(e["name"] == "roofline" for e in events
               if e["kind"] == "event")


@pytest.mark.parametrize("action", ["telemetry", "goodput", "timeline",
                                    "roofline"])
def test_the_offline_subcommands_read_the_run(runs, action, capsys):
    tmp, _, _ = runs
    assert tcli.main([action, "--rsl_path", str(tmp / "flagged")]) == 0
    assert capsys.readouterr().out.strip()
    assert tcli.main([action, "--rsl_path", str(tmp / "nothing")]) == 1


def test_test_takes_the_flags(runs):
    """``test`` takes the flags and ignores --profile, --aot-warmup and
    --metrics-port, as the JAX test does; its flight record is dumped."""
    tmp, _, _ = runs
    argv = ["test", "-d", str(tmp / "data"), "--rsl_path",
            str(tmp / "test"), "--device", "cpu", "--debug",
            "--synthetic-fallback", "-b", "128", "-f",
            str(tmp / "plain" / "bestmodel-mnist-vit.ckpt"), "--telemetry",
            *FLAGS[1:], "--metrics-port", "1"]
    assert tcli.main(argv) == 0
    names = set(os.listdir(tmp / "test"))
    assert {"flightrec-rank0.json", "goodput.json", "telemetry"} <= names
    assert not {"trace", "costs.json"} & names


def test_serve_still_refuses_the_exporter_and_the_recorder():
    """Named when serve refused them: serve now takes --metrics-port,
    --flightrec/--no-flightrec and --flightrec-ring (a replica's exporter
    and flight recorder), with the JAX serve parser's defaults and
    values."""
    from distributedpytorch_tpu.config import config_from_argv as jax_argv

    base = ["serve", "-d", "/d", "-f", "/c"]
    for extra in ([], ["--metrics-port", "1"], ["--no-flightrec"],
                  ["--flightrec", "--flightrec-ring", "64"]):
        got = tconfig.config_from_argv(base + ["--device", "cpu", *extra])
        want = jax_argv(base + extra)
        assert (got.metrics_port, got.flightrec, got.flightrec_ring) == \
            (want.metrics_port, want.flightrec, want.flightrec_ring)
