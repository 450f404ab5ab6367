"""The port's fleet simulator (``sim/``), held against the JAX package's:

  * for the same scenario, seed, size and latency model, ``run_scenario``
    returns an equal report, with an equal ``event_log_sha256``, in both
    packages: ``control`` at N = 10, ``chaos`` at its full N = 100 and 180
    virtual seconds (a few seconds of CPU each), and ``burst`` under a
    latency-model file;
  * the port's chaos artifacts parse through the port's live readers, as
    JAX ``scripts/sim_gate.py`` stage C holds the JAX ones:
    ``telemetry.aggregate`` with zero skipped records,
    ``tracing.reconcile`` with no torn chain over 1000+ records,
    ``goodput.report``, ``timeline.build_timeline`` over 100+ ranks and
    ``slo.incidents_report`` naming the designed incident;
  * the ``sim`` subcommand prints the report, and refuses an unknown
    scenario with exit code 1."""

import contextlib
import io
import json
import os

import pytest

from distributedpytorch_tpu.sim import runner as jax_runner
from distributedpytorch_tpu_torch import (cli, goodput, slo, telemetry,
                                          timeline, tracing)
from distributedpytorch_tpu_torch.sim import runner

SEED = 7
MODEL = {"version": 1, "provenance": {"source": "a test's model"},
         "quantities": {
             "infer_base_s": {"min": 0.2, "p50": 0.4, "p90": 0.6,
                              "p95": 0.7, "p99": 0.9, "max": 1.2},
             "respond_s": {"min": 0.001, "p50": 0.002, "p90": 0.004,
                           "p95": 0.005, "p99": 0.008, "max": 0.02}}}


@pytest.fixture(scope="module")
def chaos_dir(tmp_path_factory):
    """The port's chaos run with its artifacts written, and its report."""
    rsl = str(tmp_path_factory.mktemp("chaos"))
    return rsl, runner.run_scenario("chaos", seed=SEED, rsl_path=rsl)


@pytest.mark.parametrize("case", ("control", "chaos", "burst_model"))
def test_report_and_event_log_equal_jax(case, tmp_path):
    kw = {"seed": SEED}
    name = case
    if case == "control":
        kw["replicas"] = 10
    if case == "burst_model":
        name = "burst"
        kw["model_path"] = str(tmp_path / "model.json")
        with open(kw["model_path"], "w") as f:
            json.dump(MODEL, f)
    want = jax_runner.run_scenario(name, **kw)
    got = runner.run_scenario(name, **kw)
    assert got == want
    assert len(got["event_log_sha256"]) == 64
    if case == "control":
        assert got["scale"]["actions"] == 0 and got["incidents"] == []
    if case == "burst_model":
        assert got["latency_model_provenance"]["source"] == "a test's model"


def test_written_artifacts_keep_the_replay(chaos_dir):
    """Writing the artifacts changes no byte of the replay: the report
    written equals one replayed without a disk, and a second seed
    replays another log."""
    rsl, report = chaos_dir
    assert report == runner.run_scenario("chaos", seed=SEED)
    with open(os.path.join(rsl, "sim-report.json")) as f:
        assert json.load(f)["event_log_sha256"] == report["event_log_sha256"]
    assert runner.run_scenario("control", seed=SEED + 1)[
        "event_log_sha256"] != runner.run_scenario(
        "control", seed=SEED)["event_log_sha256"]
    assert report["incidents"] == ["availability"]
    assert report["rollout_outcome"] == "promote"
    assert report["requests"]["dropped_forever"] == 0


def test_artifacts_parse_through_the_port_readers(chaos_dir):
    rsl, report = chaos_dir
    events = telemetry.load_events(os.path.join(rsl, "telemetry"))
    agg = telemetry.aggregate(events)
    assert agg.get("skipped_events", 0) == 0 and len(agg["ranks"]) >= 100
    records = tracing.load_records(rsl)
    assert len(records) >= 1000
    assert tracing.reconcile(records) == []
    assert "wall-clock attribution" in goodput.report(rsl)
    assert len(timeline.build_timeline(rsl)["ranks"]) >= 100
    assert "availability" in slo.incidents_report(rsl)


def test_sim_cli_prints_the_report(tmp_path):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["sim", "--scenario", "control", "--replicas", "10",
                       "--seed", str(SEED), "--rsl_path", str(tmp_path)])
    assert rc == 0
    assert json.loads(out.getvalue()) == runner.run_scenario(
        "control", seed=SEED, replicas=10)
    assert os.path.exists(tmp_path / "sim-events.jsonl")
    assert cli.main(["sim", "--scenario", "no-such-scenario",
                     "--rsl_path", str(tmp_path)]) == 1
