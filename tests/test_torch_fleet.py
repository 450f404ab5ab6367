"""The port's copies of the fleet's observability plane held against the
JAX package's modules on the same inputs, the cases of JAX
``tests/test_slo.py`` and ``tests/test_fleet.py``:

  * ``slo``: ``validate_spec``'s one-line errors, ``load_spec``, and
    ``evaluate`` over the burn-rate, quantile and share windows (the
    verdicts equal), ``windowed_quantile`` and ``incidents_report``;
  * ``fleet``: ``parse_metrics`` of rendered text and of a port
    exporter's own ``/metrics`` (the JAX parser reads the same series),
    ``merge_targets``, ``render_fleet_metrics``, and the collector
    against fake rank exporters, the JAX one and the port's side by side
    (the same alive sets, merged series and incident bundle); its
    listener's backlog; ``run_cli``'s clean exit on a bad spec;
  * ``deadline``: ``fetch``, ``fetch_json`` and ``post_json`` against a
    live server and a closed port, as the JAX helpers answer;
  * the ``fleet`` and ``incidents`` subcommands' flags and defaults
    against the JAX parser's."""

import http.server
import json
import random
import socket
import threading
import time
import urllib.request

import numpy as np
import pytest

from distributedpytorch_tpu import deadline as jax_deadline
from distributedpytorch_tpu import fleet as jax_fleet
from distributedpytorch_tpu import slo as jax_slo
from distributedpytorch_tpu import telemetry as jax_telemetry
from distributedpytorch_tpu.config import config_from_argv as jax_argv
from distributedpytorch_tpu_torch import config as tconfig
from distributedpytorch_tpu_torch import (deadline, fleet, goodput, slo,
                                          telemetry)

ERROR_SLO = {
    "name": "serve-errors", "kind": "ratio",
    "bad": "dpt_serve_failed_total", "total": "dpt_serve_requests_total",
    "target": 0.99,
    "windows": [{"seconds": 10, "burn": 2.0}, {"seconds": 60, "burn": 1.0}]}
QUANTILE_SLO = {"name": "p95", "kind": "quantile",
                "series": "dpt_serve_request_latency_ms", "q": 0.95,
                "max": 100.0, "windows": [{"seconds": 10}]}
SHARE_SLO = {"name": "compute-share", "kind": "share",
             "category": "compute", "min": 0.5,
             "windows": [{"seconds": 30}]}


def _sample(t, bad=0.0, total=0.0, extra=None, hists=None):
    counters = {"dpt_serve_failed_total": bad,
                "dpt_serve_requests_total": total}
    counters.update(extra or {})
    return {"t": float(t), "counters": counters, "histograms": hists or {}}


def _hist_state(values):
    h = telemetry.Histogram("x")
    for v in values:
        h.observe(v)
    return {"count": h.count, "sum": h.sum, "min": h.min, "max": h.max,
            "nonpos": h._nonpos, "buckets": dict(h._buckets)}


def _gp(compute, other):
    return {'dpt_goodput_seconds_total{category="compute"}': compute,
            'dpt_goodput_seconds_total{category="input_wait"}': other}


def _windows():
    """(spec, samples) of each JAX test_slo.py evaluation case."""
    burning = [_sample(t, bad=5.0 * i, total=50.0 * i)
               for i, t in enumerate(range(0, 70, 5))]
    last = burning[-1]["counters"]
    recovered = burning + [
        _sample(burning[-1]["t"] + dt, bad=last["dpt_serve_failed_total"],
                total=last["dpt_serve_requests_total"] + 10.0 * dt)
        for dt in range(5, 125, 5)]
    lat = "dpt_serve_request_latency_ms"
    return {
        "fast_burn": (ERROR_SLO, [_sample(t, bad=10.0 * i, total=100.0 * i)
                                  for i, t in enumerate(range(0, 70, 5))]),
        "slow_burn": (ERROR_SLO, [_sample(0), _sample(5, 30, 100),
                                  _sample(30, 30, 500), _sample(55, 30, 900),
                                  _sample(60, 30, 1000)]),
        "burning": (ERROR_SLO, burning),
        "recovered": (ERROR_SLO, recovered),
        "no_traffic": (ERROR_SLO, []),
        "one_sample": (ERROR_SLO, [_sample(0, 5, 10)]),
        "idle": (ERROR_SLO, [_sample(t, 7.0, 7.0) for t in range(0, 70, 5)]),
        "quantile_recovers": (QUANTILE_SLO, [
            _sample(0, hists={lat: _hist_state([500.0] * 100)}),
            _sample(20, hists={lat: _hist_state([500.0] * 100
                                                + [10.0] * 100)})]),
        "quantile_fires": (QUANTILE_SLO, [
            _sample(0, hists={lat: _hist_state([10.0] * 100)}),
            _sample(20, hists={lat: _hist_state([10.0] * 100
                                                + [500.0] * 100)})]),
        "share_healthy": (SHARE_SLO, [_sample(0, extra=_gp(0, 0)),
                                      _sample(35, extra=_gp(30, 5))]),
        "share_starved": (SHARE_SLO, [_sample(0, extra=_gp(0, 0)),
                                      _sample(35, extra=_gp(5, 30))]),
        "all_three": (None, burning),
    }


@pytest.mark.parametrize("case", list(_windows()))
def test_evaluate_equals_jax(case):
    spec, samples = _windows()[case]
    specs = [ERROR_SLO, QUANTILE_SLO, SHARE_SLO] if spec is None else [spec]
    slos = slo.validate_spec({"slos": specs})
    assert slos == jax_slo.validate_spec({"slos": specs})
    got = slo.evaluate(slos, samples)
    assert got == jax_slo.evaluate(slos, json.loads(json.dumps(samples)))
    assert len(got) == len(specs)


def test_windowed_quantile_equals_jax():
    lat = "dpt_serve_request_latency_ms"
    rng = np.random.default_rng(3)
    first = rng.lognormal(3.0, 1.0, 500).tolist()
    second = first + rng.lognormal(5.0, 0.3, 200).tolist()
    samples = [_sample(0, hists={lat: _hist_state(first)}),
               _sample(20, hists={lat: _hist_state(second)})]
    for q in (0.5, 0.95, 0.99):
        for seconds in (10.0, 30.0):
            assert slo.windowed_quantile(samples, lat, q, seconds) == \
                jax_slo.windowed_quantile(samples, lat, q, seconds)


SPEC_ERRORS = [
    ("no_name", lambda s: s.pop("name")),
    ("bad_name", lambda s: s.update(name="bad name!")),
    ("kind", lambda s: s.update(kind="nope")),
    ("windows", lambda s: s.update(windows=[])),
    ("seconds", lambda s: s.update(windows=[{"seconds": -1}])),
    ("burn", lambda s: s.update(windows=[{"seconds": 5}])),
    ("bad", lambda s: s.pop("bad")),
    ("target", lambda s: s.update(target=1.5)),
    ("duplicate", None), ("empty", None), ("not_object", None),
]


def _spec_error(mod, case, mutate):
    if case == "duplicate":
        doc = {"slos": [ERROR_SLO, ERROR_SLO]}
    elif case == "empty":
        doc = {"slos": []}
    elif case == "not_object":
        doc = ["not", "an", "object"]
    else:
        spec = json.loads(json.dumps(ERROR_SLO))
        mutate(spec)
        doc = {"slos": [spec]}
    with pytest.raises(ValueError) as e:
        mod.validate_spec(doc)
    return str(e.value)


@pytest.mark.parametrize("case,mutate", SPEC_ERRORS,
                         ids=[c for c, _ in SPEC_ERRORS])
def test_validate_spec_errors_equal_jax(case, mutate):
    msg = _spec_error(slo, case, mutate)
    assert msg == _spec_error(jax_slo, case, mutate)
    assert "\n" not in msg


def test_load_spec_and_incidents_report_equal_jax(tmp_path):
    p = tmp_path / "slo.json"
    p.write_text("{ not json")
    for mod in (slo, jax_slo):
        with pytest.raises(ValueError, match="slo.json"):
            mod.load_spec(str(p))
    p.write_text(json.dumps({"slos": [ERROR_SLO]}))
    assert slo.load_spec(str(p)) == jax_slo.load_spec(str(p))
    assert slo.incidents_report(str(tmp_path)) == \
        jax_slo.incidents_report(str(tmp_path))
    bundle = {"kind": "incident", "slo": "serve-errors", "slo_kind": "ratio",
              "cycle": 7,
              "windows": [{"seconds": 10, "value": 12.0, "threshold": 2.0,
                           "t_start": 1.0, "t_end": 11.0}],
              "suspect_ranks": [1],
              "offending_requests": ["r1-000004", "r1-000005"],
              "healthz": {"0": {"status": "ok"}, "1": None}}
    (tmp_path / "incident-001-serve-errors.json").write_text(
        json.dumps(bundle))
    text = slo.incidents_report(str(tmp_path))
    assert text == jax_slo.incidents_report(str(tmp_path))
    assert "r1-000004" in text and "(down)" in text


# -- fleet: parsing, merging, rendering ---------------------------------

def _sketch(mod, values):
    h = mod.Histogram("dpt_lat_ms")
    for v in values:
        h.observe(v)
    return h


def _rank_text(requests, failed, latencies):
    """One rank's /metrics body in the exporter's exposition shape,
    rendered by the JAX package's renderer."""
    merged = {
        "counters": {"dpt_serve_requests_total": float(requests),
                     "dpt_serve_failed_total": float(failed),
                     'dpt_goodput_seconds_total{category="compute"}': 2.0},
        "gauges": {"dpt_serve_queue_depth": 1.0},
        "histograms": {"dpt_serve_request_latency_ms":
                       _sketch(jax_telemetry, latencies)}}
    return jax_fleet.render_fleet_metrics(merged, 1)


def test_parse_merge_render_equal_jax():
    rng = random.Random(3)
    va = [rng.lognormvariate(3.0, 1.0) for _ in range(2000)] + [0.0, -1.0]
    vb = [rng.lognormvariate(4.0, 0.5) for _ in range(1000)]
    texts = [_rank_text(100, 5, va), _rank_text(50, 0, vb)]
    got = [fleet.parse_metrics(t) for t in texts]
    assert got == [jax_fleet.parse_metrics(t) for t in texts]
    merged = fleet.merge_targets(got)
    want = jax_fleet.merge_targets(got)
    assert merged["counters"] == want["counters"]
    assert merged["gauges"] == want["gauges"]
    for name, h in merged["histograms"].items():
        w = want["histograms"][name]
        assert (h.count, h.sum, h.min, h.max, h._nonpos, h._buckets) == \
            (w.count, w.sum, w.min, w.max, w._nonpos, w._buckets)
        pooled = _sketch(telemetry, va + vb)
        assert h.count == pooled.count
        for q in (0.5, 0.95, 0.99):
            assert h.quantile(q) == w.quantile(q)
            assert h.quantile(q) == pytest.approx(pooled.quantile(q),
                                                  rel=1e-9)
    for alive in (0, 2):
        assert fleet.render_fleet_metrics(merged, alive) == \
            jax_fleet.render_fleet_metrics(want, alive)
    assert "dpt_up" not in fleet.merge_targets(
        [{"gauges": {"dpt_up": 1.0}}])["gauges"]


def test_port_exporter_text_parses_as_jax_parses_it(tmp_path):
    """The port's own /metrics (telemetry counters, gauges, histograms
    and goodput categories of a port process): the JAX collector's parser
    and the port's read the same series."""
    tel = telemetry.configure(str(tmp_path), True, rank=0)
    goodput.configure(str(tmp_path), True)
    exp = goodput.start_exporter(0, rank=0)
    try:
        tel.counter("serve/requests").add(7)
        tel.counter("serve/failed").add(2)
        tel.gauge("serve/queue_depth").set(3)
        tel.gauge("kernel/flash_fwd_launches").set(48)
        for v in (0.5, 2.0, 30.0, 250.0):
            tel.histogram("serve/request_latency_ms").observe(v)
        with goodput.get().timed("compute"):
            pass
        text = urllib.request.urlopen(
            f"http://127.0.0.1:{exp.port}/metrics", timeout=10).read(
            ).decode()
    finally:
        goodput.stop_exporter()
        goodput.get().close()
        tel.close()
    got = fleet.parse_metrics(text)
    assert got == jax_fleet.parse_metrics(text)
    assert got["counters"]["dpt_serve_requests_total"] == 7
    assert got["counters"]["dpt_serve_failed_total"] == 2
    assert got["gauges"]["dpt_kernel_flash_fwd_launches"] == 48
    assert got["histograms"]["dpt_serve_request_latency_ms"]["count"] == 4
    assert 'dpt_goodput_seconds_total{category="compute"}' in \
        got["counters"]


# -- fleet: the collector against fake exporters ------------------------

class _FakeExporter:
    """A stand-in rank: serves a mutable /metrics body and /healthz."""

    def __init__(self, rank, port=0):
        self.rank = rank
        self.requests, self.failed = 0.0, 0.0
        outer = self

        class _H(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 - http.server API
                if self.path.startswith("/metrics"):
                    body = _rank_text(outer.requests, outer.failed,
                                      [5.0]).encode()
                elif self.path.startswith("/healthz"):
                    body = json.dumps({"status": "ok",
                                       "rank": outer.rank}).encode()
                else:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, fmt, *args):
                pass

        self.server = http.server.ThreadingHTTPServer(("127.0.0.1", port),
                                                      _H)
        self.port = self.server.server_address[1]
        self.server.daemon_threads = True
        threading.Thread(target=self.server.serve_forever,
                         daemon=True).start()

    def close(self):
        self.server.shutdown()
        self.server.server_close()


def _collectors(tmp_path, exps, **kw):
    """The JAX collector and the port's, each aimed at the same fake
    exporters (their ephemeral ports patched in per target), each writing
    to its own directory."""
    out = []
    for mod, sub in ((jax_fleet, "jax"), (fleet, "port")):
        (tmp_path / sub).mkdir(exist_ok=True)
        args = dict(rsl_path=str(tmp_path / sub), ranks=len(exps),
                    metrics_port=0, interval_s=0.1, stale_after=2, port=0,
                    max_cycles=0)
        args.update(kw)
        coll = mod.FleetCollector(**args)
        for t, e in zip(coll._targets, exps):
            t.port = e.port
        out.append(coll)
    return out


def _view(sample):
    """A cycle's sample without its clocks."""
    return {k: v for k, v in sample.items()
            if k not in ("ts", "mono", "t", "verdicts")}


def test_collectors_scrape_age_out_and_rejoin_as_jax(tmp_path):
    exps = [_FakeExporter(0), _FakeExporter(1)]
    exps[0].requests, exps[1].requests = 30.0, 12.0
    colls = _collectors(tmp_path, exps)
    try:
        views = []
        for step in range(4):
            if step == 1:
                exps[1].close()             # the rank dies
            if step == 3:
                exps[1] = _FakeExporter(1)  # a joiner on a fresh port
                for c in colls:
                    c._targets[1].port = exps[1].port
            views.append([_view(c.scrape_once()) for c in colls])
        for jax_view, port_view in views:
            assert port_view == jax_view
        assert [v[1]["alive"] for v in views] == [[0, 1], [0, 1], [0],
                                                  [0, 1]]
        assert views[0][1]["counters"]["dpt_serve_requests_total"] == 42.0
    finally:
        for c in colls:
            c.close()
        for e in exps:
            e.close()
    lines = [json.loads(ln) for ln in
             (tmp_path / "port" / "fleet-metrics.jsonl").read_text()
             .splitlines()]
    assert [s["cycle"] for s in lines] == [1, 2, 3, 4]


def test_collectors_write_the_same_incident_as_jax(tmp_path):
    now = time.time()
    spec = dict(ERROR_SLO, windows=[{"seconds": 0.2, "burn": 2.0},
                                    {"seconds": 0.6, "burn": 1.0}])
    for sub in ("jax", "port"):
        (tmp_path / sub).mkdir()
        with open(tmp_path / sub / "trace-rank1.jsonl", "w") as f:
            for seq, outcome in ((4, "failed"), (5, "failed"),
                                 (6, "answered")):
                f.write(json.dumps({
                    "kind": "request", "id": "r1-%06d" % seq, "seq": seq,
                    "rank": 1, "status": 500 if outcome == "failed" else 200,
                    "outcome": outcome, "spans": {}, "total_s": 0.0,
                    "ts": now, "mono": 0.0, "ts_admit": now,
                    "mono_admit": 0.0}) + "\n")
    exps = [_FakeExporter(0), _FakeExporter(1)]
    colls = _collectors(tmp_path, exps,
                        slos=slo.validate_spec({"slos": [spec]}))
    try:
        for step in range(10):
            if step == 2:           # rank 1 starts failing hard
                exps[0].requests = exps[1].requests = 100.0
                exps[1].failed = 50.0
            for c in colls:
                c.scrape_once()
            time.sleep(0.1)
        assert [c.incidents_written for c in colls] == [1, 1]
    finally:
        for c in colls:
            c.close()
        for e in exps:
            e.close()
    bundles = [slo.load_incidents(str(tmp_path / sub))
               for sub in ("jax", "port")]
    [want], [got] = bundles
    for b in (want, got):
        b.pop("ts")
        for w in b["windows"]:
            for k in ("t_start", "t_end", "value"):
                w.pop(k, None)
    assert got == want
    assert got["suspect_ranks"] == [1]
    assert got["offending_requests"] == ["r1-000004", "r1-000005"]


def test_collector_answers_a_burst_of_pollers(tmp_path):
    """The re-export listener's backlog is sized (the JAX collector keeps
    socketserver's 5): 64 connections opened at once are all answered."""
    coll = fleet.FleetCollector(str(tmp_path), 1, 1, port=0)
    coll.start()
    try:
        assert coll._server.request_queue_size == fleet.FLEET_BACKLOG
        socks = [socket.create_connection(("127.0.0.1", coll.port),
                                          timeout=10) for _ in range(64)]
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
        assert all(a.endswith(b"dpt_up 0\n") for a in answers)
    finally:
        coll.close()


def test_run_cli_bad_spec_is_a_clean_exit_as_in_jax(tmp_path, capsys):
    from distributedpytorch_tpu.config import Config as JaxConfig

    bad = tmp_path / "slo.json"
    bad.write_text(json.dumps({"slos": [{"name": "x"}]}))
    kw = dict(action="fleet", rsl_path=str(tmp_path), metrics_port=1,
              fleet_ranks=1, fleet_port=0, fleet_interval=0.05,
              fleet_stale_after=1, fleet_max_cycles=1, slo_spec=str(bad))
    assert jax_fleet.run_cli(JaxConfig(**kw)) == 2
    want = capsys.readouterr().out
    assert fleet.run_cli(tconfig.Config(**kw)) == 2
    assert capsys.readouterr().out == want


def test_run_cli_runs_its_cycles(tmp_path, capsys):
    exp = _FakeExporter(0)
    try:
        cfg = tconfig.config_from_argv(
            ["fleet", "--rsl_path", str(tmp_path), "--metrics-port",
             str(exp.port), "--fleet-port", "0", "--interval", "0.05",
             "--max-cycles", "3"])
        assert fleet.run_cli(cfg) == 0
    finally:
        exp.close()
    out = capsys.readouterr().out
    assert "stopped after 3 cycle(s); last view had 1 alive rank(s); 0 " \
           "incident(s) written" in out


# -- deadline -------------------------------------------------------------

def test_deadline_helpers_answer_as_jax():
    class _H(http.server.BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 - http.server API
            body = b'{"ok": true}' if self.path == "/j" else b"[1]"
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_POST(self):  # noqa: N802 - http.server API
            n = int(self.headers.get("Content-Length", 0))
            doc = json.loads(self.rfile.read(n))
            code = 200 if doc.get("ok") else 409
            body = json.dumps({"echo": doc}).encode()
            self.send_response(code)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *args):
            pass

    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _H)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        closed = s.getsockname()[1]
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        for mod in (deadline, jax_deadline):
            assert mod.fetch(base + "/j", 5.0) == '{"ok": true}'
            assert mod.fetch_json(base + "/j", 5.0) == {"ok": True}
            assert mod.fetch_json(base + "/l", 5.0) is None
            assert mod.fetch(f"http://127.0.0.1:{closed}/", 1.0) is None
            spent = mod.Deadline(0.0)
            assert spent.expired() and mod.fetch(base + "/j", 5.0,
                                                 deadline=spent) is None
            assert mod.Deadline(10.0).bound(2.0) == 2.0
            assert mod.post_json(base + "/p", {"ok": 1}, 5.0) == \
                (200, {"echo": {"ok": 1}})
            assert mod.post_json(base + "/p", {}, 5.0) == (409, {"echo": {}})
            assert mod.post_json(f"http://127.0.0.1:{closed}/", {}, 1.0) \
                == (0, {})
    finally:
        server.shutdown()
        server.server_close()


# -- the subcommands' flags ---------------------------------------------

FLEET_FLAGS = {"metrics_port": (["--metrics-port", "9300"], 9300),
               "fleet_ranks": (["--ranks", "4"], 4),
               "fleet_port": (["--fleet-port", "0"], 0),
               "fleet_interval": (["--interval", "0.5"], 0.5),
               "fleet_stale_after": (["--stale-after", "5"], 5),
               "fleet_max_cycles": (["--max-cycles", "7"], 7),
               "slo_spec": (["--slo-spec", "s.json"], "s.json")}


def test_fleet_and_incidents_flags_parse_with_jax_defaults():
    want = jax_argv(["fleet"])
    cfg = tconfig.config_from_argv(["fleet"])
    for field, (extra, value) in FLEET_FLAGS.items():
        assert getattr(cfg, field) == getattr(want, field), field
        got = tconfig.config_from_argv(["fleet"] + extra)
        assert getattr(got, field) == value == getattr(
            jax_argv(["fleet"] + extra), field)
    assert cfg.rsl_path == want.rsl_path
    inc = tconfig.config_from_argv(["incidents", "--rsl_path", "/r"])
    assert (inc.action, inc.rsl_path) == ("incidents", "/r") == \
        (jax_argv(["incidents", "--rsl_path", "/r"]).action, "/r")
