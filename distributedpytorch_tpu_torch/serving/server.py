"""The serving replica: HTTP front end + micro-batch dispatcher loop.

A copy of ``distributedpytorch_tpu/serving/server.py`` (:68-480); its
``faults``/``telemetry``/``tracing`` imports are the port's copies, and
its listener sizes its accept backlog to the batcher's queue.

Handler threads (ThreadingHTTPServer) parse and validate a request,
``admit()`` it into the bounded micro-batcher (503 on refusal) and block
on the request's event.  The dispatcher thread (``run()``, the caller's
thread) is the only one that touches the device: it coalesces pending
requests into the largest ready bucket (batcher.py), pads to the bucket
size, calls the injected ``infer_fn``, fans the results back out, and
ticks the elastic health boundary between batches.

``infer_fn`` is injected (a closure over the predict step, built in
cli.run_serve), so this module stays framework-free.  Elastic contract:
``run()`` lets ``WorldChangedError`` (raised by the injected
``health_fn``) propagate after the current batch resolved, so the caller
can reconfigure the world, rebuild the predict step, ``set_infer()`` it
and call ``run()`` again; the listener and the queued requests (host-side
numpy) persist across the reconfigure.

``POST /admin/drain`` starts a graceful retirement.  ``POST /admin/reload
{"checkpoint": PATH}`` is the hot-swap: the handler parks a swap request,
and the dispatcher applies it between batches through the injected
``swap_fn(path) -> (infer_fn, lineage_info)`` (built in cli.run_serve), so
the predict step is replaced with no listener restart and no mid-batch
tear; without a ``swap_fn`` it answers 501.  ``stats()`` is the ``/livez``
body and the exporter's ``/healthz`` ``serve`` block, with the served
checkpoint's lineage.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np

from .. import faults, telemetry, tracing
from .batcher import MicroBatcher, Request

# Dispatcher poll granularity: the upper bound on how stale a shutdown /
# health check can go while the queue is empty.
_TICK_S = 0.25


class ServingTier:
    """One replica: owns the listener, the batcher, and the dispatcher loop."""

    def __init__(self, infer_fn: Callable[[np.ndarray], Tuple],
                 sample_shape: Sequence[int], sample_dtype,
                 buckets: Sequence[int], max_queue: int,
                 max_latency_s: float, port: int,
                 request_timeout_s: float = 30.0,
                 max_requests: int = 0):
        self._infer = infer_fn
        self.sample_shape = tuple(int(d) for d in sample_shape)
        self.sample_dtype = np.dtype(sample_dtype)
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        self.port = int(port)
        self.request_timeout_s = float(request_timeout_s)
        self.max_requests = int(max_requests)
        self.batcher = MicroBatcher(self.buckets, max_queue, max_latency_s)
        self.answered = 0        # dispatcher thread only
        self.checkpoint: Optional[dict] = None  # lineage of the served ckpt
        self._stop = threading.Event()
        self._draining = threading.Event()
        self._swap_fn: Optional[Callable[[str], Tuple]] = None
        self._swap_lock = threading.Lock()
        self._pending_swap: Optional[dict] = None
        self.swap_timeout_s = 180.0
        self._server = None
        self._http_thread = None
        # /predict handlers still running: each writes its trace record
        # after its answer, and close() waits for them
        self._handlers = 0
        self._handlers_idle = threading.Condition()

    # -- lifecycle -----------------------------------------------------

    def start(self) -> None:
        """Bind the port and start answering.  The listener outlives
        elastic reconfigures — only close() takes it down."""
        import http.server

        tier = self

        class _Handler(http.server.BaseHTTPRequestHandler):
            def do_POST(self):  # noqa: N802 - http.server API
                path = self.path.rstrip("/")
                if path == "/admin/drain":
                    tier.drain()
                    tier._respond(self, 200, {"draining": True,
                                              "queue_depth":
                                                  tier.batcher.depth()})
                    return
                if path == "/admin/reload":
                    try:
                        tier._handle_reload(self)
                    # broad on purpose: a reload failure must become
                    # the caller's 500, never take the listener down
                    except Exception as e:
                        logging.error(f"serve: reload handler "
                                      f"failed: {e}")
                        try:
                            tier._respond(self, 500,
                                          {"error": repr(e)})
                        except Exception:
                            pass  # caller already gone mid-answer
                    return
                if path != "/predict":
                    self.send_error(404)
                    return
                with tier._handlers_idle:
                    tier._handlers += 1
                try:
                    tier._handle_predict(self)
                except BrokenPipeError:
                    pass  # client gave up; its timeout, not our crash
                except Exception as e:
                    # A handler bug must answer THIS request and never
                    # take the listener thread down with it.
                    logging.error(f"serve: request handler failed: {e}")
                    try:
                        tier._respond(self, 500, {"error": repr(e)})
                    # broad on purpose: the 500 above is best-effort —
                    # if the socket is already gone there is nobody
                    # left to answer, and raising would kill the
                    # listener thread for everyone else
                    except Exception:
                        pass
                finally:
                    with tier._handlers_idle:
                        tier._handlers -= 1
                        tier._handlers_idle.notify_all()

            def do_GET(self):  # noqa: N802 - http.server API
                if self.path.rstrip("/") == "/livez":
                    tier._respond(self, 200, tier.stats())
                else:
                    self.send_error(404)

            def log_message(self, fmt, *args):
                pass  # per-request lines would drown the run log

        class _Listener(http.server.ThreadingHTTPServer):
            # The accept backlog holds a whole queue's worth of burst:
            # at socketserver's default of 5, a burst of concurrent
            # connects is reset by the kernel before admit() can answer
            # it (a 503 is the backpressure answer, a reset is not).
            request_queue_size = max(5, tier.batcher.max_queue)

        self._server = _Listener(("0.0.0.0", self.port), _Handler)
        self.port = self._server.server_address[1]  # resolve port=0
        self._server.daemon_threads = True
        self._http_thread = threading.Thread(
            target=self._server.serve_forever,
            kwargs={"poll_interval": 0.25},
            name="serve-listener", daemon=True)
        self._http_thread.start()
        logging.info(
            f"serve: listening on :{self.port} "
            f"(buckets {list(self.buckets)}, queue bound "
            f"{self.batcher.max_queue}, flush "
            f"{self.batcher.max_latency_s * 1000:.0f}ms)")

    def set_infer(self, infer_fn: Callable[[np.ndarray], Tuple]) -> None:
        """Swap the predict step (post-reconfigure rebuild)."""
        self._infer = infer_fn

    def set_checkpoint(self, info: Optional[dict]) -> None:
        """Record the served checkpoint's lineage (sha256/epoch/path) —
        surfaced on /livez and the exporter /healthz serve block, the
        identity the front door's canary verdict compares."""
        self.checkpoint = info

    def set_swap_fn(self, fn: Callable[[str], Tuple]) -> None:
        """Install the hot-swap function: ``fn(path) -> (infer_fn,
        lineage_info)`` — rebuilds the predict closure for a new
        checkpoint (restore + warmup).  Without one, /admin/reload
        answers 501."""
        self._swap_fn = fn

    def drain(self) -> None:
        """Graceful retirement: stop admitting, flush in-flight, let
        run() return once the queue is empty.  Idempotent."""
        if not self._draining.is_set():
            logging.info("serve: draining — admissions closed, "
                         "flushing the queue")
            telemetry.get().event("serve/drain_start",
                                  queue_depth=self.batcher.depth())
        self._draining.set()

    def stop(self) -> None:
        """Ask the dispatcher loop to exit at the next boundary."""
        self._stop.set()

    def close(self) -> None:
        """Stop the listener and answer every still-queued request with
        a shutdown error — a draining tier never leaves a client
        hanging on a request it silently dropped."""
        self._stop.set()
        for req in self.batcher.close():
            req.fail(RuntimeError("server shutting down"))
        server, self._server = self._server, None
        if server is not None:
            server.shutdown()
            server.server_close()
            self._http_thread.join(timeout=5.0)
        # the handlers of the last batch write their trace records after
        # their answers: let them, before the caller closes the trace file
        with self._handlers_idle:
            self._handlers_idle.wait_for(lambda: self._handlers == 0,
                                         timeout=5.0)

    # -- handler side (HTTP threads) ----------------------------------

    def _respond(self, handler, code: int, payload: dict,
                 req_id: Optional[str] = None) -> None:
        body = json.dumps(payload).encode("utf-8")
        handler.send_response(code)
        handler.send_header("Content-Type", "application/json")
        if req_id is not None:
            handler.send_header("X-DPT-Request-Id", req_id)
        handler.send_header("Content-Length", str(len(body)))
        handler.end_headers()
        handler.wfile.write(body)

    def _handle_reload(self, handler) -> None:
        """The /admin/reload endpoint: park a swap request for the
        dispatcher thread and wait for it to apply between batches."""
        if self._swap_fn is None:
            # the JAX body but for its parenthesis, which names the JAX
            # package's history
            self._respond(handler, 501,
                          {"error": "no swap_fn installed "
                                    "(stub tier or a replica without "
                                    "hot-swap)"})
            return
        try:
            n = int(handler.headers.get("Content-Length", 0))
            doc = json.loads(handler.rfile.read(n) or b"{}")
            path = doc["checkpoint"]
        except (KeyError, TypeError, ValueError) as e:
            self._respond(handler, 400,
                          {"error": f"bad reload request: {e}"})
            return
        swap = {"path": str(path), "done": threading.Event(),
                "error": None, "info": None}
        with self._swap_lock:
            if self._pending_swap is not None:
                self._respond(handler, 409,
                              {"error": "a swap is already in flight"})
                return
            self._pending_swap = swap
        if not swap["done"].wait(self.swap_timeout_s):
            self._respond(handler, 504,
                          {"error": f"swap did not apply within "
                                    f"{self.swap_timeout_s:g}s"})
            return
        if swap["error"] is not None:
            self._respond(handler, 500, {"error": swap["error"]})
            return
        self._respond(handler, 200, {"reloaded": True,
                                     "checkpoint": swap["info"]})

    def _handle_predict(self, handler) -> None:
        tel = telemetry.get()
        tel.counter("serve/requests").add()
        if self._draining.is_set():
            # retirement: shed loudly so the front door routes around
            # us while the queue flushes (same 503 contract as full)
            tel.counter("serve/shed").add()
            body = json.dumps({"error": "draining"}).encode("utf-8")
            handler.send_response(503)
            handler.send_header("Content-Type", "application/json")
            handler.send_header("Retry-After", "1")
            handler.send_header("Content-Length", str(len(body)))
            handler.end_headers()
            handler.wfile.write(body)
            return
        try:
            faults.fire("serve.request")
            n = int(handler.headers.get("Content-Length", 0))
            payload = json.loads(handler.rfile.read(n))
            arr = np.asarray(payload["image"], dtype=self.sample_dtype)
        except (KeyError, TypeError, ValueError) as e:
            tel.counter("serve/bad_request").add()
            self._respond(handler, 400, {"error": f"bad request: {e}"})
            return
        except OSError as e:  # injected serve.request ioerror included
            tel.counter("serve/failed").add()
            self._respond(handler, 500, {"error": repr(e)})
            return
        if arr.shape != self.sample_shape:
            tel.counter("serve/bad_request").add()
            self._respond(handler, 400, {
                "error": f"image shape {list(arr.shape)} != expected "
                         f"{list(self.sample_shape)}"})
            return
        # Every valid request gets its deterministic id here; every
        # answer below — 200, 503 shed, 504 timeout, 500 — carries it
        # back as X-DPT-Request-Id, and its terminal record lands in
        # trace-rank<N>.jsonl (tracing.py).
        trace = tracing.get().start()
        rid = trace.id if trace is not None else None
        req = Request(arr, trace=trace)
        try:
            faults.fire("serve.admit")
            admitted = self.batcher.admit(req)
        except OSError as e:
            tel.counter("serve/failed").add()
            self._respond(handler, 500, {"error": repr(e)}, req_id=rid)
            if trace is not None:
                trace.finish(500, "failed", error=repr(e))
            return
        if not admitted:
            # THE backpressure answer: shed now, while the client can
            # still retry elsewhere — a full queue must never grow.
            tel.counter("serve/shed").add()
            depth = self.batcher.depth()
            self._respond(handler, 503, {
                "error": "queue full",
                "queue_depth": depth}, req_id=rid)
            if trace is not None:
                trace.finish(503, "shed", queue_depth=depth)
            return
        if not req.wait(self.request_timeout_s):
            tel.counter("serve/timeout").add()
            self._respond(handler, 504, {"error": "request timed out"},
                          req_id=rid)
            if trace is not None:
                trace.finish(504, "timeout")
            return
        if req.error is not None:
            code = 503 if self._stop.is_set() else 500
            self._respond(handler, code, {"error": repr(req.error)},
                          req_id=rid)
            if trace is not None:
                trace.finish(code, "failed", error=repr(req.error))
            return
        self._respond(handler, 200, req.result, req_id=rid)
        if trace is not None:
            trace.finish(200, "answered")

    # -- dispatcher side (run() caller's thread) --------------------------

    def run(self, health_fn: Optional[Callable[[], bool]] = None,
            health_tick_s: float = 0.5,
            shutdown: Optional[Any] = None) -> int:
        """The micro-batch loop.  Returns the number of requests
        answered when stopped (stop()/close(), a shutdown request, a
        health tick returning True, or --serve-max-requests reached).
        WorldChangedError from ``health_fn`` propagates to the caller's
        elastic loop with the queue intact."""
        tel = telemetry.get()
        next_health = time.monotonic() + health_tick_s
        while not self._stop.is_set():
            if shutdown is not None and getattr(shutdown, "requested",
                                                False) \
                    and health_fn is None:
                break  # single-replica SIGTERM: no agreement needed
            if self.max_requests and self.answered >= self.max_requests:
                break
            if self._draining.is_set() and self.batcher.depth() == 0:
                tel.event("serve/drain_done", answered=self.answered)
                logging.info(f"serve: drained after answering "
                             f"{self.answered} requests")
                break
            self._apply_swap(tel)
            batch = self.batcher.next_batch(_TICK_S)
            if batch is not None:
                self._run_batch(tel, *batch)
            if health_fn is not None \
                    and time.monotonic() >= next_health:
                # Between batches, never mid-dispatch: the boundary's
                # collective must not interleave with a device step.
                if health_fn():
                    break
                next_health = time.monotonic() + health_tick_s
        return self.answered

    def _apply_swap(self, tel) -> None:
        """Dispatcher-thread-only: apply a parked /admin/reload between
        batches.  The swap function runs on the one thread that owns
        dispatch, so the predict step is never replaced mid-batch;
        queued requests wait out the restore and warm-up and are answered
        by the NEW predict step."""
        with self._swap_lock:
            swap = self._pending_swap
        if swap is None:
            return
        try:
            infer_fn, info = self._swap_fn(swap["path"])
            self._infer = infer_fn
            self.checkpoint = info
            tracing.get().set_lineage(
                (info or {}).get("sha256"))
            swap["info"] = info
            tel.event("serve/swap",
                      checkpoint=(info or {}).get("file"),
                      sha=str((info or {}).get("sha256"))[:12],
                      epoch=(info or {}).get("epoch"))
            logging.info(f"serve: hot-swapped to "
                         f"{(info or {}).get('file')} "
                         f"(sha {str((info or {}).get('sha256'))[:12]})")
        # broad on purpose: a bad candidate (torn file, wrong model)
        # must fail THIS reload and leave the serving program untouched
        except Exception as e:
            swap["error"] = repr(e)
            tel.event("serve/swap_failed", path=swap["path"],
                      error=repr(e))
            logging.error(f"serve: hot-swap to {swap['path']!r} "
                          f"failed: {e}")
        finally:
            with self._swap_lock:
                self._pending_swap = None
            swap["done"].set()

    def _run_batch(self, tel, reqs: List[Request], bucket: int) -> None:
        arr = np.zeros((bucket,) + self.sample_shape, self.sample_dtype)
        for i, r in enumerate(reqs):
            arr[i] = r.payload
        for r in reqs:
            if r.trace is not None:
                r.trace.mark_infer_start(bucket)
        t0 = time.perf_counter()
        try:
            faults.fire("serve.infer")
            labels, confs = self._infer(arr)
        except Exception as e:
            # One bad batch (an injected ioerror, a device hiccup) fails
            # ITS requests and the tier keeps serving — dying here would
            # turn a transient into an outage.  The batch's trace records
            # land before serve/failed counts it, so a collector that
            # fires on the counter finds every record of the batch it saw
            # fail (the handler's own finish is then a no-op).
            code = 503 if self._stop.is_set() else 500
            for r in reqs:
                if r.trace is not None:
                    r.trace.mark_infer_end()
                    r.trace.finish(code, "failed", error=repr(e))
            tel.counter("serve/failed").add(len(reqs))
            tel.counter("serve/batches").add()
            self.answered += len(reqs)
            logging.error(f"serve: micro-batch of {len(reqs)} failed: {e}")
            for r in reqs:
                r.fail(e)
            return
        infer_ms = (time.perf_counter() - t0) * 1000.0
        tel.counter("serve/batches").add()
        tel.counter("serve/batch_rows").add(bucket)
        tel.counter("serve/padded_rows").add(bucket - len(reqs))
        tel.histogram("serve/infer_ms").observe(infer_ms)
        tel.gauge("serve/queue_depth").set(self.batcher.depth())
        for i, r in enumerate(reqs):
            latency_ms = r.age_s() * 1000.0
            tel.histogram("serve/request_latency_ms").observe(latency_ms)
            if r.trace is not None:
                r.trace.mark_infer_end()
                r.trace.note_latency(latency_ms)
            r.complete({
                "label": int(labels[i]),
                "confidence": round(float(confs[i]), 6),
                "bucket": bucket,
                "latency_ms": round(latency_ms, 3),
            })
        tel.counter("serve/answered").add(len(reqs))
        self.answered += len(reqs)

    # -- introspection -------------------------------------------------

    def stats(self) -> dict:
        """/livez body + the exporter's extra-health payload.  The
        ``checkpoint`` block (lineage sha256 + epoch + path) is the
        served-model identity the front door's rollout verdict keys
        on; ``draining`` tells it to stop routing here."""
        return {
            "ok": True,
            "queue_depth": self.batcher.depth(),
            "answered": self.answered,
            "buckets": list(self.buckets),
            "port": self.port,
            "draining": self._draining.is_set(),
            "checkpoint": self.checkpoint,
        }
