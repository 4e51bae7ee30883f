"""ServeFront: async continuous-batching frontend over any Engine — the
port of ``repro/serving/server.py`` (stdlib only; the engine it drives is
the port's).

The engine is a library — ``submit``/``step`` must be driven by a caller's
loop, which is fine for benchmarks and useless for traffic. ServeFront is
the missing producer/consumer split (the nano-vLLM shape, SNIPPETS §1):

  * producers call ``add_request`` from any thread (or the HTTP handler
    below) and get back a ``RequestHandle`` that streams tokens as they
    are sampled — a blocking iterator for sync consumers, ``atokens()``
    for async ones;
  * ONE consumer loop thread steps the engine whenever work is pending
    and pumps each request's new tokens into its handle between steps;
  * cancellation (client disconnect) is immediate and lock-free on the
    caller's side — ``handle.cancel()`` flips the engine's per-request
    flags and the next step's sweep returns every KV block the request
    held (within one step, tested in tests/test_torch_server.py);
  * backpressure: a bounded number of live handles — ``add_request``
    blocks (with optional timeout) instead of growing the queue without
    bound, and ``close`` wakes every blocked producer.

Because every data plane (resident, streamed dense) rides the same Engine
API, one frontend serves both; prefix caching (serving/prefix.py) composes
transparently — admission happens inside ``Engine.submit``/``step`` as
usual.

The step loop runs under runtime/fault.py's ``FaultTolerantExecutor``: a
faulted step — a typed ``StoreFault`` escaping the
weight stream, injected chaos, a device error — retries per policy, and
a PERSISTENT fault fails only the affected requests (structured
``finish_reason="error"``) while the server keeps serving. Per-request
deadlines (``max_time_s`` -> ``finish_reason="timeout"``) and an
optional step watchdog bound tail latency.

The HTTP layer is stdlib-only: ``POST /v1/generate``
streams Server-Sent Events (one ``data: {"token": N}`` frame per token,
a final ``data: {"finish_reason": ...}`` frame, then ``data: [DONE]``),
``GET /v1/stats`` reports engine/front/prefix/stream telemetry, ``GET /v1/health`` distills the fault counters into
ok/degraded (200) or dead/closed (503). A broken client socket
mid-stream triggers the cancellation path — the serving analogue of the
paper's claim that the host orchestration layer, not the accelerator,
decides whether the flash/DRAM tiers are kept busy.
"""
from __future__ import annotations

import asyncio
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from repro_torch import obs
from repro_torch.runtime.fault import FaultPolicy, FaultTolerantExecutor

_DONE = object()                 # stream terminator sentinel


class RequestHandle:
    """Per-request streaming handle. The loop thread pushes sampled
    tokens onto a thread-safe queue; consumers drain it without ever
    touching the engine. ``tokens`` accumulates the full output (the
    ``result()`` view); the queue is the incremental one.

    ``finish_reason`` (set before the stream terminates) is the
    structured outcome: "length" (served to max_new — the engine has no
    stop-token path, so every natural completion is a length finish),
    "cancelled" (client disconnect), "timeout" (per-request deadline),
    or "error" (a persistently-faulted step failed this request)."""

    def __init__(self, front: "ServeFront", rid: int,
                 deadline: float | None = None):
        self._front = front
        self.rid = rid
        self.tokens: list[int] = []
        self.cancelled = False
        self.finish_reason: str | None = None
        self.deadline = deadline         # monotonic; None = no deadline
        self._q: queue.Queue = queue.Queue()
        self._done = threading.Event()
        # request lifecycle timing (ObsPlane): TTFT = t_first - t_submit,
        # TPOT = (t_finish - t_first) / (n - 1), E2E = t_finish - t_submit
        self.t_submit = time.monotonic()
        self.t_first: float | None = None
        self._t0_pc = time.perf_counter()    # tracer-domain submit time
        self._finish_mu = threading.Lock()

    # --- loop-thread side -----------------------------------------------------

    def _push(self, toks):
        for t in toks:
            self.tokens.append(int(t))
            self._q.put(int(t))

    def _finish(self):
        # finishers race (loop pump vs a consumer's cancel vs fault
        # sweeps): the lock elects ONE winner, so the finish-reason
        # counter and latency histograms observe each request exactly once
        with self._finish_mu:
            if self._done.is_set():
                return
            self._front._observe_finish(self)
            self._done.set()
        self._q.put(_DONE)

    # --- consumer side --------------------------------------------------------

    @property
    def done(self) -> bool:
        return self._done.is_set()

    def __iter__(self):
        """Blocking per-token stream (sync consumers, the SSE handler)."""
        while True:
            t = self._q.get()
            if t is _DONE:
                return
            yield t

    async def atokens(self):
        """Async per-token stream; the blocking queue get rides the event
        loop's default thread-pool executor."""
        loop = asyncio.get_running_loop()
        while True:
            t = await loop.run_in_executor(None, self._q.get)
            if t is _DONE:
                return
            yield t

    def result(self, timeout: float | None = None) -> list[int]:
        """Block until the request completes; the full output tokens."""
        if not self._done.wait(timeout):
            raise TimeoutError(f"request {self.rid} still generating")
        return list(self.tokens)

    def cancel(self) -> bool:
        """Disconnect: stop generating and release the request's KV
        blocks (next step's sweep). Lock-free — never blocks behind a
        running step — and immediately terminates the token stream."""
        if self.done or self.cancelled:
            return False
        self.cancelled = True
        if self.finish_reason is None:
            self.finish_reason = "cancelled"
        self._front._cancel(self)
        return True


class ServeFront:
    """The continuous-batching frontend: producer intake + one consumer
    step-loop thread over a single Engine (any plane)."""

    def __init__(self, engine, max_waiting: int = 64,
                 poll_s: float = 0.05,
                 fault_policy: FaultPolicy | None = None,
                 step_fault_hook=None,
                 registry: "obs.MetricsRegistry | None" = None):
        self.engine = engine
        self.max_waiting = max_waiting
        self._poll_s = poll_s
        self._handles: dict[int, RequestHandle] = {}
        self._progress: dict[int, int] = {}      # rid -> tokens pumped
        self._mu = threading.Lock()
        self._cv = threading.Condition(self._mu)
        self._wake = threading.Event()
        self._closed = False
        self._close_lock = threading.Lock()
        self._close_done = False
        self.error: BaseException | None = None
        self.n_finished = 0
        self.n_cancelled = 0
        self.n_timeout = 0
        self.step_faults = 0            # persistent faults (requests failed)
        self.requests_failed = 0
        self.last_fault: str | None = None
        # ObsPlane: request-lifecycle histograms + finish-reason counter,
        # and ONE scrape-time collector pulling every subsystem's counters
        # (registered here, unregistered in close() — a bare Engine never
        # registers, so tests that build engines don't leak collectors)
        self.obs = registry if registry is not None else obs.default_registry()
        self._h_ttft = self.obs.histogram(
            "serve_ttft_seconds", "request submit -> first sampled token")
        self._h_tpot = self.obs.histogram(
            "serve_tpot_seconds",
            "mean inter-token interval per finished request")
        self._h_e2e = self.obs.histogram(
            "serve_e2e_seconds", "request submit -> stream finish")
        self._c_finish = self.obs.counter(
            "serve_finish_total", "finished request streams by outcome",
            label_names=("reason",))
        self.obs.register_collector(self._obs_collect)
        # loop-thread-maintained plane-stats snapshot: /v1/stats and
        # /v1/health read THIS dict (an atomic reference swap), never the
        # locked `*_stats()` accessors — a scrape must not wait behind a
        # weight upload held by an in-flight step
        self._telemetry: dict = self._plane_stats()
        self._tel_t = time.monotonic()
        if fault_policy is None:
            # serving defaults: ANY engine exception is a retryable step
            # fault (a typed StoreFault from the weight stream included),
            # and straggler detection is effectively off — serving step
            # times legitimately vary by orders of magnitude between idle
            # polls, prefill bursts and single-token decode, so the
            # training loop's trailing-median heuristic would fire
            # spuriously. A watchdog is opt-in via FaultPolicy.timeout_s.
            fault_policy = FaultPolicy(max_retries=2, retry_on=(Exception,),
                                       straggler_tolerance=10 ** 9)
        self._ftx = FaultTolerantExecutor(self._engine_step, fault_policy,
                                          fault_hook=step_fault_hook)
        self._step_no = 0
        self._loop = threading.Thread(target=self._run, daemon=True,
                                      name="servefront-loop")
        self._loop.start()

    # --- producer side --------------------------------------------------------

    def add_request(self, prompt, max_new: int = 16,
                    timeout: float | None = None,
                    max_time_s: float | None = None) -> RequestHandle:
        """Thread-safe intake. Blocks while ``max_waiting`` handles are
        live (backpressure — the frontend's bound, enforced HERE so the
        loop thread never blocks inside ``Engine.submit``); raises
        TimeoutError past ``timeout`` and RuntimeError once closed.
        ``max_time_s`` is a per-request serving deadline: a request still
        generating past it is cancelled by the loop thread and finishes
        with ``finish_reason="timeout"`` (tokens sampled so far kept)."""
        wait_deadline = (None if timeout is None
                         else time.monotonic() + timeout)
        with self._cv:
            while len(self._handles) >= self.max_waiting \
                    and not self._closed:
                remaining = None
                if wait_deadline is not None:
                    remaining = wait_deadline - time.monotonic()
                    if remaining <= 0:
                        raise TimeoutError(
                            "add_request: server at capacity "
                            f"(max_waiting={self.max_waiting})")
                self._cv.wait(remaining)
            if self._closed:
                raise RuntimeError("add_request: server is closed"
                                   + (f" ({self.error!r})" if self.error
                                      else ""))
            rid = self.engine.submit(list(prompt), max_new=max_new)
            h = RequestHandle(self, rid,
                              deadline=(None if max_time_s is None
                                        else time.monotonic() + max_time_s))
            self._handles[rid] = h
            self._progress[rid] = 0
        self._wake.set()
        return h

    def _cancel(self, h: RequestHandle):
        # lock-free on purpose: called from disconnect handlers that must
        # never wait behind a running compiled step.
        self.engine.cancel(h.rid)
        self.n_cancelled += 1
        h._finish()                     # terminate the stream NOW
        self._wake.set()                # let the loop sweep the slot

    # --- consumer loop --------------------------------------------------------

    def _work_pending(self) -> bool:
        eng = self.engine
        return (bool(eng.waiting) or bool(eng.pool.active)
                or any(not r.done for r in eng.requests.values()))

    def _pump(self):
        """Forward each request's newly sampled tokens into its handle,
        finish handles whose requests completed, and drop fully-drained
        bookkeeping (``Engine.forget`` refuses until the slot is swept,
        so a cancelled-mid-step rid simply retries next pump)."""
        drained = []
        with self._mu:
            for rid, h in self._handles.items():
                req = self.engine.requests.get(rid)
                if req is None:                  # already forgotten
                    if h.finish_reason is None:
                        h.finish_reason = "error"
                    h._finish()
                    drained.append(rid)
                    continue
                if not h.cancelled and not h.done:
                    out = req.out
                    prog = self._progress[rid]
                    if len(out) > prog:
                        if h.t_first is None:
                            h.t_first = time.monotonic()
                            self._h_ttft.observe(h.t_first - h.t_submit)
                        h._push(out[prog:len(out)])
                        self._progress[rid] = len(out)
                if req.done:
                    if not h.done:
                        if req.cancelled:
                            h.cancelled = True   # engine-side cancel
                            if h.finish_reason is None:
                                h.finish_reason = "cancelled"
                        else:
                            self.n_finished += 1
                            if h.finish_reason is None:
                                # no stop-token path: natural completion
                                # is always a length finish
                                h.finish_reason = "length"
                        h._finish()
                    if self.engine.forget(rid):
                        drained.append(rid)
            for rid in drained:
                self._handles.pop(rid, None)
                self._progress.pop(rid, None)
            if drained:
                self._cv.notify_all()            # backpressure slots freed

    def _engine_step(self):
        return self.engine.step()

    def _observe_finish(self, h: RequestHandle):
        """Request-lifecycle observation, called exactly once per handle
        by the ``_finish`` winner (any thread). Must never raise — it sits
        on the fault-sweep and teardown paths."""
        try:
            now = time.monotonic()
            reason = h.finish_reason or "length"
            self._c_finish.inc(1.0, labels={"reason": reason})
            self._h_e2e.observe(now - h.t_submit)
            if h.t_first is not None and len(h.tokens) > 1:
                self._h_tpot.observe((now - h.t_first)
                                     / (len(h.tokens) - 1))
            tracer = obs.default_tracer()
            if tracer.enabled:
                tracer.complete(f"req{h.rid}", h._t0_pc,
                                time.perf_counter() - h._t0_pc,
                                tid=tracer.request_tid(h.rid),
                                cat="request",
                                args={"reason": reason,
                                      "tokens": len(h.tokens)})
        except Exception:                # noqa: BLE001 - observation only
            pass

    def _obs_collect(self):
        """Scrape-time collector: frontend counters + every counter the
        wrapped engine's subsystems expose (lock-free reads throughout)."""
        yield obs.Sample("serve_live_handles", "gauge",
                     float(len(self._handles)))
        yield obs.Sample("serve_requests_finished_total", "counter",
                     float(self.n_finished))
        yield obs.Sample("serve_requests_cancelled_total", "counter",
                     float(self.n_cancelled))
        yield obs.Sample("serve_requests_timeout_total", "counter",
                     float(self.n_timeout))
        yield obs.Sample("serve_step_faults_total", "counter",
                     float(self.step_faults))
        yield obs.Sample("serve_step_retries_total", "counter",
                     float(self._ftx.n_retries))
        yield obs.Sample("serve_requests_failed_total", "counter",
                     float(self.requests_failed))
        yield from self.engine.obs_samples()

    def _plane_stats(self) -> dict:
        """Plane-specific telemetry in the /v1/stats shape (prefix keys
        top-level, ``stream``/``experts``/``spec`` nested). Takes the
        streamer/pool locks — loop thread (or construction time) ONLY."""
        eng = self.engine
        out = dict(eng.prefix_stats(strict=False))
        stream = eng.stream_stats(strict=False)
        if stream:
            out["stream"] = stream
            if getattr(eng, "streamed_moe", False):
                out["experts"] = eng.expert_stats(strict=False)
        spec = eng.spec_stats(strict=False)
        if spec:
            out["spec"] = spec
        return out

    def _refresh_telemetry(self, force: bool = False):
        """Swap in a fresh plane-stats snapshot. Throttled: expert/stream
        stats aggregate over the step history, so refreshing every step
        would grow per-step cost with run length; the end-of-burst refresh
        (``force``) keeps the snapshot exact whenever the engine idles."""
        now = time.monotonic()
        if force or now - self._tel_t >= 0.1:
            self._telemetry = self._plane_stats()
            self._tel_t = now

    def _run(self):
        while True:
            stepped = False
            try:
                if self._work_pending():
                    # step under the fault executor: transient faults
                    # (StoreFault from the weight stream, injected chaos,
                    # device hiccups) retry per policy; a watchdog (if
                    # armed) abandons hung steps. Only a PERSISTENT fault
                    # escapes to the handler below.
                    self._ftx.run_step(self._step_no)
                    self._step_no += 1
                    stepped = True
                self._pump()
                self._sweep_deadlines()
                if stepped:
                    self._refresh_telemetry(force=not self._work_pending())
            except Exception as e:
                # persistently-faulted step: fail the AFFECTED requests
                # with finish_reason="error" and keep serving — the
                # engine's own step-top sweep (pure host code, runs before
                # the compiled path) reclaims their KV blocks next step.
                self._survive_fault(e)
            except BaseException as e:           # interpreter teardown,
                self._fail(e)                    # interrupts: fail fast
                return
            with self._mu:
                if self._closed and not self._handles \
                        and not self._work_pending():
                    return
            if not stepped:
                self._wake.wait(timeout=self._poll_s)
                self._wake.clear()

    def _survive_fault(self, e: Exception):
        """A step faulted past its retry budget. Production degradation:
        the requests in flight are the blast radius — fail them with a
        structured ``finish_reason="error"`` (their consumers unblock
        immediately) — but the SERVER survives: intake stays open and the
        next request batch is served normally. Recovery converges because
        ``Engine.step`` sweeps cancelled slots before touching the
        compiled path, and an empty plan short-circuits entirely."""
        self.step_faults += 1
        self.last_fault = repr(e)
        failed = 0
        with self._cv:
            for rid, h in self._handles.items():
                if h.done:
                    continue
                h.finish_reason = "error"
                h.cancelled = True
                self.engine.cancel(rid)
                self.requests_failed += 1
                failed += 1
                h._finish()
            if failed:
                self._cv.notify_all()
        if failed:
            self._wake.set()    # let the next step sweep their KV blocks

    def _sweep_deadlines(self):
        """Cancel requests generating past their ``max_time_s`` deadline
        (``finish_reason="timeout"``; tokens sampled so far kept)."""
        now = time.monotonic()
        hit = False
        with self._cv:
            for rid, h in self._handles.items():
                if h.done or h.deadline is None or now < h.deadline:
                    continue
                h.finish_reason = "timeout"
                h.cancelled = True
                self.engine.cancel(rid)
                self.n_timeout += 1
                h._finish()
                hit = True
            if hit:
                self._cv.notify_all()
        if hit:
            self._wake.set()

    def _fail(self, e: BaseException):
        with self._cv:
            self.error = e
            self._closed = True
            for h in self._handles.values():
                if h.finish_reason is None:
                    h.finish_reason = "error"
                h._finish()
            self._handles.clear()
            self._progress.clear()
            self._cv.notify_all()

    # --- lifecycle / telemetry ------------------------------------------------

    def close(self, drain: bool = True, timeout: float | None = None):
        """Stop intake and shut the loop down. ``drain=True`` serves every
        live request to completion first; ``drain=False`` cancels them
        (their KV blocks come back through the final sweep). Idempotent
        and thread-safe: exactly one caller performs the shutdown, every
        other (concurrent or later) call returns immediately without
        re-joining or re-raising (regression-tested in
        tests/test_torch_server.py). Also closes the engine (blocked
        submitters)."""
        with self._close_lock:
            if self._close_done:
                return
            self._close_done = True
        with self._cv:
            self._closed = True
            if not drain:
                for h in list(self._handles.values()):
                    if not (h.done or h.cancelled):
                        h.cancelled = True
                        if h.finish_reason is None:
                            h.finish_reason = "cancelled"
                        self.engine.cancel(h.rid)
                        self.n_cancelled += 1
                        h._finish()
            self._cv.notify_all()
        self._wake.set()
        self._loop.join(timeout)
        self.engine.close()
        self._refresh_telemetry(force=True)   # final exact snapshot
        self.obs.unregister_collector(self._obs_collect)
        if self.error is not None:
            raise RuntimeError("serve loop failed") from self.error

    def stats(self) -> dict:
        """One merged telemetry dict for GET /v1/stats: frontend counters
        + engine queue/pool state + whichever plane-specific stats the
        wrapped engine exposes. NON-BLOCKING by construction: every read
        here is a lock-free attribute read or the loop-thread-maintained
        ``_telemetry`` snapshot — this never waits behind a device step or
        a weight upload holding the streamer/pool locks."""
        eng = self.engine
        out = {
            "live_handles": len(self._handles),
            "waiting": len(eng.waiting),
            "running": len(eng.pool.active),
            "finished": self.n_finished,
            "cancelled": self.n_cancelled,
            "steps": eng._steps_done,
            "free_kv_blocks": len(eng.pool.free_blocks),
            "step_traces": eng.step_traces,
            "closed": self._closed,
            "timeouts": self.n_timeout,
            "step_faults": self.step_faults,
            "step_retries": self._ftx.n_retries,
            "step_watchdog": self._ftx.n_watchdog,
            "requests_failed": self.requests_failed,
            "last_fault": self.last_fault,
        }
        out.update(self._telemetry)
        return out

    def metrics_text(self) -> str:
        """Prometheus 0.0.4 exposition for GET /v1/metrics. Collector
        reads are lock-free by the ``obs_samples`` contract, so scraping
        mid-step is safe."""
        return self.obs.expose()

    def health(self) -> tuple[int, dict]:
        """(http_code, payload) for GET /v1/health. "ok" means no fault
        counter has ever ticked; "degraded" (still 200 — the server IS
        serving) means the fault plane absorbed damage: corrected-on-
        retry UECC pages, relocations, DRAM fallbacks, streamer fetch
        faults, step retries, or failed/timed-out requests. 503 once the
        step loop is dead or the frontend is closed."""
        counters = {
            "step_faults": self.step_faults,
            "step_retries": self._ftx.n_retries,
            "step_watchdog": self._ftx.n_watchdog,
            "requests_failed": self.requests_failed,
            "timeouts": self.n_timeout,
        }
        # the loop-thread snapshot, NOT the locked accessors: health must
        # answer even while a step holds the streamer/pool locks
        s = self._telemetry.get("stream", {})
        for k in ("uecc_detected", "read_retries", "relocations",
                  "degraded_pages", "dram_fallback_reads",
                  "fetch_retries", "fetch_faults",
                  "prefetch_failures"):
            if k in s:
                counters[k] = s[k]
        if self.error is not None or not self._loop.is_alive():
            status, code = "dead", 503
        elif self._closed:
            status, code = "closed", 503
        elif any(counters.values()):
            status, code = "degraded", 200
        else:
            status, code = "ok", 200
        return code, {"status": status, "last_fault": self.last_fault,
                      **counters}


# --- stdlib HTTP frontend -----------------------------------------------------


def make_http_server(front: ServeFront, port: int = 8000,
                     host: str = "127.0.0.1") -> ThreadingHTTPServer:
    """Bind the frontend to a threading stdlib HTTP server (one handler
    thread per connection; ``port=0`` picks a free port — the bound one
    is ``server.server_address[1]``). Caller runs ``serve_forever`` in a
    thread and ``shutdown()``s it on exit.

      POST /v1/generate  {"prompt": [ids], "max_new": N, "stream": true,
                          "max_time_s": S}
          -> SSE: one ``data: {"token": t}`` frame per sampled token, a
             final ``data: {"finish_reason": r}`` frame, then
             ``data: [DONE]``; ``"stream": false`` -> one JSON body with
             tokens + finish_reason.
          A broken client socket mid-stream cancels the request (KV
          blocks back on the free list within one step).
      GET  /v1/stats     -> ServeFront.stats() as JSON.
      GET  /v1/health    -> ServeFront.health(): 200 ok/degraded while
          serving (degraded = fault counters nonzero), 503 dead/closed.
      GET  /v1/metrics   -> Prometheus 0.0.4 text exposition (ObsPlane
          registry: TTFT/TPOT/E2E histograms, finish-reason counters,
          engine step-phase timings, NAND/stream/pool/expert/fault
          counters). Lock-free scrape — safe mid-step.
    """

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *args):            # keep test output clean
            pass

        def _json(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/v1/stats":
                self._json(200, front.stats())
            elif self.path == "/v1/health":
                code, payload = front.health()
                self._json(code, payload)
            elif self.path == "/v1/metrics":
                body = front.metrics_text().encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4; "
                                 "charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self.send_error(404)

        def do_POST(self):
            if self.path != "/v1/generate":
                self.send_error(404)
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(n) or b"{}")
                prompt = [int(t) for t in payload["prompt"]]
                max_new = int(payload.get("max_new", 16))
                stream = bool(payload.get("stream", True))
                timeout = payload.get("timeout")
                max_time_s = payload.get("max_time_s")
            except (KeyError, TypeError, ValueError):
                self.send_error(400, "bad request body")
                return
            try:
                h = front.add_request(prompt, max_new=max_new,
                                      timeout=timeout,
                                      max_time_s=max_time_s)
            except TimeoutError:
                self.send_error(503, "server at capacity")
                return
            except (RuntimeError, ValueError) as e:
                self.send_error(400, str(e))
                return
            if not stream:
                toks = h.result()
                self._json(200, {"rid": h.rid, "tokens": toks,
                                 "finish_reason": h.finish_reason})
                return
            self.close_connection = True
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Connection", "close")
            self.end_headers()
            try:
                for t in h:
                    frame = json.dumps({"token": int(t)})
                    self.wfile.write(f"data: {frame}\n\n".encode())
                    self.wfile.flush()
                tail = json.dumps({"finish_reason": h.finish_reason})
                self.wfile.write(f"data: {tail}\n\n".encode())
                self.wfile.write(b"data: [DONE]\n\n")
                self.wfile.flush()
            except (BrokenPipeError, ConnectionResetError, OSError):
                # client went away mid-stream: the cancellation path —
                # flags flip now, the next step's sweep frees the KV
                h.cancel()

    server = ThreadingHTTPServer((host, port), Handler)
    server.front = front
    return server
