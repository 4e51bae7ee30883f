"""The port's ServeFront (``serving/server.py``) over the port's CPU engine,
in the ``tests/test_server.py`` scenarios: streams equal to the engine
loop (and to a JAX ServeFront's), the async stream, cancels that reclaim
every KV block, backpressure and close, the HTTP front end to end (SSE,
errors, health, the finish-reason frame), a persistent step fault that
fails its requests while the server survives, and deadlines. The streamed
engine under the forced faults of ``benchmarks/serve_chaos.py`` (a worker
crash escalated to a step retry, an armed store) serves the fault-free
tokens and reports degraded."""
from __future__ import annotations

import asyncio
import http.client
import json
import threading
import time

import jax
import numpy as np
import pytest
import torch

from repro.configs.paper_models import OPT_TINY as J_OPT_TINY
from repro.models import dense as jdense
from repro.serving.engine import Engine as JEngine
from repro.serving.server import ServeFront as JServeFront
from repro_torch import interop
from repro_torch.configs import OPT_TINY
from repro_torch.runtime.fault import FaultPolicy, StepFault
from repro_torch.serving.engine import Engine
from repro_torch.serving.server import ServeFront, make_http_server
from repro_torch.store import PageStore, StreamConfig
from repro_torch.store.faults import FaultConfig, FaultInjector

torch.set_num_threads(2)

MAX_SEQ = 96
BS = 16


@pytest.fixture(scope="module")
def jax_params():
    return jdense.init(J_OPT_TINY, jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def params(jax_params):
    return interop.params_from_numpy(jax.tree.map(np.asarray, jax_params),
                                     device="cpu")


def _engine(params, **kw):
    return Engine(OPT_TINY, params, max_slots=2, max_seq=MAX_SEQ, rber=0.0,
                  device="cpu", **kw)


def _free_and_cached(eng):
    cached = 0 if eng.prefix is None else len(eng.prefix)
    return len(eng.pool.free_blocks) + cached


def _wait_drained(front, eng, timeout=30):
    deadline = time.monotonic() + timeout
    while front.stats()["live_handles"] \
            or _free_and_cached(eng) != eng.pool.n_blocks - 1:
        assert time.monotonic() < deadline, "KV blocks leaked"
        time.sleep(0.01)


# --- ServeFront core -------------------------------------------------------------


def test_front_streams_equal_the_engine_loop_and_the_reference_front(
        params, jax_params):
    ref = _engine(params)
    r1 = ref.submit(list(range(1, 30)), max_new=8)
    r2 = ref.submit([9, 8], max_new=8)
    want = ref.run()
    front = ServeFront(_engine(params))
    h1 = front.add_request(list(range(1, 30)), max_new=8)
    h2 = front.add_request([9, 8], max_new=8)
    assert list(h1) == want[r1]
    assert h2.result(timeout=60) == want[r2]
    assert front.stats()["finished"] == 2
    front.close()
    jfront = JServeFront(JEngine(J_OPT_TINY, jax_params, max_slots=2,
                                 max_seq=MAX_SEQ, rber=0.0))
    j1 = jfront.add_request(list(range(1, 30)), max_new=8)
    j2 = jfront.add_request([9, 8], max_new=8)
    assert [j1.result(timeout=120), j2.result(timeout=120)] == \
        [want[r1], want[r2]]
    jfront.close()


def test_front_async_stream(params):
    ref = _engine(params)
    rid = ref.submit([3, 1, 4, 1, 5], max_new=6)
    want = ref.run()[rid]
    front = ServeFront(_engine(params))
    h = front.add_request([3, 1, 4, 1, 5], max_new=6)

    async def drain():
        return [t async for t in h.atokens()]

    assert asyncio.run(drain()) == want
    front.close()


def test_cancel_mid_generation_reclaims_blocks(params):
    eng = _engine(params)
    total_free = len(eng.pool.free_blocks)
    front = ServeFront(eng)
    h = front.add_request(list(range(1, 40)), max_new=48)
    it = iter(h)
    assert isinstance(next(it), int)
    steps_before = eng._steps_done
    assert h.cancel()
    assert list(it) == []
    deadline = time.monotonic() + 30
    while len(eng.pool.free_blocks) < total_free:
        assert time.monotonic() < deadline, "cancelled KV blocks leaked"
        time.sleep(0.01)
    assert eng._steps_done <= steps_before + 2
    assert not h.cancel()
    st = front.stats()
    assert st["cancelled"] == 1 and st["finished"] == 0
    front.close()


def test_cancel_waiting_request(params):
    eng = _engine(params)
    front = ServeFront(eng, max_waiting=8)
    holders = [front.add_request(list(range(1, 30)), max_new=16)
               for _ in range(2)]
    waiter = front.add_request([5, 6, 7], max_new=16)
    assert waiter.cancel()
    assert list(waiter) == []
    for h in holders:
        h.result(timeout=60)
    assert front.stats()["cancelled"] == 1
    front.close()
    assert len(eng.pool.free_blocks) == eng.pool.n_blocks - 1


def test_front_backpressure_and_close(params):
    front = ServeFront(_engine(params), max_waiting=1)
    h = front.add_request(list(range(1, 30)), max_new=MAX_SEQ - 30)
    with pytest.raises(TimeoutError, match="capacity"):
        front.add_request([1, 2], max_new=4, timeout=0.02)
    h.result(timeout=60)
    h2 = front.add_request([2, 3, 4], max_new=6)
    front.close(drain=True)
    assert h2.done and len(h2.tokens) == 6
    with pytest.raises(RuntimeError, match="closed"):
        front.add_request([1], max_new=1)


def test_front_close_no_drain_cancels(params):
    eng = _engine(params)
    front = ServeFront(eng)
    h = front.add_request(list(range(1, 30)), max_new=64)
    next(iter(h))
    front.close(drain=False)
    assert h.done and len(h.tokens) < 64
    assert len(eng.pool.free_blocks) == eng.pool.n_blocks - 1


def test_close_is_idempotent_and_thread_safe(params):
    front = ServeFront(_engine(params))
    front.add_request([1, 2, 3], max_new=2).result(timeout=60)
    errs = []

    def closer():
        try:
            front.close(drain=True, timeout=60)
        except BaseException as e:       # noqa: BLE001 - recorded
            errs.append(e)

    threads = [threading.Thread(target=closer) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads) and errs == []
    front.close()
    assert front.stats()["closed"]


def test_stress_with_disconnects_prefix_cache_on(params):
    """Concurrent producers, every third request disconnecting mid-stream,
    over the prefix-cached engine: served streams complete, and no KV
    block leaks (free or held by the prefix index)."""
    eng = _engine(params, prefix_cache=True)
    front = ServeFront(eng, max_waiting=16)
    results, errors = [], []

    def producer(pid):
        try:
            for i in range(3):
                prompt = [2] * BS + [(pid * 7 + 3) % 50 + 1 + (i * 13 + j)
                                     % 40 for j in range(9)]
                h = front.add_request(prompt, max_new=8, timeout=120)
                if (pid + i) % 3 == 0:
                    got = []
                    for t in h:
                        got.append(t)
                        h.cancel()
                    results.append(("cancelled", h, got))
                else:
                    results.append(("served", h, list(h)))
        except BaseException as e:       # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=producer, args=(p,))
               for p in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not errors, errors
    assert any(k == "cancelled" for k, _, _ in results)
    for kind, h, got in results:
        if kind == "served":
            assert len(got) == 8 and got == h.tokens
    front.close()
    assert _free_and_cached(eng) == eng.pool.n_blocks - 1
    assert eng.prefix_stats()["prefix_inserted"] > 0


# --- faults: step faults, deadlines, health ------------------------------------


def test_step_fault_fails_requests_but_server_survives(params):
    boom = {"arm": False}

    def hook(step, retries):
        if boom["arm"]:
            raise RuntimeError("injected persistent step fault")

    front = ServeFront(_engine(params), poll_s=0.01,
                       fault_policy=FaultPolicy(
                           max_retries=1, retry_on=(Exception,),
                           straggler_tolerance=10 ** 9),
                       step_fault_hook=hook)
    eng = front.engine
    try:
        h0 = front.add_request([1, 2, 3], max_new=2)
        assert h0.result(timeout=60) and h0.finish_reason == "length"
        assert front.health() == (200, {
            "status": "ok", "last_fault": None, "step_faults": 0,
            "step_retries": 0, "step_watchdog": 0, "requests_failed": 0,
            "timeouts": 0})
        boom["arm"] = True
        h = front.add_request([4, 5, 6], max_new=32)
        h._done.wait(60)
        assert h.done and h.finish_reason == "error"
        assert front.step_faults >= 1 and front.requests_failed == 1
        assert front.stats()["step_retries"] >= 1
        boom["arm"] = False
        h2 = front.add_request([7, 8, 9], max_new=2)
        assert len(h2.result(timeout=60)) == 2
        assert h2.finish_reason == "length"
        _wait_drained(front, eng)
        code, payload = front.health()
        assert code == 200 and payload["status"] == "degraded"
    finally:
        front.close(drain=False)


def test_request_deadline_times_out(params):
    front = ServeFront(_engine(params), poll_s=0.01)
    eng = front.engine
    try:
        h = front.add_request([1, 2, 3], max_new=MAX_SEQ - 4,
                              max_time_s=0.1)
        h._done.wait(60)
        assert h.done and h.finish_reason == "timeout"
        assert front.n_timeout == 1
        _wait_drained(front, eng)
    finally:
        front.close(drain=False)


def test_chaos_on_the_streamed_engine(params):
    """serve_chaos's dense phase at OPT_TINY on the port: an armed store,
    a forced worker crash (two failing fetches -> StoreFault -> a step
    retry), a persistent step fault on a sacrificial request, then a
    recovery request — every other request's tokens equal the fault-free
    front's, no KV block or pool slot leaks, health reports degraded."""
    probe = PageStore()
    Engine(OPT_TINY, params, max_slots=2, max_seq=MAX_SEQ,
           weight_store=probe, stream_cfg=StreamConfig(pin_edges=False),
           device="cpu")
    budget = int(probe.total_bytes * 0.6)

    def streamed():
        store = PageStore(n_planes=8)
        return Engine(OPT_TINY, params, max_slots=2, max_seq=MAX_SEQ,
                      weight_store=store, device="cpu",
                      stream_cfg=StreamConfig(device_budget_bytes=budget,
                                              group_size=1,
                                              prefetch_depth=2)), store

    prompts = [[(7 * i + j) % 400 + 1 for j in range(5 + i % 4)]
               for i in range(6)]
    eng0, _ = streamed()
    front0 = ServeFront(eng0)
    base = [h.result(timeout=120) for h in
            [front0.add_request(p, max_new=4) for p in prompts]]
    base_rec = front0.add_request([11, 22, 33], max_new=4).result(
        timeout=120)
    front0.close()

    eng, store = streamed()
    store.attach_injector(FaultInjector(FaultConfig(
        seed=3, read_rber=2e-5, stuck_page_rate=0.05, slow_read_every=9,
        slow_read_s=0.001)))
    fault = {"arm": False}

    def hook(step, retries):
        if fault["arm"]:
            raise StepFault("forced persistent step fault")

    eng.streamer.max_fetch_retries = 1
    eng.streamer.retry_backoff_s = 0.001
    crash = {"left": 2}                  # > the worker's retry budget
    real_window = eng.streamer._window

    def window(g):
        if crash["left"] > 0:
            crash["left"] -= 1
            raise IOError("forced NAND channel crash")
        return real_window(g)

    eng.streamer._window = window
    front = ServeFront(eng, poll_s=0.01, step_fault_hook=hook)
    got = [h.result(timeout=120) for h in
           [front.add_request(p, max_new=4) for p in prompts]]
    fault["arm"] = True
    sac = front.add_request([9, 9, 9], max_new=4)
    sac._done.wait(120)
    fault["arm"] = False
    rec = front.add_request([11, 22, 33], max_new=4)
    assert rec.result(timeout=120) == base_rec
    assert got == base
    assert sac.finish_reason == "error" and rec.finish_reason == "length"
    _wait_drained(front, eng)
    code, health = front.health()
    st = front.stats()
    front.close()
    assert (code, health["status"]) == (200, "degraded")
    assert st["step_retries"] >= 1 and st["step_faults"] >= 1
    assert st["stream"]["fetch_faults"] >= 1
    s = store.stats()
    assert s["ecc_corrected_pages"] > 0 and s["relocations"] > 0
    resident = sum(store.entry_pages(n) for g in range(eng.n_groups)
                   if g in eng.cache for n in eng._group_entries(g))
    assert eng.wpool.used_pages == resident
    assert eng.pool.n_free_blocks == eng.pool.n_blocks - 1
    text = front.metrics_text()
    assert "nand_relocations_total" not in text    # collector unregistered


# --- the stdlib HTTP front end ---------------------------------------------------


@pytest.fixture()
def http_server(params):
    eng = _engine(params, prefix_cache=True)
    front = ServeFront(eng, max_waiting=8)
    server = make_http_server(front, 0)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    yield server, front, eng
    server.shutdown()
    server.server_close()
    front.close()


def _post(port, payload):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("POST", "/v1/generate", json.dumps(payload),
                 {"Content-Type": "application/json"})
    return conn, conn.getresponse()


def _sse(resp):
    toks, reason = [], None
    for line in resp.read().decode().splitlines():
        if line.startswith("data: ") and line != "data: [DONE]":
            frame = json.loads(line[len("data: "):])
            if "token" in frame:
                toks.append(frame["token"])
            else:
                reason = frame.get("finish_reason")
    return toks, reason


def _get(port, path):
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    c.request("GET", path)
    resp = c.getresponse()
    body = resp.read()
    c.close()
    return resp.status, body


def test_http_end_to_end(params, http_server):
    """SSE streaming; a second client on the same 2-block system prompt
    gets identical tokens while admission skips the cached prefill; a
    mid-stream disconnect returns every KV block; stats and metrics."""
    server, front, eng = http_server
    port = server.server_address[1]
    system = list(range(1, 40))
    ref = _engine(params)
    rid = ref.submit(system + [50, 51], max_new=8)
    want = ref.run()[rid]

    conn, resp = _post(port, {"prompt": system + [50, 51], "max_new": 8})
    assert resp.status == 200
    assert resp.getheader("Content-Type") == "text/event-stream"
    assert _sse(resp) == (want, "length")
    conn.close()
    saved0 = eng.prefix_stats()["prefix_prefill_tokens_saved"]
    conn, resp = _post(port, {"prompt": system + [50, 51], "max_new": 8})
    assert _sse(resp)[0] == want
    conn.close()
    assert eng.prefix_stats()["prefix_prefill_tokens_saved"] \
        == saved0 + 2 * BS

    conn, resp = _post(port, {"prompt": system + [70], "max_new": 48})
    resp.fp.readline()
    resp.close()
    conn.close()
    deadline = time.monotonic() + 30
    while front.stats()["cancelled"] < 1 \
            or _free_and_cached(eng) != eng.pool.n_blocks - 1:
        assert time.monotonic() < deadline, "disconnect leaked KV blocks"
        time.sleep(0.02)
    code, body = _get(port, "/v1/stats")
    st = json.loads(body)
    assert code == 200
    assert st["finished"] == 2 and st["cancelled"] == 1
    assert st["prefix_hits"] >= 2 and st["live_handles"] == 0
    code, body = _get(port, "/v1/metrics")
    text = body.decode()
    assert code == 200 and "serve_ttft_seconds_count" in text
    assert "engine_steps_total" in text and "prefix_hits_total" in text


def test_http_non_streaming_errors_health_and_finish_frame(params,
                                                           http_server):
    server, _, _ = http_server
    port = server.server_address[1]
    conn, resp = _post(port, {"prompt": [4, 5, 6], "max_new": 5,
                              "stream": False})
    body = json.loads(resp.read())
    assert resp.status == 200 and len(body["tokens"]) == 5
    assert body["finish_reason"] == "length"
    conn.close()
    for bad in ({"max_new": 5}, {"prompt": []}):
        conn, resp = _post(port, bad)
        assert resp.status == 400
        conn.close()
    assert _get(port, "/nope")[0] == 404
    code, body = _get(port, "/v1/health")
    health = json.loads(body)
    assert code == 200 and health["status"] in ("ok", "degraded")
    assert health["step_faults"] == 0 and health["requests_failed"] == 0
    conn, resp = _post(port, {"prompt": [1, 2, 3], "max_new": 4})
    toks, reason = _sse(resp)
    assert len(toks) == 4 and reason == "length"
    conn.close()
