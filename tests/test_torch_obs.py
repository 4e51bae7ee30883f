"""The port's ObsPlane (``repro_torch.obs``) against the reference's
(``repro.obs``): the ``tests/test_obs.py`` scenarios — registry, tracer,
timeline — run on both packages, the Prometheus exposition of the same
operations is byte-equal, and the histogram merge property holds with
three histograms."""
from __future__ import annotations

import json
import threading

import pytest

from hyp_compat import given, settings, st

from repro import obs as jobs
from repro_torch import obs as tobs

PKGS = {"port": tobs, "reference": jobs}


@pytest.fixture(params=sorted(PKGS))
def o(request):
    return PKGS[request.param]


values = st.lists(st.floats(min_value=0.0, max_value=100.0,
                            allow_nan=False, allow_infinity=False),
                  max_size=200)


@given(values, values)
@settings(max_examples=50, deadline=None)
def test_histogram_merge_equals_union_of_three(a, b):
    """merge(h(a), h(b)) == h(a + b), on both packages: the fixed-bounds
    contract, with three histograms (the reference test's name split
    yields two)."""
    for o in PKGS.values():
        bounds = o.log_buckets(1e-3, 10.0, 2)
        ha, hb, hu = (o.Histogram(n, "", buckets=bounds)
                      for n in ("a", "b", "u"))
        for v in a:
            ha.observe(v)
        for v in b:
            hb.observe(v)
        for v in a + b:
            hu.observe(v)
        merged = ha.snapshot().merge(hb.snapshot())
        union = hu.snapshot()
        assert merged.counts == union.counts
        assert merged.count == union.count
        assert merged.sum == pytest.approx(union.sum)


@given(values)
@settings(max_examples=50, deadline=None)
def test_histogram_cumulative_monotone_and_equal(vals):
    snaps = []
    for o in PKGS.values():
        h = o.Histogram("h", "", buckets=o.log_buckets(1e-3, 10.0, 2))
        for v in vals:
            h.observe(v)
        cum = h.snapshot().cumulative()
        assert all(y >= x for x, y in zip(cum, cum[1:]))
        assert cum[-1] == len(vals)
        snaps.append(h.snapshot())
    assert snaps[0].counts == snaps[1].counts
    assert snaps[0].percentile(0.5) == snaps[1].percentile(0.5)


def test_histogram_percentile_and_overflow(o):
    h = o.Histogram("h", "", buckets=o.log_buckets(1e-3, 10.0, 4))
    for _ in range(100):
        h.observe(0.05)
    lo = max(b for b in h.bounds if b <= 0.05)
    hi = min(b for b in h.bounds if b >= 0.05)
    assert lo <= h.percentile(0.5) <= hi
    g = o.Histogram("g", "", buckets=(1.0, 2.0))
    g.observe(5.0)
    assert g.snapshot().counts == (0, 0, 1)
    assert g.snapshot().percentile(0.99) == 2.0
    assert o.log_buckets(1e-4, 100.0, 4) == jobs.log_buckets(1e-4, 100.0, 4)
    with pytest.raises(ValueError):
        o.log_buckets(0.0, 1.0)


def test_concurrent_increments_exact(o):
    reg = o.MetricsRegistry()
    c = reg.counter("c_total", "stress")
    h = reg.histogram("h_seconds", "stress")
    g = reg.gauge("g", "stress")
    n, m = 8, 300

    def work():
        for i in range(m):
            c.inc()
            h.observe(0.01 * (i % 7))
            g.inc()

    threads = [threading.Thread(target=work) for _ in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert c.value() == g.value() == h.snapshot().count == n * m


def test_registry_semantics(o):
    reg = o.MetricsRegistry()
    assert reg.counter("x_total", "") is reg.counter("x_total", "")
    with pytest.raises(ValueError):
        reg.gauge("x_total", "")
    c = reg.counter("f_total", "", label_names=("reason",))
    c.inc(2, labels={"reason": "error"})
    assert c.value(labels={"reason": "error"}) == 2
    with pytest.raises(ValueError):
        c.inc(-1, labels={"reason": "error"})
    with pytest.raises(ValueError):
        c.inc(labels={})
    off = o.MetricsRegistry(enabled=False)
    off.counter("c_total", "").inc(5)
    off.register_collector(lambda: [o.Sample("s", "counter", 1.0)])
    assert off.expose() == "# obs disabled\n" and off.snapshot() == {}


def _golden(o) -> str:
    """tests/test_obs.py's exposition scenario, plus a collector that
    raises and one that yields labeled samples."""
    reg = o.MetricsRegistry()
    c = reg.counter("serve_finish_total", "finished requests",
                    label_names=("reason",))
    c.inc(3, labels={"reason": "length"})
    c.inc(1, labels={"reason": "timeout"})
    reg.gauge("engine_free_kv_blocks", "free pool blocks").set(12)
    h = reg.histogram("serve_ttft_seconds", "time to first token",
                      buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 20.0):
        h.observe(v)

    def good():
        yield o.Sample("nand_pages_read_total", "counter", 7.0)
        yield o.Sample("nand_plane_reads_total", "counter", 3.0,
                       (("plane", "0"),))

    def bad():
        raise RuntimeError("subsystem died")

    reg.register_collector(good)
    reg.register_collector(good)
    reg.register_collector(bad)
    return reg.expose()


def test_exposition_equals_the_reference_byte_for_byte():
    got, want = _golden(tobs), _golden(jobs)
    assert got == want
    assert got.startswith(
        "# HELP engine_free_kv_blocks free pool blocks\n"
        "# TYPE engine_free_kv_blocks gauge\n"
        "engine_free_kv_blocks 12\n")
    assert 'serve_ttft_seconds_bucket{le="+Inf"} 3\n' in got
    assert got.count("nand_pages_read_total 7") == 1


def test_span_nesting_and_orphans(o):
    tr = o.Tracer(enabled=True)
    with tr.span("outer"):
        with tr.span("inner"):
            pass
    by = {e["name"]: e for e in tr.events() if e["ph"] == "X"}
    assert by["outer"]["ts"] <= by["inner"]["ts"]
    assert tr.orphans() == 0
    tr.begin("leaked")
    t0 = tr.begin("outer2")
    tr.begin("inner-leak")
    tr.end("outer2", t0)
    assert tr.orphans() == 2
    off = o.Tracer(enabled=False)
    with off.span("x"):
        pass
    off.complete("y", 0.0, 1.0)
    assert [e for e in off.events() if e["ph"] == "X"] == []


def test_trace_export_schema_and_ring(o, tmp_path):
    tr = o.Tracer(enabled=True, max_events=10)
    with tr.span("step", tid=o.TID_COMPUTE, args={"tokens": 3}):
        pass
    for i in range(50):
        tr.complete(f"e{i}", 0.0, 0.0, tid=o.TID_STREAM)
    n = tr.export(str(tmp_path / "t.json"))
    evs = json.loads((tmp_path / "t.json").read_text())
    assert len(evs) == n
    assert all({"name", "ph", "pid", "tid", "ts"} <= set(e) for e in evs)
    xs = [e for e in evs if e["ph"] == "X"]
    assert len(xs) == 10 and xs[-1]["name"] == "e49"
    names = {e["args"]["name"] for e in evs if e["ph"] == "M"}
    assert {"engine.compute", "weight.stream", "pool.upload",
            "nand.read"} <= names
    assert (o.TID_COMPUTE, o.TID_STREAM, o.TID_POOL, o.TID_NAND,
            o.TID_REQUEST0) == (jobs.TID_COMPUTE, jobs.TID_STREAM,
                                jobs.TID_POOL, jobs.TID_NAND,
                                jobs.TID_REQUEST0)


def test_timeline_ring(o):
    tl = o.StepTimeline(capacity=8)
    for i in range(20):
        tl.record(i, {"dispatch": 0.001 * i}, tokens=i)
    assert len(tl) == 8 and tl.total_recorded == 20
    assert [r["step"] for r in tl.snapshot()] == list(range(12, 20))
    assert tl.snapshot(3)[-1]["tokens"] == 19
    summ = tl.summary()
    assert summ["steps_retained"] == 8 and summ["steps_total"] == 20
    assert summ["phase_seconds"]["dispatch"] == pytest.approx(
        sum(0.001 * i for i in range(12, 20)))
    one = o.StepTimeline(capacity=4)
    one.record(0, {"a": 1.0}, stall_s=0.5)
    assert one.snapshot() == [{"step": 0, "phases": {"a": 1.0},
                               "stall_s": 0.5}]


def test_default_registry_swap_and_restore(o):
    fresh = o.MetricsRegistry()
    prev = o.set_default_registry(fresh)
    try:
        assert o.default_registry() is fresh
    finally:
        o.set_default_registry(prev)
    assert o.default_registry() is prev


def test_engine_step_phases_reach_the_registry_and_tracer():
    """The port's engine records its step phases: the histogram, the token
    counter, the timeline, and (tracer on) compute-track spans."""
    import torch

    from repro_torch.configs import OPT_TINY
    from repro_torch.models import dense
    from repro_torch.serving.engine import Engine

    params = dense.init(OPT_TINY, torch.Generator().manual_seed(0),
                        device="cpu")
    reg = tobs.MetricsRegistry()
    tracer = tobs.Tracer(enabled=True)
    prev = tobs.set_default_tracer(tracer)
    try:
        eng = Engine(OPT_TINY, params, max_slots=2, max_seq=64,
                     device="cpu", registry=reg)
        eng.submit([1, 2, 3], max_new=3)
        eng.run()
    finally:
        tobs.set_default_tracer(prev)
    steps = len(eng.stats)
    h = reg.histogram("engine_step_seconds", label_names=("phase",))
    for phase in ("plan", "dispatch", "sync", "total"):
        assert h.snapshot(labels={"phase": phase}).count == steps
    toks = reg.counter("engine_tokens_total", label_names=("kind",))
    assert toks.value(labels={"kind": "prefill"}) == 3
    assert toks.value(labels={"kind": "decode"}) == 2
    assert eng.timeline.total_recorded == steps
    names = {e["name"] for e in tracer.events() if e["ph"] == "X"}
    assert {"plan", "dispatch", "sync"} <= names
    text = reg.expose()
    assert 'engine_step_seconds_count{phase="total"} %d' % steps in text


def test_streamed_engine_spans_and_samples():
    """The stream path's spans (``stream.group{g}``, ``pool.upload``,
    ``nand.read_pages`` with its analytic ``nand_s``, the streamed step's
    phases) land on their tracks while the tracer is on, and none while it
    is off; the engine's samples carry the store's, pool's, streamer's
    and cache's families."""
    import torch

    from repro_torch.configs import OPT_TINY
    from repro_torch.models import dense
    from repro_torch.serving.engine import Engine
    from repro_torch.store import PageStore, StreamConfig

    params = dense.init(OPT_TINY, torch.Generator().manual_seed(0),
                        device="cpu")

    def run(tracer):
        prev = tobs.set_default_tracer(tracer)
        try:
            eng = Engine(OPT_TINY, params, max_slots=2, max_seq=64,
                         device="cpu", weight_store=PageStore(n_planes=8),
                         stream_cfg=StreamConfig(pin_edges=False),
                         registry=tobs.MetricsRegistry())
            eng.submit([1, 2, 3], max_new=2)
            eng.run()
        finally:
            tobs.set_default_tracer(prev)
        return eng

    off = tobs.Tracer(enabled=False)
    run(off)
    assert [e for e in off.events() if e["ph"] == "X"] == []
    on = tobs.Tracer(enabled=True)
    eng = run(on)
    xs = [e for e in on.events() if e["ph"] == "X"]
    by_tid = {}
    for e in xs:
        by_tid.setdefault(e["tid"], set()).add(e["name"])
    assert {"stream.group0", f"stream.group{eng.n_groups - 1}"} <= \
        by_tid[tobs.TID_STREAM]
    assert by_tid[tobs.TID_POOL] == {"pool.upload"}
    assert by_tid[tobs.TID_NAND] == {"nand.read_pages"}
    assert {"plan", "embed", "stream_wait", "group_dispatch", "finish",
            "sync"} <= by_tid[tobs.TID_COMPUTE]
    nand = [e for e in xs if e["name"] == "nand.read_pages"]
    assert all(e["args"]["nand_s"] > 0 and e["args"]["pages"] > 0
               for e in nand)
    names = {s.name for s in eng.obs_samples()}
    assert {"engine_steps_total", "engine_stall_frac",
            "nand_pages_read_total", "nand_plane_reads_total",
            "pool_uploads_total", "stream_groups_total",
            "stream_cache_hits_total"} <= names
    assert eng.telemetry()["steps"] == len(eng.stats)
