"""Chrome ``trace_event`` span tracer for the serving stack.

The paper's pipelining story — group l+1's NAND pages streaming while
group l's compute runs, pool uploads riding the prefetch worker, router
bitmaps syncing mid-step — is an OVERLAP claim, and overlap is only
checkable on a timeline. This tracer records spans onto fixed tracks
(compute / stream / pool / NAND / requests) and exports them in the
Chrome trace-event JSON format, loadable in ``chrome://tracing`` or
Perfetto: stacked "X" (complete) events per track, named via "M"
(metadata) events.

Design points:

  * Disabled by default (``Tracer(enabled=False)``): ``span()`` returns
    one shared no-op context manager and ``complete()``/``instant()``
    return immediately — the hot path pays an attribute check.
  * Bounded: events land in a ``deque(maxlen=...)`` ring, so a
    long-lived server traces the LAST N events, never unbounded memory.
  * Nesting and orphans: ``span()`` keeps a per-thread stack; Chrome
    renders containment from timestamps, and ``orphans()`` counts spans
    begun but never ended (a leak detector for abandoned iterations,
    tested in tests/test_torch_obs.py).
  * The exported file is a JSON array written ONE EVENT PER LINE — valid
    Chrome/Perfetto trace JSON and line-greppable (the CI schema check
    parses it whole, then validates every event dict).
"""
from __future__ import annotations

import json
import threading
import time
from collections import deque

__all__ = ["Tracer", "default_tracer", "set_default_tracer",
           "TID_COMPUTE", "TID_STREAM", "TID_POOL", "TID_NAND",
           "TID_REQUEST0"]

# Fixed track ids (Chrome "tid"): one per serving-stack plane. Requests
# get their own rolling band so concurrent requests render side by side.
TID_COMPUTE = 1          # engine step phases (host dispatch view)
TID_STREAM = 2           # streamer / prefetcher fetch work
TID_POOL = 3             # page-pool staged uploads (per-shard)
TID_NAND = 4             # PageStore page reads (per-plane args)
TID_REQUEST0 = 100       # request lifecycle spans: 100 + (rid % width)

_TRACK_NAMES = {
    TID_COMPUTE: "engine.compute",
    TID_STREAM: "weight.stream",
    TID_POOL: "pool.upload",
    TID_NAND: "nand.read",
}
_REQUEST_TRACKS = 8      # rid % 8 request lanes


class _NullSpan:
    """Shared no-op context manager for the disabled tracer."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    def __init__(self, tracer: "Tracer", name: str, tid: int, cat: str,
                 args: dict | None):
        self._tracer = tracer
        self._name = name
        self._tid = tid
        self._cat = cat
        self._args = args

    def __enter__(self):
        self._tracer._push(self._name)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter() - self._t0
        self._tracer._pop(self._name)
        self._tracer.complete(self._name, self._t0, dur, tid=self._tid,
                              cat=self._cat, args=self._args)
        return False


class Tracer:
    """Bounded, thread-safe trace-event recorder (one per process by
    default — ``default_tracer()``)."""

    def __init__(self, enabled: bool = False, max_events: int = 200_000):
        self.enabled = bool(enabled)
        self._events: deque = deque(maxlen=int(max_events))
        self._lock = threading.Lock()
        self._local = threading.local()
        self._orphans = 0
        # one origin for the whole trace: perf_counter is monotonic but
        # epoch-free, so every ts is relative to tracer creation.
        self._t0 = time.perf_counter()

    # --- span stack (nesting / orphan accounting) ----------------------------

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _push(self, name: str):
        self._stack().append(name)

    def _pop(self, name: str):
        st = self._stack()
        while st:
            top = st.pop()
            if top == name:
                return
            # a span begun inside us was never ended: count the leak
            with self._lock:
                self._orphans += 1

    def orphans(self) -> int:
        """Spans begun but never ended (so far) — ``begin`` without
        ``end`` plus mispaired nesting detected at pop time."""
        with self._lock:
            n = self._orphans
        st = getattr(self._local, "stack", None)
        return n + (len(st) if st else 0)

    # --- recording -----------------------------------------------------------

    def _us(self, t: float) -> float:
        return (t - self._t0) * 1e6

    def span(self, name: str, tid: int = TID_COMPUTE, cat: str = "",
             args: dict | None = None):
        """Context manager timing its body into one complete event."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, tid, cat, args)

    def begin(self, name: str):
        """Explicit begin/end pair (for spans that cross yield points,
        e.g. the streamed group loop). Returns the begin timestamp."""
        if not self.enabled:
            return 0.0
        self._push(name)
        return time.perf_counter()

    def end(self, name: str, t0: float, tid: int = TID_COMPUTE,
            cat: str = "", args: dict | None = None):
        if not self.enabled:
            return
        self._pop(name)
        self.complete(name, t0, time.perf_counter() - t0, tid=tid,
                      cat=cat, args=args)

    def complete(self, name: str, t0: float, dur_s: float,
                 tid: int = TID_COMPUTE, cat: str = "",
                 args: dict | None = None):
        """Record a pre-timed span (Chrome "X" event). ``t0`` is a
        ``perf_counter`` reading; ``dur_s`` seconds."""
        if not self.enabled:
            return
        ev = {"name": name, "ph": "X", "pid": 0, "tid": int(tid),
              "ts": self._us(t0), "dur": max(dur_s, 0.0) * 1e6}
        if cat:
            ev["cat"] = cat
        if args:
            ev["args"] = args
        with self._lock:
            self._events.append(ev)

    def instant(self, name: str, tid: int = TID_COMPUTE,
                args: dict | None = None):
        if not self.enabled:
            return
        ev = {"name": name, "ph": "i", "pid": 0, "tid": int(tid),
              "ts": self._us(time.perf_counter()), "s": "t"}
        if args:
            ev["args"] = args
        with self._lock:
            self._events.append(ev)

    def request_tid(self, rid: int) -> int:
        return TID_REQUEST0 + int(rid) % _REQUEST_TRACKS

    # --- export --------------------------------------------------------------

    def _meta_events(self) -> list[dict]:
        names = dict(_TRACK_NAMES)
        for i in range(_REQUEST_TRACKS):
            names[TID_REQUEST0 + i] = f"requests.{i}"
        return [{"name": "thread_name", "ph": "M", "pid": 0, "tid": tid,
                 "ts": 0, "args": {"name": label}}
                for tid, label in sorted(names.items())]

    def events(self) -> list[dict]:
        """Snapshot: metadata (track-name) events + recorded events in
        arrival order."""
        with self._lock:
            recorded = list(self._events)
        return self._meta_events() + recorded

    def export(self, path: str) -> int:
        """Write the Chrome trace JSON (array form, one event per line).
        Returns the number of events written (metadata included)."""
        events = self.events()
        with open(path, "w") as f:
            f.write("[\n")
            for i, ev in enumerate(events):
                tail = "," if i + 1 < len(events) else ""
                f.write(json.dumps(ev, sort_keys=True) + tail + "\n")
            f.write("]\n")
        return len(events)

    def clear(self):
        with self._lock:
            self._events.clear()
            self._orphans = 0
        self._t0 = time.perf_counter()


_default_lock = threading.Lock()
_default: Tracer | None = None


def default_tracer() -> Tracer:
    """The process-wide tracer the stack records into. DISABLED until
    something (a caller, a test) enables it — tracing is a
    debugging tool, not an always-on cost."""
    global _default
    with _default_lock:
        if _default is None:
            _default = Tracer(enabled=False)
        return _default


def set_default_tracer(tr: Tracer) -> Tracer:
    global _default
    with _default_lock:
        prev, _default = _default, tr
    return prev if prev is not None else Tracer()
