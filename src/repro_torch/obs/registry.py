"""ObsPlane metrics registry: counters, gauges, log-bucketed histograms.

NVLLM's claims are time-decomposition claims — FFN hidden under NAND
reads, attention riding DRAM, stall-coupled admission — so the serving
stack needs ONE place where every subsystem's counters meet a time
dimension. This module is that place:

  * ``MetricsRegistry`` is process-wide and thread-safe. Instruments are
    get-or-create by name (the Prometheus family model): ``counter``,
    ``gauge``, ``histogram`` — histograms use FIXED log-spaced buckets so
    two histograms of the same family merge by bucket-wise addition
    (property-tested in tests/test_torch_obs.py) and percentiles come from
    cumulative-bucket interpolation, not sample retention.
  * Subsystems with existing private counter dicts (PageStore, streamer,
    expert cache, page pool, prefix index, fault injector) do NOT pay a
    registry call per increment. They expose ``obs_samples()`` — a
    lock-free read of their own counters — and a COLLECTOR registered by
    the serving frontend pulls those samples at scrape time. The hot path
    cost of the whole plane is therefore what the serve path already
    paid, plus a handful of histogram observes per request.
  * Zero-overhead no-op mode: a registry built with ``enabled=False``
    (or ``REPRO_OBS=0``) hands out shared null instruments whose
    ``inc``/``set``/``observe`` are empty methods — the disabled cost is
    one attribute lookup at instrument-creation time, nothing per event.

Exposition is Prometheus text format 0.0.4 (``expose()``), served by the
stdlib HTTP frontend at ``GET /v1/metrics`` (serving/server.py).
"""
from __future__ import annotations

import bisect
import math
import os
import threading
from dataclasses import dataclass
from typing import Callable, Iterable, Sequence

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "Sample",
    "default_registry", "set_default_registry", "log_buckets",
    "LATENCY_BUCKETS_S",
]


def log_buckets(lo: float = 1e-4, hi: float = 100.0,
                per_decade: int = 4) -> tuple[float, ...]:
    """Fixed log-spaced histogram bounds covering [lo, hi] inclusive.

    Fixed (not data-dependent) bounds are the merge contract: any two
    histograms built from the same ``log_buckets`` call merge exactly."""
    if lo <= 0 or hi <= lo or per_decade < 1:
        raise ValueError(f"bad bucket spec lo={lo} hi={hi}/{per_decade}")
    n = int(round(math.log10(hi / lo) * per_decade))
    step = 10.0 ** (1.0 / per_decade)
    return tuple(lo * step ** i for i in range(n + 1))


# 100us .. 100s, 4 buckets per decade: wide enough for TTFT on a cold
# compile (tens of seconds on CPU CI) and fine enough for decode TPOT.
LATENCY_BUCKETS_S = log_buckets(1e-4, 100.0, 4)


@dataclass(frozen=True)
class Sample:
    """One scrape-time sample a collector yields into the exposition:
    ``kind`` is "counter" or "gauge"; ``labels`` a (k, v) tuple-pairs
    tuple (hashable, ordered)."""
    name: str
    kind: str
    value: float
    labels: tuple[tuple[str, str], ...] = ()


def _fmt_value(v: float) -> str:
    f = float(v)
    if f == math.inf:
        return "+Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _fmt_labels(pairs: Iterable[tuple[str, str]]) -> str:
    items = [f'{k}="{v}"' for k, v in pairs]
    return "{" + ",".join(items) + "}" if items else ""


class _Instrument:
    """Shared labeled-value plumbing: one lock, one dict keyed by the
    label-value tuple (label NAMES are fixed per family at creation)."""

    kind = "untyped"

    def __init__(self, name: str, help: str, label_names: Sequence[str] = ()):
        self.name = name
        self.help = help
        self.label_names = tuple(label_names)
        self._lock = threading.Lock()
        self._values: dict[tuple, float] = {}

    def _key(self, labels: dict | None) -> tuple:
        if not self.label_names:
            return ()
        labels = labels or {}
        try:
            return tuple(str(labels[k]) for k in self.label_names)
        except KeyError as e:
            raise ValueError(f"{self.name}: missing label {e}") from None

    def samples(self) -> list[Sample]:
        with self._lock:
            items = sorted(self._values.items())
        return [Sample(self.name, self.kind, v,
                       tuple(zip(self.label_names, key)))
                for key, v in items]


class Counter(_Instrument):
    """Monotonic float counter (optionally labeled)."""

    kind = "counter"

    def inc(self, value: float = 1.0, labels: dict | None = None):
        if value < 0:
            raise ValueError(f"{self.name}: counters only go up")
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + value

    def value(self, labels: dict | None = None) -> float:
        key = self._key(labels)
        with self._lock:
            return self._values.get(key, 0.0)


class Gauge(_Instrument):
    """Last-write-wins gauge (optionally labeled)."""

    kind = "gauge"

    def set(self, value: float, labels: dict | None = None):
        key = self._key(labels)
        with self._lock:
            self._values[key] = float(value)

    def inc(self, value: float = 1.0, labels: dict | None = None):
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + value

    def value(self, labels: dict | None = None) -> float:
        key = self._key(labels)
        with self._lock:
            return self._values.get(key, 0.0)


@dataclass
class HistSnapshot:
    """Frozen histogram state: per-bucket (non-cumulative) counts with a
    trailing overflow bucket, plus sum/count. ``merge`` is bucket-wise
    addition — exact because the bounds are fixed."""
    bounds: tuple[float, ...]
    counts: tuple[int, ...]          # len(bounds) + 1 (overflow last)
    sum: float
    count: int

    def cumulative(self) -> list[int]:
        out, acc = [], 0
        for c in self.counts:
            acc += c
            out.append(acc)
        return out

    def merge(self, other: "HistSnapshot") -> "HistSnapshot":
        if self.bounds != other.bounds:
            raise ValueError("merge needs identical bucket bounds")
        return HistSnapshot(
            self.bounds,
            tuple(a + b for a, b in zip(self.counts, other.counts)),
            self.sum + other.sum, self.count + other.count)

    def percentile(self, q: float) -> float:
        """Bucket-interpolated percentile (q in [0, 1]). Within a bucket
        the mass is assumed uniform; the overflow bucket clamps to its
        lower bound (the histogram's honest upper knowledge)."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"percentile wants q in [0,1], got {q}")
        if self.count == 0:
            return 0.0
        rank = q * self.count
        acc = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if acc + c >= rank:
                lo = 0.0 if i == 0 else self.bounds[i - 1]
                if i >= len(self.bounds):        # overflow bucket
                    return self.bounds[-1]
                hi = self.bounds[i]
                frac = (rank - acc) / c
                return lo + frac * (hi - lo)
            acc += c
        return self.bounds[-1]


class Histogram(_Instrument):
    """Fixed-bucket histogram (optionally labeled). ``observe`` is a
    bisect + three dict/list updates under one lock — cheap enough for
    per-token TPOT observes on the serve path."""

    kind = "histogram"

    def __init__(self, name: str, help: str,
                 buckets: Sequence[float] = LATENCY_BUCKETS_S,
                 label_names: Sequence[str] = ()):
        super().__init__(name, help, label_names)
        bounds = tuple(float(b) for b in buckets)
        if list(bounds) != sorted(set(bounds)):
            raise ValueError(f"{name}: bucket bounds must strictly increase")
        self.bounds = bounds
        self._counts: dict[tuple, list[int]] = {}
        self._sums: dict[tuple, float] = {}

    def observe(self, value: float, labels: dict | None = None):
        v = float(value)
        i = bisect.bisect_left(self.bounds, v)
        key = self._key(labels)
        with self._lock:
            counts = self._counts.get(key)
            if counts is None:
                counts = self._counts[key] = [0] * (len(self.bounds) + 1)
                self._sums[key] = 0.0
            counts[i] += 1
            self._sums[key] += v

    def snapshot(self, labels: dict | None = None) -> HistSnapshot:
        key = self._key(labels)
        with self._lock:
            counts = list(self._counts.get(key,
                                           [0] * (len(self.bounds) + 1)))
            s = self._sums.get(key, 0.0)
        return HistSnapshot(self.bounds, tuple(counts), s, sum(counts))

    def percentile(self, q: float, labels: dict | None = None) -> float:
        return self.snapshot(labels).percentile(q)

    def samples(self) -> list[Sample]:     # exposition handled specially
        return []

    def _expose_into(self, lines: list[str]):
        with self._lock:
            keys = sorted(self._counts)
            data = [(k, list(self._counts[k]), self._sums[k]) for k in keys]
        for key, counts, s in data:
            base = tuple(zip(self.label_names, key))
            acc = 0
            for bound, c in zip(self.bounds, counts):
                acc += c
                lbl = _fmt_labels(base + (("le", _fmt_value(bound)),))
                lines.append(f"{self.name}_bucket{lbl} {acc}")
            acc += counts[-1]
            lbl = _fmt_labels(base + (("le", "+Inf"),))
            lines.append(f"{self.name}_bucket{lbl} {acc}")
            lines.append(f"{self.name}_sum{_fmt_labels(base)} "
                         f"{_fmt_value(s)}")
            lines.append(f"{self.name}_count{_fmt_labels(base)} {acc}")


class _NullInstrument:
    """The disabled plane: every mutator is an empty method, every read a
    zero. One shared instance per kind — creating instruments against a
    disabled registry allocates nothing."""

    def inc(self, value: float = 1.0, labels: dict | None = None):
        pass

    def set(self, value: float, labels: dict | None = None):
        pass

    def observe(self, value: float, labels: dict | None = None):
        pass

    def value(self, labels: dict | None = None) -> float:
        return 0.0

    def percentile(self, q: float, labels: dict | None = None) -> float:
        return 0.0

    def snapshot(self, labels: dict | None = None) -> HistSnapshot:
        return HistSnapshot((), (0,), 0.0, 0)


_NULL = _NullInstrument()


class MetricsRegistry:
    """Process-wide instrument + collector registry.

    ``enabled=False`` is the zero-overhead mode: instrument getters
    return the shared null instrument and ``register_collector`` is a
    no-op, so a disabled serving stack records nothing and allocates
    nothing per event."""

    def __init__(self, enabled: bool = True):
        self.enabled = bool(enabled)
        self._lock = threading.Lock()
        self._instruments: dict[str, _Instrument] = {}
        self._collectors: list[Callable[[], Iterable[Sample]]] = []

    # --- instrument registration ---------------------------------------------

    def _get(self, cls, name: str, help: str, **kw):
        if not self.enabled:
            return _NULL
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = self._instruments[name] = cls(name, help, **kw)
            elif not isinstance(inst, cls):
                raise ValueError(
                    f"{name}: registered as {inst.kind}, requested "
                    f"{cls.kind}")
            return inst

    def counter(self, name: str, help: str = "",
                label_names: Sequence[str] = ()) -> Counter:
        return self._get(Counter, name, help, label_names=label_names)

    def gauge(self, name: str, help: str = "",
              label_names: Sequence[str] = ()) -> Gauge:
        return self._get(Gauge, name, help, label_names=label_names)

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = LATENCY_BUCKETS_S,
                  label_names: Sequence[str] = ()) -> Histogram:
        return self._get(Histogram, name, help, buckets=buckets,
                         label_names=label_names)

    # --- scrape-time collectors ----------------------------------------------

    def register_collector(self, fn: Callable[[], Iterable[Sample]]):
        """``fn()`` is called at scrape time and yields ``Sample``s pulled
        from a subsystem's private counters (lock-free reads — a scrape
        must never wait behind a device step). Idempotent per callable."""
        if not self.enabled:
            return
        with self._lock:
            if fn not in self._collectors:
                self._collectors.append(fn)

    def unregister_collector(self, fn):
        with self._lock:
            try:
                self._collectors.remove(fn)
            except ValueError:
                pass

    # --- exposition ----------------------------------------------------------

    def _collect(self) -> dict[str, tuple[str, list[Sample]]]:
        """Collector samples grouped by family name -> (kind, samples).
        A collector that raises is dropped from THAT scrape only — one
        faulted subsystem must not take the whole exposition down."""
        with self._lock:
            collectors = list(self._collectors)
        fams: dict[str, tuple[str, list[Sample]]] = {}
        for fn in collectors:
            try:
                samples = list(fn())
            except Exception:
                continue
            for s in samples:
                kind, lst = fams.setdefault(s.name, (s.kind, []))
                lst.append(s)
        return fams

    def expose(self) -> str:
        """Prometheus text exposition 0.0.4: instruments first, then
        collector families, both name-sorted. Deterministic — the golden
        test in tests/test_torch_obs.py compares byte-for-byte."""
        if not self.enabled:
            return "# obs disabled\n"
        lines: list[str] = []
        with self._lock:
            insts = [self._instruments[k]
                     for k in sorted(self._instruments)]
        for inst in insts:
            lines.append(f"# HELP {inst.name} {inst.help}")
            lines.append(f"# TYPE {inst.name} {inst.kind}")
            if isinstance(inst, Histogram):
                inst._expose_into(lines)
            else:
                for s in inst.samples():
                    lines.append(f"{s.name}{_fmt_labels(s.labels)} "
                                 f"{_fmt_value(s.value)}")
        fams = self._collect()
        for name in sorted(fams):
            kind, samples = fams[name]
            lines.append(f"# TYPE {name} {kind}")
            for s in sorted(samples, key=lambda x: x.labels):
                lines.append(f"{s.name}{_fmt_labels(s.labels)} "
                             f"{_fmt_value(s.value)}")
        return "\n".join(lines) + "\n"

    def snapshot(self) -> dict:
        """Flat name->value dict (labeled series keyed ``name{k="v"}``) —
        the periodic stats-log and benchmark view of the same data."""
        out: dict[str, float] = {}
        if not self.enabled:
            return out
        with self._lock:
            insts = list(self._instruments.values())
        for inst in insts:
            if isinstance(inst, Histogram):
                continue
            for s in inst.samples():
                out[s.name + _fmt_labels(s.labels)] = s.value
        for name, (kind, samples) in self._collect().items():
            for s in samples:
                out[s.name + _fmt_labels(s.labels)] = s.value
        return out


_default_lock = threading.Lock()
_default: MetricsRegistry | None = None


def default_registry() -> MetricsRegistry:
    """The process-wide registry every Engine/ServeFront built without an
    explicit one shares. ``REPRO_OBS=0`` boots it disabled (the no-op
    plane) — the overhead benchmark's A side."""
    global _default
    with _default_lock:
        if _default is None:
            _default = MetricsRegistry(
                enabled=os.environ.get("REPRO_OBS", "1") != "0")
        return _default


def set_default_registry(reg: MetricsRegistry) -> MetricsRegistry:
    """Swap the process default (tests, the overhead A/B benchmark).
    Returns the previous one so callers can restore it."""
    global _default
    with _default_lock:
        prev, _default = _default, reg
    return prev if prev is not None else MetricsRegistry()
