"""ObsPlane: the serving stack's observability plane — the port's copy
of ``repro/obs`` (stdlib only, so nothing here differs from the
reference but the package it lives in).

Three pieces, one process-wide default of each:

  * ``MetricsRegistry`` (registry.py) — thread-safe counters / gauges /
    fixed-log-bucket histograms plus scrape-time collectors, exposed as
    Prometheus text at ``GET /v1/metrics``;
  * ``Tracer`` (trace.py) — Chrome trace-event spans on fixed tracks
    (compute / stream / pool / NAND / requests), exported with
    ``Tracer.export``;
  * ``StepTimeline`` (timeline.py) — a bounded ring of per-step host
    phase breakdowns (``Engine.timeline``).

Everything is import-cheap and dependency-free (stdlib only) so the
store layer can import it without cycles, and everything has a
zero-overhead disabled mode (``REPRO_OBS=0`` / ``enabled=False``).
"""
from repro_torch.obs.registry import (Counter, Gauge, Histogram,
                                      HistSnapshot, LATENCY_BUCKETS_S,
                                      MetricsRegistry, Sample,
                                      default_registry, log_buckets,
                                      set_default_registry)
from repro_torch.obs.timeline import StepTimeline
from repro_torch.obs.trace import (TID_COMPUTE, TID_NAND, TID_POOL,
                                   TID_REQUEST0, TID_STREAM, Tracer,
                                   default_tracer, set_default_tracer)

__all__ = [
    "Counter", "Gauge", "Histogram", "HistSnapshot", "LATENCY_BUCKETS_S",
    "MetricsRegistry", "Sample", "default_registry", "log_buckets",
    "set_default_registry", "StepTimeline", "Tracer", "default_tracer",
    "set_default_tracer", "TID_COMPUTE", "TID_NAND", "TID_POOL",
    "TID_REQUEST0", "TID_STREAM",
]
