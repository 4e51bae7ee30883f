"""Per-step timeline: a bounded ring of Engine.step phase breakdowns.

``Engine.stats`` (the per-step list the scheduler reads) grows without
bound and carries device-side counters only; the timeline is the HOST
time view — where one step's wall clock went (plan / embed / group
dispatch / stream-wait / route-sync / acquire / finish / sync-back) and
how much of it was stall. It is a fixed-capacity ring so a long-lived
server keeps the last N steps at O(N) memory, and it is what the
periodic stats view summarizes from.
"""
from __future__ import annotations

import threading

__all__ = ["StepTimeline"]


class StepTimeline:
    """Thread-safe fixed-capacity ring of per-step records (dicts)."""

    def __init__(self, capacity: int = 256):
        if capacity < 1:
            raise ValueError("StepTimeline needs capacity >= 1")
        self.capacity = int(capacity)
        self._ring: list[dict | None] = [None] * self.capacity
        self._next = 0                   # total records ever written
        self._lock = threading.Lock()

    def record(self, step: int, phases: dict[str, float], **extra):
        """Append one step's record: ``step`` number, ``phases`` mapping
        phase name -> seconds, plus any scalar extras (tokens, stall_s)."""
        rec = {"step": int(step), "phases": dict(phases), **extra}
        with self._lock:
            self._ring[self._next % self.capacity] = rec
            self._next += 1

    @property
    def total_recorded(self) -> int:
        with self._lock:
            return self._next

    def __len__(self) -> int:
        with self._lock:
            return min(self._next, self.capacity)

    def snapshot(self, n: int | None = None) -> list[dict]:
        """The last ``n`` (default: all retained) records, oldest first —
        contiguous across wraparound (tested in tests/test_torch_obs.py)."""
        with self._lock:
            have = min(self._next, self.capacity)
            take = have if n is None else min(int(n), have)
            start = self._next - take
            return [dict(self._ring[i % self.capacity])
                    for i in range(start, self._next)]

    def summary(self) -> dict:
        """Aggregate view for the periodic stats line: per-phase total
        seconds over the retained window plus step/stall totals."""
        recs = self.snapshot()
        phases: dict[str, float] = {}
        stall = 0.0
        for r in recs:
            for k, v in r["phases"].items():
                phases[k] = phases.get(k, 0.0) + v
            stall += r.get("stall_s", 0.0)
        return {"steps_retained": len(recs),
                "steps_total": self.total_recorded,
                "phase_seconds": phases,
                "stall_seconds": stall}
