"""Fault-tolerant step execution: retry, watchdog, straggler mitigation —
the port's copy of ``repro/runtime/fault.py`` (stdlib only).

At thousand-node scale, per-step failures are routine. The policy here is
the standard production loop:

  1. every step can run under a WATCHDOG timeout (``timeout_s``): the
     step runs on a helper thread and a step that produces no result in
     time raises ``StepFault`` — the runaway thread is abandoned (there
     is no safe way to kill it), so a genuinely hung engine surfaces as
     repeated watchdog faults and escalates like any persistent fault.
     Straggler detection is softer: a step exceeding
     ``straggler_factor`` x the trailing-median step time is counted,
     and persistent stragglers escalate to a fault;
  2. a transient fault retries the step up to ``max_retries`` times
     (weights/optimizer state are step-functional: retry is exact).
     ``retry_on`` widens what counts as transient — the serving frontend
     wraps its consumer loop with ``retry_on=(Exception,)`` so a typed
     ``StoreFault`` from the weight stream (or any engine error) retries
     before failing the affected requests;
  3. a persistent fault restores from the last checkpoint (``on_restore``)
     — or, with no restore hook, raises to the caller (the serving frontend
     then fails the AFFECTED requests and keeps serving).

In one process, faults are injected by tests and chip_smoke.py's chaos
phase (the ``fault_hook``).
"""
from __future__ import annotations

import dataclasses
import queue
import statistics
import threading
import time
from typing import Any, Callable


class StepFault(RuntimeError):
    """A step failed in a way worth retrying (device error, preemption)."""


@dataclasses.dataclass
class FaultPolicy:
    max_retries: int = 2
    straggler_factor: float = 3.0
    straggler_window: int = 16
    straggler_tolerance: int = 3     # consecutive stragglers -> fault
    # watchdog: None runs the step inline (zero overhead — the training
    # loop's default); a float runs it on a helper thread and faults a
    # step that produces no result in time (the serving frontend's hung-
    # step escape hatch).
    timeout_s: float | None = None
    # exception types that count as a RETRYABLE step fault. The default
    # preserves the training loop's behavior (only explicit StepFaults
    # retry); the serving frontend widens it to (Exception,).
    retry_on: tuple = (StepFault,)


@dataclasses.dataclass
class StepStats:
    step: int
    seconds: float
    retries: int
    straggler: bool


class FaultTolerantExecutor:
    def __init__(self, step_fn: Callable, policy: FaultPolicy | None = None,
                 fault_hook: Callable[[int, int], None] | None = None,
                 on_restore: Callable[[], Any] | None = None):
        self.step_fn = step_fn
        self.policy = policy or FaultPolicy()
        self.fault_hook = fault_hook        # tests inject faults here
        self.on_restore = on_restore        # checkpoint-restore escalation
        self.times: list[float] = []
        self.history: list[StepStats] = []
        self._straggler_run = 0
        self.n_restores = 0
        self.n_retries = 0                  # total across all steps
        self.n_watchdog = 0                 # watchdog expiries

    def _median(self) -> float:
        w = self.times[-self.policy.straggler_window:]
        return statistics.median(w) if w else float("inf")

    def _call(self, args):
        """One attempt, under the watchdog when armed. The helper thread
        is daemonic and ABANDONED on expiry — its late result (or error)
        is dropped; a hung step that still holds a lock will make the
        retry hang too, expire again, and escalate past max_retries."""
        if self.policy.timeout_s is None:
            return self.step_fn(*args)
        box: queue.Queue = queue.Queue(maxsize=1)

        def attempt():
            try:
                box.put((True, self.step_fn(*args)))
            except BaseException as e:       # delivered to the waiter
                box.put((False, e))

        t = threading.Thread(target=attempt, daemon=True,
                             name="step-watchdog-attempt")
        t.start()
        try:
            ok, val = box.get(timeout=self.policy.timeout_s)
        except queue.Empty:
            self.n_watchdog += 1
            raise StepFault(
                f"step watchdog: no result within "
                f"{self.policy.timeout_s}s (step abandoned)") from None
        if ok:
            return val
        raise val

    def run_step(self, step: int, *args):
        retries = 0
        while True:
            t0 = time.monotonic()
            try:
                if self.fault_hook is not None:
                    self.fault_hook(step, retries)
                out = self._call(args)
                dt = time.monotonic() - t0
                break
            except self.policy.retry_on:
                retries += 1
                self.n_retries += 1
                if retries > self.policy.max_retries:
                    if self.on_restore is not None:
                        self.n_restores += 1
                        restored = self.on_restore()
                        if restored is not None:
                            args = restored
                        retries = 0
                        continue
                    raise
        straggler = (len(self.times) >= 4
                     and dt > self.policy.straggler_factor * self._median())
        self._straggler_run = self._straggler_run + 1 if straggler else 0
        if self._straggler_run >= self.policy.straggler_tolerance:
            # persistent straggler: treat as a fault domain -> surface it
            self._straggler_run = 0
            raise StepFault(f"persistent straggler at step {step}")
        self.times.append(dt)
        self.history.append(StepStats(step, dt, retries, straggler))
        return out
