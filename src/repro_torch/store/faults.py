"""The typed store fault — the port's copy of ``repro/store/faults.py``'s
``StoreFault`` (the fault injector and read-retry plane are not ported)."""
from __future__ import annotations


class StoreFault(RuntimeError):
    """A store/stream fetch failed past its retry budget — the typed
    escalation a streamer worker hands its consumer instead of a bare
    exception."""
