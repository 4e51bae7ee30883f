"""Control plane (``serving/engine.py`` ``Engine.step``): the host's
milliseconds a step outside the replayed graph's device span, over the
window's steps: the engine's own host phases (``plan`` + ``dispatch`` +
``sync``, the last holding the wait for the device and the bookkeeping
after it) less the replay's span (CUDA events around each replay)."""
from bench.harness import replay_ms


def read(ctx):
    rows = [r for r in ctx["steps"] if r.replay is not None]
    if not rows:
        return None
    host = sum(sum(r.phases.get(k, 0.0) for k in ("plan", "dispatch", "sync"))
               for r in rows) * 1e3
    return (host - sum(replay_ms(rows))) / len(rows)
