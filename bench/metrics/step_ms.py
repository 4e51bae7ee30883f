"""Model step (``_step_impl`` captured and replayed, ``graphs.py``): the
device span of each replay, CUDA events around it, over the window's
steps."""
from bench.harness import replay_ms


def read(ctx):
    ms = replay_ms(ctx["steps"])
    return sum(ms) / len(ms) if ms else None
