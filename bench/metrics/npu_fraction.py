"""Scheduler, Algorithm 2 (``core/scheduler.py``): the share of the
projection column groups on the NPU while a step runs (the engine's
``npu_fraction`` counter of the step before), over the window's steps, in
percent."""


def read(ctx):
    steps = ctx["steps"]
    if not steps:
        return None
    h = ctx["model"]["alg2_groups"]
    return 100.0 * sum(r.work.n_on for r in steps) / (h * len(steps))
