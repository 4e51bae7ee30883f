"""Scheduler (``core/scheduler.py``: admission, ``step_token_budget``,
``plan_chunks``): the model rows a step runs, prefill and decode lanes
together, over the window's steps."""


def read(ctx):
    steps = ctx["steps"]
    if not steps:
        return None
    return sum(sum(n for _, n, _ in r.work.lanes) for r in steps) / len(steps)
