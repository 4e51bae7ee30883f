"""Device: the share of the window in which the card ran no replay of the
step (CUDA events around each replay, against the window's host clock),
in percent. The engine is synchronous: between two replays the host
plans, dispatches and does its bookkeeping while the card waits."""
from bench.harness import replay_ms


def read(ctx):
    ms = replay_ms(ctx["steps"])
    if not ms:
        return None
    window_ms = (ctx["t_close"] - ctx["t_open"]) * 1e3
    return 100.0 * (1.0 - sum(ms) / window_ms)
