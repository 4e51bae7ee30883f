"""Every output token emitted inside the window over the window's
seconds."""
from bench import stats


def read(ctx):
    return stats.rate(ctx["records"], ctx["t_open"], ctx["t_close"])
