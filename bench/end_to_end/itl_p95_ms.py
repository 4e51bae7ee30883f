"""95th percentile of all inter-token gaps, over all requests, that end
inside the window."""
from bench import stats


def read(ctx):
    v = stats.percentile(stats.itl(ctx["records"], ctx["t_open"],
                                   ctx["t_close"]), 95)
    return None if v is None else v * 1e3
