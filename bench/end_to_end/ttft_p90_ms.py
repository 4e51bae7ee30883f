"""90th percentile of time to first token, from the client's submit, over
the requests whose first token falls inside the window."""
from bench import stats


def read(ctx):
    v = stats.percentile(stats.ttft(ctx["records"], ctx["t_open"],
                                    ctx["t_close"]), 90)
    return None if v is None else v * 1e3
