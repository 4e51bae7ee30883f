"""The window's arithmetic, from the client's own host stamps.

Every output token carries the stamp of the ``Engine.step()`` return that
brought it to the client; a request carries its submit stamp. The window
is (open, close]: a token is inside when its stamp is.

* ``rate``: tokens inside / (close - open).
* ``itl``: every gap between consecutive tokens of a request whose later
  token is inside.
* ``ttft``: submit -> first token, for requests whose first token is
  inside.
* ``percentile``: the nearest-rank percentile, an observed sample (the
  ceil(p/100 * n)-th smallest): no interpolation.
"""
from __future__ import annotations

import math


def percentile(values, p: float) -> float | None:
    xs = sorted(values)
    if not xs:
        return None
    rank = max(1, math.ceil(p / 100.0 * len(xs)))
    return xs[rank - 1]


def inside(t: float, t_open: float, t_close: float) -> bool:
    return t_open < t <= t_close


def tokens_inside(records, t_open: float, t_close: float) -> int:
    return sum(1 for r in records for t in r.stamps
               if inside(t, t_open, t_close))


def rate(records, t_open: float, t_close: float) -> float:
    return tokens_inside(records, t_open, t_close) / (t_close - t_open)


def itl(records, t_open: float, t_close: float) -> list[float]:
    return [b - a for r in records for a, b in zip(r.stamps, r.stamps[1:])
            if inside(b, t_open, t_close)]


def ttft(records, t_open: float, t_close: float) -> list[float]:
    return [r.stamps[0] - r.submit for r in records
            if r.stamps and inside(r.stamps[0], t_open, t_close)]
