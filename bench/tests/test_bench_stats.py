"""The window's arithmetic on synthetic stamps: exact percentiles, the
window's rate, the inter-token gaps and TTFT; a stall inside the window
moves both the rate and the gap tail."""
from __future__ import annotations

import dataclasses

import bench_testlib as lib  # noqa: F401
from bench import stats


@dataclasses.dataclass
class Rec:
    submit: float
    stamps: list


def steady(n_req=4, step=0.025, steps=400, stall_every=0, stall=0.0):
    """n_req requests emitting a token every step from t=0.1; every
    ``stall_every``-th step after t=2 waits ``stall`` seconds more."""
    recs = [Rec(0.0, []) for _ in range(n_req)]
    t = 0.1
    for i in range(steps):
        if stall_every and t > 2.0 and i % stall_every == 0:
            t += stall
        for r in recs:
            r.stamps.append(t)
        t += step
    return recs


def test_percentile_is_nearest_rank():
    xs = list(range(1, 101))
    assert stats.percentile(xs, 95) == 95
    assert stats.percentile(xs, 90) == 90
    assert stats.percentile([5.0], 95) == 5.0
    assert stats.percentile([3, 1, 2, 4], 50) == 2
    assert stats.percentile([], 95) is None


def test_rate_counts_tokens_inside():
    recs = steady()
    # (1.0, 6.0]: stamps 0.1 + 0.025 i for i in 37..236 -> 200 steps
    assert stats.tokens_inside(recs, 1.0, 6.0) == 4 * 200
    assert abs(stats.rate(recs, 1.0, 6.0) - 160.0) < 1e-9


def test_itl_and_ttft():
    recs = steady()
    gaps = stats.itl(recs, 1.0, 6.0)
    assert len(gaps) == 4 * 200
    assert all(abs(g - 0.025) < 1e-9 for g in gaps)
    late = [Rec(1.5, [2.0, 2.1]), Rec(0.5, [0.9, 1.2])]
    assert stats.ttft(late, 1.0, 6.0) == [0.5]


def test_a_stall_moves_the_tail_and_the_rate():
    base, stalled = steady(), steady(stall_every=10, stall=0.05)
    assert abs(stats.percentile(stats.itl(base, 1.0, 6.0), 95) - 0.025) \
        < 1e-9
    # a tenth of the gaps inside the window are 75 ms: past the 95th
    p95 = stats.percentile(stats.itl(stalled, 1.0, 6.0), 95)
    assert abs(p95 - 0.075) < 1e-9
    assert stats.percentile(stats.itl(stalled, 1.0, 6.0), 50) < 0.026
    assert stats.rate(stalled, 1.0, 6.0) < 0.9 * stats.rate(base, 1.0, 6.0)
