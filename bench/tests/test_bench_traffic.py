"""The traffic generator: deterministic in the seed, a different order
for another seed, the same set of sizes for every seed."""
from __future__ import annotations

import bench_testlib as lib  # noqa: F401  (import paths)
from bench import traffic


def take(mix, seed, n=96, vocab=50272):
    s = traffic.Stream(mix, vocab, seed)
    return [s.next() for _ in range(n)]


def test_same_seed_same_requests():
    mix = traffic.load("short-chat")
    a, b = take(mix, 3_000_000_007), take(mix, 3_000_000_007)
    assert [(r.prompt, r.max_new) for r in a] == \
        [(r.prompt, r.max_new) for r in b]


def test_other_seed_other_order_same_sizes():
    mix = traffic.load("short-chat")
    n = mix["pool"]
    a, b = take(mix, 1, n), take(mix, 2, n)
    sa = [(len(r.prompt), r.max_new) for r in a]
    sb = [(len(r.prompt), r.max_new) for r in b]
    assert sa != sb
    assert sorted(sa) == sorted(sb) == sorted(traffic.sizes(mix))
    assert a[0].prompt != b[0].prompt


def test_sizes_follow_the_mix():
    for name in ("short-chat", "long-decode", "long-decode-3k"):
        mix = traffic.load(name)
        ps, outs = zip(*traffic.sizes(mix))
        assert mix["prompt"]["min"] <= min(ps) <= max(ps) <= mix["prompt"]["max"]
        assert mix["output"]["min"] <= min(outs) <= max(outs) \
            <= mix["output"]["max"]
        assert len(set(ps)) > len(ps) // 2


def test_longest_request_opens_every_seed():
    mix = traffic.load("long-decode")
    longest = max(sum(p) for p in traffic.sizes(mix))
    for seed in (0, 5, 2**31 + 9):
        r = take(mix, seed, 1)[0]
        assert len(r.prompt) + r.max_new == longest
        assert traffic.max_context(mix) == longest - 1


def test_token_ids_cover_the_vocabulary():
    r = take(traffic.load("short-chat"), 9, 64, vocab=1000)
    ids = [t for q in r for t in q.prompt]
    assert 0 <= min(ids) and max(ids) < 1000 and len(set(ids)) > 900


def test_a_fixed_order_is_the_same_for_every_seed():
    mix = traffic.load("long-decode")
    assert mix["order"] == "fixed"
    n = 3 * mix["pool"]
    a, b = take(mix, 1, n), take(mix, 2**31 + 5, n)
    assert [(len(r.prompt), r.max_new) for r in a] == \
        [(len(r.prompt), r.max_new) for r in b]
    assert a[0].prompt != b[0].prompt
    assert sorted((len(r.prompt), r.max_new) for r in a[:mix["pool"]]) == \
        sorted(traffic.sizes(mix))
