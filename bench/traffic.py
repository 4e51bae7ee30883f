"""The one traffic generator. A mix is ``traffic/<name>.json``:

    {"loop": "closed", "clients": 8,
     "prompt": {"dist": "log_uniform" | "uniform", "min": 16, "max": 256},
     "output": {"dist": ..., "min": 8, "max": 64},
     "pool": 64, "order": "seeded" | "fixed"}

``pool`` request sizes are fixed by the mix alone: the i-th takes the
prompt length at quantile (i + 1/2) / pool of its distribution and the
output length at the quantile (i + 1/2) * phi mod 1, so every seed serves
the same set of sizes. The pool is dealt out in cycles, each cycle a fresh
permutation, except that the request with the longest context opens the
first cycle (it drives Algorithm 2's bitmap to the state the mix holds it
in, within the warm-up). ``order`` "seeded" (the default) draws each
cycle's permutation from the seed; "fixed" draws it from the cycle's
number alone, so every seed sends the same sizes in the same order: where
a window holds only a few cycles of long requests, the order decides how
many prefill steps fall inside it, and a seeded order would change the
window's work from seed to seed. Prompt token ids are uniform over the
vocabulary, drawn from (seed, request index). A closed loop's clients each
send their next request when the previous one has completed.
"""
from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
PHI = (math.sqrt(5.0) - 1.0) / 2.0


@dataclasses.dataclass(frozen=True)
class Request:
    index: int
    prompt: list
    max_new: int


def load(name: str, root: Path = HERE) -> dict:
    return json.loads((root / "traffic" / f"{name}.json").read_text())


def _length(spec: dict, u: float) -> int:
    lo, hi = spec["min"], spec["max"]
    if spec["dist"] == "log_uniform":
        v = math.exp(math.log(lo) + u * (math.log(hi) - math.log(lo)))
    elif spec["dist"] == "uniform":
        v = lo + u * (hi - lo)
    else:
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    return int(min(max(round(v), lo), hi))


def sizes(mix: dict) -> list[tuple[int, int]]:
    """The pool's (prompt length, output length) pairs, seed-free."""
    n = mix["pool"]
    return [(_length(mix["prompt"], (i + 0.5) / n),
             _length(mix["output"], ((i + 0.5) * PHI) % 1.0))
            for i in range(n)]


def max_context(mix: dict) -> int:
    """The most KV rows a request of the mix holds."""
    return max(p + o - 1 for p, o in sizes(mix))


class Stream:
    """The seed's requests, in the order the clients take them."""

    def __init__(self, mix: dict, vocab: int, seed: int):
        self.mix, self.vocab, self.seed = mix, vocab, seed
        self.pool = sizes(mix)
        self.order: list[int] = []
        self.cycle = 0
        self.index = 0

    def _refill(self):
        fixed = self.mix.get("order", "seeded") == "fixed"
        rng = np.random.default_rng(
            [1 << 21, self.cycle] if fixed else [self.seed, self.cycle])
        perm = [int(i) for i in rng.permutation(len(self.pool))]
        if self.cycle == 0:
            longest = max(range(len(self.pool)),
                          key=lambda i: sum(self.pool[i]))
            perm.remove(longest)
            perm.insert(0, longest)
        self.order.extend(perm)
        self.cycle += 1

    def next(self) -> Request:
        if not self.order:
            self._refill()
        p_len, out_len = self.pool[self.order.pop(0)]
        rng = np.random.default_rng([self.seed, 1 << 20, self.index])
        prompt = rng.integers(0, self.vocab, size=p_len).tolist()
        req = Request(self.index, prompt, out_len)
        self.index += 1
        return req
