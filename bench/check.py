"""How ``correct`` is decided, after the window has closed and the
program's state is freed.

* the gaps: a sample of the requests the window finished, drawn from the
  seed: the longest of them, one of each engine slot, and more up to the
  cell's ``served_tokens`` and ``requests``. The plain reference runs once over
  each prompt with its served tokens (teacher-forced, whole, f32, TF32
  off) and each served token's reference logit is held against the
  reference's best at its position. ``max_gap`` is the widest gap, in
  logits; ``mean_gap`` their mean; ``mismatch_share`` the share of served
  tokens that are not the reference's best. A cell's ``check.limits``
  names the numbers it compares. Greedy decoding serves the program's own
  best, so a sound program reads its rounding only.
* ``alg2_steps_off``: the steps whose Algorithm 2 bitmap (the engine's
  ``npu_fraction`` counter) is not what the algorithm gives for the
  engine's KV lengths up to that step (``reference/alg2.py``). The
  reference splits each position's Q and O projections by that counter:
  this holds the counter to the algorithm.

``control`` runs the reference a second time with every bfloat16
activation rounded to float8 and reads the gap of the token it puts first
at each position: the control's picks, judged as the program's are.
"""
from __future__ import annotations

import numpy as np
import torch

from bench.reference import alg2
from bench.reference import common as rc
from bench.weights import family


def sample(records, seed: int, check: dict) -> list:
    """The requests compared: the longest finished one; then, in an order
    drawn from the seed, the first request of each engine slot not yet in
    the sample, so that every slot's output is judged; then further
    requests in that order while the count stays within the cell's
    ``requests`` and the served tokens within its ``served_tokens``."""
    if not records:
        return []
    longest = max(records, key=lambda r: (len(r.prompt) + len(r.out),
                                          -r.index))
    rest = [r for r in records if r is not longest]
    order = [rest[int(i)] for i in np.random.default_rng(
        [seed, 2 << 20]).permutation(len(rest))]
    out, slots = [longest], {longest.slot}
    for r in order:
        if r.slot not in slots:
            out.append(r)
            slots.add(r.slot)
    taken = {id(r) for r in out}
    served = sum(len(r.out) for r in out)
    for r in order:
        if (id(r) in taken or len(out) >= check["requests"]
                or served + len(r.out) > check["served_tokens"]):
            continue
        out.append(r)
        served += len(r.out)
    return out


def positions_on(rec, n_on_start: int) -> np.ndarray:
    """Algorithm 2's NPU column groups at each position of ``rec``'s
    teacher-forced sequence, from the steps that ran it."""
    n = len(rec.prompt) + len(rec.out) - 1
    on = np.full((n,), n_on_start, np.int64)
    r0 = 0
    for r1, groups in rec.segs:
        on[r0:r1] = groups
        r0 = r1
    return on


def readings(g: torch.Tensor) -> dict:
    """The numbers a cell may compare, over all served tokens' gaps."""
    return {"max_gap": float(g.max()), "mean_gap": float(g.mean()),
            "mismatch_share": float((g > 0).float().mean())}


def gaps(model: dict, seed: int, rber: float, recs, device,
         modes=("ref",)) -> dict:
    """{mode: readings} over the sample's served tokens ("ref": the
    program's tokens against the reference; "control": the control's own
    first token at each position), and the tokens compared."""
    wt = rc.Weights(model, seed, rber, device)
    seqs = [torch.as_tensor(r.prompt + r.out[:-1], device=device)
            for r in recs]
    first = [len(r.prompt) - 1 for r in recs]
    on = [torch.as_tensor(positions_on(r, model["alg2_groups"]),
                          device=device) for r in recs]
    with torch.no_grad():
        logits = family(model).forward(model, wt, seqs, first, on,
                                       ("ref",) + tuple(
                                           m for m in modes if m != "ref"))
    ref = logits["ref"]
    out = {"tokens": sum(len(r.out) for r in recs)}
    served = torch.cat([torch.as_tensor(r.out, device=device)
                        for r in recs])
    ref_all = torch.cat(ref)
    out["ref"] = readings(rc.gaps(ref_all, served))
    if "control" in modes:
        picks = torch.cat(logits["control"]).argmax(-1)
        out["control"] = readings(rc.gaps(ref_all, picks))
    return out


def routed_experts(model: dict, seed: int, rber: float, segments,
                   device) -> None:
    """Each step's distinct experts a layer, for the stretches of steps run
    past the window (``segments``, in the order they ran), from the
    reference's routes over the same tokens (each request's tokens when
    the last stretch ended), set on the steps' work
    (``roofline.Step.experts``). Near-ties aside, these are the routes the
    step's kernels served."""
    tokens, rows = {}, {}
    for seg in segments:
        tokens.update(seg.tokens)
        for ran in seg.ran:
            for rec, ctx, n in ran:
                rows[id(rec)] = max(rows.get(id(rec), 0), ctx + n)
    keys = list(rows)
    seqs = [torch.as_tensor(tokens[k][:rows[k]], device=device)
            for k in keys]
    offset = dict(zip(keys, np.cumsum([0] + [rows[k] for k in keys])))
    routes: list = []
    wt = rc.Weights(model, seed, rber, device)
    with torch.no_grad():
        family(model).forward(model, wt, seqs, [len(t) for t in seqs],
                              [None] * len(seqs), ("ref",), routes=routes)
    for seg in segments:
        for work, ran in zip(seg.works, seg.ran):
            pos = torch.cat([torch.arange(offset[id(rec)] + ctx,
                                          offset[id(rec)] + ctx + n)
                             for rec, ctx, n in ran]).to(device)
            work.experts = [int(torch.unique(r[pos]).numel())
                            for r in routes]


def alg2_steps_off(stats: list, model: dict) -> int:
    want = alg2.groups_on([s["kv_len"] for s in stats], model)
    h = model["alg2_groups"]
    return sum(1 for s, w in zip(stats, want)
               if round(s["npu_fraction"] * h) != w)
