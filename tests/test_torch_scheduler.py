"""Algorithm 2, the admission planner and the paged KV pool of the port
against the JAX package, bit for bit (integer and host work), on the same
seeded operation sequences."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import scheduler as jsched
from repro.serving.kvcache import PagedKVPool as JPool
from repro_torch.core import scheduler as tsched
from repro_torch.serving.kvcache import PagedKVPool as TPool

torch.set_num_threads(2)


@pytest.mark.parametrize("kv_aware", [True, False])
@pytest.mark.parametrize("cfg_kw", [dict(column_bytes=128, h=32),
                                    dict(column_bytes=4096, h=32),
                                    dict(column_bytes=64, h=4)])
def test_kv_aware_step_is_bit_exact(kv_aware, cfg_kw):
    jcfg, tcfg = jsched.SchedulerConfig(**cfg_kw), tsched.SchedulerConfig(**cfg_kw)
    rng = np.random.default_rng(sum(cfg_kw.values()))
    kv = np.cumsum(rng.integers(0, 40, 200))           # a growing cache
    jb, jp = jsched.init_bitmap(jcfg), jnp.int32(0)
    tb, tp = tsched.init_bitmap(tcfg), torch.tensor(0, dtype=torch.int32)
    for n in kv:
        jb, jp, jd = jsched.kv_aware_step(jb, jp, jnp.int32(n), 128, 4, 32,
                                          jcfg, kv_aware)
        tb, tp, td = tsched.kv_aware_step(tb, tp, torch.tensor(int(n)), 128,
                                          4, 32, tcfg, kv_aware)
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
        assert int(tp) == int(jp) and int(td) == int(jd)
        assert float(tsched.npu_fraction(tb)) == float(jsched.npu_fraction(jb))
    if kv_aware and cfg_kw["column_bytes"] == 4096:
        assert int(tb.sum()) < tcfg.h          # the cache growth offloaded


def test_estimate_attention_cycles_is_bit_exact():
    for n in (0, 1, 255, 256, 2047, 10**6):
        assert int(tsched.estimate_attention_cycles(n, 4096, 32, 128)) == \
            int(jsched.estimate_attention_cycles(n, 4096, 32, 128))


def test_step_token_budget_is_identical():
    for adaptive in (True, False):
        for budget, floor in ((32, 0.25), (64, 0.1), (1, 0.0)):
            j = jsched.AdmissionConfig(token_budget=budget,
                                       budget_floor=floor, adaptive=adaptive)
            t = tsched.AdmissionConfig(token_budget=budget,
                                       budget_floor=floor, adaptive=adaptive)
            for f in np.linspace(-0.2, 1.2, 15):
                for s in (0.0, 0.3, 1.0):
                    assert tsched.step_token_budget(t, f, s) == \
                        jsched.step_token_budget(j, f, s)


def test_plan_chunks_is_identical():
    rng = np.random.default_rng(4)
    for _ in range(300):
        slots = rng.permutation(8)
        n_dec = int(rng.integers(0, 5))
        dec = [int(s) if rng.random() < 0.5 else (int(s), int(rng.integers(1, 5)))
               for s in slots[:n_dec]]
        pre = [(int(s), int(rng.integers(1, 60))) for s in slots[n_dec:]]
        cancelled = {int(s) for s in slots if rng.random() < 0.15}
        budget = int(rng.integers(1, 40))
        chunk = int(rng.integers(1, 17))
        assert tsched.plan_chunks(dec, pre, budget, chunk, cancelled) == \
            jsched.plan_chunks(dec, pre, budget, chunk, cancelled)


def test_split_projection_matches_reference():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 64), np.float32)
    w = rng.standard_normal((64, 96), np.float32)
    flash = rng.standard_normal((3, 96), np.float32)
    bitmap = np.array([1, 0, 1, 1, 0, 0, 1, 0], np.int32)
    got = tsched.split_projection(*map(torch.from_numpy, (x, w, flash, bitmap)))
    want = jsched.split_projection(x, w, flash, bitmap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def _pool_state(pool):
    return (pool.block_tables.tolist(), list(pool.free_blocks),
            list(pool.free_slots), pool.ref_count.tolist(),
            pool.reserved.tolist(), dict(pool.active), pool.lengths.tolist(),
            pool.n_free_blocks)


@pytest.mark.parametrize("seed", range(6))
def test_paged_kv_pool_tracks_the_reference(seed):
    """The same seeded alloc/grow/bump/release sequence on both pools: the
    same slots, block tables, free lists, ref counts and reservations
    after every operation, and the allocator invariants hold."""
    rng = np.random.default_rng(seed)
    args = (1, 4, 24, 2, 4)
    jp = JPool(*args, block_size=4, n_blocks=13)
    tp = TPool(*args, block_size=4, n_blocks=13, device="cpu")
    live: dict[int, int] = {}
    for rid in range(60):
        op = rng.choice(["alloc", "grow", "release"])
        n = int(rng.integers(1, 25))
        if op == "alloc":
            s_j, s_t = jp.alloc(rid, need_tokens=n), tp.alloc(rid, n)
            assert s_j == s_t
            if s_t is not None:
                live[s_t] = n
        elif op == "grow" and live:
            s = sorted(live)[int(rng.integers(len(live)))]
            new_len = min(n, live[s])            # never past the reservation
            jp.ensure(s, new_len)
            tp.ensure(s, new_len)
            if new_len > tp.lengths[s]:
                jp.bump(s, new_len - int(jp.lengths[s]))
                tp.bump(s, new_len - int(tp.lengths[s]))
        elif op == "release" and live:
            s = sorted(live)[int(rng.integers(len(live)))]
            jp.release(s)
            tp.release(s)
            del live[s]
        assert _pool_state(tp) == _pool_state(jp)
        mapped = tp.block_tables[np.nonzero(tp.block_tables)]
        assert len(set(mapped.tolist())) == len(mapped), "double-mapped"
        assert 0 not in mapped, "dump block handed out"
        assert len(mapped) + len(tp.free_blocks) == tp.n_blocks - 1
        assert tp.n_free_blocks >= 0
        for s in live:
            assert tp.capacity(s) >= tp.lengths[s]
    np.testing.assert_array_equal(tp.lengths_dev.numpy(),
                                  np.asarray(jp.lengths_dev))


def test_pool_exhaustion_and_reuse():
    pool = TPool(1, 2, 16, 2, 4, block_size=4, n_blocks=5, device="cpu")
    s1 = pool.alloc(0, need_tokens=8)
    s2 = pool.alloc(1, need_tokens=8)
    pool.ensure(s1, 8)
    pool.ensure(s2, 8)
    used = set(pool.block_tables[s1, :2].tolist()) \
        | set(pool.block_tables[s2, :2].tolist())
    assert len(used) == 4 and 0 not in used
    assert pool.n_free_blocks == 0
    assert pool.alloc(2, need_tokens=4) is None  # exhausted, not corrupted
    pool.release(s1)
    assert pool.alloc(3, need_tokens=8) is not None
    with pytest.raises(ValueError, match="max_seq"):
        pool.alloc(4, need_tokens=17)
