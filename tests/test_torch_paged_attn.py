"""Paged attention's plain version (the CPU path of
``kernels/paged_attn.paged_attn``), its windowed path and the port's
``chunk_attention_paged`` against the JAX package: the Pallas kernel in
interpret mode and the XLA reference, on ragged lengths, empty contexts and
scrambled physical blocks. Inputs are made with numpy from a seed and fed
to both packages."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.erdpe import ExecMode
from repro.kernels import ops
from repro.kernels.paged_attn import paged_attn_pallas, paged_attn_xla
from repro.models import common as jcm
from repro_torch import interop
from repro_torch.kernels import paged_attn as tpa
from repro_torch.models import common as tcm

torch.set_num_threads(2)

# f32 inputs: the same math in another summation order (the JAX file's
# tolerance); bf16 inputs: p is rounded to bf16 relative to the running max
# in the Pallas kernel and to the global max in the XLA reference and the
# plain version, one bf16 rounding apart (the JAX file's bf16 tolerance).
TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def _inputs(seed, b, s, t, h, n_kv, dh, bs, ctx, dtype):
    """Chunk queries, chunk K/V and a scrambled paged pool holding each
    slot's ``ctx`` context rows (garbage everywhere else)."""
    rng = np.random.default_rng(seed)
    max_blocks = s // bs
    n_blocks = 1 + b * max_blocks

    def mk(*shape):
        return np.asarray(jnp.asarray(rng.standard_normal(shape, np.float32)
                                      ).astype(dtype))
    q, kn, vn = mk(b, t, h, dh), mk(b, t, n_kv, dh), mk(b, t, n_kv, dh)
    k_pool, v_pool = mk(n_blocks, bs, n_kv, dh), mk(n_blocks, bs, n_kv, dh)
    perm = rng.permutation(np.arange(1, n_blocks))
    tables = np.zeros((b, max_blocks), np.int32)
    pi = 0
    for i in range(b):
        for j in range(-(-ctx[i] // bs)):
            tables[i, j] = perm[pi]
            pi += 1
    return dict(q=q, k_pool=k_pool, v_pool=v_pool, tables=tables,
                ctx=np.asarray(ctx, np.int32), kn=kn, vn=vn)


def _t(d):
    return {k: interop.tensor_from_numpy(v, device="cpu")
            for k, v in d.items()}


def _close(got, want, dtype, msg=""):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), err_msg=msg,
                               **TOL[dtype])


CASES = [  # b, s, t, h, n_kv, dh, bs, ctx
    (1, 32, 1, 4, 4, 32, 16, [11]),          # MHA decode (T=1)
    (3, 32, 5, 4, 2, 32, 8, [11, 22, 0]),    # GQA chunk, ragged + empty
    (2, 32, 7, 8, 1, 16, 4, [32, 3]),        # MQA, tiny blocks, full table
]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_state_matches_pallas_and_xla(case, dtype):
    b, s, t, h, n_kv, dh, bs, ctx = case
    x = _inputs(b * t + h, b, s, t, h, n_kv, dh, bs, ctx, dtype)
    tx = _t(x)
    got = tpa.paged_attention_state(tx["q"], tx["k_pool"], tx["v_pool"],
                                    tx["tables"], tx["ctx"])
    args = (x["q"], x["k_pool"], x["v_pool"], x["tables"], x["ctx"])
    for impl, want in {
            "pallas": ops.paged_attention_state(*args, interpret=True),
            "xla": ops.paged_attention_state_xla(*args)}.items():
        for g, w, name in zip(got, want, ("acc", "m", "l")):
            _close(g, w, dtype, f"{impl} {name}")
    empty = x["ctx"] == 0
    assert bool(torch.isneginf(got[1][torch.from_numpy(empty)]).all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_raw_paged_attn_matches_raw_kernels(dtype):
    """The grouped-query level: paged_attn (plain on the CPU) against
    paged_attn_pallas (interpret) and paged_attn_xla."""
    x = _inputs(4, 3, 32, 5, 4, 2, 32, 8, [11, 22, 0], dtype)
    qg = np.asarray(ops._group_chunk_queries(jnp.asarray(x["q"]), 2,
                                             jnp.asarray(x["k_pool"]).dtype))
    tq = tpa.group_chunk_queries(
        interop.tensor_from_numpy(x["q"], device="cpu"), 2,
        interop.tensor_from_numpy(x["k_pool"], device="cpu").dtype)
    np.testing.assert_array_equal(tq.float().numpy(), qg.astype(np.float32))
    tx = _t(x)
    got = tpa.paged_attn(tq, tx["k_pool"], tx["v_pool"], tx["tables"],
                         tx["ctx"])
    args = (qg, x["k_pool"], x["v_pool"], x["tables"], x["ctx"])
    for impl, want in {"pallas": paged_attn_pallas(*args, interpret=True),
                       "xla": paged_attn_xla(*args)}.items():
        for g, w, name in zip(got, want, ("acc", "m", "l")):
            _close(g, w, dtype, f"{impl} {name}")


@pytest.mark.parametrize("window", [1, 5, 20])
def test_windowed_plain_path_matches_xla(window):
    b, s, t, h, n_kv, dh, bs, ctx = 3, 32, 5, 4, 2, 16, 8, [11, 22, 0]
    x = _inputs(9, b, s, t, h, n_kv, dh, bs, ctx, "float32")
    q_pos = x["ctx"][:, None] + np.arange(t)[None, :]
    tx = _t(x)
    got = tpa.paged_attention_state_plain(
        tx["q"], tx["k_pool"], tx["v_pool"], tx["tables"], tx["ctx"],
        window=window, q_positions=torch.from_numpy(q_pos))
    want = ops.paged_attention_state_xla(
        x["q"], x["k_pool"], x["v_pool"], x["tables"], x["ctx"],
        window=window, q_positions=jnp.asarray(q_pos))
    for g, w, name in zip(got, want, ("acc", "m", "l")):
        _close(g, w, "float32", name)


@pytest.mark.parametrize("mode", [ExecMode.XLA, ExecMode.PALLAS])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 3])
def test_chunk_attention_paged_matches_reference(mode, dtype, window):
    """Paged context + intra-chunk causal term, merged; ragged contexts
    including an EMPTY one (fresh prefill)."""
    b, s, t, h, n_kv, dh, bs = 3, 24, 5, 4, 2, 16, 8
    x = _inputs(9, b, s, t, h, n_kv, dh, bs, [0, 7, 24], dtype)
    tx = _t(x)
    got = tcm.chunk_attention_paged(tx["q"], tx["k_pool"], tx["v_pool"],
                                    tx["tables"], tx["ctx"], tx["kn"],
                                    tx["vn"], window=window)
    want = jcm.chunk_attention_paged(
        x["q"], x["k_pool"], x["v_pool"], x["tables"], x["ctx"], x["kn"],
        x["vn"], window=window, mode=mode)
    assert got.dtype == interop.tensor_from_numpy(x["q"], device="cpu").dtype
    _close(got, want, dtype)
    assert not torch.isnan(got.float()).any()


def test_wrapper_checks_what_the_kernel_takes_on_the_cpu_too():
    """The engine's grouped queries are contiguous (a permuted view would
    be refused by the kernel), and the wrapper refuses a non-contiguous q
    on the CPU as it does on the card."""
    x = _inputs(1, 2, 32, 16, 4, 4, 32, 16, [5, 0], "bfloat16")
    tx = _t(x)
    qg = tpa.group_chunk_queries(tx["q"], 4, torch.bfloat16)
    assert qg.is_contiguous()
    args = (tx["k_pool"], tx["v_pool"], tx["tables"], tx["ctx"])
    tpa.paged_attn(qg, *args)
    with pytest.raises(ValueError, match="contiguous"):
        tpa.paged_attn(qg.transpose(2, 3).contiguous().transpose(2, 3), *args)
    with pytest.raises(TypeError):
        tpa.paged_attn(qg, *args[:2], tx["tables"].long(), tx["ctx"])


def _grouped(seed, b, n_kv, tr, dh, bs, ctx, max_blocks, dtype):
    """Grouped, pre-scaled queries and a scrambled pool, numpy."""
    x = _inputs(seed, b, max_blocks * bs, tr, n_kv, n_kv, dh, bs, ctx, dtype)
    qg = np.asarray(ops._group_chunk_queries(jnp.asarray(x["q"]), n_kv,
                                             jnp.asarray(x["k_pool"]).dtype))
    return qg, x["k_pool"], x["v_pool"], x["tables"], x["ctx"]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ordered_plain_matches_pallas_walk(case, dtype):
    """The plain version in the kernel's order, walking the whole table in
    one range, is the Pallas kernel's sequential walk: m and l to f32
    rounding, acc to ORDERED_REL_TOL (the same bf16 roundings of p)."""
    b, s, t, h, n_kv, dh, bs, ctx = case
    args = _grouped(b * t + h, b, n_kv, t * (h // n_kv), dh, bs, ctx, s // bs,
                    dtype)
    acc, m, l = tpa.paged_attn_plain_ordered(
        *(interop.tensor_from_numpy(a, device="cpu") for a in args),
        blocks_per_split=s)
    acc_w, m_w, l_w = (torch.from_numpy(np.array(a)) for a in
                       paged_attn_pallas(*args, interpret=True))
    torch.testing.assert_close(m, m_w, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(l, l_w, rtol=1e-5, atol=1e-5)
    rel = float((acc - acc_w).norm()) / max(float(acc_w.norm()), 1e-6)
    assert rel <= tpa.ORDERED_REL_TOL, rel


@pytest.mark.parametrize("bps", [1, 2, 3, 64])
def test_ordered_plain_splits_merge_to_the_plain_state(bps):
    """f32 pool (no rounding of p): any cut of the table into ranges merges
    to the plain version's state."""
    args = [interop.tensor_from_numpy(a, device="cpu") for a in
            _grouped(5, 3, 2, 6, 16, 4, [0, 13, 30], 8, "float32")]
    got = tpa.paged_attn_plain_ordered(*args, blocks_per_split=bps)
    for g, w in zip(got, tpa.paged_attn_plain(*args)):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


def test_kernel_errors_pass_the_pallas_kernel_and_flag_faults():
    """kernel_errors, the checks the CUDA kernel is held to on the card,
    pass the Pallas kernel's output (interpret mode) on the same inputs and
    fail a state that left out the bf16 rounding of p, and one that read a
    wrong pool block."""
    max_blocks = 16
    args = _grouped(7, 2, 2, 8, 64, 16, [200, 57], max_blocks, "bfloat16")
    targs = [interop.tensor_from_numpy(a, device="cpu") for a in args]

    def errors(state):
        return tpa.kernel_errors(*targs, *state, blocks_per_split=max_blocks)

    good = errors([torch.from_numpy(np.array(a)) for a in
                   paged_attn_pallas(*args, interpret=True)])
    assert max(v for k, v in good.items() if k != "max_abs_err") <= 1, good
    # f32 pools holding the same values: p is not rounded
    unrounded = errors(tpa.paged_attn_plain_ordered(
        targs[0], targs[1].float(), targs[2].float(), *targs[3:],
        blocks_per_split=max_blocks))
    assert unrounded["acc_vs_ordered"] > 1, unrounded
    tables = args[3].copy()
    tables[0, 3] = tables[1, 0]                 # one block read from elsewhere
    wrong = errors([torch.from_numpy(np.array(a)) for a in paged_attn_pallas(
        args[0], args[1], args[2], tables, args[4], interpret=True)])
    assert wrong["acc_vs_plain"] > 1 and wrong["acc_vs_ordered"] > 1, wrong


def test_kernel_source_takes_the_wrapper_plan():
    """The wrapper's head sizes are the kernel's instantiations, and its
    fixed split plan fits the kernel (one table entry a lane), so the plan
    kernel_errors models is the one the card runs."""
    import re
    from repro_torch.kernels import build
    src = (build.CSRC / "paged_attn.cu").read_text()
    cases = {int(c) for c in re.findall(r"case (\d+):\s*\n\s*return "
                                        r"launch_split<\1, NT>", src)}
    assert cases == set(tpa._HEAD_DIMS)
    max_bps = int(re.search(r"constexpr int MAX_BPS = (\d+);", src).group(1))
    assert 1 <= tpa._BLOCKS_PER_SPLIT <= max_bps
    assert "paged_attn" in build.SOURCES
