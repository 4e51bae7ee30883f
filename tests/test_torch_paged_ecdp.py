"""The paged ECDP's plain version (the CPU path of
``kernels/paged_ecdp.paged_ecdp_matmul``) against the JAX package: the XLA
gather path (``paged_ecdp_matmul_xla``) and the Pallas kernel in interpret
mode (``ops.paged_ecdp_matmul``), at tests/test_paged_ffn.py's shapes and
tolerances, over page tables built by both packages' pools from the same
store bytes. Weights and activations are made with numpy from a seed."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import tiering as jtier
from repro.kernels import ops
from repro.kernels.paged_ffn import paged_ecdp_matmul_xla
from repro.store import PageStore as JPageStore
from repro.store import WeightPagePool as JPool
from repro_torch import interop
from repro_torch.core import erdpe as terdpe
from repro_torch.core.tiering import PagedWeight
from repro_torch.kernels import ecdp as tecdp
from repro_torch.kernels import paged_ecdp as tpe
from repro_torch.store import PageStore, WeightPagePool

torch.set_num_threads(2)

SHAPES = [(1, 128, 128), (4, 256, 128), (3, 200, 72), (8, 64, 384),
          (5, 640, 256)]


def _paged(seed, k, n, rber, spare=0):
    """One (K, N) weight in a JAX and a port store, uploaded into pools of
    ``entry_pages + spare`` pages: (jax FlashWeight, jax table and pool,
    port FlashWeight, port PagedWeight)."""
    w = np.random.default_rng(seed).standard_normal((k, n), dtype=np.float32)
    jfw = jtier.encode_flash(jnp.asarray(w), rber=rber, seed=3)
    tfw = interop.flash_from_numpy(jax.tree.map(np.asarray, jfw),
                                   device="cpu")
    js, ts = JPageStore(n_planes=4), PageStore(n_planes=4)
    js.put("w", jfw)
    ts.put("w", tfw)
    n_pages = ts.entry_pages("w") + spare
    jpool = JPool(js, n_pages)
    tpool = WeightPagePool(ts, n_pages, device="cpu")
    if spare:                                  # a scrambled free list
        perm = np.random.default_rng(seed + 1).permutation(n_pages)
        jpool._free = [int(s) for s in perm]
        tpool._free = [int(s) for s in perm]
    jt, tt = jpool.upload(["w"])["w"], tpool.upload(["w"])["w"]
    np.testing.assert_array_equal(tt["q_tbl"], jt["q_tbl"])
    pw = PagedWeight(tpool.buffer, *tt["dev"], kn=(k, n))
    return jfw, (jt, jpool.buffer), tfw, pw


def _act(seed, m, k):
    return np.random.default_rng(seed).standard_normal((m, k),
                                                       dtype=np.float32)


def _port(a, pw, **kw):
    return tpe.paged_ecdp_matmul(torch.from_numpy(a), pw.pool, pw.q_tbl,
                                 pw.p_slots, pw.s_slots, pw.kn, **kw).numpy()


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_gathers_rebuild_the_resident_arrays(m, k, n):
    _, _, tfw, pw = _paged(m + k + n, k, n, 1e-3, spare=5)
    assert torch.equal(tpe.gather_q(pw.pool, pw.q_tbl, k, n), tfw.q)
    assert torch.equal(tpe.gather_parity(pw.pool, pw.p_slots, k, n),
                       tfw.parity)
    assert torch.equal(tpe.gather_scale(pw.pool, pw.s_slots, n), tfw.scale)


@pytest.mark.parametrize("m,k,n", SHAPES)
@pytest.mark.parametrize("rber", [0.0, 2e-3])
def test_plain_matches_xla_and_pallas(m, k, n, rber):
    """The reference's paged paths and the port's plain version on the
    same pool bytes, at test_paged_ffn.py's tolerances."""
    jfw, (jt, jbuf), tfw, pw = _paged(7 * m + k + n, k, n, rber, spare=3)
    a = _act(m, m, k)
    got = _port(a, pw)
    tbl = [jnp.asarray(jt[c]) for c in ("q_tbl", "p_slots", "s_slots")]
    xla = paged_ecdp_matmul_xla(jnp.asarray(a), jbuf, *tbl, (k, n))
    pallas = ops.paged_ecdp_matmul(jnp.asarray(a), jbuf, *tbl, (k, n))
    for want in (xla, pallas):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5,
                                   atol=1e-4)
    # and it is the resident plain ECDP on the same bytes, exactly
    resident = tecdp.ecdp_matmul_plain(torch.from_numpy(a), tfw.q,
                                       tfw.parity, tfw.scale)
    np.testing.assert_array_equal(got, resident.numpy())


def test_ecc_off_reads_the_raw_bytes():
    jfw, _, tfw, pw = _paged(5, 256, 128, 2e-3)
    a = _act(6, 4, 256)
    got = _port(a, pw, ecc_enabled=False)
    want = tecdp.ecdp_matmul_plain(torch.from_numpy(a), tfw.q, tfw.parity,
                                   tfw.scale, ecc_enabled=False)
    np.testing.assert_array_equal(got, want.numpy())
    assert not np.array_equal(got, _port(a, pw))   # errors were corrected


def test_flash_matmul_dispatches_paged():
    """erdpe.flash_matmul serves a PagedWeight and restores leading dims
    like the FlashWeight path; bf16 activations as the engine sends."""
    k, n = 192, 80
    _, _, tfw, pw = _paged(0, k, n, 1e-3)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 3, k), dtype=np.float32)).to(torch.bfloat16)
    before = tpe.paged_ecdp_matmul.launches
    out = terdpe.flash_matmul(x, pw)
    assert out.shape == (2, 3, n) and out.dtype == torch.bfloat16
    assert torch.equal(out, terdpe.flash_matmul(x, tfw))
    f32 = torch.float32
    assert torch.equal(terdpe.maybe_flash_matmul(x, pw, out_dtype=f32),
                       terdpe.flash_matmul(x, tfw, out_dtype=f32))
    assert tpe.paged_ecdp_matmul.launches == before   # CPU: plain version


def test_stacked_paged_weight_rejected():
    _, _, _, pw = _paged(5, 128, 128, 0.0)
    stacked = PagedWeight(pw.pool, pw.q_tbl[None], pw.p_slots[None],
                          pw.s_slots[None], kn=(128, 128))
    assert stacked.lead == (1,) and stacked.shape == (1, 128, 128)
    with pytest.raises(ValueError, match="PagedWeight"):
        terdpe.flash_matmul(torch.ones((2, 128)), stacked)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    _, _, _, pw = _paged(2, 136, 200, 0.0)
    a = torch.ones((4, 136))
    args = (pw.pool, pw.q_tbl, pw.p_slots, pw.s_slots)
    tpe.paged_ecdp_matmul(a, *args, (136, 200))
    with pytest.raises(TypeError):
        tpe.paged_ecdp_matmul(a.half(), *args, (136, 200))
    with pytest.raises(TypeError):
        tpe.paged_ecdp_matmul(a, pw.pool, pw.q_tbl.long(), pw.p_slots,
                              pw.s_slots, (136, 200))
    with pytest.raises(TypeError):
        tpe.paged_ecdp_matmul(a, pw.pool.view(torch.uint8), *args[1:],
                              (136, 200))
    with pytest.raises(ValueError, match="tile grid"):
        tpe.paged_ecdp_matmul(a, *args, (136, 300))
    with pytest.raises(ValueError):
        tpe.paged_ecdp_matmul(torch.ones((4, 128)), *args, (136, 200))
    with pytest.raises(ValueError, match="p_slots"):
        tpe.paged_ecdp_matmul(a, pw.pool, pw.q_tbl, pw.p_slots[:0],
                              pw.s_slots, (136, 200))
    with pytest.raises(ValueError, match="contiguous"):
        tpe.paged_ecdp_matmul(a, pw.pool, pw.q_tbl.t().contiguous().t(),
                              pw.p_slots, pw.s_slots, (136, 200))


# --- the launch plan, shared with the ECDP (no card needed) ------------------

# the OPT-6.7B flash matmuls at the serving (M 64; lm_head 4), decode (4)
# and prefill (512) row counts, and the card tests' shapes
PLAN_SHAPES = ([(m, 4096, 4096) for m in (4, 64, 512)]
               + [(m, 4096, 16384) for m in (4, 64, 512)]
               + [(m, 16384, 4096) for m in (4, 64, 512)]
               + [(m, 4096, 50272) for m in (4, 64, 512)]
               + [(1, 64, 16), (3, 136, 48), (64, 4096, 333), (4, 16384, 130),
                  (100, 2048, 200), (15, 200, 100), (17, 1032, 136),
                  (65, 520, 264), (64, 136, 384), (1, 72, 96)])


@pytest.mark.parametrize("m,k,n", PLAN_SHAPES)
@pytest.mark.parametrize("bf16", [True, False], ids=["bf16", "f32"])
def test_launch_plan_splits_k_in_whole_codewords(m, k, n, bf16):
    """Both wrappers size their buffers with ``ecdp.alloc`` and so launch
    the same plan; its splits cover K once, in whole codewords (whole
    64-row steps for the tensor-core body), as the kernel counts them
    (ceil(K / k_split)); the bf16 partials stay within half the weight's
    bytes wherever K allows one split of 8·M rows."""
    assert tpe.alloc is tecdp.alloc
    plan = tecdp.launch_plan(m, k, n, 132, bf16)
    assert plan.k_split % (64 if bf16 else 8) == 0
    assert plan.splits == -(-k // plan.k_split)
    assert (plan.splits - 1) * plan.k_split < k <= plan.splits * plan.k_split
    want_tile = 16 if m <= 16 else 64 if m <= 64 else 128
    assert plan.m_tile == (want_tile if bf16 else 64)
    if bf16 and plan.splits > 1 and k >= 8 * m:
        assert plan.splits * m * n * 4 <= k * n / 2


@pytest.mark.parametrize("m", [1, 64, 65, 512])
@pytest.mark.parametrize("k,n", [(4096, 4096), (16384, 4096), (136, 48)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_alloc_partials_fit_the_plan(m, k, n, dtype):
    """The partial buffer holds every split's rows as the kernel writes
    them: all M rows in one launch for bf16, 64-row runs for f32."""
    a = torch.zeros((m, k), dtype=dtype)
    plan, out, partial = tecdp.alloc(a, k, n, 132)
    assert tuple(out.shape) == (m, n) and out.dtype == torch.float32
    rows = m if dtype == torch.bfloat16 else min(m, 64)
    if plan.splits == 1:
        assert partial is None
    else:
        assert tuple(partial.shape) == (plan.splits, rows, n)
        assert partial.dtype == torch.float32
