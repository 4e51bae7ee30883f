"""Decode attention's plain versions (the CPU path of
``kernels/decode_attn.decode_attention_state``, and the plain version in
the CUDA kernel's order with its checks) and the port's
``decode_attention_incremental`` / ``decode_attention`` against the JAX
package: the Pallas kernel in interpret mode and the XLA branch, on the
shapes of ``tests/test_kernels.py`` (MHA, GQA with ragged lengths, MQA with
S not a multiple of the block), f32 and bf16 caches, and a zero-length
slot. Inputs are made with numpy from a seed and fed to both packages."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.erdpe import ExecMode
from repro.kernels import ops
from repro.kernels.decode_attn import decode_attn_pallas
from repro.models import common as jcm
from repro_torch import interop
from repro_torch.kernels import decode_attn as tda
from repro_torch.models import common as tcm

torch.set_num_threads(2)

# f32 caches: the same math in another summation order (the JAX file's
# tolerance); bf16 caches: p is rounded to bf16 against the running max in
# the Pallas kernel and in the kernel-order plain version, and against the
# global max in the XLA branch and the plain version, one bf16 rounding of
# p apart (the JAX file's bf16 tolerance).
TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}

CASES = [  # b, s, h, n_kv, dh, lengths
    (1, 64, 4, 4, 32, [8]),                  # MHA
    (3, 96, 4, 2, 32, [8, 15, 22]),          # GQA, ragged lengths
    (2, 80, 8, 1, 16, [8, 15]),              # MQA, S not a multiple of 32
    (3, 96, 4, 2, 32, [0, 5, 96]),           # a zero-length and a full slot
]


def _inputs(seed, b, s, h, n_kv, dh, dtype):
    rng = np.random.default_rng(seed)

    def mk(*shape):
        return np.asarray(jnp.asarray(rng.standard_normal(shape, np.float32)
                                      ).astype(dtype))
    return dict(q=mk(b, 1, h, dh), kc=mk(b, s, n_kv, dh), vc=mk(b, s, n_kv, dh),
                kn=mk(b, 1, n_kv, dh), vn=mk(b, 1, n_kv, dh))


def _grouped(x, n_kv):
    """The reference's query grouping (ops.decode_attention_state), numpy:
    (B, KV, rep, Dh), scaled in f32, in the cache dtype."""
    b, _, h, dh = x["q"].shape
    return np.asarray((jnp.asarray(x["q"][:, 0]).astype(jnp.float32)
                       * dh ** -0.5).reshape(b, n_kv, h // n_kv, dh)
                      .astype(x["kc"].dtype))


def _t(a):
    return interop.tensor_from_numpy(np.asarray(a), device="cpu")


def _close(got, want, dtype, msg=""):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), err_msg=msg,
                               **TOL[dtype])


def _xla_state(q, kc, vc, lens):
    """The XLA branch of the reference's decode_attention_incremental, as
    written there (common.py:295-309), returning its (acc, m, l)."""
    b, s, n_kv, dh = kc.shape
    h = q.shape[2]
    cdt = kc.dtype
    qf = ((q.astype(jnp.float32)[:, 0] * dh ** -0.5)
          .reshape(b, n_kv, h // n_kv, dh).astype(cdt))
    scores = jnp.einsum("bkrd,bskd->bkrs", qf, kc,
                        preferred_element_type=jnp.float32)
    valid = jnp.arange(s)[None, :] < jnp.reshape(lens, (-1, 1))
    scores = jnp.where(valid[:, None, None, :], scores, -jnp.inf)
    m = jnp.max(scores, axis=-1)
    m_safe = jnp.where(jnp.isfinite(m), m, 0.0)
    p = jnp.where(valid[:, None, None, :], jnp.exp(scores - m_safe[..., None]),
                  0.0)
    acc = jnp.einsum("bkrs,bskd->bkrd", p.astype(cdt), vc,
                     preferred_element_type=jnp.float32)
    return acc, m, jnp.sum(p, axis=-1)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_state_plain_matches_pallas_and_xla(case, dtype):
    b, s, h, n_kv, dh, lens = case
    x = _inputs(b * s + h, b, s, h, n_kv, dh, dtype)
    lens = np.asarray(lens, np.int32)
    args = (_t(x["q"][:, 0]), _t(x["kc"]), _t(x["vc"]), _t(lens))
    before = tda.decode_attention_state.launches
    plain = tda.decode_attention_state(*args)
    assert tda.decode_attention_state.launches == before    # CPU: no kernel
    qg = tda.group_decode_queries(args[0], n_kv, args[1].dtype)
    ordered = tda.decode_attn_plain_ordered(qg, *args[1:])
    jargs = (x["q"][:, 0], x["kc"], x["vc"], jnp.asarray(lens))
    refs = {"pallas": ops.decode_attention_state(*jargs, interpret=True),
            "xla": _xla_state(x["q"], x["kc"], x["vc"], jnp.asarray(lens))}
    for impl, want in refs.items():
        for got, tag in ((plain, "plain"), (ordered, "ordered")):
            for g, w, name in zip(got, want, ("acc", "m", "l")):
                _close(g, w, dtype, f"{tag} vs {impl} {name}")
    empty = torch.from_numpy(lens == 0)
    for acc, m, l in (plain, ordered):
        assert bool(torch.isneginf(m[empty]).all())
        assert bool((l[empty] == 0).all()) and bool((acc[empty] == 0).all())


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ordered_plain_matches_pallas_walk(case, dtype):
    """The kernel-order plain version walking one range of 16-row tiles is
    the Pallas kernel's sequential walk at block_s=16: m and l to f32
    rounding, acc to ORDERED_REL_TOL (the same roundings of p)."""
    b, s, h, n_kv, dh, lens = case
    x = _inputs(b + s, b, s, h, n_kv, dh, dtype)
    qg = _grouped(x, n_kv)
    lens = np.asarray(lens, np.int32)
    acc_w, m_w, l_w = (torch.from_numpy(np.array(a)) for a in
                       decode_attn_pallas(qg, x["kc"], x["vc"], lens,
                                          block_s=16, interpret=True))
    acc, m, l = tda.decode_attn_plain_ordered(
        _t(qg), _t(x["kc"]), _t(x["vc"]), _t(lens), split=s, tile=16)
    torch.testing.assert_close(m, m_w, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(l, l_w, rtol=1e-5, atol=1e-5)
    rel = float((acc - acc_w).norm()) / max(float(acc_w.norm()), 1e-6)
    assert rel <= tda.ORDERED_REL_TOL, rel


@pytest.mark.parametrize("split,tile", [(32, 32), (64, 32), (256, 32),
                                        (16, 8), (8, 8), (128, 32),
                                        (tda.SPLIT_ROWS, tda.TILE_ROWS)])
def test_ordered_plain_splits_merge_to_the_plain_state(split, tile):
    """f32 caches (no rounding of p): any cut into splits and tiles merges
    to the plain version's state."""
    b, s, h, n_kv, dh = 3, 80, 8, 2, 16
    x = _inputs(5, b, s, h, n_kv, dh, "float32")
    qg = tda.group_decode_queries(_t(x["q"][:, 0]), n_kv, torch.float32)
    args = (qg, _t(x["kc"]), _t(x["vc"]),
            torch.tensor([0, 37, 80], dtype=torch.int32))
    got = tda.decode_attn_plain_ordered(*args, split=split, tile=tile)
    for g, w in zip(got, tda.decode_attn_plain(*args)):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


def _fault_inputs():
    """bf16, B=2, KV=2, rep=4, Dh=64, S=256, lengths [200, 57]; key 70 of
    slot 0 planted along each head's first query (a score far above the
    rest), so the running max of query row 0 jumps at the third tile."""
    b, s, h, n_kv, dh = 2, 256, 8, 2, 64
    x = _inputs(7, b, s, h, n_kv, dh, "bfloat16")
    qg = _grouped(x, n_kv)
    kc = x["kc"].copy()
    kc[0, 70] = (qg[0, :, 0].astype(np.float32) * 8 * dh ** 0.5).astype(
        kc.dtype)
    return qg, kc, x["vc"], np.asarray([200, 57], np.int32)


def _faults_fail(targs, errors, split):
    """The states of three faults on _fault_inputs, each walked in
    ``split``-row ranges and checked by ``errors``: a state that left out
    the bf16 rounding of p, one that never read rows 32..63, and one that
    merged rows 0..63 and 64.. without rescaling the first."""
    def ordered(*a):
        return tda.decode_attn_plain_ordered(*a, split=split)
    # f32 caches holding the same values: p is not rounded
    unrounded = errors(ordered(targs[0].float(), targs[1].float(),
                               targs[2].float(), targs[3]))
    assert unrounded["acc_vs_ordered"] > 1, unrounded
    # rows 32..63 never read: the state of the cache without them
    keep = torch.cat([torch.arange(32), torch.arange(64, 256),
                      torch.arange(32)])
    dropped = errors(ordered(
        targs[0], targs[1][:, keep], targs[2][:, keep],
        torch.where(targs[3] > 64, targs[3] - 32, targs[3].clamp(max=32))))
    assert dropped["acc_vs_plain"] > 1 and dropped["acc_vs_ordered"] > 1, \
        dropped
    # rows 0..63 and 64.. as two states, merged without rescaling the first
    first = ordered(targs[0], targs[1], targs[2], targs[3].clamp(max=64))
    rest = ordered(targs[0], targs[1][:, 64:].contiguous(),
                   targs[2][:, 64:].contiguous(),
                   (targs[3] - 64).clamp(min=0))
    m = torch.maximum(first[1], rest[1])
    scale_rest = torch.where(torch.isfinite(rest[1]),
                             torch.exp(rest[1] - m), 0.0)
    scale_first = torch.where(torch.isfinite(first[1]),
                              torch.exp(first[1] - m), 0.0)
    l = first[2] * scale_first + rest[2] * scale_rest
    skipped = errors((first[0] + rest[0] * scale_rest[..., None], m, l))
    assert skipped["acc_vs_plain"] > 1 and skipped["acc_vs_ordered"] > 1, \
        skipped
    assert skipped["l"] <= 1 and skipped["m"] <= 1, skipped


def _worst(errs):
    return max(v for k, v in errs.items() if k != "max_abs_err")


def test_kernel_errors_pass_the_pallas_kernel_and_flag_faults():
    """kernel_errors at the Pallas kernel's walk (one range over S=256,
    32-row tiles) pass the Pallas kernel's output (interpret mode,
    32-row blocks) and fail a dropped tile, a skipped rescale and a state
    that left out the bf16 rounding of p."""
    qg, kc, vc, lens = _fault_inputs()
    targs = [_t(a) for a in (qg, kc, vc, lens)]

    def errors(state):
        return tda.kernel_errors(*targs, *state, split=256)

    good = errors([torch.from_numpy(np.array(a)) for a in decode_attn_pallas(
        qg, kc, vc, lens, block_s=32, interpret=True)])
    assert _worst(good) <= 1, good
    _faults_fail(targs, errors, 256)


def test_kernel_errors_at_the_kernel_split_pass_its_order_and_flag_faults():
    """kernel_errors as the card holds the CUDA kernel to them (SPLIT_ROWS
    ranges of TILE_ROWS rows) pass the plain version in that order and
    fail the same faults."""
    qg, kc, vc, lens = _fault_inputs()
    targs = [_t(a) for a in (qg, kc, vc, lens)]

    def errors(state):
        return tda.kernel_errors(*targs, *state)

    good = errors(tda.decode_attn_plain_ordered(*targs))
    assert _worst(good) <= 1, good
    _faults_fail(targs, errors, tda.SPLIT_ROWS)


@pytest.mark.parametrize("mode", [ExecMode.XLA, ExecMode.PALLAS])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 7])
def test_decode_attention_incremental_matches_reference(mode, dtype, window):
    """Cache state + the self term merged; lengths [0, 5, 96] (an empty
    slot sees only its own token). PALLAS with a window falls back to the
    XLA branch in the reference, and the port takes the plain path."""
    b, s, h, n_kv, dh = 3, 96, 4, 2, 32
    x = _inputs(11, b, s, h, n_kv, dh, dtype)
    lens = np.asarray([0, 5, 96], np.int32)
    got = tcm.decode_attention_incremental(
        _t(x["q"]), _t(x["kc"]), _t(x["vc"]), _t(lens), _t(x["kn"]),
        _t(x["vn"]), window=window)
    want = jcm.decode_attention_incremental(
        x["q"], x["kc"], x["vc"], jnp.asarray(lens), x["kn"], x["vn"],
        window=window, mode=mode)
    assert got.dtype == _t(x["q"]).dtype
    _close(got, want, dtype)
    assert not torch.isnan(got.float()).any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_incremental_takes_a_host_int(dtype):
    """kv_len as a host int (decode_step's) equals the same length as a
    (B,) tensor, and the reference's scalar kv_len."""
    b, s, h, n_kv, dh = 2, 40, 4, 4, 16
    x = _inputs(3, b, s, h, n_kv, dh, dtype)
    args = (_t(x["q"]), _t(x["kc"]), _t(x["vc"]))
    new = (_t(x["kn"]), _t(x["vn"]))
    got = tcm.decode_attention_incremental(*args, 23, *new)
    same = tcm.decode_attention_incremental(
        *args, torch.tensor([23, 23], dtype=torch.int32), *new)
    assert torch.equal(got, same)
    want = jcm.decode_attention_incremental(x["q"], x["kc"], x["vc"],
                                            jnp.int32(23), x["kn"], x["vn"])
    _close(got, want, dtype)


@pytest.mark.parametrize("mode", [ExecMode.XLA, ExecMode.PALLAS])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 9])
@pytest.mark.parametrize("case", CASES[:3])
def test_decode_attention_matches_reference(mode, dtype, window, case):
    """The normalised decode attention (the XLA branch on the CPU) against
    the reference in both modes; lengths of at least one key (the XLA
    branch's softmax of an empty row is NaN in both packages)."""
    b, s, h, n_kv, dh, lens = case
    x = _inputs(b * h + s, b, s, h, n_kv, dh, dtype)
    lens = np.asarray(lens, np.int32)
    got = tcm.decode_attention(_t(x["q"]), _t(x["kc"]), _t(x["vc"]),
                               _t(lens), window=window)
    want = jcm.decode_attention(x["q"], x["kc"], x["vc"], jnp.asarray(lens),
                                window=window, mode=mode)
    _close(got, want, dtype)


def test_grouped_entry_is_the_state_of_the_grouped_queries():
    """decode_attn on group_decode_queries' output is decode_attention_state
    on the unscaled queries, bit for bit, and launches nothing on the
    CPU."""
    x = _inputs(4, 3, 64, 8, 2, 32, "bfloat16")
    q, kc, vc = _t(x["q"][:, 0]), _t(x["kc"]), _t(x["vc"])
    lens = torch.tensor([0, 33, 64], dtype=torch.int32)
    before = tda.decode_attention_state.launches
    got = tda.decode_attn(tda.group_decode_queries(q, 2, kc.dtype), kc, vc,
                          lens)
    want = tda.decode_attention_state(q, kc, vc, lens)
    assert tda.decode_attention_state.launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_wrapper_checks_what_the_kernel_takes_on_the_cpu_too():
    x = _inputs(1, 2, 32, 4, 2, 32, "bfloat16")
    q, kc, vc = _t(x["q"][:, 0]), _t(x["kc"]), _t(x["vc"])
    lens = torch.tensor([5, 0], dtype=torch.int32)
    tda.decode_attention_state(q, kc, vc, lens)
    with pytest.raises(ValueError, match="contiguous"):
        tda.decode_attention_state(q, kc.transpose(0, 1).contiguous()
                                   .transpose(0, 1), vc, lens)
    with pytest.raises(TypeError):
        tda.decode_attention_state(q, kc, vc, lens.long())
    with pytest.raises(ValueError):
        tda.decode_attention_state(q, kc, vc[:, :, :1].contiguous(), lens)
    with pytest.raises(ValueError):
        tda.decode_attention_state(q, kc, vc, lens[:1])


def test_kernel_source_walks_the_tile_the_checks_model():
    """kernel_errors models the CUDA kernel's walk with TILE_ROWS; the
    CUDA-core body's TILE and the tensor-core body's CHUNK must be the same
    number, and SPLIT_ROWS a multiple of it. The wrapper's mirror of the
    tensor-core body (head sizes, ring depth, heads a block) is the
    source's."""
    import re
    from repro_torch.kernels import build
    src = (build.CSRC / "decode_attn.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
    assert const("TILE") == tda.TILE_ROWS
    assert const("CHUNK") == tda.TILE_ROWS
    assert tda.SPLIT_ROWS % const("CHUNK") == 0
    assert tda.SPLIT_ROWS % tda.TILE_ROWS == 0
    assert const("STAGES") == tda._STAGES
    assert const("MAX_HPB") == tda._MAX_HEADS_PER_BLOCK
    cases = {int(c) for c in re.findall(r"case (\d+):\s*\n\s*err = "
                                        r"launch_mma<\1>", src)}
    assert cases == set(tda._MMA_HEAD_DIMS)
    assert "decode_attn" in build.SOURCES


@pytest.mark.parametrize("dtype,dh,offset,mma", [
    (torch.bfloat16, 128, 0, True), (torch.bfloat16, 64, 0, True),
    (torch.bfloat16, 32, 0, True), (torch.bfloat16, 256, 0, False),
    (torch.bfloat16, 96, 0, False), (torch.float32, 128, 0, False),
    (torch.bfloat16, 128, 1, False), (torch.bfloat16, 80, 0, True),
    (torch.float32, 80, 0, False)])
def test_wrapper_picks_the_body_the_card_runs(dtype, dh, offset, mma):
    """bf16 caches at Dh 32, 64, 80, 128 on 16-byte boundaries take the
    tensor-core body; f32, other head sizes and caches off a 16-byte
    boundary the CUDA-core body."""
    b, s, n_kv = 2, 40, 2
    flat = torch.zeros(b * s * n_kv * dh + offset, dtype=dtype)
    kc = flat[offset:].view(b, s, n_kv, dh)
    q = torch.zeros((b, n_kv, 1, dh), dtype=dtype)
    assert tda.uses_mma(q, kc, kc) == mma


def test_tensor_core_ring_holds_eight_warps_an_sm_at_dh_128():
    """The tensor-core body's shared memory: two thread blocks of four
    warps (eight warps) fit an H100 SM's 228 KB at Dh=128, with the 1 KB
    each block reserves; fewer heads take a smaller block."""
    full = tda.smem_bytes(1, 128, n_kv=32, mma=True)
    assert full == 4 * tda._STAGES * tda.TILE_ROWS * 136 * 2
    assert 2 * (full + 1024) <= 228 * 1024
    assert tda.smem_bytes(1, 128, n_kv=2, mma=True) == full // 2
    assert tda.smem_bytes(3, 64) == 4 * (2 * 3 * 64 + 3 * 32 + 9)


def test_card_head_sizes_cover_every_config():
    """Every config the port ships (the OPT family, LLaMA-2-7B, OPT_TINY)
    passes the card's head-size checks: the paged-attention kernel's
    instances and both decode-attention bodies, the tensor-core one for
    its bf16 caches (OPT-2.7B's Dh 80 among them). Head sizes no kernel
    takes stay refused."""
    from repro_torch import configs
    from repro_torch.kernels import paged_attn as tpa
    cfgs = [c for c in vars(configs).values()
            if isinstance(c, configs.ArchConfig)]
    assert {c.name for c in cfgs} >= {"opt-1.3b", "opt-2.7b", "opt-6.7b",
                                       "opt-13b", "opt-30b", "llama2-7b"}
    for c in cfgs:
        assert tpa.takes_head_dim(c.head_dim), c.name
        assert tda.takes_head_dim(c.head_dim), c.name
        assert c.head_dim in tda._MMA_HEAD_DIMS, c.name
    assert configs.OPT_2_7B.head_dim == 80
    for dh in (24, 40, 96, 272):
        assert not tpa.takes_head_dim(dh)
    for dh in (8, 40, 272):
        assert not tda.takes_head_dim(dh)
