"""The MoE family module (``repro_torch.models.moe``) and the expert-grouped
ECDP's plain version (``kernels/grouped_ecdp.py``) against the JAX package
on the CPU, at the smoke configs (qwen3-moe-30b-a3b: 8 experts, top 2,
qk-norm; phi3.5-moe-42b: 4 experts), with the JAX init's params carried
across by ``interop``. Inputs are made with numpy from a seed and fed to
both packages. Tolerances are stated at each test."""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.core import ecc as jecc
from repro.core import tiering as jtier
from repro.core.quant import quantize_int8 as jquant
from repro.kernels import ops
from repro.models import moe as jmoe
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.core.erdpe import flash_matmul_grouped
from repro_torch.core.tiering import FlashWeight, PagedWeight, deploy
from repro_torch.kernels import grouped_ecdp as tg
from repro_torch.models import family_module
from repro_torch.models import moe as tmoe

torch.set_num_threads(2)

ARCHS = ["qwen3-moe-30b-a3b", "phi3.5-moe-42b-a6.6b"]
BF16_ULP = 2.0 ** -8


def _t(a):
    return interop.tensor_from_numpy(np.asarray(a), device="cpu")


def _f(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else a,
                      np.float32)


@functools.lru_cache(maxsize=None)
def _params(arch):
    """(JAX cfg, port cfg, JAX init params, the same params in the port)."""
    jcfg, tcfg = jget(arch, smoke=True), get_config(arch, smoke=True)
    jp = jmoe.init(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, interop.params_from_numpy(
        jax.tree.map(np.asarray, jp), device="cpu")


@functools.lru_cache(maxsize=None)
def _tier(arch, tier):
    """(JAX params, port params) of ``arch``-smoke: bf16, or deployed at
    rber ``tier`` by the JAX package and carried across."""
    _, _, jp, tp = _params(arch)
    if tier == "bf16":
        return jp, tp
    jd, _ = jtier.deploy(jp, rber=tier, seed=0)
    return jd, interop.deployed_from_numpy(jax.tree.map(np.asarray, jd),
                                           device="cpu")


def _layer0(tree):
    return jax.tree.map(lambda a: a[0], tree)


def _bank0(port_bank):
    return {k: v[0] for k, v in port_bank.items()}


# --- init, registry -------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_init_has_the_reference_tree_shapes_and_dtypes(arch):
    jcfg, tcfg, jp, _ = _params(arch)
    got = tmoe.init(tcfg, torch.Generator().manual_seed(0), device="cpu")
    want = jax.tree_util.tree_flatten_with_path(jp)[0]
    flat = {jax.tree_util.keystr(p): v for p, v in want}
    mine = {jax.tree_util.keystr(p): v for p, v in
            jax.tree_util.tree_flatten_with_path(
                jax.tree.map(lambda t: t, got))[0]}
    assert set(mine) == set(flat)
    for k, v in flat.items():
        assert tuple(mine[k].shape) == v.shape, k
        assert mine[k].dtype == torch.bfloat16 and v.dtype == jnp.bfloat16
    # dense_init's scale: std of a bank matrix near sqrt(2 / (K + N))
    w = got["layers"]["moe"]["experts"]["w_down"].float()
    k, n = w.shape[-2:]
    assert abs(float(w.std()) / (2.0 / (k + n)) ** 0.5 - 1) < 0.1
    assert family_module("moe") is tmoe


@pytest.mark.parametrize("rber", [0.0, 1e-3])
@pytest.mark.parametrize("arch", ARCHS)
def test_deploy_is_byte_identical_to_the_reference(arch, rber):
    """The MoE tree deployed by both packages from the same params: every
    flash leaf (the (L, E, K, N) banks, encoded slice by slice with one
    bit-error seed over the stack; lm_head) and every DRAM leaf (the
    router included) byte for byte, and the same tier map."""
    from repro_torch.core.tiering import _walk
    _, _, jp, tp = _params(arch)
    jd, jmap = jtier.deploy(jp, rber=rber, seed=0)
    td, tmap = deploy(tp, rber=rber, seed=0)
    assert tmap == jmap and tmap["layers/moe/router"] == "dram"
    want = dict(_walk(interop.deployed_from_numpy(
        jax.tree.map(np.asarray, jd), device="cpu")))
    got = dict(_walk(td))
    assert set(got) == set(want)
    for path, leaf in got.items():
        if isinstance(leaf, FlashWeight):
            for f in ("q", "parity", "scale"):
                assert torch.equal(getattr(leaf, f),
                                   getattr(want[path], f)), (path, f)
        else:
            assert torch.equal(leaf, want[path]), path


# --- routing ----------------------------------------------------------------------

# Routes compare where the k-th and (k+1)-th logits of JAX's run are more
# than this apart: the two packages' f32 contractions sum in other orders
# (a few f32 ulps of the logits), so a closer pair may order either way.
ROUTE_MARGIN = 1e-5


@pytest.mark.parametrize("groups", [(1, 0), (4, 2), (2, 1)],
                         ids=["flat", "4_groups_top2", "2_groups_top1"])
def test_serve_route_matches_reference(groups):
    """Gates within 1e-6 (softmax of f32 logits that agree to a few f32
    ulps) and indices equal wherever the route is clear; the grouped
    routing keeps only the top groups' experts."""
    n_groups, topk_groups = groups
    rng = np.random.default_rng(7)
    d, e, k = 32, 8, 2
    router = rng.standard_normal((d, e), dtype=np.float32)
    x = np.asarray(jnp.asarray(rng.standard_normal((3, 5, d)), jnp.bfloat16))
    jg, ji = jmoe.serve_route(jnp.asarray(router), jnp.asarray(x), k,
                              n_groups=n_groups, topk_groups=topk_groups)
    tgates, tidx = tmoe.serve_route(_t(router), _t(x), k, n_groups=n_groups,
                                    topk_groups=topk_groups)
    assert tgates.dtype == torch.float32 and tidx.dtype == torch.int32
    logits = np.einsum("std,de->ste", x.astype(np.float32), router)
    if n_groups > 1:
        gl = logits.reshape(3, 5, n_groups, e // n_groups).max(-1)
        top_g = np.argsort(-gl, -1)[..., :topk_groups]
        groups_of = np.asarray(tidx) // (e // n_groups)
        assert all(g in top_g[s, t] for (s, t, _), g in
                   np.ndenumerate(groups_of)), "routed outside its groups"
        keep = np.zeros_like(logits, bool)
        for (s, t, _), g in np.ndenumerate(top_g):
            keep[s, t, g * (e // n_groups):(g + 1) * (e // n_groups)] = True
        logits = np.where(keep, logits, -np.inf)
    srt = np.sort(logits, -1)[..., ::-1]
    clear = (srt[..., k - 1] - srt[..., k]) > ROUTE_MARGIN
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(np.asarray(tidx)[clear],
                                  np.asarray(ji)[clear])
    np.testing.assert_allclose(np.asarray(tgates)[clear],
                               np.asarray(jg)[clear], rtol=0, atol=1e-6)


def test_serve_route_refuses_groups_that_do_not_divide_the_experts():
    with pytest.raises(ValueError, match="not divisible"):
        tmoe.serve_route(torch.zeros(4, 6), torch.zeros(1, 1, 4), 2,
                         n_groups=4, topk_groups=2)


# --- the serving FFN -----------------------------------------------------------

def _serve_inputs(arch, tier, seed=1):
    """Layer 0's bank and router, a (2, 6, D) bf16 input and its route, in
    both packages (the route JAX's, carried across)."""
    jcfg, _, _, _ = _params(arch)
    jd, td = _tier(arch, tier)
    jbank, jrouter = _layer0(jd["layers"]["moe"]["experts"]), \
        jd["layers"]["moe"]["router"][0]
    tbank = _bank0(td["layers"]["moe"]["experts"])
    x = jnp.asarray(np.random.default_rng(seed).standard_normal(
        (2, 6, jcfg.d_model)), jnp.bfloat16)
    g, i = jmoe.serve_route(jrouter, x, jcfg.top_k)
    return jbank, tbank, x, g, i


@pytest.mark.parametrize("tier", ["bf16", 0.0, 1e-3])
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_expert_ffn_matches_reference(arch, tier):
    """The full bank, on the same route: bit-equal (each expert's rows are
    the same products, f32 sums of bf16-exact operands over K <= 64, the
    same roundings to bf16; the deployed bank read raw in both)."""
    jbank, tbank, x, g, i = _serve_inputs(arch, tier)
    want = jmoe.serve_expert_ffn(jbank, x, g, i)
    got = tmoe.serve_expert_ffn(tbank, _t(x), _t(g), _t(i))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(_f(got), _f(want))


@pytest.mark.parametrize("tier", ["bf16", 1e-3])
def test_serve_expert_ffn_slab_matches_full_bank(tier):
    """tests/test_moe_serving.py:60's property on the port: a slab holding
    only the routed experts, in another row order, with its ``slab_map``,
    gives the full bank's outputs bit for bit; and the JAX slab's."""
    arch = "qwen3-moe-30b-a3b"
    jbank, tbank, x, g, i = _serve_inputs(arch, tier, seed=3)
    routed = sorted(set(np.asarray(i).ravel().tolist()))
    perm = routed[::-1]
    slab_map = np.full((8,), -1, np.int32)
    for row, ex in enumerate(perm):
        slab_map[ex] = row
    full = tmoe.serve_expert_ffn(tbank, _t(x), _t(g), _t(i))
    if tier == "bf16":
        tslab = {k: v[perm] for k, v in tbank.items()}
        jslab = {k: v[jnp.asarray(perm)] for k, v in jbank.items()}
    else:
        tslab = {k: v[perm] for k, v in tbank.items()}
        jslab = {k: jax.tree.map(lambda a: a[jnp.asarray(perm)], v)
                 for k, v in jbank.items()}
    part = tmoe.serve_expert_ffn(tslab, _t(x), _t(g), _t(i), _t(slab_map))
    np.testing.assert_array_equal(_f(part), _f(full))
    want = jmoe.serve_expert_ffn(jslab, x, g, i, jnp.asarray(slab_map))
    np.testing.assert_array_equal(_f(part), _f(want))


@pytest.mark.parametrize("flash", [False, True], ids=["bf16", "deployed"])
def test_serve_expert_ffn_unmapped_expert_contributes_zero(flash):
    """tests/test_moe_serving.py:84 on the port: every expert unmapped."""
    d = f = 8
    bank = {k: torch.ones((1, d, f), dtype=torch.bfloat16)
            for k in ("w_gate", "w_up", "w_down")}
    if flash:
        bank, _ = deploy(bank)
    out = tmoe.serve_expert_ffn(bank, torch.ones((1, 1, d),
                                                 dtype=torch.bfloat16),
                                torch.ones((1, 1, 1)),
                                torch.zeros((1, 1, 1), dtype=torch.int32),
                                torch.full((4,), -1, dtype=torch.int32))
    assert not out.any()


def _paged_slab(bank, rows, seed=0):
    """Layer 0's deployed bank programmed expert by expert into a port
    PageStore and uploaded into a CPU page pool with a shuffled free list;
    returns {name: PagedWeight} whose tables are stacked over ``rows``
    (bank rows, in slab order)."""
    from repro_torch.store import PageStore, WeightPagePool
    store = PageStore(n_planes=8)
    names = []
    for name, fw in bank.items():
        for e in range(fw.q.shape[0]):
            store.put(f"{name}@{e}", FlashWeight(fw.q[e], fw.parity[e],
                                                 fw.scale[e]))
            names.append(f"{name}@{e}")
    n_pages = sum(store.entry_pages(n) for n in names)
    pool = WeightPagePool(store, n_pages, device="cpu")
    pool._free = [int(s) for s in
                  np.random.default_rng(seed).permutation(n_pages)]
    tbls = pool.upload(names)
    return {name: PagedWeight(
        pool.buffer, *(torch.stack([tbls[f"{name}@{e}"]["dev"][j]
                                    for e in rows]) for j in range(3)),
        kn=tuple(fw.q.shape[1:])) for name, fw in bank.items()}


def test_paged_expert_bank_is_refused_with_its_roadmap_item():
    """The streamed plane's pool-paged expert bank, which the port once
    refused, now serves: ``serve_expert_ffn`` over a PagedWeight slab of
    the routed experts (reverse row order, with its ``slab_map``) gives
    the deployed FlashWeight bank's outputs bit for bit (the same bytes
    through the same plain products), and so does ``_expert_matmul`` over
    the whole bank paged (expert e's rows at e * C)."""
    arch = "qwen3-moe-30b-a3b"
    _, tbank, x, g, i = _serve_inputs(arch, 1e-3, seed=3)
    routed = sorted(set(np.asarray(i).ravel().tolist()))
    perm = routed[::-1]
    slab_map = np.full((8,), -1, np.int32)
    for row, ex in enumerate(perm):
        slab_map[ex] = row
    full = tmoe.serve_expert_ffn(tbank, _t(x), _t(g), _t(i))
    paged = _paged_slab(tbank, perm)
    assert paged["w_gate"].lead == (len(perm),)
    part = tmoe.serve_expert_ffn(paged, _t(x), _t(g), _t(i), _t(slab_map))
    assert torch.equal(part, full)
    whole = _paged_slab(tbank, range(8), seed=1)
    xe = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (8, 3, 64), dtype=np.float32)).to(torch.bfloat16)
    assert torch.equal(tmoe._expert_matmul(xe, whole["w_gate"]),
                       tmoe._expert_matmul(xe, tbank["w_gate"]))


# --- the capacity dispatch -----------------------------------------------------

@pytest.mark.parametrize("tier", ["bf16", 1e-3])
@pytest.mark.parametrize("capacity_factor", [8.0, 0.25])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_reference(arch, capacity_factor, tier):
    """tests/test_models.py:159's two capacities: 8.0 drops nothing, 0.25
    drops; the same assignments drop in both packages (the stable sort),
    so the outputs are bit-equal on inputs whose routes are clear."""
    jcfg, tcfg, _, _ = _params(arch)
    jd, td = _tier(arch, tier)
    jl, tl = _layer0(jd["layers"]["moe"]), {
        "router": td["layers"]["moe"]["router"][0],
        "experts": _bank0(td["layers"]["moe"]["experts"])}
    x = jnp.asarray(np.random.default_rng(2).standard_normal(
        (2, 8, jcfg.d_model)), jnp.bfloat16)
    want = jmoe.moe_apply(jcfg, jl, x, capacity_factor=capacity_factor)
    got = tmoe.moe_apply(tcfg, tl, _t(x), capacity_factor=capacity_factor)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(_f(got), _f(want))
    if capacity_factor < 1:      # dropped tokens: some rows lose an expert
        full = tmoe.moe_apply(tcfg, tl, _t(x), capacity_factor=8.0)
        assert not torch.equal(got, full)


# --- forward, prefill, decode_step ---------------------------------------------

# Logits of the two packages: bf16 activations whose f32 sums run in
# another order round one ulp apart now and then, and two random-init
# layers carry those flips. Bound: 2^-5 of the row's largest |logit|.
# The prompt is scanned (seeds 0..29): a router near-tie in either
# package's run moves a whole expert (and, at the capacity dispatch's
# one row per expert at decode, its neighbours' drops), which no bound on
# the logits covers; this seed's runs move none, and every greedy step of
# JAX's keeps its top-2 margin above MIN_MARGIN (0.0135 at least here).
LOGIT_REL_TOL = 2.0 ** -5
MIN_MARGIN = 0.01
PROMPT_SEED, PROMPT_SHAPE, PAD_TO, N_DECODE = 16, (2, 8), 16, 4


def _assert_rel_close(got, want, what):
    want = _f(want)
    row_max = np.abs(want).max(axis=-1, keepdims=True)
    err = np.abs(_f(got) - want)
    assert np.all(err <= LOGIT_REL_TOL * row_max), \
        (what, float((err / np.maximum(row_max, 1e-30)).max()))


@functools.lru_cache(maxsize=None)
def _jax_fns(arch):
    jcfg = jget(arch, smoke=True)
    prefill = jax.jit(functools.partial(jmoe.prefill, jcfg),
                      static_argnames=("pad_to",))
    decode = jax.jit(functools.partial(jmoe.decode_step, jcfg))
    return prefill, decode


def _prompt(vocab):
    return np.random.default_rng(PROMPT_SEED).integers(
        0, vocab, PROMPT_SHAPE).astype(np.int32)


@pytest.mark.parametrize("tier", ["bf16", 0.0, 1e-3])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch, tier):
    jcfg, tcfg, _, _ = _params(arch)
    jp, tp = _tier(arch, tier)
    toks = _prompt(jcfg.vocab_size)
    want = jmoe.forward(jcfg, jp, jnp.asarray(toks), remat=False)
    got = tmoe.forward(tcfg, tp, torch.from_numpy(toks))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    for t in range(PROMPT_SHAPE[1]):
        _assert_rel_close(got[:, t], want[:, t], f"position {t}")


@pytest.mark.parametrize("tier", ["bf16", 0.0, 1e-3])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_greedy_decode_match_reference(arch, tier):
    """``prefill`` (cache padded to 16 rows) then 4 greedy ``decode_step``s
    (capacity 2.0): logits and cache rows within the bound above, greedy
    tokens equal."""
    jcfg, tcfg, _, _ = _params(arch)
    jp, tp = _tier(arch, tier)
    jprefill, jdecode = _jax_fns(arch)
    toks = _prompt(jcfg.vocab_size)
    j_last, j_cache = jprefill(jp, {"tokens": jnp.asarray(toks)},
                               pad_to=PAD_TO)
    t_last, t_cache = tmoe.prefill(tcfg, tp,
                                   {"tokens": torch.from_numpy(toks)},
                                   pad_to=PAD_TO)
    shape = tmoe.cache_shape(tcfg, PROMPT_SHAPE[0], PAD_TO)
    for name in ("k", "v"):
        assert tuple(t_cache[name].shape) == tuple(shape[name].shape) \
            == j_cache[name].shape
        _assert_rel_close(t_cache[name], j_cache[name], name)
        assert not t_cache[name][:, :, PROMPT_SHAPE[1]:].any()
    _assert_rel_close(t_last, j_last, "prefill")
    for step in range(1, N_DECODE + 1):
        top2 = np.sort(np.asarray(j_last), axis=-1)[:, -2:]
        assert float((top2[:, 1] - top2[:, 0]).min()) > MIN_MARGIN, \
            "the prompt is not margin-safe"
        j_tok = np.asarray(jnp.argmax(j_last, -1), np.int32)
        np.testing.assert_array_equal(t_last.argmax(-1).int().numpy(), j_tok)
        kv_len = PROMPT_SHAPE[1] + step - 1
        j_last, j_cache = jdecode(jp, j_cache, {
            "token": jnp.asarray(j_tok), "kv_len": jnp.int32(kv_len)})
        t_last, t_cache = tmoe.decode_step(tcfg, tp, t_cache, {
            "token": torch.from_numpy(j_tok.copy()), "kv_len": kv_len})
        _assert_rel_close(t_last, j_last, f"decode step {step}")
    np.testing.assert_array_equal(t_last.argmax(-1).int().numpy(),
                                  np.asarray(jnp.argmax(j_last, -1)))
    for name in ("k", "v"):
        _assert_rel_close(t_cache[name], j_cache[name], name)


def test_decode_step_raises_outside_the_cache():
    _, tcfg, _, tp = _params("qwen3-moe-30b-a3b")
    _, cache = tmoe.prefill(tcfg, tp, {"tokens": torch.ones(
        (1, 4), dtype=torch.int32)}, pad_to=8)
    with pytest.raises(ValueError, match="kv_len"):
        tmoe.decode_step(tcfg, tp, cache, {
            "token": torch.ones((1,), dtype=torch.int32), "kv_len": 8})


# --- the grouped ECDP's plain version ------------------------------------------

def _bank(seed, e, k, n, rber):
    """An (E, K, N) bank quantized and encoded by the JAX package, bit
    errors planted in the stored bytes at ``rber``: (raw int8, parity u8,
    scale (E, 1, N) f32)."""
    rng = np.random.default_rng(seed)
    qs, ps, ss = [], [], []
    for ex in range(e):
        q, scale = jquant(jnp.asarray(rng.standard_normal((k, n),
                                                          dtype=np.float32)),
                          axis=0)
        raw = np.asarray(jecc.weights_to_bytes(q))
        ps.append(np.asarray(jecc.encode(jnp.asarray(raw))).astype(np.uint8))
        if rber:
            raw, _ = jecc.inject_bit_errors_np(raw, rber, seed + ex)
        qs.append(raw.view(np.int8))
        ss.append(np.asarray(scale))
    return np.stack(qs), np.stack(ps), np.stack(ss)


@pytest.mark.parametrize("ecc_on", [True, False], ids=["ecc_on", "ecc_off"])
@pytest.mark.parametrize("rber", [0.0, 2e-3])
@pytest.mark.parametrize("counts", [[3, 0, 5, 1], [0, 0, 7, 0],
                                    [2, 2, 2, 2]])
def test_grouped_plain_matches_a_per_expert_loop_of_ecdp_xla(counts, rber,
                                                             ecc_on):
    """Each expert's rows against ``ops.ecdp_matmul_xla`` on that expert's
    bytes (f32 sums in another order: rtol 1e-5, atol 1e-4, the ECDP
    tests' bounds); with ECC off the raw product, with ECC on the
    corrected one, and the two differ where errors were planted."""
    e, k, n = len(counts), 128, 48
    q, p, s = _bank(sum(counts) + int(rber * 1e4), e, k, n, rber)
    rows = sum(counts)
    a = np.asarray(jnp.asarray(np.random.default_rng(9).standard_normal(
        (rows, k)), jnp.bfloat16))
    row_start = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    got = tg.grouped_ecdp_matmul(_t(a), _t(row_start), _t(q), _t(p), _t(s),
                                 ecc_enabled=ecc_on).numpy()
    for ex in range(e):
        r0, r1 = row_start[ex], row_start[ex + 1]
        if r1 == r0:
            continue
        want = ops.ecdp_matmul_xla(jnp.asarray(a[r0:r1]), q[ex], p[ex],
                                   s[ex], ecc_enabled=ecc_on)
        np.testing.assert_allclose(got[r0:r1], np.asarray(want), rtol=1e-5,
                                   atol=1e-4)
        if not ecc_on:          # the raw bytes' product, nothing corrected
            raw = a[r0:r1].astype(np.float32) @ q[ex].astype(np.float32)
            np.testing.assert_allclose(got[r0:r1], raw * s[ex], rtol=1e-5,
                                       atol=1e-4)
    if rber:
        other = tg.grouped_ecdp_matmul(_t(a), _t(row_start), _t(q), _t(p),
                                       _t(s), ecc_enabled=not ecc_on)
        assert not np.array_equal(other.numpy(), got)


def test_grouped_entry_takes_what_the_kernel_takes():
    q, p, s = _bank(0, 2, 64, 32, 0.0)
    a = torch.zeros((3, 64), dtype=torch.bfloat16)
    rs = torch.tensor([0, 1, 3], dtype=torch.int32)
    out = tg.grouped_ecdp_matmul(a, rs, _t(q), _t(p), _t(s))
    assert out.shape == (3, 32) and out.dtype == torch.float32
    with pytest.raises(TypeError, match="bf16"):
        tg.grouped_ecdp_matmul(a.float(), rs, _t(q), _t(p), _t(s))
    with pytest.raises(ValueError, match="do not fit"):
        tg.grouped_ecdp_matmul(a, rs[:2], _t(q), _t(p), _t(s))
    with pytest.raises(ValueError, match="K mismatch"):
        tg.grouped_ecdp_matmul(a[:, :56], rs, _t(q), _t(p), _t(s))
    fw = FlashWeight(_t(q), _t(p), _t(s))
    torch.testing.assert_close(
        flash_matmul_grouped(a, fw, rs, out_dtype=torch.float32), out)
    with pytest.raises(ValueError, match="one \\(E, K, N\\)"):
        flash_matmul_grouped(a, fw[0], rs)


@pytest.mark.parametrize("r,e,max_rows", [(512, 128, 64), (32, 128, 4),
                                          (2688, 128, 21), (64, 8, 32)])
def test_grouped_plan_cuts_whole_steps(r, e, max_rows):
    """The launch plan: M tile 16 or 64, K in whole 64-row steps, the
    partials within half the busy experts' weight bytes."""
    for k, n in ((2048, 768), (768, 2048), (64, 32)):
        plan = tg.grouped_plan(r, e, k, n, max_rows, 132)
        assert plan.m_tile == (16 if max_rows <= 16 else 64)
        assert plan.k_split % 64 == 0 and plan.splits * plan.k_split >= k
        assert (plan.splits - 1) * plan.k_split < k
        if plan.splits > 1:
            assert plan.partial == (plan.splits, r, n)
            assert plan.splits * r * n * 4 <= min(e, r) * k * n / 2
