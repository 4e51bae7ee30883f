"""Mixture-of-Experts decoder family (qwen3-moe-30b-a3b, phi3.5-moe-42b) —
the port of ``repro/models/moe.py``.

The dense family's skeleton (``models/dense.py``: its layer bodies take
the FFN as a hook) with the FFN replaced by a top-k MoE. Two dispatches,
as in the reference:

  * ``moe_apply`` — the offline path's sorted CAPACITY dispatch: top-k
    routing per token, a stable sort by expert id, rank within the expert
    from an exclusive cumsum of the counts, assignments at rank >=
    capacity to a trash row; tokens go into an (E, C+1, D) buffer, every
    expert runs on its C+1 rows, and a gather brings them back, gate-
    weighted and summed over the k copies, per token group: one outside a
    mesh, the data axes' size inside one (the reference's grouping, which
    decides which tokens are dropped).
  * ``serve_route`` + ``serve_expert_ffn`` — the serving engine's LOSSLESS
    dispatch: every (token, k) assignment owns its own row, so no capacity
    drops, and each expert's result is independent of the bank's
    composition (a partial slab with ``slab_map`` gives the full bank's
    outputs bit for bit).

A flash-tier (``FlashWeight``) bank of stacked (E, K, N) experts is read
RAW, with ECC off, as the reference's ``_expert_matmul`` reads it
(``ops.ecdp_matmul_xla``'s default): correction folds in at deployment. It
runs through the expert-grouped ECDP (``kernels/grouped_ecdp.py``), one
launch per bank matrix: the routed rows sorted by expert and
``row_start`` from the counts, all on the device (no host read, so the
engine's captured step holds it). A pool-paged bank (``PagedWeight``,
the streamed MoE plane's slab: page tables stacked over slab rows) runs the
same way through the grouped paged ECDP, one launch per bank matrix with
ECC off, where the reference maps ``paged_ecdp_matmul_xla`` over the slab.
A plain bf16 bank takes the reference's dense buffer and a batched product.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.erdpe import flash_matmul_grouped
from repro_torch.core.tiering import FlashWeight, PagedWeight
from repro_torch.launch import sharding as sh
from repro_torch.models import dense

# the top-level params whose leaves carry a leading layer axis: the train
# step hands each layer's slice to the loss as its own autograd leaf
# (launch/steps.py)
STACKED = ("layers",)


# --- init ---------------------------------------------------------------------

def moe_init(cfg, generator: torch.Generator, device="cuda",
             lead: tuple = (), sink=None, prefix: str = "") -> dict:
    """One MoE FFN's params (``lead`` stacks them, e.g. (L,)): the router
    (D, E) and the expert banks w_gate/w_up (E, D, F), w_down (E, F, D),
    bf16 with the JAX ``moe_init``'s shapes and scales, drawn in that
    order. ``sink`` as ``dense.init``'s, over the paths under ``prefix``."""
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff

    def stack(path, lead, k, n):
        return dense.init_stack(
            generator, lead, k, n, device,
            None if sink is None else sink(prefix + path, lead + (k, n)))

    return {"router": stack("router", lead, d, e),
            "experts": {
                "w_gate": stack("experts/w_gate", lead + (e,), d, f),
                "w_up": stack("experts/w_up", lead + (e,), d, f),
                "w_down": stack("experts/w_down", lead + (e,), f, d)}}


def init(cfg, generator: torch.Generator, device="cuda", sink=None) -> dict:
    """Random params with the JAX ``moe.init``'s tree, shapes and scales:
    the dense family's attention, norms, embedding and lm_head, and a
    layer-stacked ``layers/moe`` (router (L, D, E), banks (L, E, K, N)).
    ``sink`` as ``dense.init``'s."""
    params = dense.init(cfg, generator, device, ffn=False, sink=sink)
    params["layers"]["moe"] = moe_init(cfg, generator, device,
                                       (cfg.n_layers,), sink, "layers/moe/")
    return params


# --- expert products ----------------------------------------------------------

def _expert_matmul(x: torch.Tensor, w,
                   out_dtype=torch.bfloat16) -> torch.Tensor:
    """x: (E, C, K) bf16 — expert e's rows x[e] — @ w (E, K, N) -> (E, C, N)
    in ``out_dtype``. A FlashWeight bank (or a PagedWeight slab of E paged
    experts) runs the grouped ECDP (grouped paged ECDP) with ECC off over
    the E * C rows (expert e's at e * C); a plain bank the f32 product of
    the bf16 operands."""
    e, c, k = x.shape
    if isinstance(w, (FlashWeight, PagedWeight)):
        row_start = torch.arange(0, (e + 1) * c, c, dtype=torch.int32,
                                 device=x.device)
        out = flash_matmul_grouped(x.reshape(e * c, k), w, row_start,
                                   ecc_enabled=False, out_dtype=out_dtype,
                                   max_rows=c)
        return out.reshape(e, c, -1)
    return torch.bmm(x.float(), w.float()).to(out_dtype)


def _swiglu_bank(bank, xb, dtype, matmul=_expert_matmul,
                 down_dtype=torch.bfloat16):
    """The experts' SwiGLU on their rows: down(silu(gate) * up), the gate
    and up products rounded to bf16, the down product to ``down_dtype``
    (f32 for a tensor-parallel partial)."""
    h_g = matmul(xb, bank["w_gate"])
    h_u = matmul(xb, bank["w_up"])
    h = (F.silu(h_g.float()) * h_u.float()).to(dtype)
    return matmul(h, bank["w_down"], out_dtype=down_dtype)


# --- capacity dispatch (offline path) ----------------------------------------

def _route(xt, router, k: int):
    """The capacity dispatch's top-k routing of xt (Tg, D): (gates (Tg, k)
    f32, softmax over the selected logits, idx (Tg, k))."""
    gates, idx = torch.topk(xt.float() @ router.float(), k)
    return torch.softmax(gates, dim=-1), idx


def _dispatch_group(cfg, xt, router, capacity_factor, dtype):
    """Capacity dispatch for one token group. xt: (Tg, D). Returns (buf
    (E, C+1, D), combine metadata)."""
    tg, d = xt.shape
    e, k = cfg.n_experts, cfg.top_k
    gates, idx = _route(xt, router, k)                        # (Tg, k)
    flat_e = idx.reshape(-1)                                  # (Tg*k,)
    dev = xt.device
    flat_tok = torch.arange(tg, device=dev)[:, None].expand(tg, k)
    flat_tok = flat_tok.reshape(-1)
    cap = max(int(tg * k / e * capacity_factor), 1)

    e_sorted, order = torch.sort(flat_e, stable=True)
    counts = torch.zeros((e,), dtype=torch.int64, device=dev).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, 0) - counts                 # exclusive
    rank = torch.arange(tg * k, device=dev) - starts[e_sorted]
    slot = torch.clamp(rank, max=cap)                         # cap -> trash

    buf = torch.zeros((e, cap + 1, d), dtype=dtype, device=dev)
    buf[e_sorted, slot] = xt[flat_tok[order]].to(dtype)
    buf[:, cap] = 0                                           # clear trash

    # unsort the (expert, slot) addresses, not the D-wide vectors: the
    # combine is then a pure gather
    inv = torch.empty_like(order).scatter_(
        0, order, torch.arange(tg * k, device=dev))
    return buf, (gates, e_sorted[inv], slot[inv], rank[inv], cap)


def _combine_group(out_buf, meta, d):
    """Gather-based combine for one group. out_buf: (E, C+1, D)."""
    gates, e_un, slot_un, rank_un, cap = meta
    tg, k = gates.shape
    gathered = out_buf[e_un, torch.clamp(slot_un, max=cap)]   # (Tg*k, D)
    gathered = torch.where((rank_un >= cap)[:, None], 0.0, gathered.float())
    weighted = gathered * gates.reshape(-1)[:, None]
    return weighted.reshape(tg, k, d).sum(dim=1)


def moe_apply(cfg, p, x, capacity_factor: float = 1.25):
    """x: (B, S, D) -> (B, S, D). The B * S tokens split into G =
    ``sharding.data_group_count(B * S)`` groups in order (1 outside a mesh;
    inside one, the data axes' size), each with its own capacity dispatch
    (capacity from its own token count), the experts on its (C+1)-row
    buffers and its combine, as the reference's grouped dispatch. Under a
    mesh the layer runs on the whole tokens and weights (gathered, and the
    result handed back in ``x``'s placements), the same on every rank."""
    b, s, d = x.shape
    t = b * s
    g = sh.data_group_count(t)
    router = sh.whole(p["router"])
    bank = {k: sh.whole(w) for k, w in p["experts"].items()}
    xt = sh.whole(x).reshape(g, t // g, d)
    outs = []
    for i in range(g):
        buf, meta = _dispatch_group(cfg, xt[i], router, capacity_factor,
                                    x.dtype)
        out_buf = _swiglu_bank(bank, buf, x.dtype)            # (E, C+1, D)
        outs.append(_combine_group(out_buf, meta, d))
    out = outs[0] if g == 1 else torch.cat(outs)
    return sh.like(out.reshape(b, s, d).to(x.dtype), x)


# --- serving-engine MoE FFN ---------------------------------------------------

def serve_route(router, x, top_k: int, n_groups: int = 1,
                topk_groups: int = 0):
    """Top-k routing for a (S, T, D) serving chunk batch: (gates (S, T, k)
    f32 — softmax over the selected logits — and idx (S, T, k) int32).

    Group-limited routing (``n_groups`` contiguous expert groups, each
    token routing within its ``topk_groups`` best groups by the group's max
    logit); ``topk_groups`` in {0, n_groups} disables it."""
    logits = torch.einsum("std,de->ste", x.float(), router.float())
    if n_groups > 1 and 0 < topk_groups < n_groups:
        e = logits.shape[-1]
        if e % n_groups:
            raise ValueError(f"n_experts={e} not divisible by "
                             f"n_expert_groups={n_groups}")
        gsz = e // n_groups
        lead = logits.shape[:-1]
        gl = logits.reshape(lead + (n_groups, gsz)).amax(-1)
        gidx = torch.topk(gl, topk_groups).indices            # (S, T, kg)
        keep = torch.zeros(lead + (n_groups,), dtype=torch.bool,
                           device=x.device).scatter_(-1, gidx, True)
        keep = keep[..., None].expand(lead + (n_groups, gsz)).reshape(
            lead + (e,))
        logits = torch.where(keep, logits, float("-inf"))
    gates, idx = torch.topk(logits, top_k)
    return torch.softmax(gates, dim=-1), idx.to(torch.int32)


def _grouped_rows(flat_row, ok, e_bank: int):
    """The routed rows sorted by bank row (unmapped ones last, past every
    expert): (order (A,), row_start (E+1,) int32), on the device."""
    key = torch.where(ok, flat_row, e_bank)
    _, order = torch.sort(key, stable=True)
    counts = torch.zeros((e_bank + 1,), dtype=torch.int64,
                         device=key.device).scatter_add_(
        0, key, torch.ones_like(key))
    row_start = torch.cat([counts.new_zeros((1,)),
                           torch.cumsum(counts[:e_bank], 0)])
    return order, row_start.to(torch.int32)


def expert_rows(idx, slab_map, e_bank: int):
    """The dispatch of a (S, T, k) route onto a bank of ``e_bank`` rows:
    (flat_row (A,) int64, ok (A,) bool, order, row_start) with assignment
    a = token * k + j (``_grouped_rows``'s order and row_start). Tensor-
    parallel shards share one dispatch: it depends on the route, not on
    the columns."""
    row = idx if slab_map is None else slab_map[idx.long()]
    flat_row = row.reshape(-1).long()
    ok = flat_row >= 0
    return (flat_row, ok) + _grouped_rows(flat_row, ok, e_bank)


def serve_expert_ffn(bank, x, gates, idx, slab_map=None, partial=False,
                     rows=None):
    """Batched-expert SwiGLU over a full or partial expert bank.

    bank     : {"w_gate","w_up","w_down"} each (E_bank, K, N) FlashWeight
               (deployed), PagedWeight slab (page tables stacked over
               E_bank slab rows: the streamed plane) or plain tensor.
    x        : (S, T, D) normed FFN input; gates/idx (S, T, k).
    slab_map : (n_experts,) int expert id -> bank row, -1 = not resident
               (those assignments contribute 0). None = identity.
    partial  : the tensor-parallel expert FFN. Each shard's bank holds the
               experts' d_ff/S columns (w_gate / w_up column-parallel,
               w_down row-parallel over the same slice), so the down
               product is a PARTIAL: it stays f32 (not rounded to bf16)
               through the gate-weighted combine, and the output is
               returned f32 and uncast for the caller's
               ``core.erdpe.all_reduce_sum``, the cast after the sum.
    rows     : ``expert_rows(idx, slab_map, E_bank)``, when the caller
               computed it already (once for every shard).

    Assignment a = token * k + j owns row a. A FlashWeight bank or a
    PagedWeight slab: the rows sorted by bank row, one grouped (paged)
    ECDP per bank matrix with ECC off, and the results put back in
    assignment order; a slab's launch plan is made for the ``n_experts``
    of ``slab_map``, the full bank's, so a slab gives the full bank's
    outputs bit for bit on the card too. A plain bank: the reference's
    (E_bank, A, D) buffer with assignment a in column a, and a batched
    product."""
    s, t, d = x.shape
    k = idx.shape[-1]
    a = s * t * k
    w_gate = bank["w_gate"]
    e_bank = w_gate.shape[0]
    if rows is None:
        rows = expert_rows(idx, slab_map, e_bank)
    flat_row, ok, order, row_start = rows
    down_dtype = torch.float32 if partial else torch.bfloat16
    x2 = x.reshape(s * t, d)
    if isinstance(w_gate, (FlashWeight, PagedWeight)):
        xs = x2.index_select(0, torch.div(order, k, rounding_mode="floor"))
        plan_experts = None if slab_map is None else slab_map.shape[0]

        def grouped_mm(r, w, out_dtype=torch.bfloat16):
            # an expert gets at most S * T rows: top-k picks distinct ones
            return flash_matmul_grouped(r, w, row_start, ecc_enabled=False,
                                        out_dtype=out_dtype, max_rows=s * t,
                                        plan_experts=plan_experts)
        ys = _swiglu_bank(bank, xs, x.dtype, grouped_mm,
                          down_dtype)                         # (A, D)
        out_a = torch.empty_like(ys).index_copy_(0, order, ys).float()
    else:
        cols = torch.arange(a, device=x.device)
        safe = torch.where(ok, flat_row, 0)
        xa = x2[:, None].expand(s * t, k, d).reshape(a, d)
        buf = torch.zeros((e_bank, a, d), dtype=x.dtype, device=x.device)
        buf[safe, cols] = torch.where(ok[:, None], xa, 0).to(x.dtype)
        out_buf = _swiglu_bank(bank, buf, x.dtype,
                               down_dtype=down_dtype)         # (E, A, D)
        out_a = out_buf[safe, cols].float()
    out_a = torch.where(ok[:, None], out_a, 0.0)
    out = (out_a * gates.reshape(a)[:, None]).reshape(s, t, k, d).sum(dim=2)
    return out if partial else out.to(x.dtype)


# --- offline inference API ----------------------------------------------------

def _ffn(cfg, lp, h):
    return moe_apply(cfg, lp["moe"], h)


def _decode_ffn(cfg, lp, h):
    return moe_apply(cfg, lp["moe"], h, capacity_factor=2.0)


def forward(cfg, params, tokens, remat=True, return_cache=False):
    """Train / prefill forward: tokens (B, S) -> logits (B, S, V) f32 (and
    the cache with ``return_cache``); the MoE FFN at capacity factor 1.25,
    layers rematerialized while grad is enabled (``dense.forward``)."""
    return dense.forward(cfg, params, tokens, remat=remat,
                         return_cache=return_cache, ffn=_ffn)


def train_loss(cfg, params, batch):
    """Mean next-token cross-entropy of batch {"tokens", "labels"}. The
    gradient reaches the router through the combine's gate weights."""
    return dense.train_loss(cfg, params, batch, ffn=_ffn)


def prefill(cfg, params, batch, pad_to: int | None = None):
    """(last_logits (B, V), cache), the cache padded to ``pad_to`` rows."""
    return dense.prefill(cfg, params, batch, pad_to=pad_to, ffn=_ffn)


decode_check = dense.decode_check


def decode_body(cfg, params, cache, token, kv_len):
    """The device half of ``decode_step`` (``dense.decode_body`` with the
    MoE FFN at capacity factor 2.0): reads no tensor on the host, so
    ``launch.steps.make_decode_step(compiled=True)`` captures it."""
    return dense.decode_body(cfg, params, cache, token, kv_len,
                             ffn=_decode_ffn)


def decode_step(cfg, params, cache, batch):
    """One decode step (``dense.decode_step``'s contract: the cache is
    written in place at kv_len) with the MoE FFN at capacity factor 2.0."""
    return dense.decode_step(cfg, params, cache, batch, ffn=_decode_ffn)


cache_shape = dense.cache_shape
