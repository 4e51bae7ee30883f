"""NVLLM serving engine — the port of ``repro/serving/engine.py``'s dense
planes and its resident MoE plane: the paper's end-to-end dataflow (§3.5) at
request level, with the KV-cache-aware scheduler (Algorithm 2) in the loop.

  * data plane — ``_step_impl``: one MIXED prefill/decode step over a
    static (n_slots, chunk_tokens) lane batch. Each slot contributes up to
    ``chunk_tokens`` lanes — a prefilling slot a chunk of its prompt, a
    decoding slot its last sampled token. The step embeds, runs the layers
    in a Python loop (PyTorch has no scan; each layer indexes the stacked
    weights), with block-PAGED attention over the KV pool
    (models/common.chunk_attention_paged), evaluates lm_head only at each
    slot's last valid lane, samples, writes every new K/V row through the
    block tables IN PLACE in one ``index_put_`` per pool, bumps the
    per-slot lengths and updates the Algorithm 2 bitmap, in place too.
    Padding lanes write to the pool's reserved dump block, so every write
    is unconditional. Its inputs are static device buffers, so on the card
    the compiled engine captures the whole step once in a CUDA graph and
    replays it every step (``repro_torch.graphs``) — the counterpart of
    the reference's jitted step.
  * MoE (resident plane) — each layer's attention on the DRAM projections,
    the router's top-k, and the deployed expert banks read raw (ECC off)
    through one expert-grouped ECDP launch per bank matrix
    (``models/moe.serve_expert_ffn``), inside the same captured step.
  * MoE (streamed plane) — with a ``weight_store`` the expert banks stay in
    the host page store, one entry per (layer, expert). ``_streamed_step_moe``
    runs each layer's attention + router on the device, reads the routed
    expert ids on the host (the step's per-layer sync, the MoE analog of
    Algorithm 2's plane bitmap), gathers the routed experts' page tables
    into the layer's SLAB from the ``ExpertCache`` (a miss uploads
    synchronously: a misroute stall), and runs the expert half through one
    grouped paged ECDP launch per bank matrix. The expert half of layer l
    is chained with layer l+1's attention + router (``_moe_fused_impl``);
    the embed rides layer 0's (``_moe_head_impl``) and the finish the last
    layer's experts (``_moe_tail_impl``). The ``ExpertPrefetcher``'s worker
    uploads the router-history predictor's picks ahead of the layers.
    Tensor-parallel (``StreamConfig.n_shards`` > 1), each shard runs its
    d_ff/S slice of the routed experts to an f32 partial and one
    all-reduce a layer completes the expert FFN.
  * flash tier — FFN weights and ``lm_head`` are deployed as INT8 + parity
    (``core.tiering.deploy``) and read through the ECDP on every use; the
    Q and O projections also keep a flash copy, and Algorithm 2's bitmap
    picks, per column group, the bf16 DRAM product or the flash product
    (``_proj`` computes both, as the reference does). On CUDA tensors the
    ECDP and the paged attention are the hand-written kernels; on CPU
    tensors their plain versions.
  * control plane — the Python ``Engine``: a waiting->running admission
    queue (submit ENQUEUES; a slot and a worst-case block reservation are
    claimed at admission), per-step chunk planning under the Alg.2-coupled
    token budget (core/scheduler.plan_chunks), completion, O(1) slot
    release, per-step stats.
  * streamed plane — with a ``weight_store`` (``store.PageStore``) the
    flash tier (FFN, lm_head and the per-layer Q/K/V/O flash copies) lives
    in host NAND pages, not in device memory. ``_streamed_step`` embeds,
    then runs the layers group by group as the ``LayerStreamer`` hands
    each group's window over — its pages uploaded by a worker thread into
    the device ``WeightPagePool`` in one staged transfer — and the group's
    flash weights are read in place through page tables (``PagedWeight``,
    the paged ECDP), then finishes as the resident step does. lm_head stays
    a device ``FlashWeight``. A ``ResidencyCache`` keeps pinned and recent
    groups resident under ``StreamConfig.device_budget_bytes``; the
    streamer's stall fraction contracts the step token budget. With a
    ``faults.FaultInjector`` armed on the store, every window read is
    verified on the host before its upload (``store/pagestore.py``).
  * speculative serving — ``spec_cfg`` (``serving/spec.py``): decoding
    slots pack ``[last_token, d_1 .. d_k]`` draft proposals (drafted in
    the step body from each slot's token history) into their chunk lanes;
    one pass — one window rotation on the streamed plane — verifies all k,
    the step emits ``n_accept + 1`` tokens and advances the KV length by
    that count (a rewind over the rejected lanes), on both data planes and
    inside the captured step.
  * prefix cache — ``prefix_cache=True``: a completed request's full
    prompt blocks stay in the KV pool under a chain hash
    (``serving/prefix.py``), and admission adopts the longest cached
    prefix copy-free, so a warm request prefills only its tail.
  * observability — each step's host phases (``plan``, ``dispatch``,
    ``sync``; streamed: ``embed``, ``stream_wait``, ``group_dispatch``,
    ``finish``; streamed MoE: ``head_dispatch``, ``route_sync``,
    ``expert_acquire``, ``fused_dispatch``, ``tail_dispatch``) land in
    ``timeline``, the ``engine_step_seconds``
    histogram and, when the tracer is on, spans; ``telemetry()`` and
    ``obs_samples()`` feed the serving front (``serving/server.py``).
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import itertools
import threading
import time

import numpy as np
import torch

from repro_torch import graphs, obs
from repro_torch.core import scheduler as sched
from repro_torch.core.erdpe import all_reduce_sum, flash_matmul
from repro_torch.core.tiering import (ATTN_FLASH_KEYS, PagedWeight, _walk,
                                      deploy, encode_flash,
                                      program_attn_flash)
from repro_torch.kernels.paged_attn import _HEAD_DIMS, takes_head_dim
from repro_torch.models import common as cm
from repro_torch.models import dense
from repro_torch.models import moe as moe_mod
from repro_torch.serving import spec as spec_mod
from repro_torch.serving.kvcache import PagedKVPool
from repro_torch.serving.prefix import PrefixIndex, block_hashes
from repro_torch.serving.sampler import SampleConfig, last_valid_hidden, sample
from repro_torch.store.expert_cache import ExpertCache, ExpertPrefetcher
from repro_torch.store.page_pool import (ShardedWeightPagePool,
                                         WeightPagePool)
from repro_torch.store.pagestore import (StoreRef, drop_store_refs,
                                         graft_store_refs)
from repro_torch.store.streamer import (LayerStreamer, ResidencyCache,
                                        StreamConfig)


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new: int
    pos: int = 0                     # prompt tokens consumed (chunked prefill)
    slot: int | None = None          # None while waiting for admission
    out: list[int] = dataclasses.field(default_factory=list)
    done: bool = False
    cancelled: bool = False          # set by Engine.cancel
    cached_len: int = 0              # prompt tokens adopted from the prefix
                                     # cache at admission (pos starts here)

    @property
    def prefilling(self) -> bool:
        return self.pos < len(self.prompt)

    @property
    def kv_rows(self) -> int:
        """Worst-case KV footprint: every prompt token plus every decode
        step writes one row; the LAST sampled token is never written."""
        return len(self.prompt) + max(self.max_new - 1, 0)


def _proj(x, w_dram, w_flash, bitmap):
    """Bitmap-dispatched projection: NPU bf16 weights (an f32 GEMM) vs the
    flash ERDPE (Alg. 2). Both products are computed; the bitmap selects
    per column group. The GEMM is full f32, as in the reference, while
    ``torch.backends.cuda.matmul.allow_tf32`` is False (PyTorch's default;
    the entry points set it)."""
    if w_flash is None or bitmap is None:
        return (x.float() @ w_dram.float()).to(torch.bfloat16)
    flash_out = flash_matmul(x, w_flash, out_dtype=torch.float32)
    return sched.split_projection(x, w_dram, flash_out,
                                  bitmap).to(torch.bfloat16)


def _qkv(cfg, lp, fl, x, positions, bitmap):
    """Norm -> bitmap-dispatched projections -> qk-norm -> rope. Only wq is
    bitmap-dispatched; K/V stay on the NPU."""
    ap = lp["attn"]
    b, s, _ = x.shape
    h = dense._norm(cfg, x, lp, "ln1")
    q = _proj(h, ap["wq"], None if fl is None else fl["wq"], bitmap).reshape(
        b, s, cfg.n_heads, cfg.head_dim)
    k = _proj(h, ap["wk"], None, None).reshape(b, s, cfg.n_kv_heads,
                                               cfg.head_dim)
    v = _proj(h, ap["wv"], None, None).reshape(b, s, cfg.n_kv_heads,
                                               cfg.head_dim)
    if cfg.qk_norm:
        q = cm.rms_norm(q, ap["q_norm"])
        k = cm.rms_norm(k, ap["k_norm"])
    if cfg.use_rope:
        q = cm.apply_rope(q, positions, cfg.rope_base)
        k = cm.apply_rope(k, positions, cfg.rope_base)
    return q, k, v


def _chunk_layer(cfg, bitmap, lengths, positions, block_tables, x, layer,
                 ffn=None):
    """One mixed-batch layer over all slots' chunk lanes. ``layer`` =
    (params slice, flash attn copy slice, read-only paged K/V pool slices).
    The pool is not written here: the chunk's own K/V enters through the
    intra-chunk term, and the step writes all layers' rows afterwards.
    ``ffn`` (normed input -> FFN output) stands in for the layer's own FFN:
    the tensor-parallel one (``_sharded_ffn``)."""
    lp, fl, kc, vc = layer
    ap = lp["attn"]
    b, t, _ = x.shape
    q, k, v = _qkv(cfg, lp, fl, x, positions, bitmap)
    attn = cm.chunk_attention_paged(q, kc, vc, block_tables, lengths, k, v,
                                    window=cfg.local_window)
    out = _proj(attn.reshape(b, t, -1), ap["wo"], fl["wo"], bitmap)
    x = x + out
    h = dense._norm(cfg, x, lp, "ln2")
    x = x + (dense._ffn_apply(cfg, lp["ffn"], h) if ffn is None else ffn(h))
    return x, (k, v)


def _sharded_ffn(cfg, shard_ffns, mesh, h):
    """The tensor-parallel FFN: shard ``s`` runs its part on
    ``mesh.devices[s]`` — its w_gate / w_up columns, the activation, the
    same slice's w_down rows — to an f32 partial; ``all_reduce_sum`` sums
    the partials and the cast comes after the sum."""
    partials = [dense._ffn_apply(cfg, p, h.to(dev), partial=True)
                for p, dev in zip(shard_ffns, mesh.devices)]
    return all_reduce_sum(partials, mesh).to(h.dtype)


def _moe_attn_router_body(cfg, lengths, positions, block_tables, x, lp, kc,
                          vc):
    """Attention + router for one MoE layer. MoE keeps Q/K/V/O on the NPU
    (f32 DRAM products, no flash copy): the in-flash engine serves the
    expert banks. Returns the post-attention residual, the normed FFN
    input, the router's (gates, idx) and the layer's fresh K/V."""
    b, t, _ = x.shape
    q, k, v = _qkv(cfg, lp, None, x, positions, None)
    attn = cm.chunk_attention_paged(q, kc, vc, block_tables, lengths, k, v,
                                    window=cfg.local_window)
    x = x + _proj(attn.reshape(b, t, -1), lp["attn"]["wo"], None, None)
    h = dense._norm(cfg, x, lp, "ln2")
    gates, idx = moe_mod.serve_route(
        lp["moe"]["router"], h, cfg.top_k, n_groups=cfg.n_expert_groups,
        topk_groups=cfg.topk_expert_groups)
    return x, h, gates, idx, k, v


def _chunk_layer_moe(cfg, lengths, positions, block_tables, x, layer):
    """One mixed-batch MoE layer (resident plane): attention + router, then
    the expert FFN over the full deployed bank (``slab_map`` None).
    ``layer`` = (params slice, read-only paged K/V pool slices)."""
    lp, kc, vc = layer
    x, h, gates, idx, k, v = _moe_attn_router_body(
        cfg, lengths, positions, block_tables, x, lp, kc, vc)
    x = x + moe_mod.serve_expert_ffn(lp["moe"]["experts"], h, gates, idx)
    return x, (k, v)


def _embed_chunk(cfg, params, lengths, tokens, q_lens):
    """Token embedding + lane bookkeeping -> (x, positions, ctx_lens)."""
    t_chunk = tokens.shape[1]
    lane = torch.arange(t_chunk, device=tokens.device)[None, :]
    positions = lengths[:, None] + lane
    x = params["embed"][tokens.long()]
    if "pos_embed" in params:
        # padding lanes can point past the learned-position table; steer
        # them to row 0 (an out-of-range index on CUDA is a device assert).
        # Their K/V is causally masked and goes to the dump block.
        emb_pos = torch.where(lane < q_lens[:, None], positions, 0)
        x = x + params["pos_embed"][emb_pos.long()]
    # slots with no lanes this step keep stale lengths; zero their context
    # so the paged kernel's dead-block skip holds.
    ctx_lens = torch.where(q_lens > 0, lengths, 0)
    return x, positions, ctx_lens


def _finish_step(cfg, sched_cfg, sample_cfg, kv_aware, final_norm, lm_head,
                 state, x, k_new, v_new, q_lens, admitted, positions,
                 block_tables, generator, spec=None):
    """Everything after the layer stack: final norm, last-lane lm_head and
    sampling, ONE paged KV write per pool, Algorithm 2. Writes the state IN
    PLACE (the pools, lengths, bitmap and prev_cycles keep their tensors,
    so a captured step replays over them). Returns (tokens (slots,) int32,
    logits (slots, V) f32, stats (3,) f32: kv_len, delta_cycles,
    npu_fraction).

    ``spec`` = (k, drafts, n_draft, is_decode) switches on the verify tail:
    lm_head is also evaluated on every slot's first k + 1 lanes (a second
    ECDP call), ``spec.verify_lanes`` accepts or rejects the decoding
    slots' drafts, a prefill completion samples at its last lane, and a
    decoding slot's length advances by ``n_emit = n_accept + 1`` instead
    of by the lanes written (the in-graph half of the KV rewind; the
    scatter still writes every lane). Returns (tokens (slots, k+1) int32,
    n_emit (slots,) int32, logits, lane_logits (slots, k+1, V) f32, stats
    (6 + 2 slots,) f32: the three above, then drafted, accepted and
    emitted over the decoding slots, then drafted and accepted per slot).
    Draws, when sampling: verify_lanes' (its docstring), then the last
    lane's."""
    lengths = state["lengths"]
    if cfg.norm_type == "rms":
        x = cm.rms_norm(x, final_norm)
    else:
        x = cm.layer_norm(x, final_norm["g"], final_norm["b"])
    # lm_head only at each slot's last valid lane
    x_last = last_valid_hidden(x, q_lens)
    logits = flash_matmul(x_last, lm_head, out_dtype=torch.float32)
    if spec is None:
        toks = sample(logits, generator, sample_cfg)
        adv = q_lens
    else:
        spec_k, drafts, n_draft, is_decode = spec
        # the verify lanes: a decoding slot's last valid lane is among them
        lane_logits = flash_matmul(x[:, :spec_k + 1], lm_head,
                                   out_dtype=torch.float32)
        toks_v, n_accept = spec_mod.verify_lanes(
            lane_logits, drafts, n_draft, generator, sample_cfg)
        tok_last = sample(logits, generator, sample_cfg)  # prefill completions
        toks = torch.where(is_decode[:, None], toks_v, tok_last[:, None])
        n_emit = torch.where(is_decode, n_accept + 1, 1).to(torch.int32)
        adv = torch.where(is_decode, n_emit, q_lens)      # length REWIND

    # --- paged KV write: all layers/slots/lanes, in place -------------------
    k_pool, v_pool = state["k"], state["v"]
    block_size = k_pool.shape[2]
    max_blocks = block_tables.shape[1]
    lane = torch.arange(positions.shape[1], device=positions.device)[None, :]
    valid = lane < q_lens[:, None]
    blk_idx = torch.clamp(positions // block_size, 0, max_blocks - 1).long()
    blk = torch.gather(block_tables, 1, blk_idx)
    # invalid lanes (and any unmapped table hit) land in the dump block 0
    blk = torch.where(valid, blk, 0).long()
    off = torch.where(valid, positions % block_size, 0).long()
    k_pool[:, blk, off] = k_new.to(k_pool.dtype)
    v_pool[:, blk, off] = v_new.to(v_pool.dtype)
    new_lengths = lengths + adv

    # --- Algorithm 2: KV-cache-aware rebalance ------------------------------
    # admitted (not only worked) slots: a budget-starved prefill slot's
    # cached KV still sets the attention picture Algorithm 2 reacts to.
    # Speculative lengths count accepted rows only (the rewound length).
    kv_len = torch.where(admitted, new_lengths, 0).max()
    new_bitmap, new_prev, delta = sched.kv_aware_step(
        state["bitmap"], state["prev_cycles"], kv_len, cfg.d_model,
        cfg.n_kv_heads, cfg.head_dim, sched_cfg, kv_aware)
    lengths.copy_(new_lengths)
    state["bitmap"].copy_(new_bitmap)
    state["prev_cycles"].copy_(new_prev)
    stats = torch.stack([kv_len.float(), delta.float(),
                         sched.npu_fraction(new_bitmap)])
    if spec is None:
        return toks, logits, stats
    # per-slot drafted/accepted: the adaptive-k acceptance EMA's signal
    draft_slots = torch.where(is_decode, n_draft, 0)
    accept_slots = torch.where(is_decode, n_accept, 0)
    emit = torch.where(is_decode, n_emit, 0).sum()
    stats = torch.cat([stats, torch.stack([draft_slots.sum(),
                                           accept_slots.sum(), emit]).float(),
                       draft_slots.float(), accept_slots.float()])
    return toks, n_emit, logits, lane_logits, stats


def _embed_spec(cfg, proposer, spec_k, params, lengths, tokens, q_lens,
                hist, hist_lens, draft_cap):
    """Speculative head of the step: drafting + embedding. The drafter
    proposes up to ``spec_k`` tokens per slot from its history; lanes
    1..n_draft of decoding slots (``draft_cap > 0`` only there) take the
    proposals and the slot's lane count grows to ``1 + n_draft``: the
    verify pass treats them as any other chunk lanes. Returns
    ``_embed_chunk``'s tuple plus (q_lens, drafts, n_draft)."""
    drafts, n_avail = proposer.propose(hist, hist_lens)
    n_draft = torch.minimum(n_avail, draft_cap).to(torch.int32)
    b, t_chunk = tokens.shape
    lane = torch.arange(t_chunk, device=tokens.device)[None, :]
    dpad = torch.cat([torch.zeros((b, 1), dtype=tokens.dtype,
                                  device=tokens.device),
                      drafts.to(tokens.dtype),
                      torch.zeros((b, t_chunk - 1 - spec_k),
                                  dtype=tokens.dtype, device=tokens.device)],
                     dim=1)
    use = (lane >= 1) & (lane <= n_draft[:, None])
    tokens = torch.where(use, dpad, tokens)
    q_lens = q_lens + n_draft            # draft_cap == 0 off the decode path
    x, positions, ctx_lens = _embed_chunk(cfg, params, lengths, tokens, q_lens)
    return x, positions, ctx_lens, q_lens, drafts, n_draft


def _embed_step(cfg, params, lengths, tokens, q_lens, spec):
    """The step's head, shared by both planes: ``_embed_chunk``, or with
    ``spec`` (``_step_impl``'s) ``_embed_spec``. Returns (x, positions,
    ctx_lens, q_lens, fin), ``fin`` being ``_finish_step``'s ``spec``."""
    if spec is None:
        return (*_embed_chunk(cfg, params, lengths, tokens, q_lens), q_lens,
                None)
    proposer, spec_k, hist, hist_lens, draft_cap, is_decode = spec
    x, positions, ctx_lens, q_lens, drafts, n_draft = _embed_spec(
        cfg, proposer, spec_k, params, lengths, tokens, q_lens, hist,
        hist_lens, draft_cap)
    return x, positions, ctx_lens, q_lens, (spec_k, drafts, n_draft,
                                            is_decode)


def _step_impl(cfg, sched_cfg, sample_cfg, kv_aware, params, layers,
               attn_flash, state, tokens, q_lens, admitted, block_tables,
               generator, spec=None):
    """One mixed prefill/decode step for ALL pool slots — the data plane.

    state  : {"k","v": (L, n_blocks, block_size, KV, Dh), "lengths":
              (slots,) i32, "bitmap": (H,) i32, "prev_cycles": i32}, all
              written in place.
    layers : per-layer param dicts (views of the stacked params);
    attn_flash : per-layer {"wq", "wo"} FlashWeights (None for MoE).
    tokens : (slots, T) i32 chunk lanes; q_lens (slots,) valid lanes;
    admitted (slots,) bool; block_tables (slots, max_blocks) i32.
    Returns (sampled (slots,) i32, logits (slots, V) f32, stats (3,) f32).
    An IDLE batch (every q_lens 0, every admitted False) writes only the
    dump block 0 and leaves lengths and bitmap as they are; Algorithm 2
    sees kv_len 0, so under ``kv_aware`` prev_cycles stays too (without
    it prev_cycles always takes the step's cycles, here 0).

    ``spec`` = (proposer, k, hist (slots, H) int32, hist_lens (slots,),
    draft_cap (slots,), is_decode (slots,) bool) runs the speculative step
    (``_embed_spec``, ``_finish_step``'s verify tail) and returns what
    ``_finish_step`` returns with ``spec``.
    """
    bitmap = state["bitmap"] if kv_aware else None
    x, positions, ctx_lens, q_lens, fin = _embed_step(
        cfg, params, state["lengths"], tokens, q_lens, spec)
    ks, vs = [], []
    for li in range(cfg.n_layers):          # the layer loop (no scan)
        if cfg.family == "moe":
            # MoE projections stay on the NPU: no bitmap, no flash copy
            x, (kl, vl) = _chunk_layer_moe(
                cfg, ctx_lens, positions, block_tables, x,
                (layers[li], state["k"][li], state["v"][li]))
        else:
            x, (kl, vl) = _chunk_layer(
                cfg, bitmap, ctx_lens, positions, block_tables, x,
                (layers[li], attn_flash[li], state["k"][li],
                 state["v"][li]))
        ks.append(kl)
        vs.append(vl)
    return _finish_step(cfg, sched_cfg, sample_cfg, kv_aware,
                        params["final_norm"], params["lm_head"], state, x,
                        torch.stack(ks), torch.stack(vs), q_lens, admitted,
                        positions, block_tables, generator, spec=fin)


def _paged(pool_buf, tbl, kn, shard=None):
    """Bind one page-table dict (its device tables; shard ``shard``'s of a
    sharded pool's table) to the pool tensor as a PagedWeight — the flash
    weight the ERDPE consumes in place."""
    q_tbl, p_slots, s_slots = (tbl["dev"] if shard is None
                               else tbl["dev_shards"][shard])
    return PagedWeight(pool=pool_buf, q_tbl=q_tbl, p_slots=p_slots,
                       s_slots=s_slots, kn=tuple(kn))


def _stream_group_impl(cfg, bitmap, shapes, layers_dram, window, pool_buf,
                       k_pool, v_pool, x, positions, ctx_lens, block_tables,
                       lo, group_size, mesh=None):
    """One STREAMED layer group: the resident step's per-layer math, with
    the group's flash weights grafted into each layer's DRAM params as
    PagedWeights over ``pool_buf``. Returns (x, [k per layer], [v per
    layer]).

    Under tensor parallelism (``mesh``) ``pool_buf`` is the shards'
    partitions and ``shapes["ffn"]`` the shard-LOCAL (K, N): attention and
    its projections run once, on the first device, over shard 0's
    replicated copies (the reference computes them alike on every shard),
    and each shard runs its part of the FFN (``_sharded_ffn``)."""
    ks, vs = [], []
    for i in range(group_size):
        li = lo + i
        lp = dict(layers_dram[li])
        ffn = None
        if mesh is None:
            lp["ffn"] = {**lp.get("ffn", {}),
                         **{k: _paged(pool_buf, t[i], shapes["ffn"][k])
                            for k, t in window["ffn"].items()}}
            attn_buf = pool_buf
        else:
            shard_ffns = [
                {**lp.get("ffn", {}),
                 **{k: _paged(pool_buf[s], t[i], shapes["ffn"][k], shard=s)
                    for k, t in window["ffn"].items()}}
                for s in range(mesh.n_shards)]
            ffn = functools.partial(_sharded_ffn, cfg, shard_ffns, mesh)
            attn_buf = pool_buf[0]
        fl = {k: _paged(attn_buf, t[i], shapes["attn"][k])
              for k, t in window["attn"].items()}
        x, (kl, vl) = _chunk_layer(cfg, bitmap, ctx_lens, positions,
                                   block_tables, x,
                                   (lp, fl, k_pool[li], v_pool[li]), ffn)
        ks.append(kl)
        vs.append(vl)
    return x, ks, vs


def _moe_expert_paged_impl(kn, x, h, gates, idx, slab, slab_map, pool_buf,
                           mesh=None):
    """Expert half of one STREAMED MoE layer: the slab is page tables only,
    stacked (e_slab, ...) per bank matrix (``slab[name]["dev"]``); the
    routed experts' weights stay raw pages in ``pool_buf`` and one grouped
    paged ECDP per bank matrix reads them in place. ``kn`` is each
    matrix's (K, N).

    Under tensor parallelism (``mesh``) ``pool_buf`` is the shards'
    partitions and ``kn`` the shard-LOCAL (K, N): the route's dispatch is
    computed once, and shard ``s`` binds its slab tables
    (``"dev_shards"[s]``) over its partition and runs its d_ff/S slice of
    every routed expert on ``mesh.devices[s]`` to an f32 partial
    (``serve_expert_ffn(partial=True)``); ``all_reduce_sum`` completes the
    layer's expert FFN and the cast to bf16 comes after the sum."""
    if mesh is None:
        bank = {name: _paged(pool_buf, t, kn[name])
                for name, t in slab.items()}
        return x + moe_mod.serve_expert_ffn(bank, h, gates, idx, slab_map)
    banks = [{name: _paged(pool_buf[s], t, kn[name], shard=s)
              for name, t in slab.items()} for s in range(mesh.n_shards)]
    rows = moe_mod.expert_rows(idx, slab_map, banks[0]["w_gate"].shape[0])
    partials = [moe_mod.serve_expert_ffn(
        bank, h.to(dev), gates.to(dev), idx.to(dev), slab_map.to(dev),
        partial=True, rows=tuple(r.to(dev) for r in rows))
        for bank, dev in zip(banks, mesh.devices)]
    return x + all_reduce_sum(partials, mesh).to(x.dtype)


def _moe_fused_impl(cfg, kn, layer, x, h, gates, idx, slab, slab_map,
                    pool_buf, positions, ctx_lens, block_tables, mesh=None):
    """The expert half of layer l - 1 chained into the attention + router
    half of layer l (``layer`` = its DRAM params and K/V pool slices): the
    host's expert-id read sits between two such calls. Returns
    ``_moe_attn_router_body``'s tuple. ``mesh``: the expert half
    tensor-parallel (``_moe_expert_paged_impl``)."""
    x = _moe_expert_paged_impl(kn, x, h, gates, idx, slab, slab_map,
                               pool_buf, mesh)
    lp, kc, vc = layer
    return _moe_attn_router_body(cfg, ctx_lens, positions, block_tables, x,
                                 lp, kc, vc)


def _moe_head_impl(cfg, params, layer, lengths, tokens, q_lens,
                   block_tables, spec=None):
    """Head of the streamed MoE step: the embed (drafting included, with
    ``spec``) and layer 0's attention + router, which read no pool page.
    Returns (x, h, gates, idx, k, v, positions, ctx_lens, q_lens, fin),
    ``fin`` being ``_finish_step``'s ``spec``."""
    x, positions, ctx_lens, q_lens, fin = _embed_step(
        cfg, params, lengths, tokens, q_lens, spec)
    lp, kc, vc = layer
    x, h, gates, idx, k, v = _moe_attn_router_body(
        cfg, ctx_lens, positions, block_tables, x, lp, kc, vc)
    return x, h, gates, idx, k, v, positions, ctx_lens, q_lens, fin


def _moe_tail_impl(cfg, sched_cfg, sample_cfg, kv_aware, kn, final_norm,
                   lm_head, state, x, h, gates, idx, slab, slab_map,
                   pool_buf, k_new, v_new, q_lens, admitted, positions,
                   block_tables, generator, spec=None, mesh=None):
    """Tail of the streamed MoE step: the last layer's expert half (over
    the ``mesh``'s shards when given) and the finish (``_finish_step``:
    final norm, sampling or verification, the paged KV write, Algorithm
    2). Returns what ``_finish_step`` returns."""
    x = _moe_expert_paged_impl(kn, x, h, gates, idx, slab, slab_map,
                               pool_buf, mesh)
    return _finish_step(cfg, sched_cfg, sample_cfg, kv_aware, final_norm,
                        lm_head, state, x, k_new, v_new, q_lens, admitted,
                        positions, block_tables, generator, spec=spec)


def _map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    return fn(tree)


_layer_slice = dense.layer_slice


class Engine:
    """Serving engine over a ``dense``- or ``moe``-family ArchConfig.

    ``params`` is a raw param tree (``models.dense.init`` or params carried
    across with ``interop``); it is moved to ``device`` and deployed there
    (flash tier with ``rber``/``seed``). A tree from
    ``tiering.deploy_init`` is deployed already: its FlashWeight leaves
    (or, streamed, its StoreRefs into ``weight_store``) pass through, and
    must have been made with the same ``rber``/``seed``. ``block_size``/``n_blocks`` size
    the paged KV pool; ``admission_cfg`` sets the chunk width and the
    Alg.2-coupled per-step token budget; ``max_waiting`` bounds the queue
    (``submit`` then blocks). ``last_logits`` holds the latest step's
    (slots, V) f32 logits.

    ``compiled`` (the default, as in the reference) serves every step
    through ONE static-shape step body: its inputs are device buffers made
    once and filled from pinned host arrays before each step, and it writes
    the pools, lengths, bitmap and Algorithm 2 baseline in place. On the
    card the first step captures that body in a CUDA graph
    (``repro_torch.graphs``: warmed up and captured on an idle batch) and
    every step replays it; ``step_traces`` counts the captures (1 after
    the first step, whatever the slot churn, chunked prefills or
    admission). A failed capture raises: the engine never drops to eager
    on its own. On the CPU, where PyTorch has no graphs, the same body runs
    without capture and ``step_traces`` is 0. ``compiled=False`` runs the
    body eagerly on every device (``step_traces`` -1). A non-greedy
    ``sample_cfg`` draws inside the graph from the engine's generator,
    registered with it; a build that cannot register one refuses
    ``compiled=True`` with temperature > 0 on the card.

    The resident engine keeps the DRAM projections ``wq``/``wk``/``wv``/
    ``wo`` in f32, made once from bf16 (exact), so no step upcasts them.

    A ``moe``-family engine serves on the resident plane (compiled or
    eager, speculative too): attention stays on the DRAM projections (no
    flash copy, no bitmap dispatch), the router picks each lane's top-k
    experts, and each deployed expert bank runs as one grouped ECDP launch
    a layer with ECC off (``models/moe.serve_expert_ffn``); Algorithm 2's
    bitmap still updates and still contracts the step token budget. With a
    ``weight_store`` a MoE engine serves the streamed MoE plane (expert
    paging; ``StreamConfig.group_size`` 1): the expert banks stay in the
    store and only the routed experts' pages are uploaded, into a device
    page pool sized once at construction, under an ``ExpertCache`` of
    what the device budget leaves after lm_head and the slab. On the card
    the compute stream waits for each slab row's upload before its layer's
    launch; freeing a transient or evicted expert records the consumer
    event the next upload into its pages waits on. ``expert_stats()``
    reports its traffic; ``close()`` stops its prefetcher.

    ``weight_store`` (a ``store.PageStore``) serves the streamed plane:
    the flash tier is programmed into the store (or, if the store already
    holds a page table — a die image — taken from it, and ``params`` is the
    DRAM tier) and streamed onto the device under ``stream_cfg``
    (``store.StreamConfig``). The streamed step always runs eagerly
    (``step_traces`` -1): each layer group binds another window's page
    tables, so one graph cannot serve every group. Its DRAM weights stay
    bf16, within its device budget. On the card every kernel of a step
    runs on the stream current at construction.

    ``spec_cfg`` (``spec.SpecConfig``) turns on SPECULATIVE serving on
    either plane: decoding slots pack ``[last_token, d_1 .. d_k]`` into
    their chunk lanes, one forward pass verifies all k, and each verify
    step emits ``n_accept + 1`` tokens (``last_lane_logits`` holds the
    step's (slots, k+1, V) verify-lane logits). ``drafter='model'`` also
    takes a small resident draft model (``draft_cfg``/``draft_params``,
    dense family, a raw param tree moved to ``device``). As in the
    reference it needs the compiled data plane: ``compiled=False`` is
    refused (a streamed engine, eager by construction, is accepted).

    ``StreamConfig(n_shards=S)`` with S > 1 serves either streamed plane
    TENSOR-PARALLEL over a "model" mesh (``mesh``: a
    ``launch.mesh.ModelMesh`` or a list of S devices, which may repeat one;
    default ``make_model_mesh(S, device)``, S distinct devices, whose first
    must be ``device``). The weight page pool is a
    ``ShardedWeightPagePool``, one partition per shard on its device; the
    DRAM tier, the KV pool, the bitmap, attention, the router, lm_head,
    sampling and the expert ids' read to the host stay on the first
    device. Each shard runs its column slice of w_gate / w_up and the row
    slice of w_down: of the dense FFN, or of every routed expert through
    the grouped paged ECDP on its partition, the gate-weighted combine in
    f32 on its partial. ``core.erdpe.all_reduce_sum`` completes every FFN
    (a layer's expert FFN) in f32 before the cast. ``device_budget_bytes``
    stays the aggregate budget; each shard's pool is sized to its share.
    A matrix the shards cannot split into whole 128-wide tiles is refused
    ("cannot partition"), and so is S > 1 with no ``weight_store``.

    ``prefix_cache`` turns on hash-based prefix caching; ``registry`` is
    the ``obs.MetricsRegistry`` the step histogram and token counter live
    in (default: the process-wide one).
    """

    def __init__(self, cfg, params, max_slots: int = 4, max_seq: int = 256,
                 sample_cfg: SampleConfig = SampleConfig(),
                 sched_cfg: sched.SchedulerConfig | None = None,
                 kv_aware: bool = True, rber: float = 0.0, seed: int = 0,
                 block_size: int = 16, n_blocks: int | None = None,
                 admission_cfg: sched.AdmissionConfig | None = None,
                 max_waiting: int | None = None, weight_store=None,
                 stream_cfg: StreamConfig | None = None, device="cuda",
                 compiled: bool = True, prefix_cache: bool = False,
                 spec_cfg: spec_mod.SpecConfig | None = None,
                 draft_cfg=None, draft_params=None,
                 registry: "obs.MetricsRegistry | None" = None, mesh=None):
        if cfg.family not in ("dense", "moe"):
            raise ValueError("engine serves dense- and moe-family archs "
                             f"(got {cfg.family!r})")
        n_shards = stream_cfg.n_shards if stream_cfg is not None else 1
        if n_shards > 1 or mesh is not None:
            if weight_store is None:
                raise ValueError(
                    f"n_shards={n_shards} shards the streamed plane's page "
                    "pool and FFN: pass a weight_store")
        self.cfg = cfg
        self.device = torch.device(device)
        if self.device.type == "cuda" and not takes_head_dim(cfg.head_dim):
            # no plain fallback on the card: every layer's attention
            # would leave the kernel path
            raise ValueError(
                f"{cfg.name}: head_dim {cfg.head_dim} is not one the "
                f"paged-attention kernel takes ({_HEAD_DIMS}); serve it with "
                f"device='cpu'")
        self._stream = (torch.cuda.current_stream(self.device)
                        if self.device.type == "cuda" else None)
        self.sample_cfg = sample_cfg
        self.kv_aware = kv_aware
        self.admission_cfg = admission_cfg or sched.AdmissionConfig()
        self.spec_cfg = spec_cfg
        self.proposer = None
        if spec_cfg is not None:
            # the caller's argument: the streamed plane runs eagerly by
            # construction and still takes speculative lanes
            if not compiled:
                raise ValueError("speculative decoding runs through the "
                                 "compiled data plane (compiled=False has "
                                 "no verify lanes)")
            if spec_cfg.k + 1 > self.admission_cfg.chunk_tokens:
                raise ValueError(
                    f"spec k={spec_cfg.k} needs k+1 <= chunk_tokens="
                    f"{self.admission_cfg.chunk_tokens} verify lanes")
            if draft_params is not None:
                draft_params = _map_tree(lambda t: t.to(self.device),
                                         draft_params)
            self.proposer = spec_mod.DraftProposer(spec_cfg, draft_cfg,
                                                   draft_params)
        self.store = weight_store
        self.streamed = weight_store is not None
        self.streamed_moe = self.streamed and cfg.family == "moe"
        self.compiled = compiled and not self.streamed
        if (self.compiled and self.device.type == "cuda"
                and sample_cfg.temperature > 0
                and not graphs.can_capture_generator()):
            raise ValueError("compiled=True with temperature > 0 samples "
                             "inside the CUDA graph, and this PyTorch build "
                             "cannot register a generator with one; pass "
                             "compiled=False")
        # a store that already holds a page table was programmed before (a
        # die image): NAND programming is write-once, so the flash tier
        # comes from its table and ``params`` is the DRAM tier only. A tree
        # that carries StoreRefs (``tiering.deploy_init``'s) was programmed
        # into this store by its caller: deploy passes them through
        carries_refs = any(isinstance(t, StoreRef)
                           for _, t in _walk(params))
        if carries_refs and not self.streamed:
            raise ValueError("StoreRef leaves need the streamed engine's "
                             "weight_store, the store they were put in")
        self.store_preprogrammed = (self.streamed and not carries_refs
                                    and len(weight_store.table) > 0)
        with torch.no_grad():
            params = _map_tree(
                lambda t: t if isinstance(t, StoreRef) else t.to(self.device),
                params)
            if self.store_preprogrammed:
                if rber > 0.0:
                    raise ValueError(
                        "rber applies at flash-programming time; a "
                        "preprogrammed store carries its own error injection")
                refs = weight_store.param_refs(
                    exclude_prefixes=("attn_flash/",))
                self.params = graft_store_refs(
                    _map_tree(lambda t: t.to(torch.bfloat16), params), refs)
                self.tier_map = {p: "flash" for p in refs}
            else:
                # DRAM tier: bf16 attention weights, embeddings, norms;
                # flash tier: INT8+ECC FFN and lm_head (device FlashWeights,
                # or StoreRefs to the store's pages), plus a flash copy of
                # the Q/O projections the bitmap can move columns to.
                self.params, self.tier_map = deploy(
                    params, rber=rber, seed=seed, store=weight_store)
            self.mesh = None
            if self.streamed:
                self.stream_cfg = stream_cfg or StreamConfig()
                self.attn_flash = None
                if self.streamed_moe:
                    self._init_streamed_moe(max_slots, mesh)
                else:
                    self._init_streamed(params, rber, seed, mesh)
            else:
                self.stream_cfg = None
                # MoE keeps attention DRAM-only: the flash engine serves
                # the expert banks
                self.attn_flash = (
                    None if cfg.family == "moe"
                    else self._flash_attn_copy(params, rber, seed))
                # the DRAM projections in f32, made once (bf16 -> f32 is
                # exact): _proj's and split_projection's upcast returns them
                attn = self.params["layers"]["attn"]
                for k in ("wq", "wk", "wv", "wo"):
                    attn[k] = attn[k].float()
                self._layers = [_layer_slice(self.params["layers"], li)
                                for li in range(cfg.n_layers)]
        h = sched_cfg.h if sched_cfg else 32
        while cfg.n_heads * cfg.head_dim % h:
            h //= 2
        self.sched_cfg = sched_cfg or sched.SchedulerConfig(
            column_bytes=cfg.d_model, h=h)
        self.bitmap = sched.init_bitmap(self.sched_cfg, self.device)
        self.pool = PagedKVPool(cfg.n_layers, max_slots, max_seq,
                                cfg.n_kv_heads, cfg.head_dim,
                                block_size=block_size, n_blocks=n_blocks,
                                device=self.device)
        self.pool.stream = self._stream  # admission's lengths writes
        # admission cap on a request's KV rows: the exact max_seq, the
        # physical pool minus the dump block, and (learned positions) the
        # embedding table
        kv_cap = min(self.pool.max_seq,
                     (self.pool.n_blocks - 1) * self.pool.block_size)
        if "pos_embed" in self.params:
            kv_cap = min(kv_cap, self.params["pos_embed"].shape[0])
        self._kv_cap = kv_cap
        # the step's inputs: device buffers made once, filled before each
        # step from pinned host arrays (non-blocking copies on the stream)
        n, t_chunk = self.pool.n_slots, self.admission_cfg.chunk_tokens
        shapes = {"tokens": ((n, t_chunk), torch.int32),
                  "q_lens": ((n,), torch.int32),
                  "admitted": ((n,), torch.bool),
                  "block_tables": ((n, self.pool.max_blocks), torch.int32)}
        if spec_cfg is not None:
            # per-slot token histories feeding the drafter (kept across
            # steps, as the reference's), and the verify-lane inputs
            shapes.update(hist=((n, max_seq + 1), torch.int32),
                          hist_lens=((n,), torch.int32),
                          draft_cap=((n,), torch.int32),
                          is_decode=((n,), torch.bool))
        pin = self.device.type == "cuda"
        self._host_in = {k: torch.zeros(shape, dtype=dt, pin_memory=pin)
                         for k, (shape, dt) in shapes.items()}
        self._dev_in = {k: torch.zeros(shape, dtype=dt, device=self.device)
                        for k, (shape, dt) in shapes.items()}
        self._captured = None            # the step's CUDA graph
        self._traces = 0
        # control-plane lock: submit / step / close may come from several
        # threads; ``cancel`` stays lock-free (flag flips only).
        self._mu = threading.RLock()
        self._cv = threading.Condition(self._mu)
        self._closed = False
        self._close_lock = threading.Lock()
        self._close_done = False
        self.max_waiting = max_waiting
        self.requests: dict[int, Request] = {}
        self.waiting: collections.deque[Request] = collections.deque()
        self._next_rid = 0
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(seed)
        self._prev_cycles = torch.zeros((), dtype=torch.int32,
                                        device=self.device)
        self._npu_frac = 1.0             # host view of the Alg. 2 bitmap
        self._stall_frac = 0.0           # EMA of streamer stall per step
        self._steps_done = 0
        self._auto_depth_done = False
        self.stats: list[dict] = []
        self.last_logits: torch.Tensor | None = None
        self.last_lane_logits: torch.Tensor | None = None
        if spec_cfg is not None:
            self._hist = self._host_in["hist"].numpy()
            self._hist_lens = self._host_in["hist_lens"].numpy()
            self._spec_totals = {"verify_steps": 0, "drafted": 0,
                                 "accepted": 0, "emitted": 0}
            # per-slot acceptance-rate EMA driving the adaptive verify-lane
            # count; reset to optimistic full depth at re-admission
            self._accept_ema = np.ones((n,), np.float64)
        # hash-based prefix caching: completed requests retain their full
        # prompt blocks under a chain hash; admission adopts the longest
        # cached chain copy-free (ref bump only)
        self.prefix = PrefixIndex(self.pool) if prefix_cache else None
        self._prefix_tokens_saved = 0
        # ObsPlane: per-step phase histogram + timeline ring. A disabled
        # registry hands out no-op instruments, so a dark plane costs a
        # few perf_counter reads per step.
        self.obs = registry if registry is not None \
            else obs.default_registry()
        self.timeline = obs.StepTimeline(256)
        self._h_step = self.obs.histogram(
            "engine_step_seconds", "serving step host wall time by phase",
            label_names=("phase",))
        self._c_step_tokens = self.obs.counter(
            "engine_tokens_total", "tokens processed by the step loop",
            label_names=("kind",))
        self._phases: dict[str, float] = {}

    def _flash_attn_copy(self, params, rber, seed):
        """Per-layer flash (INT8+ECC) copies of the Q and O projections —
        the ones the bitmap dispatches — with the reference's per-layer
        seeds (seed + layer)."""
        attn = params["layers"]["attn"]
        return [{k: encode_flash(attn[k][li], rber=rber, seed=seed + li)
                 for k in ("wq", "wo")}
                for li in range(self.cfg.n_layers)]

    # --- tensor-parallel streamed serving ------------------------------------

    def _make_mesh(self, mesh):
        """The "model" mesh behind ``StreamConfig.n_shards`` (None when
        unsharded): ``mesh`` (a ModelMesh or a device list) or S distinct
        devices of the engine's type. Its first device must be the
        engine's."""
        from repro_torch.launch.mesh import ModelMesh, make_model_mesh
        n = self.stream_cfg.n_shards
        if mesh is not None and not isinstance(mesh, ModelMesh):
            mesh = make_model_mesh(len(mesh), devices=mesh)
        if mesh is not None and mesh.n_shards != n:
            raise ValueError(f"a mesh of {mesh.n_shards} devices for "
                             f"StreamConfig(n_shards={n})")
        if n <= 1:
            return None
        if mesh is None:
            mesh = make_model_mesh(n, self.device)
        first, dev = mesh.first, self.device
        if first.type != dev.type or (
                dev.type == "cuda" and (first.index or 0) != (
                    dev.index if dev.index is not None
                    else torch.cuda.current_device())):
            raise ValueError(f"the mesh's first device ({first}) must be "
                             f"the engine's ({dev}): the DRAM tier, "
                             "attention and sampling live there")
        return mesh

    def _entry_plan(self, name: str):
        """ShardPlan of one store entry (sharded mode), memoized — the
        plan the ShardedWeightPagePool derives, needed here before the pool
        exists to size it."""
        plan = self._entry_plans.get(name)
        if plan is None:
            from repro_torch.launch.sharding import tp_shard_axis
            plan = self.store.shard_entry(name, self.stream_cfg.n_shards,
                                          tp_shard_axis(name))
            self._entry_plans[name] = plan
        return plan

    def _entry_pages_local(self, name: str) -> int:
        """Pool pages entry ``name`` occupies PER SHARD."""
        if self.mesh is None:
            return self.store.entry_pages(name)
        p = self._entry_plan(name)
        pb = self.store.page_bytes
        return (len(p.q_pages[0]) + -(-p.parity_nbytes // pb)
                + -(-p.scale_nbytes // pb))

    def _entry_kn(self, name: str) -> tuple:
        """The (K, N) the data plane binds for entry ``name``: the whole
        matrix unsharded, the shard-LOCAL partition under TP."""
        if self.mesh is None:
            return tuple(self.store.table[name]["q"].shape)
        return tuple(self._entry_plan(name).local_kn)

    def _make_wpool(self, n_pages: int):
        """The device weight page pool, partitioned over the mesh when TP
        serving is on (``n_pages`` is then the slots PER SHARD)."""
        if self.mesh is None:
            return WeightPagePool(self.store, n_pages, device=self.device,
                                  stream=self._stream)
        return ShardedWeightPagePool(self.store, n_pages, self.mesh,
                                     stream=self._stream)

    def _check_shardable(self, names):
        """Refuse a silent replication of the entries the TP rules shard:
        the FFN's all-reduce is unconditional, so a replicated w_gate /
        w_up / w_down would count the product n_shards times."""
        if self.mesh is None:
            return
        from repro_torch.launch.sharding import tp_shard_axis
        bad = sorted({n.partition("@")[0] for n in names
                      if tp_shard_axis(n) is not None
                      and self._entry_plan(n).axis is None})
        if bad:
            s = self.stream_cfg.n_shards
            raise ValueError(
                f"n_shards={s} cannot partition {bad}: the sharded matrix "
                f"dim must divide into {s} whole 128-wide tile columns/rows "
                "(make d_ff/d_model a multiple of 128*n_shards, or lower "
                "n_shards)")

    # --- streamed mode (FlashStore weight tier) -----------------------------

    def _init_streamed(self, raw_params, rber, seed, mesh=None):
        """Flash tier lives in the PageStore: program the per-layer attn
        flash copies next to deploy()'s FFN/lm_head entries, split the DRAM
        remainder out of the tiered tree, and stand up the page pool,
        residency cache and layer streamer under the device weight budget
        (over the mesh's shards when ``StreamConfig.n_shards`` > 1)."""
        cfg, sc = self.cfg, self.stream_cfg
        self.mesh = self._make_mesh(mesh)
        self._entry_plans: dict = {}
        if cfg.n_layers % sc.group_size:
            raise ValueError(f"group_size={sc.group_size} must divide "
                             f"n_layers={cfg.n_layers}")
        # per-layer flash Q/K/V/O copies with the resident engine's seeds;
        # a die image normally carries them, and a read-only one without
        # them cannot be fixed here
        if f"attn_flash/{ATTN_FLASH_KEYS[0]}@0" not in self.store.table:
            if isinstance(self.store._data, np.memmap):
                raise ValueError(
                    "die image lacks the per-layer attn flash copies and is "
                    "read-only; program them into a writable store")
            program_attn_flash(self.store, raw_params["layers"]["attn"],
                               cfg.n_layers, rber=rber, seed=seed)
        self._ffn_refs = {k: v for k, v in self.params["layers"]["ffn"].items()
                          if isinstance(v, StoreRef)}
        stray = [p for p, t in self.tier_map.items()
                 if t == "flash" and p != "lm_head"
                 and not p.startswith("layers/ffn/")]
        if stray:
            raise ValueError("streamed mode expects the dense flash layout "
                             f"(layers/ffn/* + lm_head); stray flash leaves "
                             f"would silently never be fetched: {stray}")
        layers_dram = drop_store_refs(self.params["layers"])
        self._layers = [_layer_slice(layers_dram, li)
                        for li in range(cfg.n_layers)]
        self._dram_params = {k: self.params[k]
                             for k in ("embed", "pos_embed", "final_norm")
                             if k in self.params}
        self.n_groups = cfg.n_layers // sc.group_size
        group_names = [self._group_entries(g) for g in range(self.n_groups)]
        self._check_shardable(group_names[0])
        group_nbytes = [sum(self.store.entry_nbytes(n) for n in names)
                        for names in group_names]
        self._group_bytes = max(group_nbytes)   # depth auto-tuning re-budgets
        lm_bytes = self.store.entry_nbytes("lm_head")
        # the rotating window holds up to prefetch_depth groups in flight;
        # whatever budget remains is residency-cache capacity
        window_bytes = sc.prefetch_depth * self._group_bytes
        if sc.device_budget_bytes is None or sc.pin_all:
            cache_cap = None
        else:
            cache_cap = sc.device_budget_bytes - window_bytes
            if cache_cap < lm_bytes:
                raise ValueError(
                    f"device_budget_bytes={sc.device_budget_bytes} cannot "
                    f"hold {sc.prefetch_depth} prefetch windows "
                    f"({window_bytes}B) + pinned lm_head ({lm_bytes}B)")
        # pool size in PHYSICAL pages (padded tiles inflate small params
        # past their payload bytes): the worst pages-per-payload-byte ratio
        # over the groups converts the cache's payload budget, plus the
        # in-flight windows and one retiring transient; capped at the tier.
        # Sharded: the pages are PER SHARD (replicated attention copies keep
        # their whole pages on every shard) while the cache budget stays
        # AGGREGATE, so the ratio is local pages over global bytes, and the
        # cache is clamped so one shard's backing fits its budget share.
        group_pages = [sum(self._entry_pages_local(n) for n in names)
                       for names in group_names]
        pb = self.store.page_bytes
        worst = max(gp * pb / max(nb, 1)
                    for gp, nb in zip(group_pages, group_nbytes))
        self._pool_reserve_pages = \
            (sc.prefetch_depth + 1) * max(group_pages)
        if cache_cap is not None and sc.n_shards > 1:
            cache_cap = min(cache_cap, int(sc.device_budget_bytes
                                           / (sc.n_shards * worst)))
            if cache_cap < lm_bytes:
                raise ValueError(
                    f"device_budget_bytes={sc.device_budget_bytes} over "
                    f"{sc.n_shards} shards leaves a per-device share too "
                    f"small for the pinned lm_head ({lm_bytes}B); raise "
                    "the budget")
        n_pages = sum(group_pages)
        if cache_cap is not None:
            n_pages = min(n_pages, -(-int(worst * cache_cap) // pb)
                          + self._pool_reserve_pages)
        self.wpool = self._make_wpool(n_pages)
        self._win_shapes = {
            "ffn": {k: self._entry_kn(ref.entry(0))
                    for k, ref in self._ffn_refs.items()},
            "attn": {k: self._entry_kn(f"attn_flash/{k}@0")
                     for k in ATTN_FLASH_KEYS},
        }
        self.cache = ResidencyCache(cache_cap, on_evict=self._evict_window)
        self.streamer = LayerStreamer(self.n_groups, self._fetch_group,
                                      self.cache, sc.prefetch_depth,
                                      discard=self._discard_window)
        # hot pins: lm_head is read every step (a device FlashWeight, read
        # whole, so it skips the pool); the first/last groups bound the
        # stream's cold start and tail when they fit.
        self._lm_head = self.store.get("lm_head", self.device)
        self.cache.insert("lm_head", self._lm_head, lm_bytes, pin=True)
        if sc.pin_all:
            for g in range(self.n_groups):
                self.streamer.pin(g)
        elif sc.pin_edges:
            for g in dict.fromkeys((0, self.n_groups - 1)):
                self.streamer.pin(g)
        # init-time reads are deployment, not serving
        self.store.reset_counters()
        self.wpool.reset_counters()

    # --- streamed MoE mode (expert paging) ----------------------------------

    def _init_streamed_moe(self, max_slots: int, mesh=None):
        """MoE flash tier: the per-(layer, expert) bank slices live in the
        PageStore (``deploy`` splits the stacked (L, E, K, N) banks at
        ``name@li.ei``); router, attention and norms stay DRAM. Stands up
        the page pool, the ``ExpertCache`` ((layer, expert) residency) and
        the router-history prefetcher under the device budget; the per-layer
        expert SLAB is budget-accounted like the dense prefetch windows.
        With ``StreamConfig.n_shards`` > 1 the pool is partitioned over the
        mesh's shards, every expert's w_gate / w_up by tile columns and
        w_down by tile rows (``launch.sharding.tp_shard_axis``)."""
        cfg, sc = self.cfg, self.stream_cfg
        self.mesh = self._make_mesh(mesh)
        self._entry_plans: dict = {}
        if sc.group_size != 1:
            raise ValueError(
                f"group_size={sc.group_size}: MoE streaming is per-layer "
                "(group_size=1) — each layer's routing depends on the "
                "previous layer's experts, so a multi-layer group cannot "
                "know its expert set up front")
        experts = self.params["layers"]["moe"]["experts"]
        self._expert_refs = {k: v for k, v in experts.items()
                             if isinstance(v, StoreRef)}
        if set(self._expert_refs) != {"w_gate", "w_up", "w_down"}:
            raise ValueError("MoE streamed mode expects the expert bank "
                             "(w_gate/w_up/w_down) in the store, got "
                             f"{sorted(self._expert_refs)}")
        for ref in self._expert_refs.values():
            if ref.lead != (cfg.n_layers, cfg.n_experts):
                raise ValueError(
                    f"expert bank {ref.name!r} is split {ref.lead}, expected "
                    f"(n_layers, n_experts)=({cfg.n_layers}, {cfg.n_experts})")
        stray = [p for p, t in self.tier_map.items()
                 if t == "flash" and p != "lm_head"
                 and not p.startswith("layers/moe/experts/")]
        if stray:
            raise ValueError("MoE streamed mode expects the expert flash "
                             "layout (layers/moe/experts/* + lm_head); stray "
                             f"flash leaves would never be fetched: {stray}")
        layers_dram = drop_store_refs(self.params["layers"])
        self._layers = [_layer_slice(layers_dram, li)
                        for li in range(cfg.n_layers)]
        self._dram_params = {k: self.params[k]
                             for k in ("embed", "pos_embed", "final_norm")
                             if k in self.params}
        self._check_shardable(
            [ref.entry(0, 0) for ref in self._expert_refs.values()])
        self._expert_nbytes = [
            [sum(self.store.entry_nbytes(ref.entry(li, e))
                 for ref in self._expert_refs.values())
             for e in range(cfg.n_experts)]
            for li in range(cfg.n_layers)]
        max_expert = max(max(r) for r in self._expert_nbytes)
        self._max_expert_bytes = max_expert
        # fetch generation stamps and the per-layer slab memo
        # (``_acquire_experts``): both exist before the pins fetch
        self._fetch_gen = itertools.count(1)
        self._slab_memo: dict = {}
        worst_routed = min(cfg.n_experts,
                           max_slots * self.admission_cfg.chunk_tokens
                           * cfg.top_k)
        self._e_slab = max(1, int(sc.expert_slab or worst_routed))
        lm_bytes = self.store.entry_nbytes("lm_head")
        slab_bytes = self._e_slab * max_expert
        if sc.device_budget_bytes is None or sc.pin_all:
            cache_cap = None
        else:
            cache_cap = sc.device_budget_bytes - lm_bytes - slab_bytes
            if cache_cap < max_expert:
                raise ValueError(
                    f"device_budget_bytes={sc.device_budget_bytes} cannot "
                    f"hold the pinned lm_head ({lm_bytes}B) + the "
                    f"{self._e_slab}-row expert slab ({slab_bytes}B) + at "
                    f"least one cacheable expert ({max_expert}B); raise the "
                    "budget or shrink StreamConfig.expert_slab")
        # the device page pool in PHYSICAL pages: the cache's payload budget
        # at the worst pages-per-payload-byte ratio, plus the slab's
        # misroute fetches and the prefetcher's in-flight traffic, capped
        # at the whole expert tier. Sized once: a grow mid-run would
        # synchronize the card and swap the pool tensor. Sharded: LOCAL
        # pages per expert against the AGGREGATE cache budget, as on the
        # dense plane, and the cache clamped so that one shard's backing
        # fits its budget share.
        expert_pages = [
            [sum(self._entry_pages_local(ref.entry(li, e))
                 for ref in self._expert_refs.values())
             for e in range(cfg.n_experts)]
            for li in range(cfg.n_layers)]
        tier_pages = sum(sum(r) for r in expert_pages)
        max_ep = max(max(r) for r in expert_pages)
        pb = self.store.page_bytes
        worst = max(expert_pages[li][e] * pb
                    / max(self._expert_nbytes[li][e], 1)
                    for li in range(cfg.n_layers)
                    for e in range(cfg.n_experts))
        self._pool_reserve_pages = 2 * self._e_slab * max_ep
        if cache_cap is not None and sc.n_shards > 1:
            cache_cap = min(cache_cap, int(sc.device_budget_bytes
                                           / (sc.n_shards * worst)))
            if cache_cap < max_expert:
                raise ValueError(
                    f"device_budget_bytes={sc.device_budget_bytes} over "
                    f"{sc.n_shards} shards leaves a per-device share too "
                    f"small for one cacheable expert ({max_expert}B); "
                    "raise the budget or shrink StreamConfig.expert_slab")
        if cache_cap is None:
            n_pages = tier_pages
        else:
            n_pages = min(tier_pages,
                          -(-int(worst * cache_cap) // pb)
                          + self._pool_reserve_pages)
        self.wpool = self._make_wpool(n_pages)
        self._expert_kn = {name: self._entry_kn(ref.entry(0, 0))
                           for name, ref in self._expert_refs.items()}
        self.expert_cache = ExpertCache(cache_cap, cfg.n_layers,
                                        cfg.n_experts, n_slots=max_slots,
                                        on_evict=self._evict_window)
        self.cache = self.expert_cache
        self.streamer = None             # the dense group streamer is unused
        self._lm_head = self.store.get("lm_head", self.device)
        if sc.pin_all:                   # the fully resident baseline
            pins = [(li, e) for li in range(cfg.n_layers)
                    for e in range(cfg.n_experts)]
        else:
            # always-routed shared experts: the first pin_shared_experts
            # of every layer never pay an upload or a misroute stall
            pins = [(li, e) for li in range(cfg.n_layers)
                    for e in range(min(sc.pin_shared_experts,
                                       cfg.n_experts))]
        for li, e in pins:
            val, nb = self._fetch_expert(li, e)
            if not self.expert_cache.insert((li, e), val, nb, pin=True):
                self._discard_window(val)
        self.prefetcher = ExpertPrefetcher(
            self.expert_cache, self._fetch_expert,
            discard=self._discard_window,
            batch_fetch=self._fetch_expert_batch)
        # misroute-stall-aware budget retune (auto_expert_budget)
        self._auto_expert_done = False
        self._max_routed_seen = 0
        self._host_q_lens = np.zeros((max_slots,), np.int32)
        self._host_draft_cap = None
        # init-time reads (lm_head, pins) are deployment, not serving
        self.store.reset_counters()
        self.expert_cache.reset_counters()
        self.wpool.reset_counters()

    def _fetch_expert(self, li: int, e: int):
        """Upload ONE (layer, expert) weight set's pages (w_gate / w_up /
        w_down) in one staged transfer and return (its page tables,
        payload bytes). Runs on the compute path or on the prefetch worker
        (whose uploads go to the pool's copy stream)."""
        return (self._fetch_experts(li, [e])[e],
                self._expert_nbytes[li][e])

    def _fetch_experts(self, li: int, es):
        """Upload SEVERAL of one layer's experts in ONE staged transfer;
        returns {expert: table dict}."""
        sets = self._fetch_expert_sets([(li, e) for e in es])
        return {e: v for (_, e), v in sets.items()}

    def _fetch_expert_sets(self, keys):
        """Upload several (layer, expert) weight sets, any mix of layers, in
        ONE staged transfer; returns {(layer, expert): {name: page tables,
        "slots": the pool slots, "ready": the upload's event, "gen": a
        fetch generation stamp}}."""
        tbls = self.wpool.upload(
            [ref.entry(li, e) for li, e in keys
             for ref in self._expert_refs.values()])
        out = {}
        for li, e in keys:
            val = {name: tbls[ref.entry(li, e)]
                   for name, ref in self._expert_refs.items()}
            val["slots"] = np.concatenate(
                [val[name]["slots"] for name in self._expert_refs])
            val["ready"] = val["w_gate"]["ready"]
            # the slab memo keys on it, so a re-fetch (new pool slots) can
            # never alias a stale memoized slab; next() on a count is atomic
            # (the compute path and the prefetch worker both fetch)
            val["gen"] = next(self._fetch_gen)
            out[(li, e)] = val
        return out

    def _fetch_expert_batch(self, keys):
        """The prefetch worker's batch hook: its whole drained queue in one
        staged transfer. Returns {key: (value, nbytes)}."""
        sets = self._fetch_expert_sets(keys)
        return {k: (v, self._expert_nbytes[k[0]][k[1]])
                for k, v in sets.items()}

    def _acquire_experts(self, li: int, routed):
        """Gather one layer's ROUTED experts into the slab's page tables.

        Cache hits are acquired ref-held; an expert the prefetch worker is
        reading is waited for (bounded); the rest are MISROUTE STALLS,
        uploaded together in ONE staged transfer and hold-inserted (an
        insert the budget rejects leaves a TRANSIENT, freed after the
        launch). Returns (slab {name: {"dev": (q_tbl (e_slab, kt, nt),
        p_slots, s_slots) device int32}}, slab_map (n_experts,) int32 device
        tensor
        with -1 = not in the slab, held keys and transient slot arrays to
        release / free after the launch, the missing expert-id set). Under
        a mesh each slab entry also carries ``"dev_shards"``, the same
        tables on each shard's device (the slots are symmetric)."""
        routed = [int(e) for e in routed] or [0]
        if len(routed) > self._e_slab:
            raise ValueError(
                f"layer {li} routed {len(routed)} distinct experts > "
                f"expert_slab={self._e_slab}; raise StreamConfig.expert_slab")
        cache = self.expert_cache
        held, transients, vals = [], [], {}
        missing = []
        for e in routed:
            key = (li, e)
            val = cache.acquire(key)
            if val is None and self.prefetcher.in_flight(key):
                # the worker is reading this expert's pages: wait for it
                # instead of reading them twice
                t0 = time.perf_counter()
                deadline = t0 + 1.0
                while (self.prefetcher.in_flight(key)
                       and time.perf_counter() < deadline):
                    time.sleep(0.0005)
                val = cache.acquire(key)
                cache.note_stall(time.perf_counter() - t0)
            if val is None:
                missing.append(e)
            else:
                held.append(key)
                vals[e] = val
        if missing:
            t0 = time.perf_counter()
            fetched = self._fetch_experts(li, missing)
            dt = time.perf_counter() - t0
            for e in missing:
                val, nb = fetched[e], self._expert_nbytes[li][e]
                cache.note_fetch(nb)
                cache.note_stall(dt / len(missing))
                prior = (cache.acquire((li, e))
                         if (li, e) in cache else None)
                if prior is not None:
                    # the prefetch worker landed it between the miss and
                    # this fetch: use its copy, ours is a transient
                    held.append((li, e))
                    transients.append(val["slots"])
                    vals[e] = prior
                elif cache.insert((li, e), val, nb, hold=True):
                    held.append((li, e))
                    vals[e] = val
                else:
                    transients.append(val["slots"])
                    vals[e] = val
        rows = [vals[e] for e in routed]
        # read after write: each row's pages are in once its upload's
        # events (on the pool's copy streams: one per distinct device of a
        # sharded pool) have passed, whoever uploaded it (this thread or
        # the prefetch worker); the memoized slab below needs them too
        for ready in {id(r["ready"]): r["ready"] for r in rows
                      if r["ready"] is not None}.values():
            self.wpool.wait_ready(ready)
        # slab memo: in steady decode a layer routes the same expert set
        # step after step, and its page tables move only when an expert is
        # re-fetched (a new generation stamp)
        memo_key = (tuple(routed), tuple(r["gen"] for r in rows))
        memo = self._slab_memo.get(li)
        if memo is not None and memo[0] == memo_key:
            slab, dev_map = memo[1], memo[2]
        else:
            slab_map = np.full((self.cfg.n_experts,), -1, np.int32)
            for r, e in enumerate(routed):
                slab_map[e] = r
            rows += [rows[0]] * (self._e_slab - len(rows))    # static rows
            # a sharded pool's slots are symmetric: every shard binds the
            # same (shard-local) tables, copied to each distinct device
            devs = (self.mesh.devices if self.mesh is not None
                    else (self.device,))
            slab = {}
            for name in self._expert_refs:
                host = [torch.from_numpy(np.stack([r[name][k] for r in rows]))
                        for k in ("q_tbl", "p_slots", "s_slots")]
                on = {d: tuple(t.to(d) for t in host)
                      for d in dict.fromkeys(devs)}
                slab[name] = {"dev": on[devs[0]],
                              "dev_shards": tuple(on[d] for d in devs)}
            dev_map = torch.from_numpy(slab_map).to(self.device)
            self._slab_memo[li] = (memo_key, slab, dev_map)
        return slab, dev_map, held, transients, set(missing)

    def _evict_window(self, key, value):
        """Cache eviction hook: hand an evicted window's pool slots back
        (the pool orders their reuse after the consumer's reads)."""
        if isinstance(value, dict) and "slots" in value:
            self.wpool.free(value["slots"])

    def _discard_window(self, value):
        """Streamer cleanup of a fetched window the cache did not keep:
        free its transient pool slots (after the consumer retired it)."""
        if isinstance(value, dict) and "slots" in value:
            self.wpool.free(value["slots"])

    def _group_entries(self, g: int) -> list[str]:
        """Store entry names backing layer group ``g``'s device window."""
        lo = g * self.stream_cfg.group_size
        names = []
        for li in range(lo, lo + self.stream_cfg.group_size):
            names += [ref.entry(li) for ref in self._ffn_refs.values()]
            names += [f"attn_flash/{k}@{li}" for k in ATTN_FLASH_KEYS]
        return names

    def _fetch_group(self, g: int):
        """Upload one layer group's pages into the device page pool — ONE
        staged transfer for the whole window — and return the window of
        per-layer page tables the group binds to the pool. Runs on the
        streamer's worker thread."""
        gs = self.stream_cfg.group_size
        lis = range(g * gs, (g + 1) * gs)
        names = self._group_entries(g)
        tbls = self.wpool.upload(names)
        win = {
            "ffn": {k: [tbls[ref.entry(li)] for li in lis]
                    for k, ref in self._ffn_refs.items()},
            "attn": {k: [tbls[f"attn_flash/{k}@{li}"] for li in lis]
                     for k in ATTN_FLASH_KEYS},
            # the hand-back token for the pool, and the upload's event
            "slots": np.concatenate([t["slots"] for t in tbls.values()]),
            "ready": tbls[names[0]]["ready"],
        }
        return win, sum(self.store.entry_nbytes(n) for n in names)

    def _state(self) -> dict:
        """The step's device state (every tensor written in place)."""
        return {"k": self.pool.k, "v": self.pool.v,
                "lengths": self.pool.lengths_dev, "bitmap": self.bitmap,
                "prev_cycles": self._prev_cycles}

    def _resident_body(self):
        """The resident data plane over the static inputs and the state:
        what the graph captures. Returns what ``_step_impl`` returns."""
        d = self._dev_in
        return _step_impl(self.cfg, self.sched_cfg, self.sample_cfg,
                          self.kv_aware, self.params, self._layers,
                          self.attn_flash, self._state(), d["tokens"],
                          d["q_lens"], d["admitted"], d["block_tables"],
                          self._generator, spec=self._spec_inputs())

    def _spec_inputs(self):
        """The speculative step's drafter and static inputs, or None."""
        if self.spec_cfg is None:
            return None
        d = self._dev_in
        return (self.proposer, self.spec_cfg.k, d["hist"], d["hist_lens"],
                d["draft_cap"], d["is_decode"])

    def _load_inputs(self):
        """The host arrays into the static device buffers, on the current
        stream (non-blocking from pinned memory: the step's host reads
        complete them before the arrays are filled again)."""
        for k, t in self._dev_in.items():
            t.copy_(self._host_in[k], non_blocking=True)

    def _run_resident(self):
        """One resident step: eager, or (compiled, on the card) the graph's
        replay, captured at the first step on an idle batch."""
        if not (self.compiled and self.device.type == "cuda"):
            self._load_inputs()
            return self._resident_body()
        if self._captured is None:
            for t in self._dev_in.values():
                t.zero_()                # the idle batch: no lanes
            self._captured = graphs.capture(
                self._resident_body, generator=(
                    self._generator if self.sample_cfg.temperature > 0
                    else None))
            self._traces += 1
        self._load_inputs()
        out = list(self._captured.replay())
        # the next replay overwrites the graph's outputs: the logits outlive
        # it (``last_logits``), the rest is read on the host before it
        for i in ((1,) if self.spec_cfg is None else (2, 3)):
            out[i] = out[i].clone()
        return tuple(out)

    @property
    def captured(self):
        """The step's ``graphs.Captured`` once the card has captured it, else
        None."""
        return self._captured

    @property
    def step_traces(self) -> int:
        """Captures of the serving step: 1 once the card has stepped
        (compiled), 0 on the CPU (no graphs; the same body runs), -1 for an
        eager or streamed engine."""
        return self._traces if self.compiled else -1

    def _streamed_step(self):
        """The streamed data plane: embed, the layer groups as their
        windows arrive (the worker fills group l+1's window while group l's
        launched compute runs), finish. Returns what ``_step_impl``
        returns."""
        cfg, gs = self.cfg, self.stream_cfg.group_size
        t = time.perf_counter()
        self._load_inputs()
        d, state = self._dev_in, self._state()
        tokens, q_lens, admitted, block_tables = (
            d["tokens"], d["q_lens"], d["admitted"], d["block_tables"])
        bitmap = state["bitmap"] if self.kv_aware else None
        # speculative: the verify lanes share the groups' pass, one window
        # rotation a step whatever the slots accept
        x, positions, ctx_lens, q_lens, fin = _embed_step(
            cfg, self._dram_params, state["lengths"], tokens, q_lens,
            self._spec_inputs())
        t = self._phase("embed", t)
        ks, vs = [], []
        # closed explicitly: a group whose compute raises leaves the
        # generator at its yield, and only closing it retires the held
        # window (its pool slots) and stops the worker before a retry
        # starts a new stream
        it = self.streamer.stream()
        try:
            for g, win in it:
                t = self._phase("stream_wait", t)
                self.wpool.wait_ready(win["ready"])  # its pages are in
                x, k_g, v_g = _stream_group_impl(
                    cfg, bitmap, self._win_shapes, self._layers, win,
                    self.wpool.buffer, state["k"], state["v"], x, positions,
                    ctx_lens, block_tables, g * gs, gs, self.mesh)
                ks += k_g
                vs += v_g
                t = self._phase("group_dispatch", t)
        finally:
            it.close()
        out = _finish_step(cfg, self.sched_cfg, self.sample_cfg,
                           self.kv_aware, self._dram_params["final_norm"],
                           self._lm_head, state, x, torch.stack(ks),
                           torch.stack(vs), q_lens, admitted, positions,
                           block_tables, self._generator, spec=fin)
        self._phase("finish", t)
        return out

    def _streamed_step_moe(self):
        """The expert-paged MoE data plane: per layer, the attention +
        router half runs on the device, the top-k expert ids come to the
        host (``idx.cpu()``: the step's per-layer sync, a few hundred
        bytes), the routed experts are gathered from the ExpertCache (a
        miss is a misroute stall) and the expert half reads them through
        the slab. Layer l's expert half is chained with layer l+1's
        attention + router (``_moe_fused_impl``); the embed rides layer 0's
        (``_moe_head_impl``), the finish the last layer's experts
        (``_moe_tail_impl``). While layer l computes, the prefetch worker
        reads the predictor's picks for layer l+1 (wrapping to layer 0 for
        the next step). Returns what ``_step_impl`` returns."""
        cfg, cache = self.cfg, self.expert_cache
        t = time.perf_counter()
        self._load_inputs()
        d, state = self._dev_in, self._state()
        tokens, admitted, block_tables = (d["tokens"], d["admitted"],
                                          d["block_tables"])
        x, h, gates, idx, k_l, v_l, positions, ctx_lens, q_lens, fin = \
            _moe_head_impl(cfg, self._dram_params,
                           (self._layers[0], state["k"][0], state["v"][0]),
                           state["lengths"], tokens, d["q_lens"],
                           block_tables, self._spec_inputs())
        lane_bound = self._host_q_lens
        if self.spec_cfg is not None:
            # verify lanes grow q_lens on the device (by n_draft <=
            # draft_cap): the routed-expert filter takes the superset bound,
            # so a draft lane's routing is never dropped from the slab
            lane_bound = self._host_q_lens + self._host_draft_cap
        # whole-step prefetch lead: the per-layer request below gives the
        # worker one layer's compute to land its fetches; the per-slot
        # histories already know each layer's likely experts, so every
        # layer's predictions are queued up front (one batched transfer)
        active = [s for s in range(len(lane_bound)) if lane_bound[s] > 0]
        if self._steps_done > 0:
            for li in range(cfg.n_layers):
                self._request_prefetch(li, self._e_slab, slots=active)
        t = self._phase("head_dispatch", t)
        ks, vs = [k_l], [v_l]
        out = None
        for li in range(cfg.n_layers):
            idx_host = idx.cpu().numpy()             # layer li's routing
            t = self._phase("route_sync", t)
            by_slot = sched.routed_experts_by_slot(idx_host, lane_bound)
            routed = sched.routed_experts(idx_host, lane_bound)
            cache.observe(li, routed)
            for s, ids in by_slot.items():
                cache.observe_slot(s, li, ids)
            self._max_routed_seen = max(self._max_routed_seen, len(routed))
            self._request_prefetch((li + 1) % cfg.n_layers, len(routed),
                                   slots=by_slot.keys())
            t = time.perf_counter()
            slab, slab_map, held, transients, missing = \
                self._acquire_experts(li, routed)
            t = self._phase("expert_acquire", t)
            for s, ids in by_slot.items():
                cache.note_slot_route(s, len(ids),
                                      sum(1 for e in ids
                                          if int(e) in missing))
            if li + 1 < cfg.n_layers:
                # layer li's experts chained with layer li+1's attn+router
                x, h, gates, idx, k_l, v_l = _moe_fused_impl(
                    cfg, self._expert_kn,
                    (self._layers[li + 1], state["k"][li + 1],
                     state["v"][li + 1]),
                    x, h, gates, idx, slab, slab_map, self.wpool.buffer,
                    positions, ctx_lens, block_tables, self.mesh)
                ks.append(k_l)
                vs.append(v_l)
                t = self._phase("fused_dispatch", t)
            else:          # the last layer's experts with the finish
                out = _moe_tail_impl(
                    cfg, self.sched_cfg, self.sample_cfg, self.kv_aware,
                    self._expert_kn, self._dram_params["final_norm"],
                    self._lm_head, state, x, h, gates, idx, slab, slab_map,
                    self.wpool.buffer, torch.stack(ks), torch.stack(vs),
                    q_lens, admitted, positions, block_tables,
                    self._generator, spec=fin, mesh=self.mesh)
                t = self._phase("tail_dispatch", t)
            # the launches that read the slab are enqueued: the held
            # entries can go, and freeing the transients records the event
            # the next upload into their pages waits on
            for hk in held:
                cache.release(hk)
            for slots in transients:
                self.wpool.free(slots)
        return out

    def _request_prefetch(self, layer: int, breadth: int, slots=None):
        """Enqueue predicted experts for ``layer``, gated by the cache's
        score-aware admission (``would_admit``), so a speculative fetch
        never reads pages the cache would reject at once. ``slots`` (the
        active decode slots) switches the predictor to the per-slot
        histories (max-combined)."""
        cache = self.expert_cache
        want = breadth + self.stream_cfg.prefetch_experts_margin
        picks = [(layer, e) for e in cache.predict(layer, want, slots=slots)
                 if cache.would_admit((layer, e),
                                      self._expert_nbytes[layer][e])]
        if picks:
            self.prefetcher.request(picks)

    def _maybe_retune_expert_budget(self):
        """Misroute-stall-aware expert budget re-split
        (``StreamConfig.auto_expert_budget``): once, after the first
        measured steps, if routed experts stalled, return the slab's unused
        rows (e_slab against the largest routed set seen) to the expert
        cache's capacity. The slab's size is fixed at init, so the unused
        reservation is headroom the cache can spend on residency."""
        sc = self.stream_cfg
        if (not self.streamed_moe or not sc.auto_expert_budget
                or self._auto_expert_done
                or self._steps_done < sc.auto_depth_after):
            return
        self._auto_expert_done = True
        cache = self.expert_cache
        if (cache.misroute_stalls == 0 or cache.capacity is None
                or self._max_routed_seen >= self._e_slab):
            return
        unused = self._e_slab - max(self._max_routed_seen, 1)
        cache.resize(cache.capacity + unused * self._max_expert_bytes)

    def _phase(self, name: str, t0: float, now: float | None = None) -> float:
        """Accumulate one step-phase interval (ObsPlane): seconds since
        ``t0`` land in this step's phase breakdown and, when tracing is
        on, as a span on the compute track. Returns now, so boundaries
        chain: ``t = self._phase("embed", t)``."""
        if now is None:
            now = time.perf_counter()
        self._phases[name] = self._phases.get(name, 0.0) + (now - t0)
        tracer = obs.default_tracer()
        if tracer.enabled:
            tracer.complete(name, t0, now - t0, tid=obs.TID_COMPUTE,
                            cat="step")
        return now

    def _stream_stall_s(self) -> float:
        """Seconds the compute path has spent blocked on the weight stream:
        the window-queue stall (dense groups) or the cumulative misroute
        stall (MoE expert paging)."""
        if not self.streamed:
            return 0.0
        if self.streamed_moe:
            return self.expert_cache.misroute_stall_s
        return self.streamer.stall_s

    def _maybe_autotune_depth(self):
        """Overlap-depth auto-tuning (``StreamConfig.auto_depth``): once,
        after the first measured steps, re-pick ``prefetch_depth`` from the
        observed stall/stream ratio, and re-split the device budget between
        the window and the cache (never below the pinned floor)."""
        sc = self.stream_cfg
        if (self.streamer is None or not sc.auto_depth
                or self._auto_depth_done
                or self._steps_done < sc.auto_depth_after):
            return
        self._auto_depth_done = True
        st = self.streamer
        if st.stream_s <= 0:
            return                       # nothing streamed: no signal
        ratio = st.stall_s / st.stream_s
        depth = st.prefetch_depth
        want = depth
        if ratio > 0.10:
            want = depth + max(1, round(depth * min(ratio, 1.0)))
        elif ratio < 0.02 and depth > 1:
            want = depth - 1
        if sc.device_budget_bytes is not None:
            afford = int(sc.device_budget_bytes - self.cache.pinned_bytes) \
                // max(self._group_bytes, 1)
            want = min(want, max(afford, 1))
        want = max(1, int(want))
        if want == depth:
            return
        st.prefetch_depth = want
        if sc.device_budget_bytes is not None and not sc.pin_all:
            # a deeper window reclaims its bytes from the cache now
            self.cache.resize(max(
                self.cache.pinned_bytes,
                sc.device_budget_bytes - want * self._group_bytes))

    def stream_stats(self, *, strict: bool = True) -> dict:
        """Streamer + residency-cache + page-store + pool counters:
        stall/stream seconds, streamed bytes, cache hits/misses, per-plane
        page reads and the NAND seconds they imply, the fault plane's
        counters, pool uploads and the host-to-device copy time. Page
        counters cover serving only. ``strict=False`` returns ``{}`` on a
        resident engine."""
        if not self.streamed:
            if not strict:
                return {}
            raise ValueError("stream_stats: engine is not in streamed mode")
        if self.streamed_moe:
            out = {**self.expert_stats(), **self.store.stats()}
        else:
            out = {**self.streamer.stats(), **self.store.stats(),
                   **self.wpool.stats(),
                   "pool_reserve_bytes":
                       self._pool_reserve_pages * self.store.page_bytes,
                   "prefetch_depth": self.streamer.prefetch_depth}
        if self.spec_cfg is not None:
            out.update(self.spec_stats())
        return out

    def spec_stats(self, *, strict: bool = True) -> dict:
        """Speculative-decode telemetry: how much one weight pass
        amortizes. ``spec_tokens_per_step`` is emitted tokens per VERIFY
        step (a step with >= 1 decoding slot) — streamed, tokens per window
        rotation; ``spec_acceptance_rate`` is accepted / drafted.
        ``strict=False`` returns ``{}`` on a non-speculative engine."""
        if self.spec_cfg is None:
            if not strict:
                return {}
            raise ValueError("spec_stats: engine is not in speculative mode")
        t = self._spec_totals
        out = {"spec_verify_steps": t["verify_steps"],
               "spec_drafted": t["drafted"],
               "spec_accepted": t["accepted"],
               "spec_emitted": t["emitted"],
               "spec_acceptance_rate": t["accepted"] / max(t["drafted"], 1),
               "spec_tokens_per_step": t["emitted"]
               / max(t["verify_steps"], 1)}
        if self.spec_cfg.adaptive_k:
            k = self.spec_cfg.k
            out["spec_accept_ema"] = [float(v) for v in self._accept_ema]
            out["spec_adaptive_k"] = [max(1, int(round(float(v) * k)))
                                      for v in self._accept_ema]
        return out

    def expert_stats(self, *, strict: bool = True) -> dict:
        """ExpertCache telemetry of the expert-paged MoE engine: hit rate
        over routed-expert acquires, fetched bytes (prefetch included) and
        bytes per token against what streaming every expert of every layer
        each step would fetch, misroute stalls, per-slot hit rates, the
        prefetcher's and the pool's counters. ``strict=False`` returns
        ``{}`` when the engine is not serving a store-backed MoE model (a
        resident MoE engine included); ``strict=True`` raises."""
        if not self.streamed_moe:
            if not strict:
                return {}
            raise ValueError("expert_stats: engine is not serving a "
                             "store-backed MoE model")
        c = self.expert_cache.stats()
        toks = sum(s["prefill_tokens"] + s["decode_tokens"]
                   for s in self.stats)
        bank_total = sum(sum(r) for r in self._expert_nbytes)
        return {
            "expert_hits": c["hits"], "expert_misses": c["misses"],
            "expert_hit_rate": c["hits"] / max(c["hits"] + c["misses"], 1),
            "expert_bytes_fetched": c["bytes_fetched"],
            "expert_fetches": c["fetches"],
            "expert_prefetches": c["prefetches"],
            "expert_prefetched_bytes": c["prefetched_bytes"],
            "misroute_stalls": c["misroute_stalls"],
            "misroute_stall_s": c["misroute_stall_s"],
            "expert_cache_entries": c["entries"],
            "expert_cache_bytes": c["bytes_used"],
            "expert_slab": self._e_slab,
            "steps": self._steps_done, "tokens": toks,
            "expert_bytes_per_token": c["bytes_fetched"] / max(toks, 1),
            "all_experts_bytes_per_token":
                self._steps_done * bank_total / max(toks, 1),
            "slot_hit_rates": c.get("slot_hit_rates", []),
            "max_routed_seen": self._max_routed_seen,
            "expert_budget_retuned": self._auto_expert_done,
            "pool_reserve_bytes":
                self._pool_reserve_pages * self.store.page_bytes,
            **self.prefetcher.stats(),
            **self.wpool.stats(),
        }

    def prefix_stats(self, *, strict: bool = True) -> dict:
        """Prefix-cache telemetry: index entries/hits/misses/evictions
        plus the prefill tokens admission skipped through cache hits.
        ``strict=False`` returns ``{}`` when prefix caching is off."""
        if self.prefix is None:
            if not strict:
                return {}
            raise ValueError("prefix_stats: prefix caching is disabled "
                             "(construct with prefix_cache=True)")
        return {**self.prefix.stats(),
                "prefix_prefill_tokens_saved": self._prefix_tokens_saved}

    def telemetry(self) -> dict:
        """Every applicable ``*_stats`` family merged, wrong-mode families
        absent (``strict=False`` everywhere). The streamed families read
        under the streamer/pool locks, so the serving front refreshes its
        copy from its loop thread, not per HTTP request."""
        out = {"steps": self._steps_done,
               "free_kv_blocks": int(self.pool.n_free_blocks),
               "active_slots": len(self.pool.active),
               "waiting": len(self.waiting)}
        out.update(self.stream_stats(strict=False))
        out.update(self.spec_stats(strict=False))
        out.update(self.prefix_stats(strict=False))
        return out

    def obs_samples(self):
        """ObsPlane scrape samples for the engine and every subsystem it
        owns (lock-free counter reads: safe from a scrape thread while a
        step holds the streamer/pool locks)."""
        yield obs.Sample("engine_steps_total", "counter",
                         float(self._steps_done))
        yield obs.Sample("engine_free_kv_blocks", "gauge",
                         float(self.pool.n_free_blocks))
        yield obs.Sample("engine_active_slots", "gauge",
                         float(len(self.pool.active)))
        yield obs.Sample("engine_waiting_requests", "gauge",
                         float(len(self.waiting)))
        if self.streamed:
            yield obs.Sample("engine_stall_frac", "gauge",
                             float(self._stall_frac))
            yield from self.store.obs_samples()
            yield from self.wpool.obs_samples()
            if self.streamed_moe:
                yield from self.expert_cache.obs_samples()
                yield from self.prefetcher.obs_samples()
            else:
                yield from self.streamer.obs_samples()
        if self.spec_cfg is not None:
            yield from spec_mod.spec_obs_samples(self._spec_totals)
        if self.prefix is not None:
            yield from self.prefix.obs_samples()

    # --- request management (control plane) ---------------------------------

    def submit(self, prompt: list[int], max_new: int = 16,
               timeout: float | None = None) -> int:
        """Enqueue a request and return its id. Admission happens when
        capacity frees up. With ``max_waiting`` set, a full waiting queue
        BLOCKS the caller until space frees, ``timeout`` expires
        (TimeoutError) or the engine closes (RuntimeError)."""
        if not prompt:
            raise ValueError("empty prompt (a request needs >= 1 token)")
        if max_new < 1:
            raise ValueError("max_new must be >= 1 (every request samples "
                             "at least the token after its prompt)")
        with self._cv:
            if self._closed:
                raise RuntimeError("submit: engine is closed")
            if self.max_waiting is not None:
                deadline = None if timeout is None \
                    else time.monotonic() + timeout
                while len(self.waiting) >= self.max_waiting \
                        and not self._closed:
                    remaining = None
                    if deadline is not None:
                        remaining = deadline - time.monotonic()
                        if remaining <= 0:
                            raise TimeoutError(
                                "submit: waiting queue full "
                                f"(max_waiting={self.max_waiting})")
                    self._cv.wait(remaining)
                if self._closed:
                    raise RuntimeError("submit: engine is closed")
            rid = self._next_rid
            req = Request(rid, list(prompt), max_new)
            if req.kv_rows > self._kv_cap:
                raise ValueError(f"request needs {req.kv_rows} KV rows > "
                                 f"max_seq={self._kv_cap}")
            self._next_rid += 1
            self.requests[rid] = req
            self.waiting.append(req)
            self._admit()
            return rid

    def cancel(self, rid: int) -> bool:
        """Cancel a waiting or running request. Lock-free: flips flags
        only; the slot and its KV blocks come back within one ``step``.
        Returns False if the request is unknown or already done."""
        req = self.requests.get(rid)
        if req is None or req.done:
            return False
        req.cancelled = True
        req.done = True
        return True

    def forget(self, rid: int) -> bool:
        """Drop a finished request's bookkeeping. Returns False while the
        request is live or its slot has not been swept yet."""
        with self._mu:
            req = self.requests.get(rid)
            if req is None or not req.done:
                return False
            if req.slot is not None \
                    and self.pool.active.get(req.slot) == rid:
                return False             # cancelled mid-step; not yet swept
            if req in self.waiting:
                self.waiting.remove(req)
            del self.requests[rid]
            return True

    def _admit(self):
        """waiting -> running, FCFS: claim a slot and reserve the request's
        worst-case block count. With prefix caching on, admission first
        adopts the longest cached prefix copy-free (ref bump on the shared
        blocks; only the tail is reserved and prefilled), evicting cold
        fully-released chains when the tail reservation falls short."""
        while self.waiting:
            req = self.waiting[0]
            if req.done:                 # cancelled while waiting
                self.waiting.popleft()
                self._cv.notify_all()
                continue
            shared, hashes = (), None
            if self.prefix is not None:
                bs = self.pool.block_size
                # cap: >= 1 prompt token always prefills — every request
                # samples from its own last prompt lane
                hashes = block_hashes(req.prompt, bs,
                                      limit=(len(req.prompt) - 1) // bs)
                shared = self.prefix.lookup(hashes)
            slot = self.pool.alloc(req.rid, req.kv_rows,
                                   shared_blocks=shared)
            if slot is None and self.prefix is not None \
                    and self.pool.free_slots:
                need = self.pool.blocks_for(req.kv_rows) - len(shared)
                short = need - self.pool.n_free_blocks
                if short > 0 and self.prefix.evict(short) > 0:
                    # eviction may have reclaimed part of the hit chain
                    # itself (LRU does not pin this lookup): re-resolve
                    shared = self.prefix.lookup(hashes)
                    slot = self.pool.alloc(req.rid, req.kv_rows,
                                           shared_blocks=shared)
            if slot is None:
                break
            req.slot = slot
            if shared:
                req.cached_len = len(shared) * self.pool.block_size
                req.pos = req.cached_len
                self._prefix_tokens_saved += req.cached_len
            if self.spec_cfg is not None:
                # a recycled slot must not inherit the previous request's
                # acceptance history; start optimistic (full draft depth)
                self._accept_ema[slot] = 1.0
            self.waiting.popleft()
            self._cv.notify_all()

    def _sweep_cancelled(self):
        """Reclaim cancelled requests' resources at the top of every step.
        No prefix retain: a cancelled stream was never fully served, so
        its blocks are not certified shareable."""
        for slot, rid in list(self.pool.active.items()):
            req = self.requests[rid]
            if req.done and req.cancelled:
                self.pool.release(slot)
        if any(r.done for r in self.waiting):
            self.waiting = collections.deque(
                r for r in self.waiting if not r.done)
            self._cv.notify_all()

    def _finish_request(self, req: Request, slot: int):
        """Completion: retain the request's full prompt blocks in the
        prefix index (ref bump BEFORE the slot's release drops its own
        refs), then release the slot."""
        if self.prefix is not None:
            hashes = block_hashes(req.prompt, self.pool.block_size)
            if hashes:
                blocks = [int(b) for b in
                          self.pool.block_tables[slot, :len(hashes)]]
                self.prefix.insert(hashes, blocks)
        self.pool.release(slot)          # O(1): no device work

    # --- the serving step ---------------------------------------------------

    def _draft_cap(self, req: Request) -> int:
        """Verify lanes this decoding request can use: bounded by spec k
        (per slot with ``adaptive_k``: scaled by the slot's acceptance EMA,
        keeping one probe lane), by the tokens it still owes (capping by
        ``remaining - 1`` keeps every speculative KV write inside the
        admission reservation), by the pool/table row cap, and by the chunk
        width."""
        k_want = self.spec_cfg.k
        if self.spec_cfg.adaptive_k:
            k_want = max(1, int(round(self._accept_ema[req.slot] * k_want)))
        remaining = req.max_new - len(req.out)
        room = self._kv_cap - int(self.pool.lengths[req.slot]) - 1
        return max(0, min(k_want, remaining - 1, room,
                          self.admission_cfg.chunk_tokens - 1))

    def step(self) -> int:
        """One continuous-batching step over all running slots: decoding
        slots advance one token (speculative: ``n_accept + 1`` tokens
        through one pass), prefilling slots consume a prompt chunk under the
        token budget. Returns tokens processed. Thread-safe; cancelled
        requests are swept first."""
        with self._cv:
            self._sweep_cancelled()
            n = self._step_locked()
            self._cv.notify_all()
            return n

    def _step_locked(self) -> int:
        t_plan0 = time.perf_counter()
        self._phases = {}                # this step's ObsPlane breakdown
        self._admit()
        spec = self.spec_cfg is not None
        decode_slots, prefill_slots = [], []
        # ARRIVAL order (rid), not slot order: plan_chunks funds prefill
        # FCFS as given.
        for slot, rid in sorted(self.pool.active.items(), key=lambda kv: kv[1]):
            req = self.requests[rid]
            if req.done:
                continue
            if req.prefilling:
                prefill_slots.append((slot, len(req.prompt) - req.pos))
            elif spec:
                decode_slots.append((slot, 1 + self._draft_cap(req)))
            else:
                decode_slots.append(slot)
        budget = sched.step_token_budget(self.admission_cfg, self._npu_frac,
                                         self._stall_frac)
        # snapshot AFTER list-building: a lock-free cancel() landing since
        # the filter above must not be granted lanes or budget.
        cancelled = {slot for slot, rid in self.pool.active.items()
                     if self.requests[rid].done}
        plan = sched.plan_chunks(decode_slots, prefill_slots, budget,
                                 self.admission_cfg.chunk_tokens,
                                 cancelled=cancelled)
        if not plan:
            return 0
        # the step's inputs, in the pinned host arrays (numpy views)
        tokens, q_lens, admitted, tables = (
            self._host_in[k].numpy()
            for k in ("tokens", "q_lens", "admitted", "block_tables"))
        tokens.fill(0)
        q_lens.fill(0)
        admitted.fill(False)
        for slot, _ in prefill_slots:
            admitted[slot] = True
        admitted[[s if isinstance(s, int) else s[0]
                  for s in decode_slots]] = True
        if spec:
            draft_cap = self._host_in["draft_cap"].numpy()
            is_decode = self._host_in["is_decode"].numpy()
            draft_cap.fill(0)
            is_decode.fill(False)
        for slot, cnt in plan.items():
            req = self.requests[self.pool.active[slot]]
            if req.prefilling:
                chunk = req.prompt[req.pos:req.pos + cnt]
                tokens[slot, :len(chunk)] = chunk
                q_lens[slot] = len(chunk)
            else:
                tokens[slot, 0] = req.out[-1]
                q_lens[slot] = 1          # + n_draft lanes added in the step
                if spec:
                    is_decode[slot] = True
                    draft_cap[slot] = cnt - 1   # budget-clamped verify lanes
                    seq = req.prompt + req.out
                    hl = min(len(seq), self._hist.shape[1])
                    self._hist[slot, :hl] = seq[-hl:]
                    self._hist_lens[slot] = hl
            # map physical blocks for this step's writes, draft lanes
            # included (draws on the admission reservation: cannot fail)
            self.pool.ensure(slot, int(self.pool.lengths[slot]) + cnt)
        np.copyto(tables, self.pool.block_tables)
        if self.streamed_moe:
            # host lane bounds for the routed-expert filter (verify lanes
            # are added on the device; the filter uses q_lens + draft_cap)
            self._host_q_lens = q_lens.copy()
            self._host_draft_cap = draft_cap.copy() if spec else None
        t_step0 = self._phase("plan", t_plan0)
        stall0 = self._stream_stall_s()
        ctx = (torch.cuda.stream(self._stream) if self._stream is not None
               else contextlib.nullcontext())
        with torch.no_grad(), ctx:
            if self.streamed:
                out = (self._streamed_step_moe() if self.streamed_moe
                       else self._streamed_step())
                t_sync0 = time.perf_counter()
            else:
                out = self._run_resident()
                # the resident plane is one dispatch (the streamed one
                # timed its embed / groups / finish itself)
                t_sync0 = self._phase("dispatch", t_step0)
            if spec:
                toks, n_emit, logits, self.last_lane_logits, stats = out
                parts = [toks.reshape(-1), n_emit, stats]
            else:
                toks, logits, stats = out
                parts = [toks, stats]
            self.last_logits = logits
            # the step's one device->host read: tokens (exact in f32) and
            # stat scalars, packed
            host = torch.cat([t.float() for t in parts]).cpu().numpy()
        n, n_tok = self.pool.n_slots, toks.numel()
        toks_host = host[:n_tok].astype(np.int64).reshape(toks.shape)
        if spec:
            n_emit_host = host[n_tok:n_tok + n].astype(np.int64)
            st = host[n_tok + n:].tolist()
        else:
            st = host[n_tok:].tolist()
        n_processed = n_prefill = 0
        for slot in plan:
            req = self.requests[self.pool.active[slot]]
            cnt = int(q_lens[slot])
            if req.prefilling:
                n_processed += cnt
                n_prefill += cnt
                self.pool.bump(slot, cnt)
                req.pos += cnt
                if not req.prefilling:
                    # a just-completed prefill sampled at its last lane
                    req.out.append(int(toks_host[slot, 0] if spec
                                       else toks_host[slot]))
            elif spec:
                # verify step: n_accept + 1 tokens; the pool length REWINDS
                # to the accepted rows (host mirror here; the step advanced
                # the device lengths by the same count)
                ne = int(n_emit_host[slot])
                new_len = int(self.pool.lengths[slot]) + ne
                take = min(ne, req.max_new - len(req.out))
                req.out.extend(int(t) for t in toks_host[slot, :take])
                self.pool.rewind(slot, new_len)
                n_processed += ne
            else:
                self.pool.bump(slot, cnt)
                req.out.append(int(toks_host[slot]))
                n_processed += cnt
            if req.cancelled:
                # cancel() landed mid-step: reclaim now
                self.pool.release(slot)
            elif not req.prefilling and len(req.out) >= req.max_new:
                req.done = True
                self._finish_request(req, slot)
        self._phase("sync", t_sync0)
        self._npu_frac = float(st[2])
        entry = {
            "kv_len": int(st[0]),
            "delta_cycles": int(st[1]),
            "npu_fraction": self._npu_frac,
            "prefill_tokens": n_prefill,
            "decode_tokens": n_processed - n_prefill,
        }
        if spec:
            entry["spec_drafted"] = int(st[3])
            entry["spec_accepted"] = int(st[4])
            if bool(is_decode.any()):
                t = self._spec_totals
                t["verify_steps"] += 1
                t["drafted"] += int(st[3])
                t["accepted"] += int(st[4])
                t["emitted"] += int(st[5])
                if self.spec_cfg.adaptive_k:
                    nd = np.asarray(st[6:6 + n])
                    na = np.asarray(st[6 + n:6 + 2 * n])
                    a = self.spec_cfg.ema_alpha
                    for slot in np.nonzero(is_decode & (nd > 0))[0]:
                        rate = float(na[slot]) / float(nd[slot])
                        self._accept_ema[slot] = \
                            (1.0 - a) * self._accept_ema[slot] + a * rate
        stall_s = 0.0
        if self.streamed:
            # stall fraction of step wall time (EMA): the residency signal
            # the token budget contracts with (scheduler.step_token_budget)
            dt = time.perf_counter() - t_step0
            stall_s = max(self._stream_stall_s() - stall0, 0.0)
            frac = min(max(stall_s / max(dt, 1e-9), 0.0), 1.0)
            self._stall_frac = 0.5 * self._stall_frac + 0.5 * frac
            entry["stall_frac"] = self._stall_frac
        for name, dt_p in self._phases.items():
            self._h_step.observe(dt_p, labels={"phase": name})
        self._h_step.observe(time.perf_counter() - t_plan0,
                             labels={"phase": "total"})
        if n_prefill:
            self._c_step_tokens.inc(n_prefill, labels={"kind": "prefill"})
        if n_processed - n_prefill:
            self._c_step_tokens.inc(n_processed - n_prefill,
                                    labels={"kind": "decode"})
        self.timeline.record(self._steps_done, self._phases,
                             tokens=n_processed, stall_s=stall_s)
        self.stats.append(entry)
        self._steps_done += 1
        if self.streamed:
            self._maybe_autotune_depth()
            self._maybe_retune_expert_budget()
        self._admit()                    # freed slots host waiting requests
        return n_processed

    def close(self):
        """Mark the engine closed, waking every ``submit`` blocked on
        backpressure, and stop the MoE expert prefetcher's worker (its
        fetch closure holds this engine). Idempotent and thread-safe; a
        close racing a step waits for it (``_cv``)."""
        with self._close_lock:
            if self._close_done:
                return
            self._close_done = True
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        p = getattr(self, "prefetcher", None)
        if p is not None:
            p.stop()

    def run(self, max_steps: int = 1000) -> dict[int, list[int]]:
        for _ in range(max_steps):
            if self.step() == 0:
                break
        return {r.rid: r.out for r in self.requests.values()}
