"""NVLLM serving engine, resident dense plane — the port of the slice's part
of ``repro/serving/engine.py``: the paper's end-to-end dataflow (§3.5) at
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
    streamer's stall fraction contracts the step token budget.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
import time

import numpy as np
import torch

from repro_torch import graphs
from repro_torch.core import scheduler as sched
from repro_torch.core.erdpe import flash_matmul
from repro_torch.core.tiering import (ATTN_FLASH_KEYS, PagedWeight, deploy,
                                      encode_flash, program_attn_flash)
from repro_torch.models import common as cm
from repro_torch.models import dense
from repro_torch.serving.kvcache import PagedKVPool
from repro_torch.serving.sampler import SampleConfig, last_valid_hidden, sample
from repro_torch.store.page_pool import WeightPagePool
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


def _chunk_layer(cfg, bitmap, lengths, positions, block_tables, x, layer):
    """One mixed-batch layer over all slots' chunk lanes. ``layer`` =
    (params slice, flash attn copy slice, read-only paged K/V pool slices).
    The pool is not written here: the chunk's own K/V enters through the
    intra-chunk term, and the step writes all layers' rows afterwards."""
    lp, fl, kc, vc = layer
    ap = lp["attn"]
    b, t, _ = x.shape
    q, k, v = _qkv(cfg, lp, fl, x, positions, bitmap)
    attn = cm.chunk_attention_paged(q, kc, vc, block_tables, lengths, k, v,
                                    window=cfg.local_window)
    out = _proj(attn.reshape(b, t, -1), ap["wo"], fl["wo"], bitmap)
    x = x + out
    x = x + dense._ffn_apply(cfg, lp["ffn"], dense._norm(cfg, x, lp, "ln2"))
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
                 block_tables, generator):
    """Everything after the layer stack: final norm, last-lane lm_head and
    sampling, ONE paged KV write per pool, Algorithm 2. Writes the state IN
    PLACE (the pools, lengths, bitmap and prev_cycles keep their tensors,
    so a captured step replays over them). Returns (tokens (slots,) int32,
    logits (slots, V) f32, stats (3,) f32: kv_len, delta_cycles,
    npu_fraction)."""
    lengths = state["lengths"]
    if cfg.norm_type == "rms":
        x = cm.rms_norm(x, final_norm)
    else:
        x = cm.layer_norm(x, final_norm["g"], final_norm["b"])
    # lm_head only at each slot's last valid lane
    x_last = last_valid_hidden(x, q_lens)
    logits = flash_matmul(x_last, lm_head, out_dtype=torch.float32)
    toks = sample(logits, generator, sample_cfg)

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
    new_lengths = lengths + q_lens

    # --- Algorithm 2: KV-cache-aware rebalance ------------------------------
    # admitted (not only worked) slots: a budget-starved prefill slot's
    # cached KV still sets the attention picture Algorithm 2 reacts to.
    kv_len = torch.where(admitted, new_lengths, 0).max()
    new_bitmap, new_prev, delta = sched.kv_aware_step(
        state["bitmap"], state["prev_cycles"], kv_len, cfg.d_model,
        cfg.n_kv_heads, cfg.head_dim, sched_cfg, kv_aware)
    lengths.copy_(new_lengths)
    state["bitmap"].copy_(new_bitmap)
    state["prev_cycles"].copy_(new_prev)
    stats = torch.stack([kv_len.float(), delta.float(),
                         sched.npu_fraction(new_bitmap)])
    return toks, logits, stats


def _step_impl(cfg, sched_cfg, sample_cfg, kv_aware, params, layers,
               attn_flash, state, tokens, q_lens, admitted, block_tables,
               generator):
    """One mixed prefill/decode step for ALL pool slots — the data plane.

    state  : {"k","v": (L, n_blocks, block_size, KV, Dh), "lengths":
              (slots,) i32, "bitmap": (H,) i32, "prev_cycles": i32}, all
              written in place.
    layers : per-layer param dicts (views of the stacked params);
    attn_flash : per-layer {"wq", "wo"} FlashWeights.
    tokens : (slots, T) i32 chunk lanes; q_lens (slots,) valid lanes;
    admitted (slots,) bool; block_tables (slots, max_blocks) i32.
    Returns (sampled (slots,) i32, logits (slots, V) f32, stats (3,) f32).
    An IDLE batch (every q_lens 0, every admitted False) writes only the
    dump block 0 and leaves lengths and bitmap as they are; Algorithm 2
    sees kv_len 0, so under ``kv_aware`` prev_cycles stays too (without
    it prev_cycles always takes the step's cycles, here 0).
    """
    bitmap = state["bitmap"] if kv_aware else None
    x, positions, ctx_lens = _embed_chunk(cfg, params, state["lengths"],
                                          tokens, q_lens)
    ks, vs = [], []
    for li in range(cfg.n_layers):          # the layer loop (no scan)
        x, (kl, vl) = _chunk_layer(
            cfg, bitmap, ctx_lens, positions, block_tables, x,
            (layers[li], attn_flash[li], state["k"][li], state["v"][li]))
        ks.append(kl)
        vs.append(vl)
    return _finish_step(cfg, sched_cfg, sample_cfg, kv_aware,
                        params["final_norm"], params["lm_head"], state, x,
                        torch.stack(ks), torch.stack(vs), q_lens, admitted,
                        positions, block_tables, generator)


def _paged(pool_buf, tbl, kn):
    """Bind one page-table dict (its device tables) to the pool tensor as a
    PagedWeight — the flash weight the ERDPE consumes in place."""
    q_tbl, p_slots, s_slots = tbl["dev"]
    return PagedWeight(pool=pool_buf, q_tbl=q_tbl, p_slots=p_slots,
                       s_slots=s_slots, kn=tuple(kn))


def _stream_group_impl(cfg, bitmap, shapes, layers_dram, window, pool_buf,
                       k_pool, v_pool, x, positions, ctx_lens, block_tables,
                       lo, group_size):
    """One STREAMED layer group: the resident step's per-layer math, with
    the group's flash weights grafted into each layer's DRAM params as
    PagedWeights over ``pool_buf``. Returns (x, [k per layer], [v per
    layer])."""
    ks, vs = [], []
    for i in range(group_size):
        li = lo + i
        lp = dict(layers_dram[li])
        lp["ffn"] = {**lp.get("ffn", {}),
                     **{k: _paged(pool_buf, t[i], shapes["ffn"][k])
                        for k, t in window["ffn"].items()}}
        fl = {k: _paged(pool_buf, t[i], shapes["attn"][k])
              for k, t in window["attn"].items()}
        x, (kl, vl) = _chunk_layer(cfg, bitmap, ctx_lens, positions,
                                   block_tables, x,
                                   (lp, fl, k_pool[li], v_pool[li]))
        ks.append(kl)
        vs.append(vl)
    return x, ks, vs


def _map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    return fn(tree)


_layer_slice = dense.layer_slice


class Engine:
    """Resident dense serving engine over a ``dense``-family ArchConfig.

    ``params`` is a raw param tree (``models.dense.init`` or params carried
    across with ``interop``); it is moved to ``device`` and deployed there
    (flash tier with ``rber``/``seed``). ``block_size``/``n_blocks`` size
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

    ``weight_store`` (a ``store.PageStore``) serves the streamed plane:
    the flash tier is programmed into the store (or, if the store already
    holds a page table — a die image — taken from it, and ``params`` is the
    DRAM tier) and streamed onto the device under ``stream_cfg``
    (``store.StreamConfig``). The streamed step always runs eagerly
    (``step_traces`` -1): each layer group binds another window's page
    tables, so one graph cannot serve every group. Its DRAM weights stay
    bf16, within its device budget. On the card every kernel of a step
    runs on the stream current at construction.
    """

    def __init__(self, cfg, params, max_slots: int = 4, max_seq: int = 256,
                 sample_cfg: SampleConfig = SampleConfig(),
                 sched_cfg: sched.SchedulerConfig | None = None,
                 kv_aware: bool = True, rber: float = 0.0, seed: int = 0,
                 block_size: int = 16, n_blocks: int | None = None,
                 admission_cfg: sched.AdmissionConfig | None = None,
                 max_waiting: int | None = None, weight_store=None,
                 stream_cfg: StreamConfig | None = None, device="cuda",
                 compiled: bool = True):
        if cfg.family != "dense":
            raise ValueError(f"engine serves dense-family archs (got "
                             f"{cfg.family!r})")
        self.cfg = cfg
        self.device = torch.device(device)
        self._stream = (torch.cuda.current_stream(self.device)
                        if self.device.type == "cuda" else None)
        self.sample_cfg = sample_cfg
        self.kv_aware = kv_aware
        self.admission_cfg = admission_cfg or sched.AdmissionConfig()
        self.store = weight_store
        self.streamed = weight_store is not None
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
        # comes from its table and ``params`` is the DRAM tier only
        self.store_preprogrammed = (self.streamed
                                    and len(weight_store.table) > 0)
        with torch.no_grad():
            params = _map_tree(lambda t: t.to(self.device), params)
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
            if self.streamed:
                self.stream_cfg = stream_cfg or StreamConfig()
                self.attn_flash = None
                self._init_streamed(params, rber, seed)
            else:
                self.stream_cfg = None
                self.attn_flash = self._flash_attn_copy(params, rber, seed)
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

    def _flash_attn_copy(self, params, rber, seed):
        """Per-layer flash (INT8+ECC) copies of the Q and O projections —
        the ones the bitmap dispatches — with the reference's per-layer
        seeds (seed + layer)."""
        attn = params["layers"]["attn"]
        return [{k: encode_flash(attn[k][li], rber=rber, seed=seed + li)
                 for k in ("wq", "wo")}
                for li in range(self.cfg.n_layers)]

    # --- streamed mode (FlashStore weight tier) -----------------------------

    def _init_streamed(self, raw_params, rber, seed):
        """Flash tier lives in the PageStore: program the per-layer attn
        flash copies next to deploy()'s FFN/lm_head entries, split the DRAM
        remainder out of the tiered tree, and stand up the page pool,
        residency cache and layer streamer under the device weight
        budget."""
        cfg, sc = self.cfg, self.stream_cfg
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
        group_pages = [sum(self.store.entry_pages(n) for n in names)
                       for names in group_names]
        pb = self.store.page_bytes
        worst = max(gp * pb / max(nb, 1)
                    for gp, nb in zip(group_pages, group_nbytes))
        self._pool_reserve_pages = \
            (sc.prefetch_depth + 1) * max(group_pages)
        n_pages = sum(group_pages)
        if cache_cap is not None:
            n_pages = min(n_pages, -(-int(worst * cache_cap) // pb)
                          + self._pool_reserve_pages)
        self.wpool = WeightPagePool(self.store, n_pages, device=self.device,
                                    stream=self._stream)
        self._win_shapes = {
            "ffn": {k: tuple(self.store.table[ref.entry(0)]["q"].shape)
                    for k, ref in self._ffn_refs.items()},
            "attn": {k: tuple(self.store.table[f"attn_flash/{k}@0"]["q"].shape)
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
                          self._generator)

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
        toks, logits, stats = self._captured.replay()
        # the next replay overwrites the graph's output
        return toks, logits.clone(), stats

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
        self._load_inputs()
        d, state = self._dev_in, self._state()
        tokens, q_lens, admitted, block_tables = (
            d["tokens"], d["q_lens"], d["admitted"], d["block_tables"])
        bitmap = state["bitmap"] if self.kv_aware else None
        x, positions, ctx_lens = _embed_chunk(cfg, self._dram_params,
                                              state["lengths"], tokens, q_lens)
        ks, vs = [], []
        for g, win in self.streamer.stream():
            if win["ready"] is not None:
                self._stream.wait_event(win["ready"])   # its pages are in
            x, k_g, v_g = _stream_group_impl(
                cfg, bitmap, self._win_shapes, self._layers, win,
                self.wpool.buffer, state["k"], state["v"], x, positions,
                ctx_lens, block_tables, g * gs, gs)
            ks += k_g
            vs += v_g
        return _finish_step(cfg, self.sched_cfg, self.sample_cfg,
                            self.kv_aware, self._dram_params["final_norm"],
                            self._lm_head, state, x, torch.stack(ks),
                            torch.stack(vs), q_lens, admitted, positions,
                            block_tables, self._generator)

    def _stream_stall_s(self) -> float:
        """Seconds the compute path has spent blocked on the weight
        stream."""
        return self.streamer.stall_s if self.streamed else 0.0

    def _maybe_autotune_depth(self):
        """Overlap-depth auto-tuning (``StreamConfig.auto_depth``): once,
        after the first measured steps, re-pick ``prefetch_depth`` from the
        observed stall/stream ratio, and re-split the device budget between
        the window and the cache (never below the pinned floor)."""
        sc = self.stream_cfg
        if (not sc.auto_depth or self._auto_depth_done
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

    def stream_stats(self) -> dict:
        """Streamer + residency-cache + page-store + pool counters:
        stall/stream seconds, streamed bytes, cache hits/misses, per-plane
        page reads and the NAND seconds they imply, pool uploads and the
        host-to-device copy time. Page counters cover serving only."""
        if not self.streamed:
            raise ValueError("stream_stats: engine is not in streamed mode")
        return {**self.streamer.stats(), **self.store.stats(),
                **self.wpool.stats(),
                "pool_reserve_bytes":
                    self._pool_reserve_pages * self.store.page_bytes,
                "prefetch_depth": self.streamer.prefetch_depth}

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
        worst-case block count."""
        while self.waiting:
            req = self.waiting[0]
            if req.done:                 # cancelled while waiting
                self.waiting.popleft()
                self._cv.notify_all()
                continue
            slot = self.pool.alloc(req.rid, req.kv_rows)
            if slot is None:
                break
            req.slot = slot
            self.waiting.popleft()
            self._cv.notify_all()

    def _sweep_cancelled(self):
        """Reclaim cancelled requests' resources at the top of every step."""
        for slot, rid in list(self.pool.active.items()):
            req = self.requests[rid]
            if req.done and req.cancelled:
                self.pool.release(slot)
        if any(r.done for r in self.waiting):
            self.waiting = collections.deque(
                r for r in self.waiting if not r.done)
            self._cv.notify_all()

    def _finish_request(self, req: Request, slot: int):
        self.pool.release(slot)          # O(1): no device work

    # --- the serving step ---------------------------------------------------

    def step(self) -> int:
        """One continuous-batching step over all running slots: decoding
        slots advance one token, prefilling slots consume a prompt chunk
        under the token budget. Returns tokens processed. Thread-safe;
        cancelled requests are swept first."""
        with self._cv:
            self._sweep_cancelled()
            n = self._step_locked()
            self._cv.notify_all()
            return n

    def _step_locked(self) -> int:
        self._admit()
        decode_slots, prefill_slots = [], []
        # ARRIVAL order (rid), not slot order: plan_chunks funds prefill
        # FCFS as given.
        for slot, rid in sorted(self.pool.active.items(), key=lambda kv: kv[1]):
            req = self.requests[rid]
            if req.done:
                continue
            if req.prefilling:
                prefill_slots.append((slot, len(req.prompt) - req.pos))
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
        admitted[decode_slots] = True
        for slot, cnt in plan.items():
            req = self.requests[self.pool.active[slot]]
            if req.prefilling:
                chunk = req.prompt[req.pos:req.pos + cnt]
                tokens[slot, :len(chunk)] = chunk
                q_lens[slot] = len(chunk)
            else:
                tokens[slot, 0] = req.out[-1]
                q_lens[slot] = 1
            # map physical blocks for this step's writes (draws on the
            # admission reservation, so it cannot fail)
            self.pool.ensure(slot, int(self.pool.lengths[slot]) + cnt)
        np.copyto(tables, self.pool.block_tables)
        t_step0 = time.perf_counter()
        stall0 = self._stream_stall_s()
        ctx = (torch.cuda.stream(self._stream) if self._stream is not None
               else contextlib.nullcontext())
        with torch.no_grad(), ctx:
            if self.streamed:
                toks, logits, stats = self._streamed_step()
            else:
                toks, logits, stats = self._run_resident()
            self.last_logits = logits
            # the step's device->host reads: sampled tokens + stat scalars
            toks_host = toks.cpu().numpy()
            st = stats.cpu().tolist()
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
                    req.out.append(int(toks_host[slot]))
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
        self._npu_frac = float(st[2])
        entry = {
            "kv_len": int(st[0]),
            "delta_cycles": int(st[1]),
            "npu_fraction": self._npu_frac,
            "prefill_tokens": n_prefill,
            "decode_tokens": n_processed - n_prefill,
        }
        if self.streamed:
            # stall fraction of step wall time (EMA): the residency signal
            # the token budget contracts with (scheduler.step_token_budget)
            dt = time.perf_counter() - t_step0
            stall_s = max(self._stream_stall_s() - stall0, 0.0)
            frac = min(max(stall_s / max(dt, 1e-9), 0.0), 1.0)
            self._stall_frac = 0.5 * self._stall_frac + 0.5 * frac
            entry["stall_frac"] = self._stall_frac
        self.stats.append(entry)
        self._steps_done += 1
        if self.streamed:
            self._maybe_autotune_depth()
        self._admit()                    # freed slots host waiting requests
        return n_processed

    def close(self):
        """Mark the engine closed, waking every ``submit`` blocked on
        backpressure. Idempotent and thread-safe; a close racing a step
        waits for it (``_cv``)."""
        with self._close_lock:
            if self._close_done:
                return
            self._close_done = True
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    def run(self, max_steps: int = 1000) -> dict[int, list[int]]:
        for _ in range(max_steps):
            if self.step() == 0:
                break
        return {r.rid: r.out for r in self.requests.values()}
