"""Speculative decoding for the serving engine — the port of
``repro/serving/spec.py`` (DESIGN.md §8).

Streamed serving is bound by the weight stream: every decoded token pays
one full pass over the flash tier (one ``LayerStreamer`` window
rotation). This module supplies the two halves that let one such pass
emit several tokens:

  * ``DraftProposer`` proposes up to k draft tokens per decoding slot
    inside the step body (both drafters read no tensor on the host, so a
    captured step holds them):
      - ``ngram``: prompt-lookup drafting — find the most recent earlier
        occurrence of the slot's trailing n-gram in its own history
        (prompt + generated) and propose the tokens that followed it;
      - ``model``: a small RESIDENT draft model (dense family, bf16, no
        flash tier, no kernel) greedily decodes k tokens over a sliding
        window of the history.
  * ``verify_lanes`` is the accept/reject scan over the target model's
    verify-lane logits: greedy exact-match acceptance, and rejection
    sampling for temperature > 0 (accept draft d with probability p(d);
    both drafters propose greedily, so q is a point mass and the residual
    is p with d zeroed).

The engine packs ``[last_token, d_1 .. d_k]`` into a decoding slot's chunk
lanes and verifies all k proposals in one forward pass. Accepted drafts
plus one bonus token emit ``n_accept + 1`` tokens; the KV length advances
by that count (a length REWIND relative to the lanes written: rejected
rows stay in place, unreachable, and later steps overwrite them).

Greedy invariant: whatever the drafter proposes, the emitted stream is
plain greedy decoding — drafts change how many tokens a pass emits, never
which.

Where the reference's gathers lean on JAX's out-of-range semantics
(``take_along_axis`` fills, ``jnp.take`` clips), the port clamps every
index explicitly: on CUDA an index out of range is a device assert.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import obs
from repro_torch.models import common as cm
from repro_torch.models import dense
from repro_torch.serving.sampler import (SampleConfig, categorical,
                                         filter_logits)


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    """Speculative serving mode (``Engine(spec_cfg=...)``)."""
    k: int = 4                  # max draft tokens verified per slot per step
    drafter: str = "ngram"      # "ngram" (prompt lookup) | "model"
    ngram: int = 3              # longest trailing n-gram to look up
    draft_window: int = 16      # context window of the draft model
    # adaptive per-slot k: scale each slot's verify-lane ask by its recent
    # acceptance-rate EMA; every slot keeps >= 1 probe lane so the signal
    # can recover.
    adaptive_k: bool = False
    ema_alpha: float = 0.5      # EMA weight of the newest verify step

    def __post_init__(self):
        if self.k < 1:
            raise ValueError(f"spec k={self.k}: need >= 1 draft lane")
        if self.drafter not in ("ngram", "model"):
            raise ValueError(f"unknown drafter {self.drafter!r}")
        if self.drafter == "ngram" and self.ngram < 1:
            raise ValueError("ngram drafter needs ngram >= 1")
        if not (0.0 < self.ema_alpha <= 1.0):
            raise ValueError(f"ema_alpha={self.ema_alpha}: need (0, 1]")


# --- drafters (static shapes, no host reads) ---------------------------------

def ngram_propose(hist: torch.Tensor, lens: torch.Tensor, k: int,
                  n_max: int = 3) -> tuple[torch.Tensor, torch.Tensor]:
    """Prompt-lookup drafting over per-slot token histories.

    hist: (B, H) int32 history (prompt + generated), left-aligned,
          don't-care past ``lens``; lens: (B,) int32.

    For each slot, find the MOST RECENT position p < lens - n where
    ``hist[p:p+n]`` equals the trailing n-gram ``hist[lens-n:lens]``,
    preferring longer n (n = n_max .. 1), and propose the up-to-k tokens
    that followed it. Returns (drafts (B, k) int32, n_avail (B,) int32);
    a slot with no match gets n_avail = 0."""
    b, h = hist.shape
    dev = hist.device
    idx = torch.arange(h, device=dev)
    lens = lens.long()
    cont_start = torch.full((b,), -1, dtype=torch.long, device=dev)
    for n in range(n_max, 0, -1):
        ar = torch.arange(n, device=dev)
        # trailing n-gram per slot
        suf_pos = torch.clamp(lens[:, None] - n + ar[None, :], 0, h - 1)
        suffix = torch.gather(hist, 1, suf_pos)
        # all candidate windows hist[p : p+n]
        win_pos = torch.clamp(idx[:, None] + ar[None, :], 0, h - 1)
        wins = hist[:, win_pos]                                 # (B, H, n)
        match = (wins == suffix[:, None, :]).all(dim=-1)
        # p + n < lens: a continuation token exists and the match is not
        # the trailing suffix itself; lens >= n + 1 likewise
        match &= (idx[None, :] + n < lens[:, None]) & (lens[:, None] > n)
        best = torch.where(match, idx[None, :], -1).amax(dim=1)
        found = (best >= 0) & (cont_start < 0)   # longer n already iterated
        cont_start = torch.where(found, best + n, cont_start)
    pos = cont_start[:, None] + torch.arange(k, device=dev)[None, :]
    drafts = torch.gather(hist, 1, torch.clamp(pos, 0, h - 1))
    ok = (cont_start[:, None] >= 0) & (pos < lens[:, None])
    return (torch.where(ok, drafts, 0).to(torch.int32),
            ok.sum(dim=1).to(torch.int32))


def _draft_forward(dcfg, dparams, toks: torch.Tensor,
                   valid: torch.Tensor) -> torch.Tensor:
    """Last-position logits (B, V) f32 of the resident draft model over a
    (B, W) window. Positions are WINDOW-RELATIVE (0..W-1): the drafter is
    a proposal heuristic, and the window never runs past a learned-position
    table. Invalid (pre-history) lanes are masked out of attention."""
    b, w = toks.shape
    positions = torch.arange(w, device=toks.device)
    x = dense._embed(dcfg, dparams, toks, positions)
    acfg = dense.attn_cfg(dcfg)
    causal = positions[None, :] <= positions[:, None]
    mask = causal[None, None] & valid[:, None, None, :]         # (B,1,W,W)
    scale = dcfg.head_dim ** -0.5
    for li in range(dcfg.n_layers):
        lp = dense.layer_slice(dparams["layers"], li)
        h = dense._norm(dcfg, x, lp, "ln1")
        q, kk, vv = cm.qkv_project(lp["attn"], h, acfg, positions)
        # plain masked softmax over the small (W, W) window
        qf = q.float() * scale
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kk.float())
        s = torch.where(mask, s, float("-inf"))
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - torch.where(torch.isfinite(m), m, 0.0))
        p = torch.where(mask, p, 0.0)
        p = p / torch.clamp_min(p.sum(dim=-1, keepdim=True), 1e-20)
        attn = torch.einsum("bhqk,bkhd->bqhd", p, vv.float())
        attn = attn.reshape(b, w, -1).to(x.dtype)
        x = x + (attn.float() @ lp["attn"]["wo"].float()).to(x.dtype)
        x = x + dense._ffn_apply(dcfg, lp["ffn"],
                                 dense._norm(dcfg, x, lp, "ln2"))
    x = dense._final_norm(dcfg, dparams, x)
    return x[:, -1].float() @ dparams["lm_head"].float()


def model_propose(dcfg, dparams, hist: torch.Tensor, lens: torch.Tensor,
                  k: int, window: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Greedy k-token rollout of the resident draft model over the last
    ``window`` history tokens. Returns (drafts (B, k) int32, n_avail (B,)
    == k wherever any history exists)."""
    b, h = hist.shape
    dev = hist.device
    pos = lens.long()[:, None] - window + torch.arange(window, device=dev)
    toks = torch.gather(hist, 1, torch.clamp(pos, 0, h - 1))
    valid = pos >= 0
    toks = torch.where(valid, toks, 0)
    drafts = []
    for _ in range(k):
        nxt = _draft_forward(dcfg, dparams, toks, valid).argmax(
            dim=-1).to(torch.int32)
        drafts.append(nxt)
        toks = torch.cat([toks[:, 1:], nxt[:, None]], dim=1)
        valid = torch.cat([valid[:, 1:],
                           torch.ones((b, 1), dtype=torch.bool, device=dev)],
                          dim=1)
    n_avail = torch.where(lens > 0, k, 0).to(torch.int32)
    return torch.stack(drafts, dim=1), n_avail


class DraftProposer:
    """Engine-facing drafter: ``propose(hist, lens)`` reads no tensor on
    the host, so the engine calls it inside its step body (and a captured
    step holds it). The model drafter keeps its ``wo`` and ``lm_head`` in
    f32, made once from bf16 (exact), so no step upcasts them."""

    def __init__(self, cfg: SpecConfig, draft_cfg=None, draft_params=None):
        self.cfg = cfg
        if cfg.drafter == "model":
            if draft_cfg is None or draft_params is None:
                raise ValueError("drafter='model' needs draft_cfg and "
                                 "draft_params (a small resident model)")
            if draft_cfg.family != "dense":
                raise ValueError("draft model must be dense-family")
            layers = dict(draft_params["layers"])
            layers["attn"] = dict(layers["attn"],
                                  wo=layers["attn"]["wo"].float())
            draft_params = dict(draft_params, layers=layers,
                                lm_head=draft_params["lm_head"].float())
        self.draft_cfg = draft_cfg
        self.draft_params = draft_params

    def propose(self, hist: torch.Tensor,
                lens: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(B, H) history + (B,) lens -> (drafts (B, k), n_avail (B,))."""
        if self.cfg.drafter == "ngram":
            return ngram_propose(hist, lens, self.cfg.k, self.cfg.ngram)
        return model_propose(self.draft_cfg, self.draft_params, hist, lens,
                             self.cfg.k, self.cfg.draft_window)


# --- verification --------------------------------------------------------------

def verify_lanes(logits: torch.Tensor, drafts: torch.Tensor,
                 n_draft: torch.Tensor, generator: torch.Generator | None,
                 cfg: SampleConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """Accept/reject scan over one verify pass's lane logits.

    logits : (B, K+1, V) f32 — target logits at lane j (lane 0 carries the
             last emitted token, lane j >= 1 draft j).
    drafts : (B, K) int32 — proposed tokens (don't-care past n_draft).
    n_draft: (B,) int32 — valid drafts per slot (0 = plain decode).

    Returns (tokens (B, K+1) int32, n_accept (B,) int32): the step emits
    ``tokens[:, : n_accept + 1]`` — accepted drafts, then one bonus token
    from the target distribution (greedy: its argmax; after a rejection
    at lane j, the residual distribution at lane j).

    Greedy never touches ``generator``. Otherwise it draws, in this order:
    the (B, K) accept uniforms, the (B, K+1) plain samples, the (B, K+1)
    residual samples (``torch.rand`` / ``sampler.categorical``, every lane
    its own variates).
    """
    b, k1, v = logits.shape
    k = k1 - 1
    dev = logits.device
    j = torch.arange(k, device=dev)
    if cfg.temperature <= 0.0:
        # accepted drafts EQUAL the per-lane argmax, so the emitted prefix
        # is the targets row: what sequential greedy decode gives
        tgt = logits.argmax(dim=-1).to(torch.int32)
        ok = (drafts == tgt[:, :k]) & (j[None, :] < n_draft[:, None])
        n_acc = torch.cumprod(ok.to(torch.int32), dim=1).sum(dim=1)
        return tgt, n_acc.to(torch.int32)

    # rejection sampling against the FILTERED target distribution (the
    # algebra of sampler.sample); drafts are greedy, so accept d at lane j
    # with probability p_j(d), and the residual is p_j with d zeroed
    filt = filter_logits(logits, cfg)                    # (B, K+1, V)
    probs = torch.softmax(filt, dim=-1)
    d_idx = torch.clamp(drafts.long(), 0, v - 1)
    p_draft = torch.gather(probs[:, :k], -1, d_idx[..., None])[..., 0]
    u = torch.rand((b, k), generator=generator, device=dev)
    ok = (u < p_draft) & (j[None, :] < n_draft[:, None])
    n_acc = torch.cumprod(ok.to(torch.int32), dim=1).sum(dim=1).to(
        torch.int32)

    plain = categorical(filt, generator)                 # (B, K+1)
    drafts_pad = torch.cat([d_idx, torch.zeros((b, 1), dtype=torch.long,
                                               device=dev)], dim=1)
    hit = torch.zeros_like(filt, dtype=torch.bool).scatter_(
        -1, drafts_pad[..., None], True)
    resid_f = torch.where(hit, float("-inf"), filt)
    # a residual can be empty (the draft owned ALL filtered mass): fall
    # back to the plain sample there (its row draws from filt, so the
    # softmax stays finite)
    resid_ok = torch.isfinite(resid_f).any(dim=-1)       # (B, K+1)
    resid = categorical(torch.where(resid_ok[..., None], resid_f, filt),
                        generator)
    fallback = torch.where(resid_ok, resid, plain)

    jj = torch.arange(k1, device=dev)
    rejected_here = jj[None, :] < n_draft[:, None]       # a draft exists there
    bonus_lane = torch.where(rejected_here, fallback, plain)
    bonus = torch.gather(bonus_lane, 1, n_acc.long()[:, None])[:, 0]
    tokens = torch.where(jj[None, :] < n_acc[:, None],
                         drafts_pad.to(torch.int32),
                         torch.where(jj[None, :] == n_acc[:, None],
                                     bonus[:, None], 0))
    return tokens.to(torch.int32), n_acc


# --- ObsPlane samples ----------------------------------------------------------

def spec_obs_samples(totals: dict):
    """Speculative-decode counters as scrape-time ObsPlane samples;
    ``totals`` is the engine's ``_spec_totals`` (lock-free read: ints swap
    atomically under the GIL)."""
    drafted = totals.get("drafted", 0)
    yield obs.Sample("spec_verify_steps_total", "counter",
                     float(totals.get("verify_steps", 0)))
    yield obs.Sample("spec_drafted_total", "counter", float(drafted))
    yield obs.Sample("spec_accepted_total", "counter",
                     float(totals.get("accepted", 0)))
    yield obs.Sample("spec_emitted_total", "counter",
                     float(totals.get("emitted", 0)))
    yield obs.Sample("spec_acceptance_rate", "gauge",
                     totals.get("accepted", 0) / max(drafted, 1))
