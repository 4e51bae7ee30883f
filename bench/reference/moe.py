"""Plain f32 reference of the MoE decoder family (Qwen3-MoE: RMSNorm, GQA
with per-head RMSNorm on Q and K and rotary embeddings; every layer a
top-k mixture of SwiGLU experts whose gates are the softmax over the k
selected router logits). Attention stays on the DRAM projections (no
flash copy, no Algorithm 2 split). The flash tier holds the expert banks,
read raw (ECC off, as the configuration deploys them), and ``lm_head``
(SEC-DED on)."""
from __future__ import annotations

import torch

from bench.reference import common as rc
from bench.reference import dense
from bench.weights import Leaf


def leaves(m: dict) -> list[Leaf]:
    n, d, f, e, v = (m["n_layers"], m["d_model"], m["d_ff"], m["n_experts"],
                     m["vocab_size"])
    out = [Leaf("embed", (v, d), ("normal", 0.02))]
    out += dense.attn_leaves(m)
    out.append(Leaf("layers/moe/router", (n, d, e), ("normal", None), 1))
    bank = {"w_gate": (d, f), "w_up": (d, f), "w_down": (f, d)}
    out += [Leaf(f"layers/moe/experts/{k}", (n, e) + s, ("normal", None), 1,
                 True, ecc=False) for k, s in bank.items()]
    out += dense.norm_leaves(m)
    out.append(Leaf("lm_head", (d, v), ("normal", None), 0, True))
    return out


def experts(m: dict, router, bank: dict, x, mode: str, routes=None):
    """The layer's expert FFN on its (already rounded) normed input x
    (T, D); ``routes`` (a list) gets the layer's (T, k) expert ids."""
    top, idx = torch.topk(x @ router, m["top_k"], dim=-1)
    if routes is not None:
        routes.append(idx)
    gates = torch.softmax(top, dim=-1)
    out = torch.zeros_like(x)
    for e in torch.unique(idx).tolist():
        tok, slot = torch.nonzero(idx == e, as_tuple=True)
        y = rc.silu_glu(x[tok], bank["w_gate"][e], bank["w_up"][e],
                        bank["w_down"][e], mode)
        out.index_add_(0, tok, y * gates[tok, slot][:, None])
    return out


def forward(m: dict, wt: rc.Weights, seqs, first, n_on, modes,
            routes=None):
    """As ``dense.forward``; ``n_on`` is not read (no flash copies).
    ``routes`` (a list) gets each layer's (T, k) expert ids of the
    reference, the sequences packed in order."""
    lens = [int(t.shape[0]) for t in seqs]
    x0 = dense.embed(m, wt, seqs)
    xs = {md: rc.act(x0, md) for md in modes}
    for li in range(m["n_layers"]):
        ln1 = dense.norm(m, wt, "ln1", li)
        ln2 = dense.norm(m, wt, "ln2", li)
        w = dense.attn_weights(m, wt, li)
        router = wt.get("layers/moe/router", li)
        bank = {k: wt.get(f"layers/moe/experts/{k}", li)
                for k in ("w_gate", "w_up", "w_down")}
        for md in modes:
            x = xs[md]
            x = rc.act(x + dense.attention(m, w, rc.act(ln1(x), md), lens,
                                           lambda a: a @ w["wq"],
                                           lambda a: a @ w["wo"], md), md)
            xs[md] = rc.act(x + experts(
                m, router, bank, rc.act(ln2(x), md), md,
                routes if md == "ref" else None), md)
        del w, router, bank
    fin = dense.norm(m, wt, None, None)
    return {md: dense.served_logits(wt, xs[md], lens, first, fin, md)
            for md in modes}

