"""Plain f32 reference of the dense decoder family (OPT: LayerNorm before
attention and FFN, a GELU FFN with the tanh approximation, learned
positions; the RoPE / RMSNorm / SwiGLU variant where the configuration
says so). Its flash tier: the FFN and ``lm_head`` (INT8 with SEC-DED),
and Algorithm 2's flash copies of each layer's Q and O projections. The
projections are split per column group as the serving step split them:
at each position the first ``n_on`` of the ``h`` groups take the f32 DRAM
product and the rest the flash copy's."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from bench.reference import common as rc
from bench.weights import Leaf


def leaves(m: dict) -> list[Leaf]:
    n, d, h, kv, dh, f, v = (m["n_layers"], m["d_model"], m["n_heads"],
                             m["n_kv_heads"], m["head_dim"], m["d_ff"],
                             m["vocab_size"])
    out = [Leaf("embed", (v, d), ("normal", 0.02))]
    if not m.get("use_rope", True):
        out.append(Leaf("pos_embed", (m["max_seq"], d), ("normal", 0.02)))
    out += attn_leaves(m)
    ffn = ({"w_gate": (d, f), "w_up": (d, f), "w_down": (f, d)}
           if m.get("ffn_type") == "swiglu"
           else {"w_up": (d, f), "w_down": (f, d)})
    out += [Leaf(f"layers/ffn/{k}", (n,) + s, ("normal", None), 1, True)
            for k, s in ffn.items()]
    out += norm_leaves(m)
    out.append(Leaf("lm_head", (d, v), ("normal", None), 0, True))
    return out


def attn_leaves(m: dict) -> list[Leaf]:
    n, d, h, kv, dh = (m["n_layers"], m["d_model"], m["n_heads"],
                       m["n_kv_heads"], m["head_dim"])
    shapes = {"wq": (d, h * dh), "wk": (d, kv * dh), "wv": (d, kv * dh),
              "wo": (h * dh, d)}
    out = [Leaf(f"layers/attn/{k}", (n,) + s, ("normal", None), 1)
           for k, s in shapes.items()]
    if m.get("qk_norm"):
        out += [Leaf(f"layers/attn/{k}", (n, dh), ("const", 0.0), 1)
                for k in ("q_norm", "k_norm")]
    return out


def norm_leaves(m: dict) -> list[Leaf]:
    n, d = m["n_layers"], m["d_model"]
    if m.get("norm_type") == "layer":
        out = [Leaf(f"layers/{ln}_{p}", (n, d), ("const", c), 1)
               for ln in ("ln1", "ln2") for p, c in (("g", 1.0), ("b", 0.0))]
        return out + [Leaf("final_norm/g", (d,), ("const", 1.0)),
                      Leaf("final_norm/b", (d,), ("const", 0.0))]
    return ([Leaf(f"layers/{ln}", (n, d), ("const", 0.0), 1)
             for ln in ("ln1", "ln2")]
            + [Leaf("final_norm", (d,), ("const", 0.0))])


def norm(m: dict, wt: rc.Weights, name: str, li: int | None):
    """The LayerNorm or RMSNorm ``name`` of layer ``li`` (None: the final
    one) as a function."""
    if li is None:
        if m.get("norm_type") == "layer":
            g, b = wt.get("final_norm/g"), wt.get("final_norm/b")
            return lambda x: rc.layer_norm(x, g, b)
        gamma = wt.get("final_norm")
        return lambda x: rc.rms_norm(x, gamma)
    if m.get("norm_type") == "layer":
        g, b = wt.get(f"layers/{name}_g", li), wt.get(f"layers/{name}_b", li)
        return lambda x: rc.layer_norm(x, g, b)
    gamma = wt.get(f"layers/{name}", li)
    return lambda x: rc.rms_norm(x, gamma)


def embed(m: dict, wt: rc.Weights, seqs):
    """The sequences' embeddings, packed along one row axis."""
    toks = torch.cat(seqs)
    x = wt.get("embed")[toks]
    if not m.get("use_rope", True):
        pos = torch.cat([torch.arange(t.shape[0], device=toks.device)
                         for t in seqs])
        x = x + wt.get("pos_embed")[pos]
    return x


def attention(m: dict, w: dict, h, lens, proj_q, proj_o, mode: str):
    """Attention of the packed sequences (lengths ``lens``) on their normed
    input ``h`` (T, D); ``proj_q`` / ``proj_o`` compute the Q and O
    projections of all rows."""
    t = h.shape[0]
    q = rc.act(proj_q(h), mode).reshape(t, m["n_heads"], m["head_dim"])
    k = rc.act(h @ w["wk"], mode).reshape(t, m["n_kv_heads"], m["head_dim"])
    v = rc.act(h @ w["wv"], mode).reshape(t, m["n_kv_heads"], m["head_dim"])
    if m.get("qk_norm"):
        q, k = rc.rms_norm(q, w["q_norm"]), rc.rms_norm(k, w["k_norm"])
    out, r0 = [], 0
    for n in lens:
        qs, ks = q[r0:r0 + n], k[r0:r0 + n]
        if m.get("use_rope", True):
            qs, ks = rc.rope(qs, m["rope_base"]), rc.rope(ks, m["rope_base"])
        out.append(rc.causal_attention(rc.act(qs, mode), rc.act(ks, mode),
                                       v[r0:r0 + n]))
        r0 += n
    return rc.act(proj_o(rc.act(torch.cat(out), mode)), mode)


def attn_weights(m: dict, wt: rc.Weights, li: int) -> dict:
    w = {k: wt.get(f"layers/attn/{k}", li) for k in ("wq", "wk", "wv", "wo")}
    if m.get("qk_norm"):
        w.update({k: wt.get(f"layers/attn/{k}", li)
                  for k in ("q_norm", "k_norm")})
    return w


def split(x, w_dram, w_flash, n_on, h: int, mode: str):
    """Algorithm 2's bitmap-dispatched projection: at each row the column
    groups below ``n_on`` from the DRAM product, the rest from the flash
    copy's."""
    if w_flash is None:
        return x @ w_dram
    cols = w_dram.shape[1]
    group = torch.arange(cols, device=x.device) // (cols // h)
    on = group[None, :] < n_on[:, None]
    return torch.where(on, x @ w_dram, x @ w_flash)


def ffn(m: dict, w: dict, x, mode: str):
    """The FFN on its (already rounded) normed input rows."""
    if m.get("ffn_type") == "swiglu":
        return rc.silu_glu(x, w["w_gate"], w["w_up"], w["w_down"], mode)
    hid = rc.act(F.gelu(x @ w["w_up"], approximate="tanh"), mode)
    return rc.act(hid @ w["w_down"], mode)


def forward(m: dict, wt: rc.Weights, seqs, first, n_on, modes):
    """seqs: token tensors (S_i,); first[i]: the first position whose
    logits are served; n_on[i]: (S_i,) NPU column groups per position.
    Returns {mode: [(S_i - first[i], V) f32 logits]}."""
    lens = [int(t.shape[0]) for t in seqs]
    on = torch.cat(n_on)
    h_groups = m["alg2_groups"]
    x0 = embed(m, wt, seqs)
    xs = {md: rc.act(x0, md) for md in modes}
    ffn_keys = [lf.path.split("/")[-1] for lf in wt.leaves.values()
                if lf.path.startswith("layers/ffn/")]
    for li in range(m["n_layers"]):
        ln1, ln2 = norm(m, wt, "ln1", li), norm(m, wt, "ln2", li)
        w = attn_weights(m, wt, li)
        fq = fo = None
        if m.get("alg2_flash_copies"):
            fq = wt.flash_copy("layers/attn/wq", li)
            fo = wt.flash_copy("layers/attn/wo", li)
        wf = {k: wt.get(f"layers/ffn/{k}", li) for k in ffn_keys}
        for md in modes:
            x = xs[md]
            x = rc.act(x + attention(
                m, w, rc.act(ln1(x), md), lens,
                lambda a: split(a, w["wq"], fq, on, h_groups, md),
                lambda a: split(a, w["wo"], fo, on, h_groups, md), md), md)
            xs[md] = rc.act(x + ffn(m, wf, rc.act(ln2(x), md), md), md)
        del w, wf, fq, fo
    return {md: served_logits(wt, xs[md], lens, first, norm(m, wt, None,
                                                            None), md)
            for md in modes}


def served_logits(wt: rc.Weights, x, lens, first, fin, mode: str):
    """Each sequence's logits from its first served position on."""
    rows, r0 = [], 0
    for n, f in zip(lens, first):
        rows.append(torch.arange(r0 + f, r0 + n, device=x.device))
        r0 += n
    logits = rc.head(wt, x[torch.cat(rows)], fin, mode)
    return list(torch.split(logits, [n - f for n, f in zip(lens, first)]))
