"""The plain reference's shared parts: the weights as the configuration
deploys them, worked out again from the seed (``Weights``), and the f32
layers every family uses. Plain PyTorch in float32; the caller turns TF32
off. The forward runs layer by layer over a list of sequences, each whole
from its first token: nothing is cached, batched or fused.

``mode`` "ref" is the reference; "control" is the same computation with
every activation that the configuration holds in bfloat16 (the residual
stream, each normed input, Q, K and V, the attention output, each FFN's
hidden and output rows) rounded to float8 e4m3 with one scale per row,
the precision below the one the configuration states (``act``).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from bench import weights as wts
from bench.reference import flash

MODES = ("ref", "control")


class Weights:
    """Block ``i`` of each leaf as the reference uses it, in f32: a DRAM
    leaf as drawn, a flash leaf as its INT8 copy reads after its bit
    errors (and SEC-DED where the configuration keeps ECC on)."""

    def __init__(self, model: dict, seed: int, rber: float, device):
        self.model, self.seed, self.rber, self.device = (model, seed, rber,
                                                         device)
        self.leaves = {lf.path: lf for lf in wts.leaves(model)}
        self._sites: dict = {}

    def sites(self, key, nbytes: int, seed: int):
        if key not in self._sites:
            self._sites[key] = flash.flip_sites(nbytes, self.rber, seed)
        return self._sites[key]

    def get(self, path: str, i: int = 0) -> torch.Tensor:
        leaf = self.leaves[path]
        w = wts.draw(leaf, self.seed, i, self.device)
        if not leaf.flash:
            return w.float()
        block = int(np.prod(leaf.block_shape))
        sites = self.sites(path, int(np.prod(leaf.shape)),
                           flash.leaf_seed(self.seed, path))
        return flash.flash_weight(w, sites, i * block, leaf.ecc)

    def flash_copy(self, path: str, i: int) -> torch.Tensor:
        """Algorithm 2's flash copy of DRAM matrix ``path``'s block ``i``
        (a layer's Q or O projection): its own bit errors, seed + layer,
        and SEC-DED."""
        leaf = self.leaves[path]
        w = wts.draw(leaf, self.seed, i, self.device)
        sites = self.sites((path, i), w.numel(), self.seed + i)
        return flash.flash_weight(w, sites, 0, True)


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """Rows of ``x`` through float8 e4m3 with one scale each."""
    s = x.abs().amax(dim=-1, keepdim=True).clamp_min(1e-12) / 448.0
    return (x / s).to(torch.float8_e4m3fn).float() * s


def act(x: torch.Tensor, mode: str) -> torch.Tensor:
    """An activation where the configuration holds it in bfloat16."""
    return round_fp8(x) if mode == "control" else x


def layer_norm(x, g, b, eps=1e-5):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * g + b


def rms_norm(x, gamma, eps=1e-6):
    """The port's RMSNorm parameter: the gain is ``1 + gamma``."""
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * (1 + gamma)


def rope(x, base: float):
    """Rotate-half rotary embedding of x (S, H, Dh) at positions 0..S-1."""
    s, _, dh = x.shape
    inv = 1.0 / base ** (torch.arange(0, dh, 2, device=x.device,
                                      dtype=torch.float32) / dh)
    ang = torch.arange(s, device=x.device, dtype=torch.float32)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :dh // 2], x[..., dh // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q, k, v, block: int = 512):
    """q (S, H, Dh), k/v (S, KV, Dh) -> (S, H * Dh); GQA by repetition,
    queries in blocks so the scores stay small."""
    s, h, dh = q.shape
    rep = h // k.shape[1]
    k = k.repeat_interleave(rep, dim=1)
    v = v.repeat_interleave(rep, dim=1)
    out = torch.empty_like(q)
    for q0 in range(0, s, block):
        q1 = min(q0 + block, s)
        sc = torch.einsum("qhd,khd->hqk", q[q0:q1], k[:q1]) * dh ** -0.5
        mask = (torch.arange(q1, device=q.device)[None, :]
                <= torch.arange(q0, q1, device=q.device)[:, None])
        sc = sc.masked_fill(~mask[None], float("-inf"))
        out[q0:q1] = torch.einsum("hqk,khd->qhd", torch.softmax(sc, -1),
                                  v[:q1])
    return out.reshape(s, h * dh)


def gaps(ref_logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """How far each token's reference logit lies below the row's best."""
    best = ref_logits.max(dim=-1).values
    return best - ref_logits.gather(-1, tokens[:, None].long())[:, 0]


def head(wt: Weights, x: torch.Tensor, final_norm, mode: str):
    """The served rows' logits: ``final_norm(x)`` through lm_head."""
    return act(final_norm(x), mode) @ wt.get("lm_head")


def silu_glu(x, wg, wu, wd, mode):
    """A SwiGLU FFN on its (already rounded) input rows."""
    return act(act(F.silu(x @ wg) * (x @ wu), mode) @ wd, mode)
