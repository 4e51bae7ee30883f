"""Hash-based prefix caching over the paged KV pool — the port's copy of
``repro/serving/prefix.py`` (stdlib only).

Shared system prompts are the normal case at scale — every user of a
deployment pays prefill for the same instruction preamble. The paged KV
pool already carries per-block ref counts "reserved for prefix sharing"
(kvcache.py); this module is the index that spends them: a block-aligned
CHAIN HASH of prompt token prefixes maps to retained pool blocks, so a
new request whose prompt starts with an already-served prefix adopts the
cached blocks copy-free (ref bump, no device work) and prefills only its
tail.

Why a chain hash, not a per-block hash: block ``i`` of a slot's KV holds
rows ``[i*bs, (i+1)*bs)``, and every one of those K/V rows depends —
through attention across all layers — on EVERY token before it. Two
prompts may share block-3 *tokens* but differ in block 0; their block-3
K/V differs. Entry ``i``'s key therefore digests ``tokens[:(i+1)*bs]``
(implemented incrementally: ``H_i = blake2b(H_{i-1} || block_i)``), so a
hash hit certifies the whole prefix and block reuse is EXACT — the nano-
vLLM block-manager discipline.

Index invariants (property-tested in tests/test_torch_prefix.py):

  * the index holds exactly ONE pool ref per cached block — a block's
    ``ref_count`` equals (slots mapping it) + (1 if cached), always;
  * eviction is ref-count-aware LRU over fully-released CHAINS: only an
    entry with no cached children and no live slot sharer (``ref_count
    == 1`` — the index's own ref) may be evicted, so a chain frees leaf-
    first and a block under a live request is never reclaimed;
  * insert never rebinds an existing hash — the first completed request
    to cache a prefix wins, duplicates keep their own blocks until their
    normal release.
"""
from __future__ import annotations

import dataclasses
import hashlib
import itertools


def block_hashes(tokens, block_size: int, limit: int | None = None):
    """Chain digests of the FULL blocks of ``tokens``: entry ``i`` keys
    ``tokens[:(i+1)*block_size]``. A trailing partial block is never
    hashed (its KV rows are not yet position-complete for sharing).
    ``limit`` caps the number of hashed blocks — admission caps at
    ``(len(prompt) - 1) // block_size`` so at least one prompt token
    always prefills (every request must sample from its own last lane).
    """
    n_full = len(tokens) // block_size
    if limit is not None:
        n_full = min(n_full, limit)
    out = []
    h = b""
    for i in range(n_full):
        blk = tokens[i * block_size:(i + 1) * block_size]
        d = hashlib.blake2b(digest_size=16)
        d.update(h)
        d.update(b",".join(str(int(t)).encode() for t in blk))
        h = d.digest()
        out.append(h)
    return out


@dataclasses.dataclass
class _Entry:
    block: int                    # pool block id holding this prefix block
    parent: bytes | None          # previous hash in the chain (None = root)
    children: int = 0             # cached extensions (eviction gate)
    tick: int = 0                 # LRU clock at last touch


class PrefixIndex:
    """hash -> retained pool block. The control-plane half of prefix
    caching; the pool owns the device memory, the index owns ONE ref per
    cached block and the LRU/chain bookkeeping."""

    def __init__(self, pool):
        self.pool = pool
        self.entries: dict[bytes, _Entry] = {}
        self._tick = itertools.count()
        self.hits = 0             # blocks served from cache at admission
        self.misses = 0           # lookup blocks that had to prefill cold
        self.inserted = 0
        self.evicted = 0

    def __contains__(self, h: bytes) -> bool:
        return h in self.entries

    def __len__(self) -> int:
        return len(self.entries)

    def lookup(self, hashes) -> list[int]:
        """Longest cached prefix of the chain: pool block ids for the
        leading hit run (a miss breaks the chain — later hits would hash
        a prefix the request cannot adopt without the blocks before it).
        Touches every hit's LRU tick."""
        blocks = []
        for h in hashes:
            e = self.entries.get(h)
            if e is None:
                break
            e.tick = next(self._tick)
            blocks.append(e.block)
        self.hits += len(blocks)
        self.misses += len(hashes) - len(blocks)
        return blocks

    def insert(self, hashes, blocks) -> int:
        """Retain a completed request's full prompt blocks: one pool ref
        per NEWLY cached block (an existing hash keeps its original block
        — the request's duplicate copy releases normally with its slot).
        Returns the number of new entries."""
        assert len(blocks) >= len(hashes)
        n_new = 0
        parent = None
        for h, blk in zip(hashes, blocks):
            e = self.entries.get(h)
            if e is None:
                blk = int(blk)
                self.pool.ref(blk)
                e = _Entry(block=blk, parent=parent,
                           tick=next(self._tick))
                self.entries[h] = e
                if parent is not None:
                    self.entries[parent].children += 1
                n_new += 1
            parent = h
        self.inserted += n_new
        return n_new

    def evictable(self, h: bytes) -> bool:
        """A leaf of a fully-released chain: no cached children, and the
        index's ref is the block's ONLY ref (no slot maps it)."""
        e = self.entries[h]
        return e.children == 0 and int(self.pool.ref_count[e.block]) == 1

    def evict(self, n_blocks: int) -> int:
        """Free up to ``n_blocks`` pool blocks, coldest evictable entry
        first. Evicting a leaf may expose its parent as the next leaf, so
        the scan repeats until the target is met or nothing qualifies.
        Returns blocks actually freed."""
        freed = 0
        while freed < n_blocks:
            victim = None
            for h, e in self.entries.items():
                if self.evictable(h) and (
                        victim is None
                        or e.tick < self.entries[victim].tick):
                    victim = h
            if victim is None:
                break
            e = self.entries.pop(victim)
            if e.parent is not None:
                self.entries[e.parent].children -= 1
            self.pool.deref(e.block)
            freed += 1
            self.evicted += 1
        return freed

    def stats(self) -> dict:
        return {"prefix_entries": len(self.entries),
                "prefix_hits": self.hits, "prefix_misses": self.misses,
                "prefix_hit_rate": self.hits / max(self.hits + self.misses,
                                                   1),
                "prefix_inserted": self.inserted,
                "prefix_evicted": self.evicted,
                "prefix_cached_blocks": len(self.entries)}

    def obs_samples(self):
        """ObsPlane scrape samples (lock-free counter reads)."""
        from repro_torch.obs.registry import Sample
        yield Sample("prefix_entries", "gauge", float(len(self.entries)))
        yield Sample("prefix_hits_total", "counter", float(self.hits))
        yield Sample("prefix_misses_total", "counter", float(self.misses))
        yield Sample("prefix_inserted_total", "counter",
                     float(self.inserted))
        yield Sample("prefix_evicted_total", "counter", float(self.evicted))
        yield Sample("prefix_hit_rate", "gauge",
                     self.hits / max(self.hits + self.misses, 1))
