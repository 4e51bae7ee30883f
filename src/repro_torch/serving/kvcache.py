"""Block-paged, device-resident KV pool for continuous batching — the port
of ``repro/serving/kvcache.py`` (``PagedKVPool``).

  * ``k`` / ``v``: ``(n_layers, n_blocks, block_size, KV, Dh)`` tensors on
    the pool's device. Block 0 is a RESERVED dump block — never allocated,
    never read (length masks exclude it); padded block-table entries and a
    step's padding lanes are written there, so every write is
    unconditional. The serving step writes new rows IN PLACE (one
    ``index_put_`` per step, engine ``_finish_step``).
  * ``block_tables``: host ``(n_slots, max_blocks)`` int32 mapping a slot's
    logical block index to a pool block id (0 = unmapped), copied into the
    engine's static device buffer before each step.
  * ``lengths_dev`` is the device copy of the per-slot lengths the step
    reads and advances IN PLACE (the tensor never changes, so a captured
    step replays over it); ``lengths`` is the host MIRROR the control
    plane keeps in sync without device syncs.

The allocator is host-side: a free list plus per-block ref counts.
Admission RESERVES a request's worst-case block count up front, so lazily
growing slots never deadlock on an exhausted pool; physical blocks are
mapped on demand (``ensure``). ``release`` is O(1) host bookkeeping: freed
blocks keep their stale K/V, unreachable behind the length masks.
"""
from __future__ import annotations

import numpy as np
import torch


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


class PagedKVPool:
    def __init__(self, n_layers: int, n_slots: int, max_seq: int,
                 n_kv_heads: int, head_dim: int, dtype=torch.bfloat16,
                 block_size: int = 16, n_blocks: int | None = None,
                 device="cuda"):
        self.n_layers, self.n_slots, self.max_seq = n_layers, n_slots, max_seq
        self.n_kv_heads, self.head_dim = n_kv_heads, head_dim
        self.dtype, self.block_size, self.device = dtype, block_size, device
        self.max_blocks = cdiv(max_seq, block_size)
        if n_blocks is None:
            # fully provisioned by default; pass fewer to actually page
            n_blocks = n_slots * self.max_blocks + 1
        if n_blocks < 2:
            raise ValueError("need at least the dump block + one real block")
        self.n_blocks = n_blocks
        shape = (n_layers, n_blocks, block_size, n_kv_heads, head_dim)
        self.k = torch.zeros(shape, dtype=dtype, device=device)
        self.v = torch.zeros(shape, dtype=dtype, device=device)
        self.lengths = np.zeros((n_slots,), np.int32)
        self.lengths_dev = torch.zeros((n_slots,), dtype=torch.int32,
                                       device=device)
        self.block_tables = np.zeros((n_slots, self.max_blocks), np.int32)
        self.ref_count = np.zeros((n_blocks,), np.int32)
        self.free_blocks = list(range(1, n_blocks))[::-1]   # 0 = dump
        self.free_slots = list(range(n_slots))[::-1]
        self.reserved = np.zeros((n_slots,), np.int32)      # unmapped claim
        self.active: dict[int, int] = {}                    # slot -> rid

    # --- capacity arithmetic -------------------------------------------------

    def blocks_for(self, n_tokens: int) -> int:
        return cdiv(max(n_tokens, 0), self.block_size)

    @property
    def n_free_blocks(self) -> int:
        """Blocks neither mapped nor reserved by an admitted request."""
        return len(self.free_blocks) - int(self.reserved.sum())

    def n_mapped(self, slot: int) -> int:
        return int(np.count_nonzero(self.block_tables[slot]))

    def capacity(self, slot: int) -> int:
        """Tokens the slot's mapped blocks can hold."""
        return self.n_mapped(slot) * self.block_size

    # --- slot lifecycle ------------------------------------------------------

    def alloc(self, request_id: int, need_tokens: int) -> int | None:
        """Admit a request: claim a slot and RESERVE its worst-case block
        count (``need_tokens`` KV rows). Returns the slot, or None when no
        slot is free or the reservation would oversubscribe the pool."""
        need_blocks = self.blocks_for(need_tokens)
        if need_blocks > self.max_blocks:
            raise ValueError(
                f"request needs {need_tokens} KV rows > "
                f"max_seq={self.max_blocks * self.block_size}")
        if not self.free_slots or need_blocks > self.n_free_blocks:
            return None
        slot = self.free_slots.pop()
        self.active[slot] = request_id
        self.reserved[slot] = need_blocks
        self.lengths[slot] = 0
        self.lengths_dev[slot] = 0       # a write into the same tensor
        return slot

    def ensure(self, slot: int, new_len: int):
        """Map physical blocks so the slot can hold ``new_len`` tokens,
        drawing from its admission reservation."""
        want = self.blocks_for(new_len)
        have = self.n_mapped(slot)
        for i in range(have, want):
            if self.reserved[slot] <= 0:
                raise RuntimeError("slot grew past its admission reservation")
            blk = self.free_blocks.pop()
            assert self.ref_count[blk] == 0, "free list held a live block"
            self.ref_count[blk] = 1
            self.block_tables[slot, i] = blk
            self.reserved[slot] -= 1

    def release(self, slot: int):
        """O(1) bookkeeping, ZERO device work: stale K/V in freed blocks is
        unreachable (no table maps it; length masks bound every read), and
        the slot's length stays stale until ``alloc`` resets it."""
        self.active.pop(slot, None)
        for i in range(self.max_blocks):
            blk = int(self.block_tables[slot, i])
            if blk == 0:
                continue
            self.ref_count[blk] -= 1
            if self.ref_count[blk] == 0:
                self.free_blocks.append(blk)
            self.block_tables[slot, i] = 0
        self.reserved[slot] = 0
        self.free_slots.append(slot)

    def bump(self, slot: int, n: int = 1):
        """Advance the HOST mirror after a step (the step advanced the
        device lengths already)."""
        self.lengths[slot] += n
