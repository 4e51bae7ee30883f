"""ERDPE — the error-resilient dot-product engine — the port of
``repro/core/erdpe.py``.

``flash_matmul`` is how every layer consumes a flash-tier weight: a
device-resident ``FlashWeight`` or a ``PagedWeight`` read in place from the
weight page pool. It flattens leading batch/seq dims to an (M, K) GEMM, runs
the ECDP (``kernels/ecdp.py``) or the paged ECDP (``kernels/paged_ecdp.py``)
and restores the output shape. ``flash_matmul_grouped`` is how an MoE
layer consumes a stacked (E, K, N) expert bank: one grouped ECDP
(``kernels/grouped_ecdp.py``) over rows grouped by expert, or, for a slab
of pool-paged experts, one grouped paged ECDP (``kernels/paged_ecdp.py``).
There is no ``ExecMode``: the device of the tensors picks the kernel
(CUDA) or its plain version (CPU).

Under tensor parallelism a row-parallel flash matmul (``out_dtype``
f32) yields each shard's partial, and ``all_reduce_sum`` completes it in
f32 before the cast, where the reference psums inside ``flash_matmul``.
"""
from __future__ import annotations

import os

import torch

from repro_torch.core.tiering import FlashWeight, PagedWeight
from repro_torch.launch import sharding as sh
from repro_torch.kernels.ecdp import ecdp_matmul
from repro_torch.kernels.grouped_ecdp import grouped_ecdp_matmul
from repro_torch.kernels.paged_ecdp import (grouped_paged_ecdp_matmul,
                                            paged_ecdp_matmul)


def serve_ecc_mode() -> str:
    """Serve-time ECC policy ("inline" | "load"), read at call time from
    ``REPRO_SERVE_ECC``. "inline" (the default, paper-faithful) corrects on
    every read of a flash-tier weight."""
    return os.environ.get("REPRO_SERVE_ECC", "inline")


def flash_matmul(x: torch.Tensor, w, ecc_enabled: bool = True,
                 out_dtype=torch.bfloat16) -> torch.Tensor:
    """x: (..., K) activations; w: a single (K, N) FlashWeight or
    PagedWeight. Returns (..., N) in ``out_dtype``."""
    if isinstance(w, PagedWeight):
        if w.lead:
            raise ValueError("flash_matmul expects a single (K, N) "
                             "PagedWeight; index stacked tables first")
        k, n = w.kn
    else:
        if w.q.ndim != 2:
            raise ValueError("flash_matmul expects a single (K, N) "
                             "FlashWeight; index stacked layers before "
                             "calling")
        k, n = w.q.shape
    lead = tuple(x.shape[:-1])
    x2 = sh.rows_whole_inside(x).reshape(-1, k).contiguous()
    if isinstance(w, PagedWeight):
        out = paged_ecdp_matmul(x2, w.pool, w.q_tbl, w.p_slots, w.s_slots,
                                tuple(w.kn), ecc_enabled=ecc_enabled)
    else:
        out = ecdp_matmul(x2, w.q, w.parity, w.scale,
                          ecc_enabled=ecc_enabled)
    return out.reshape(lead + (n,)).to(out_dtype)


def all_reduce_sum(partials, mesh) -> torch.Tensor:
    """The tensor-parallel all-reduce: the shards' f32 partials summed in
    f32, in shard order, on the mesh's first device (the reference's
    ``psum`` before ``out_dtype``). The one collective of a layer; a
    multi-process backend would replace this function alone."""
    first = mesh.devices[0]
    out = partials[0].to(first, torch.float32)
    for p in partials[1:]:
        out = out + p.to(first, torch.float32)
    return out


def flash_matmul_grouped(x: torch.Tensor, w, row_start: torch.Tensor,
                         ecc_enabled: bool = True, out_dtype=torch.bfloat16,
                         max_rows: int | None = None,
                         plan_experts: int | None = None) -> torch.Tensor:
    """x: (R, K) bf16 rows grouped by bank row, row e's at
    ``row_start[e] .. row_start[e+1]-1`` (``row_start`` (E+1,) int32 on
    x's device); w: one (E, K, N) FlashWeight bank, or a PagedWeight slab
    whose page tables are stacked over E slab rows (the grouped paged
    ECDP). Returns (R, N) in ``out_dtype``; ``max_rows`` is the most rows
    a bank row can have; ``plan_experts`` the expert count the launch
    plan is made for (``grouped_paged_ecdp_matmul``)."""
    if isinstance(w, PagedWeight) and len(w.lead) == 1:
        out = grouped_paged_ecdp_matmul(
            x.contiguous(), row_start, w.pool, w.q_tbl, w.p_slots,
            w.s_slots, tuple(w.kn), ecc_enabled=ecc_enabled,
            max_rows=max_rows, plan_experts=plan_experts)
        return out.to(out_dtype)
    if not isinstance(w, FlashWeight) or w.q.ndim != 3:
        raise ValueError("flash_matmul_grouped expects one (E, K, N) "
                         "FlashWeight bank or a PagedWeight slab; index "
                         "stacked layers first")
    out = grouped_ecdp_matmul(x.contiguous(), row_start, w.q, w.parity,
                              w.scale, ecc_enabled=ecc_enabled,
                              max_rows=max_rows, plan_experts=plan_experts)
    return out.to(out_dtype)


def maybe_flash_matmul(x: torch.Tensor, w, ecc_enabled: bool | None = None,
                       out_dtype=torch.bfloat16) -> torch.Tensor:
    """Dispatch on tier: FlashWeight / PagedWeight -> ERDPE; plain tensor
    -> matmul in the activation dtype (over a mesh, DTensors by
    ``sharding.matmul``'s tensor-parallel rules)."""
    if isinstance(w, (FlashWeight, PagedWeight)):
        if ecc_enabled is None:
            ecc_enabled = serve_ecc_mode() == "inline"
        return flash_matmul(x, w, ecc_enabled=ecc_enabled, out_dtype=out_dtype)
    if sh.is_dtensor(x) or sh.is_dtensor(w):
        return sh.matmul(x, w.to(x.dtype)).to(out_dtype)
    return (x @ w.to(x.dtype)).to(out_dtype)
