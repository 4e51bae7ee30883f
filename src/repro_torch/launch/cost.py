"""Structural cost of a step: flops, bytes moved and peak live bytes,
counted op by op as PyTorch dispatches them — the counterpart of
``repro/launch/hlo_cost.py``.

The reference parses XLA's compiled HLO text. A PyTorch program produces
none, so ``count(fn, *args)`` runs ``fn`` under a ``TorchDispatchMode``
and charges every aten op that reaches it, with the reference's rules
(``hlo_cost.py:192-255``):

    flops   a matmul 2*M*N*K (``torch.utils.flop_counter``'s formulas:
            mm, addmm, bmm, baddbmm, convolutions, attention); a reduction
            its largest operand's elements; a data-movement op (copy, cast,
            gather, scatter, concatenation, padding, factories, sort) none;
            any other op one per output element;
    bytes   a view, a reshape or a detach nothing; an in-place slice write
            (``copy_``, ``index_put_``, ``index_copy_`` into a view) twice
            the update; any other op its inputs' bytes plus its outputs'
            bytes (a broadcast input counts its stored elements).

XLA counts a fusion or a Pallas call as one instruction at its boundary.
In the same way a call of one of the four TPU kernels' plain versions
(``BOUNDARIES``: the ECDP and its grouped and paged forms, paged attention,
decode attention) is counted once: its inputs' and outputs' bytes and the
kernel's own flops (the ECDP's 2*M*K*N; attention's QK^T and PV over every
key row). Its outputs are made from the kernel's output shapes and its
step-by-step arithmetic is not run: it would be a hundred ops a call, the
plain grouped ECDP reads its row ranges on the host (a fake or meta
tensor has no values), and the plain ECDP's dequantised copy of the
weight would triple the flash tier's bytes. The tests hold each rule's
shapes to its plain version's.

Peak live bytes: the arguments' storages, plus every storage an op makes,
from its creation to its release (a ``weakref.finalize`` per storage).

Under a mesh (``launch/dryrun.py``'s mesh cells: DTensors over a
``DeviceMesh``) one process stands for every rank and ``count`` counts one
chip's share, as the reference's ``hlo_cost`` counts one device's SPMD
program:

- an op on DTensors is left to DTensor (the mode returns
  ``NotImplemented``); its local ops come back to the counter on the local
  shards, one chip's shapes;
- with ``skip_fake`` an op on ``FakeTensor``s is run and not charged: on a
  meta cell those are DTensor's sharding propagation, at global shapes;
- the arguments and the peak are counted on the local storages;
- a collective (``_c10d_functional``'s and ``_c10d_functional_autograd``'s
  all_reduce, all_gather_into_tensor, reduce_scatter_tensor,
  all_to_all_single and their ``_coalesced`` forms; DTensor's
  ``shard_dim_alltoall``) goes into ``Cost.wire`` under the reference's
  name, by the reference's rule (``hlo_cost.py:206-224``): all-reduce 2 x
  its result, reduce-scatter its operand, all-gather max(result - operand,
  operand), all-to-all and collective-permute their result. Each adds 1 to
  ``n_collectives`` and to its kind's ``Cost.collectives``, and its result
  bytes to ``bytes``. A collective over a
  group of one rank (its size read from the group's name) moves nothing
  and is not charged; ``wait_tensor`` and ``_wrap_tensor_autograd`` are
  free. On a "cpu" ``DeviceMesh`` DTensor moves a shard from one tensor dim
  to another as an all-gather and a local chunk (gloo has no all-to-all),
  and that is what is charged.

At a boundary under a mesh each DTensor argument is charged on its local
shards, and the output is a DTensor (``_mesh_rule``): the ECDP gives, on
each mesh dim, ``Shard`` of the last dim where the weight's N is sharded
(the activation gathered whole there), ``Partial`` where its K is (the
activation split along K; the sum's all-reduce is counted at the next
redistribution), and the activation's own placement where the weight is
whole; the grouped ECDP gives ``Partial`` where the expert dim is sharded
(each chip its own experts' rows, charged for its share of the rows) and
otherwise as the ECDP; the paged ECDPs read their page pool and tables
whole on every chip and give the activation's own placement; paged and
decode attention run on each chip's (B, H) shard, as
``sharding.per_shard`` runs attention, their (acc, m, l) placed as the
query. An activation split along K or in strided shards is gathered
first.

Not ported: the HLO parser itself (instruction def-maps, while-loop trip
counts, fusion-internal slicing, collective wire patterns), which reads
text PyTorch does not produce; a loop body counted once and charged per
trip is ``repeats``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib
import sys
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.launch import sharding as sh


@dataclasses.dataclass
class Cost:
    """Flops, bytes, and the collectives' wire bytes and counts by kind
    (``collectives``), one chip's."""
    flops: float = 0.0
    bytes: float = 0.0
    wire: dict[str, float] = dataclasses.field(default_factory=dict)
    n_collectives: float = 0.0
    collectives: dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def wire_bytes(self) -> float:
        return sum(self.wire.values())

    def add(self, other: "Cost", mult: float = 1.0):
        self.flops += other.flops * mult
        self.bytes += other.bytes * mult
        self.n_collectives += other.n_collectives * mult
        for mine, theirs in ((self.wire, other.wire),
                             (self.collectives, other.collectives)):
            for k, v in theirs.items():
                mine[k] = mine.get(k, 0.0) + v * mult

    def copy(self) -> "Cost":
        return dataclasses.replace(self, wire=dict(self.wire),
                                   collectives=dict(self.collectives))


@dataclasses.dataclass
class Counted:
    """What ``count`` returns: ``fn``'s output, its cost, the bytes of the
    arguments' distinct storages, the most bytes live at once (arguments
    included), the ops charged, the plain-version boundaries met and the
    flops by kind of op (matmul, kernel, reduction, elementwise)."""
    out: object
    cost: Cost
    argument_bytes: int
    peak_live_bytes: int
    n_ops: int
    boundaries: dict[str, int]
    flops_by_kind: dict[str, float]


# ops that move data but do no arithmetic (the reference's _FREE_OPS:
# copy, convert, gather, scatter, concatenate, pad, iota, rng, sort, ...)
_MOVE_OPS = {
    "_to_copy", "clone", "copy_", "copy", "contiguous", "cat", "stack",
    "index", "index_select", "gather", "scatter", "scatter_",
    "scatter_add", "scatter_add_", "index_put", "index_put_",
    "_index_put_impl_", "index_copy", "index_copy_", "index_add_",
    "embedding", "embedding_dense_backward", "constant_pad_nd",
    "slice_backward", "select_backward", "slice_scatter", "select_scatter",
    "flip", "roll", "repeat", "zeros", "ones", "full", "zeros_like",
    "ones_like", "full_like", "new_zeros", "new_ones", "new_full",
    "scalar_tensor", "fill_", "zero_", "fill", "arange", "lift_fresh_copy",
    "randn", "rand", "normal_", "uniform_", "randint",
    "bernoulli_", "sort", "topk", "expand_copy", "masked_select",
}
# metadata only: no bytes, no flops
_NOTHING_OPS = {"detach", "_unsafe_view", "alias", "lift_fresh", "empty",
                "empty_strided", "empty_like", "new_empty",
                "new_empty_strided", "set_", "resize_", "sym_size",
                "sym_stride", "sym_numel", "sym_storage_offset"}
# in-place writes into (a view of) a buffer, by the argument that holds
# the update: copy_'s destination is the region written; 2x its bytes
_SLICE_WRITES = {"copy_": 0, "index_put_": 2, "_index_put_impl_": 2,
                 "index_copy_": 3}
# reductions without the reduction tag
_REDUCTIONS = {"logsumexp", "cumsum", "cumprod", "var_mean", "std_mean"}
# collectives (``_c10d_functional``, its autograd forms, DTensor's
# all-to-all) by the reference's HLO names; waits and wraps are free
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd",
                          "_dtensor")
_COLLECTIVES = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "shard_dim_alltoall": "all-to-all",
}
_FREE_COLLECTIVE_OPS = {"wait_tensor", "_wrap_tensor_autograd"}


def _nbytes(t: torch.Tensor) -> int:
    """Bytes a read of ``t`` touches: its stored elements (a stride-0,
    broadcast dim counts once)."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride:
            n *= size
    return n * t.element_size()


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (one chip's tensor); any other tensor as it
    is."""
    return t._local_tensor if sh.is_dtensor(t) else t


def wire_bytes(op: str, operand: float, result: float) -> float:
    """Bytes a chip sends for one collective (``hlo_cost.py:206-224``)."""
    if op == "all-reduce":
        return 2.0 * result
    if op == "reduce-scatter":
        return float(operand or result)
    if op == "all-gather":
        return float(max(result - operand, operand))
    return float(result)                 # all-to-all, collective-permute


def _group_size(func, args, kwargs) -> int:
    """The size of the process group a collective names."""
    from torch.distributed.distributed_c10d import _resolve_process_group
    names = [a.name for a in func._schema.arguments]
    i = names.index("group_name")
    name = kwargs.get("group_name", args[i] if i < len(args) else None)
    return _resolve_process_group(name).size()


def _tensors(x, out=None) -> list:
    """The tensors in ``x``: nested lists, tuples, dicts and dataclasses (a
    ``FlashWeight``'s three planes)."""
    out = [] if out is None else out
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _tensors(v, out)
    elif isinstance(x, dict):
        for v in x.values():
            _tensors(v, out)
    elif dataclasses.is_dataclass(x) and not isinstance(x, type):
        for f in dataclasses.fields(x):
            _tensors(getattr(x, f.name), out)
    return out


def _storages(args) -> dict[int, int]:
    """{id: bytes} of the distinct storages of ``args``' tensors (a
    DTensor's local shard's)."""
    live: dict[int, int] = {}
    for t in _tensors(args):
        st = _local(t).untyped_storage()
        live.setdefault(id(st), st.nbytes())
    return live


def argument_bytes(args) -> int:
    """The bytes of ``args``' distinct storages, one chip's: what ``count``
    reports as ``argument_bytes``."""
    return sum(_storages(args).values())


# --- the kernels' plain versions, counted at their boundaries ----------------

def _f32(*shape, like):
    return torch.empty(shape, dtype=torch.float32, device=like.device)


def _ecdp(a, wq, *_, **__):
    m, k = a.shape
    n = wq.shape[-1]
    return _f32(m, n, like=a), 2.0 * m * k * n


def _grouped_ecdp(a, row_start, wq, *_, **__):
    r, k = a.shape
    n = wq.shape[-1]
    return _f32(r, n, like=a), 2.0 * r * k * n


def _paged_ecdp(a, pool, q_tbl, p_slots, s_slots, kn, *_, **__):
    m, k = a.shape
    n = int(kn[1])
    return _f32(m, n, like=a), 2.0 * m * k * n


def _grouped_paged_ecdp(a, row_start, pool, q_tbl, p_slots, s_slots, kn,
                        *_, **__):
    r, k = a.shape
    n = int(kn[1])
    return _f32(r, n, like=a), 2.0 * r * k * n


def _attn_state(q, rows: int):
    """(acc, m, l) of an attention kernel over grouped queries q (B, KV,
    R, Dh) against ``rows`` key rows, and QK^T + PV's flops."""
    b, kv, r, dh = q.shape
    return ((_f32(b, kv, r, dh, like=q), _f32(b, kv, r, like=q),
             _f32(b, kv, r, like=q)), 4.0 * b * kv * r * rows * dh)


def _paged_attn(q, k_pool, v_pool, block_tables, *_, **__):
    return _attn_state(q, block_tables.shape[1] * k_pool.shape[1])


def _decode_attn(q, k_cache, *_, **__):
    return _attn_state(q, k_cache.shape[1])


# --- the boundaries under a mesh ---------------------------------------------

def _companion(pls_w, k_dim, is_scale: bool):
    """Placements of a FlashWeight's parity (shards as the weight) or
    scale (one row: shards as the weight but along K) matching
    ``pls_w``."""
    from torch.distributed.tensor import Replicate
    return [p if p.is_shard() and not (is_scale and p.dim == k_dim)
            else Replicate() for p in pls_w]


def _mesh_ecdp(args, mesh, grouped: bool):
    """The ECDP (grouped: over an (E, K, N) bank, ``row_start`` second)
    on local shards: (local args, output placements, the share of the
    rule's flops this chip does)."""
    from torch.distributed.tensor import Replicate
    i = 2 if grouped else 1
    a, wq, parity, scale = (sh.replicated(t, mesh)
                            for t in args[:1] + args[i:i + 3])
    n_dim, k_dim = wq.ndim - 1, wq.ndim - 2
    need, out = sh.product_placements(a.placements, wq.placements, 1,
                                      k_dim, n_dim)
    local = [a.redistribute(mesh, need).to_local(), wq.to_local(),
             parity.redistribute(mesh, _companion(
                 wq.placements, k_dim, False)).to_local(),
             scale.redistribute(mesh, _companion(
                 wq.placements, k_dim, True)).to_local()]
    share = 1.0
    if grouped:
        rows = sh.replicated(args[1], mesh)
        local.insert(1, rows.redistribute(
            mesh, [Replicate()] * mesh.ndim).to_local())
        share = wq.to_local().shape[0] / wq.shape[0]
    return local + list(args[i + 3:]), out, share


def _mesh_paged_ecdp(args, mesh):
    """The paged ECDPs: the page pool and its tables (and the grouped
    form's ``row_start``) whole on every chip, the activation rows as they
    are placed (gathered if split along K)."""
    from torch.distributed.tensor import Replicate
    whole = [Replicate()] * mesh.ndim
    a = sh.replicated(args[0], mesh)
    need, out = sh.product_placements(a.placements, whole, 1, 0, 1)
    rest = [sh.replicated(t, mesh).redistribute(mesh, whole).to_local()
            if isinstance(t, torch.Tensor) else t for t in args[1:]]
    return [a.redistribute(mesh, need).to_local()] + rest, out, 1.0


# (batch dim, head dim) of each attention kernel's tensor arguments, in
# order: q (B, KV, R, Dh), then the K / V caches (B, S, KV, Dh) or pools
# (blocks, block, KV, Dh), then the lengths or the block tables and lengths
_ATTN_DIMS = {"decode_attn_plain": ((0, 1), (0, 2), (0, 2), (0, None)),
              "paged_attn_plain": ((0, 1), (None, 2), (None, 2), (0, None),
                                   (0, None))}


def _mesh_attn(name, args, mesh):
    """Attention on each chip's (B, H) shard: per mesh dim, the query's
    shard of its batch or head dim kept where every other tensor argument
    is split along its own such dim (or has none and is whole), else
    everything whole there; (acc, m, l) placed as the query."""
    from torch.distributed.tensor import Replicate, Shard
    dims = _ATTN_DIMS[name]
    ts = [sh.replicated(t, mesh) for t in args[:len(dims)]]
    pls = [[] for _ in ts]
    for i in range(mesh.ndim):
        keep = None
        for role in (0, 1):
            if ts[0].placements[i] == Shard(dims[0][role]) and all(
                    t.placements[i] == (Shard(d[role]) if d[role] is not None
                                        else Replicate())
                    for t, d in zip(ts[1:], dims[1:])):
                keep = role
        for j, d in enumerate(dims):
            pls[j].append(Replicate() if keep is None or d[keep] is None
                          else Shard(d[keep]))
    local = [t.redistribute(mesh, p).to_local() for t, p in zip(ts, pls)]
    return local + list(args[len(dims):]), pls[0], 1.0


_MESH_RULES = {
    "ecdp_matmul_plain": lambda a, m: _mesh_ecdp(a, m, False),
    "grouped_ecdp_plain": lambda a, m: _mesh_ecdp(a, m, True),
    "paged_ecdp_matmul_plain": _mesh_paged_ecdp,
    "grouped_paged_ecdp_plain": _mesh_paged_ecdp,
    "paged_attn_plain": lambda a, m: _mesh_attn("paged_attn_plain", a, m),
    "decode_attn_plain": lambda a, m: _mesh_attn("decode_attn_plain", a, m),
}


def _mesh_rule(name, rule, args, kwargs):
    """A boundary with DTensor arguments: (its outputs as DTensors, this
    chip's flops, the local tensors charged) by ``_MESH_RULES[name]``."""
    mesh = next(t for t in _tensors(args) if sh.is_dtensor(t)).device_mesh
    local, pls, share = _MESH_RULES[name](list(args), mesh)
    kwargs = {k: _local(v) if isinstance(v, torch.Tensor) else v
              for k, v in kwargs.items()}
    out, flops = rule(*local, **kwargs)
    wrapped = (sh.from_shard(out, mesh, pls) if isinstance(out, torch.Tensor)
               else type(out)(sh.from_shard(t, mesh, pls) for t in out))
    return wrapped, flops * share, _tensors((local, kwargs)) + _tensors(out)


# (module, plain function, its outputs and flops from its arguments)
BOUNDARIES = (
    ("repro_torch.kernels.ecdp", "ecdp_matmul_plain", _ecdp),
    ("repro_torch.kernels.grouped_ecdp", "grouped_ecdp_plain",
     _grouped_ecdp),
    ("repro_torch.kernels.paged_ecdp", "paged_ecdp_matmul_plain",
     _paged_ecdp),
    ("repro_torch.kernels.paged_ecdp", "grouped_paged_ecdp_plain",
     _grouped_paged_ecdp),
    ("repro_torch.kernels.paged_attn", "paged_attn_plain", _paged_attn),
    ("repro_torch.kernels.decode_attn", "decode_attn_plain", _decode_attn),
)


_FREE, _NOTHING, _MATMUL, _MOVE, _REDUCE, _ELEMENTWISE, _COLLECTIVE = (
    "free", "nothing", "matmul", "move", "reduction", "elementwise",
    "collective")


def _kind(func) -> tuple[str, str]:
    """(how an op is charged, its name)."""
    name = func._schema.name.split("::")[-1]
    if func.namespace in _COLLECTIVE_NAMESPACES:
        if name in _COLLECTIVES:
            return _COLLECTIVE, name
        if name in _FREE_COLLECTIVE_OPS:
            return _FREE, name
    if func.namespace == "prim" or func.is_view:
        return _FREE, name
    if name in _NOTHING_OPS:
        return _NOTHING, name
    if func._overloadpacket in flop_registry:
        return _MATMUL, name
    if name in _MOVE_OPS:
        return _MOVE, name
    if torch.Tag.reduction in func.tags or name in _REDUCTIONS:
        return _REDUCE, name
    return _ELEMENTWISE, name


class _Counter(TorchDispatchMode):
    def __init__(self, args, skip_fake: bool = False):
        super().__init__()
        from torch._subclasses.fake_tensor import FakeTensor
        self.skip_fake, self.fake_type = skip_fake, FakeTensor
        self.dtensor_type = sh.dtensor_type()
        self.cost = Cost()
        self.n_ops = 0
        self.boundaries: dict[str, int] = {}
        self.by_kind: dict[str, float] = {}
        self.kinds: dict = {}
        self.live = _storages(args)         # id(storage) -> its bytes
        self.argument_bytes = sum(self.live.values())
        self.live_bytes = self.peak = self.argument_bytes

    def _released(self, key: int):
        self.live_bytes -= self.live.pop(key, 0)

    def track(self, outs: list):
        for t in outs:
            st = _local(t).untyped_storage()
            key = id(st)
            if key in self.live:
                continue
            nb = st.nbytes()
            self.live[key] = nb
            self.live_bytes += nb
            weakref.finalize(st, self._released, key)
        if self.live_bytes > self.peak:
            self.peak = self.live_bytes

    def charge(self, kind: str, flops: float, ins: list, outs: list,
               update=None):
        """One op of ``kind``: its flops, and its bytes by the rules above
        (``update``: the tensor an in-place slice write writes)."""
        self.n_ops += 1
        self.cost.flops += flops
        if flops:
            self.by_kind[kind] = self.by_kind.get(kind, 0.0) + flops
        if update is not None:
            self.cost.bytes += 2.0 * _nbytes(update)
        elif ins is not None:
            self.cost.bytes += (sum(_nbytes(t) for t in ins)
                                + sum(_nbytes(t) for t in outs))

    def collective(self, name: str, ins: list, outs: list):
        """One collective: its wire bytes under its reference name, one
        more collective, its result's bytes."""
        op = _COLLECTIVES[name]
        result = sum(_nbytes(t) for t in outs)
        self.n_ops += 1
        self.cost.wire[op] = self.cost.wire.get(op, 0.0) + wire_bytes(
            op, sum(_nbytes(t) for t in ins), result)
        self.cost.n_collectives += 1
        self.cost.collectives[op] = self.cost.collectives.get(op, 0.0) + 1
        self.cost.bytes += result

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if self.dtensor_type in types:
            return NotImplemented            # DTensor runs its local ops
        kwargs = kwargs or {}
        if self.skip_fake and any(isinstance(t, self.fake_type)
                                  for t in _tensors((args, kwargs))):
            return func(*args, **kwargs)     # sharding propagation
        out = func(*args, **kwargs)
        kind, name = self.kinds.get(func) or self.kinds.setdefault(
            func, _kind(func))
        if kind == _FREE:
            return out
        outs = [out] if isinstance(out, torch.Tensor) else _tensors(out)
        if kind == _COLLECTIVE:
            if _group_size(func, args, kwargs) > 1:
                self.collective(name, _tensors((args, kwargs)), outs)
        elif kind == _NOTHING:
            self.charge(kind, 0.0, None, outs)
        else:
            ins = _tensors((args, kwargs))
            if kind == _MATMUL:
                flops = float(flop_registry[func._overloadpacket](
                    *args, **kwargs, out_val=out))
            elif kind == _MOVE:
                flops = 0.0
            elif kind == _REDUCE:
                flops = float(max((t.numel() for t in ins), default=0))
            else:
                flops = float(sum(t.numel() for t in outs))
            update = (args[_SLICE_WRITES[name]] if name in _SLICE_WRITES
                      else None)
            self.charge(kind, flops, ins, outs, update)
        self.track(outs)
        return out


def repeats(fn, counter: _Counter | None = None):
    """``fn`` as the body of a loop whose trips run the same ops on the same
    shapes (``launch/steps.make_train_step``'s microbatches; the deploy's
    per-slice quantize and encode): a later call with the same argument
    shapes returns the first one's output without running and charges
    ``counter`` the first one's cost again (XLA's while body times its
    trip count). Sound where a trip's effects are its output (the caller
    copies it or only reads its shape) and in-place updates, which fake and
    meta tensors do not hold."""
    first: dict = {}

    def body(*args, **kwargs):
        key = [(tuple(t.shape), t.dtype) for t in _tensors((args, kwargs))]
        if first.get("key") == key:
            if counter is not None:
                counter.cost.add(first["cost"])
                counter.n_ops += first["n_ops"]
                for k, v in first["by_kind"].items():
                    counter.by_kind[k] = counter.by_kind.get(k, 0.0) + v
            return first["out"]
        if counter is None:
            first.update(key=key, out=fn(*args, **kwargs))
            return first["out"]
        cost0 = counter.cost.copy()
        n0, kinds0 = counter.n_ops, dict(counter.by_kind)
        out = fn(*args, **kwargs)
        delta = counter.cost.copy()
        delta.add(cost0, -1.0)
        first.update(key=key, cost=delta, n_ops=counter.n_ops - n0, out=out,
                     by_kind={k: v - kinds0.get(k, 0.0)
                              for k, v in counter.by_kind.items()})
        return out

    return body


@contextlib.contextmanager
def loop_bodies(*targets, counter: _Counter | None = None):
    """Within: each ``(module, name)`` function is a ``repeats`` loop body
    (charging ``counter``)."""
    swaps = [(mod, name, getattr(mod, name)) for mod, name in targets]
    for mod, name, fn in swaps:
        setattr(mod, name, repeats(fn, counter))
    try:
        yield
    finally:
        for mod, name, fn in swaps:
            setattr(mod, name, fn)


def _patched(counter: _Counter):
    """(module, name, original) of every loaded port module's binding of
    a ``BOUNDARIES`` function, each replaced by its counted boundary."""
    swaps = []
    for mod_name, fn_name, rule in BOUNDARIES:
        original = getattr(importlib.import_module(mod_name), fn_name)

        def boundary(*args, _rule=rule, _name=fn_name, **kwargs):
            if any(sh.is_dtensor(t) for t in _tensors((args, kwargs))):
                out, flops, charged = _mesh_rule(_name, _rule, args, kwargs)
            else:
                out, flops = _rule(*args, **kwargs)
                charged = _tensors((args, kwargs)) + _tensors(out)
            counter.boundaries[_name] = counter.boundaries.get(_name, 0) + 1
            counter.charge("kernel", flops, charged, [])
            return out

        for mod in list(sys.modules.values()):
            if (getattr(mod, "__name__", "").startswith("repro_torch")
                    and getattr(mod, fn_name, None) is original):
                swaps.append((mod, fn_name, original))
                setattr(mod, fn_name, boundary)
    return swaps


def count(fn, *args, loops: tuple = (), skip_fake: bool = False,
          **kwargs) -> Counted:
    """Run ``fn(*args, **kwargs)`` (on fake, meta or real tensors, or
    DTensors of them) and count it. The kernels' plain versions are counted
    at their boundaries, and each ``(module, name)`` of ``loops`` is a
    ``repeats`` loop body, for the duration of the call. ``skip_fake``: ops
    on fake tensors are not charged (a meta cell on a mesh: DTensor's
    sharding propagation)."""
    counter = _Counter((args, kwargs), skip_fake)
    swaps = _patched(counter)
    try:
        with counter, loop_bodies(*loops, counter=counter):
            out = fn(*args, **kwargs)
    finally:
        for mod, name, original in swaps:
            setattr(mod, name, original)
    return Counted(out=out, cost=counter.cost,
                   argument_bytes=counter.argument_bytes,
                   peak_live_bytes=counter.peak, n_ops=counter.n_ops,
                   boundaries=counter.boundaries,
                   flops_by_kind=counter.by_kind)
