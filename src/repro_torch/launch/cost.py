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

Not ported: the HLO parser itself (instruction def-maps, while-loop trip
counts, fusion-internal slicing, collective wire patterns), which reads
text PyTorch does not produce; a loop body counted once and charged per
trip is ``repeats``. The reference counts one chip of a 512-device mesh;
here the step runs on one card and has no collectives, so ``wire`` stays
empty until tensor parallelism (ROADMAP §A.4).
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


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0
    wire: dict[str, float] = dataclasses.field(default_factory=dict)
    n_collectives: float = 0.0

    @property
    def wire_bytes(self) -> float:
        return sum(self.wire.values())

    def add(self, other: "Cost", mult: float = 1.0):
        self.flops += other.flops * mult
        self.bytes += other.bytes * mult
        self.n_collectives += other.n_collectives * mult
        for k, v in other.wire.items():
            self.wire[k] = self.wire.get(k, 0.0) + v * mult


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


def _nbytes(t: torch.Tensor) -> int:
    """Bytes a read of ``t`` touches: its stored elements (a stride-0,
    broadcast dim counts once)."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride:
            n *= size
    return n * t.element_size()


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


_FREE, _NOTHING, _MATMUL, _MOVE, _REDUCE, _ELEMENTWISE = (
    "free", "nothing", "matmul", "move", "reduction", "elementwise")


def _kind(func) -> tuple[str, str]:
    """(how an op is charged, its name)."""
    name = func._schema.name.split("::")[-1]
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
    def __init__(self, args):
        super().__init__()
        self.cost = Cost()
        self.n_ops = 0
        self.boundaries: dict[str, int] = {}
        self.by_kind: dict[str, float] = {}
        self.kinds: dict = {}
        self.live: dict[int, int] = {}      # id(storage) -> its bytes
        for t in _tensors(args):
            st = t.untyped_storage()
            self.live.setdefault(id(st), st.nbytes())
        self.argument_bytes = sum(self.live.values())
        self.live_bytes = self.peak = self.argument_bytes

    def _released(self, key: int):
        self.live_bytes -= self.live.pop(key, 0)

    def track(self, outs: list):
        for t in outs:
            st = t.untyped_storage()
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

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        kind, name = self.kinds.get(func) or self.kinds.setdefault(
            func, _kind(func))
        if kind == _FREE:
            return out
        outs = [out] if isinstance(out, torch.Tensor) else _tensors(out)
        if kind == _NOTHING:
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
        cost0 = dataclasses.replace(counter.cost, wire=dict(counter.cost.wire))
        n0, kinds0 = counter.n_ops, dict(counter.by_kind)
        out = fn(*args, **kwargs)
        delta = dataclasses.replace(counter.cost, wire=dict(counter.cost.wire))
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
            out, flops = _rule(*args, **kwargs)
            counter.boundaries[_name] = counter.boundaries.get(_name, 0) + 1
            counter.charge("kernel", flops, _tensors((args, kwargs)),
                           _tensors(out))
            return out

        for mod in list(sys.modules.values()):
            if (getattr(mod, "__name__", "").startswith("repro_torch")
                    and getattr(mod, fn_name, None) is original):
                swaps.append((mod, fn_name, original))
                setattr(mod, fn_name, boundary)
    return swaps


def count(fn, *args, loops: tuple = (), **kwargs) -> Counted:
    """Run ``fn(*args, **kwargs)`` (on fake, meta or real tensors) and
    count it. The kernels' plain versions are counted at their boundaries,
    and each ``(module, name)`` of ``loops`` is a ``repeats`` loop body,
    for the duration of the call."""
    counter = _Counter((args, kwargs))
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
