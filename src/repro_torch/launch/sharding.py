"""Rule-based partition specs over param / batch / cache trees, and their
DTensor placements — the port of ``repro/launch/sharding.py``.

Rules are matched on tree path strings (``layers/attn/wq``); every spec
passes a **divisibility guard** that drops any axis whose mesh extent does
not divide the dim. Roles, as in the reference:

  embeddings / lm_head : vocab -> "model"
  attention wq/wk/wv   : out (heads*dh) -> "model";  wo: in -> "model"
  FFN in-projections   : hidden -> "model";  out-projections: in -> "model"
  MoE expert banks     : expert dim -> "model" (expert parallelism)
  RWKV / RG-LRU        : channel projections like FFN
  batch leading dim    : ("pod", "data")
  KV cache             : batch -> data axes, seq -> "model"

``fsdp=True`` also shards the weights' other matrix dim over the data axes;
``zero1=True`` shards the optimizer moments only over data (ZeRO-1).

A spec is a ``P``: one entry per tensor dim, each None, an axis name or a
tuple of names (``tuple(p)`` equals the reference's PartitionSpec as a
tuple). The spec functions read only ``mesh.axis_names`` and
``mesh.shape[axis]`` (``mesh_view`` gives a ``DeviceMesh`` that form), so
a shape object stands in for a mesh. ``placements(spec, mesh)`` turns a
spec into DTensor placements over a ``DeviceMesh`` (the reference's
``NamedSharding``): ``Shard(dim)`` on each mesh dim the spec names, else
``Replicate()``.

In-step hints: ``use_mesh(mesh)`` is the counterpart of the reference's
``with mesh:`` — the current mesh that ``constrain`` and
``data_group_count`` read, entered with DTensor's implicit replication so
that tensors the model makes inside (positions, masks) join DTensor
operands as replicated. ``constrain`` redistributes a DTensor to a spec
(the identity on a plain tensor and outside a mesh); ``pin_grad`` is the
identity forward and redistributes the cotangent to the spec backward.
``tp_shard_axis`` is the serving side: which axis of a page-store entry
shards for tensor-parallel streamed serving, from the same ``_RULES``.

A step over a mesh runs some of its work on local shards, where DTensor's
own ops differ between torch releases or choose badly: ``matmul`` (a
product by the specs' tensor-parallel rules, ``product_placements``, the
weight gathered along the data axes first: FSDP), ``split_last`` /
``merge_last`` (heads out of and into a projection), ``local_rows`` (a
function of each batch row by itself: a scan, a causal conv, one token's
attention), ``write_rows_`` (a decode step's cache row) and
``rows_whole_inside`` (activations flattened into rows). ``from_shard``
and ``replicated`` make DTensors of local or plain tensors.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import logging
import re
from typing import Any

import torch

from repro_torch.core.tiering import FlashWeight

log = logging.getLogger("repro_torch.sharding")

MODEL = "model"
DATA_AXES = ("pod", "data")


class P:
    """A partition spec: per tensor dim None, an axis name, or a tuple of
    axis names; a one-name tuple is kept as the name (as the reference's
    PartitionSpec keeps it). Equal to another ``P`` with the same entries;
    iterates as its entries."""
    __slots__ = ("_axes",)

    def __init__(self, *axes):
        self._axes = tuple(
            (a[0] if len(a) == 1 else tuple(a))
            if isinstance(a, (tuple, list)) else a for a in axes)

    def __iter__(self):
        return iter(self._axes)

    def __len__(self):
        return len(self._axes)

    def __getitem__(self, i):
        return self._axes[i]

    def __eq__(self, other):
        return isinstance(other, P) and self._axes == other._axes

    def __hash__(self):
        return hash(self._axes)

    def __repr__(self):
        return "P" + repr(self._axes)


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes: what the spec functions read."""
    axis_names: tuple
    shape: dict


def mesh_view(mesh):
    """``mesh`` in the form the spec functions read: a ``DeviceMesh`` as a
    ``MeshShape``; anything with ``axis_names`` and ``shape[axis]`` as it
    is."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None and not hasattr(mesh, "axis_names"):
        return MeshShape(tuple(names), dict(zip(names, mesh.shape)))
    return mesh


# --- divisibility guard -----------------------------------------------------

def _axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, (tuple, list)):
        out = 1
        for a in axis:
            out *= _axis_size(mesh, a)
        return out
    return mesh.shape[axis]


def guard(shape, spec: P, mesh, path: str = "?") -> P:
    """Drop spec axes that don't divide the dim (or aren't in the mesh)."""
    mesh = mesh_view(mesh)
    names = set(mesh.axis_names)
    out = []
    for i, axis in enumerate(spec):
        if axis is None:
            out.append(None)
            continue
        orig = tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)
        axes = tuple(a for a in orig if a in names)
        # drop trailing axes until divisible
        while axes and shape[i] % _axis_size(mesh, axes) != 0:
            axes = axes[:-1]
        if axes != orig:
            log.debug("guard: %s dim %d (%d) %s -> %s",
                      path, i, shape[i], spec[i], axes)
        if not axes:
            out.append(None)
        elif axes == orig:
            out.append(axis)
        elif len(axes) == 1:
            out.append(axes[0])
        else:
            out.append(axes)
    out += [None] * (len(shape) - len(out))        # pad to rank
    return P(*out)


# --- trees ----------------------------------------------------------------------

def _is_named(t) -> bool:
    return isinstance(t, tuple) and hasattr(t, "_fields")


def map_with_path(fn, tree, *rest, path: str = ""):
    """``fn(path, leaf, *rest_leaves)`` over a tree of nested dicts, lists,
    tuples, NamedTuples and ``FlashWeight``s, keyed as the reference's
    ``_path_str`` keys a pytree: dict keys, sequence indices, NamedTuple
    field names, a FlashWeight's children 0 / 1 / 2. A ``P`` and None are
    leaves; the structure of ``tree`` is kept."""
    def sub(key):
        return f"{path}/{key}" if path else str(key)
    if isinstance(tree, dict):
        out = {k: None for k in tree}
        for k in sorted(tree):
            out[k] = map_with_path(fn, tree[k], *(r[k] for r in rest),
                                   path=sub(k))
        return out
    if _is_named(tree):
        return type(tree)(*(
            map_with_path(fn, v, *(getattr(r, f) for r in rest),
                          path=sub(f))
            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, *(r[i] for r in rest),
                                        path=sub(i))
                          for i, v in enumerate(tree))
    if isinstance(tree, FlashWeight):
        kids = [map_with_path(fn, v, *(_flash_kids(r)[i] for r in rest),
                              path=sub(i))
                for i, v in enumerate(_flash_kids(tree))]
        return FlashWeight(*kids)
    return fn(path, tree, *rest)


def _flash_kids(w):
    return (w.q, w.parity, w.scale) if isinstance(w, FlashWeight) else w


def leaves_with_path(tree) -> list:
    """[(path, leaf)] in the reference's pytree order."""
    out = []
    map_with_path(lambda p, x: out.append((p, x)), tree)
    return out


# --- param rules --------------------------------------------------------------

# (path regex, spec over the LAST TWO dims, fsdp dim index or None)
_RULES: tuple[tuple[str, tuple, int | None], ...] = (
    (r".*(embed|pos_embed)$", (MODEL, None), 1),             # (V, D)
    (r".*lm_head(/[012])?$", (None, MODEL), 0),              # (D, V)
    (r".*attn/w[qkv]$", (None, MODEL), 0),
    (r".*cross/w[qkv]$", (None, MODEL), 0),
    (r".*(attn|cross)/wo$", (MODEL, None), 1),
    (r".*(w_gate|w_up|w_in_x|w_in_y)(/[012])?$", (None, MODEL), 0),
    (r".*(w_down|w_out)(/[012])?$", (MODEL, None), 1),
    (r".*tmix/w_[rkvg](/[012])?$", (None, MODEL), 0),
    (r".*tmix/w_o(/[012])?$", (MODEL, None), 1),
    (r".*channel_mix/w_rgate(/[012])?$", (None, MODEL), 0),
    (r".*router$", (None, None), None),
)

_EXPERT_RE = re.compile(r".*experts/.*")


def _data_axes(mesh) -> tuple:
    return tuple(a for a in DATA_AXES if a in mesh_view(mesh).axis_names)


def spec_for_param(path: str, shape, mesh, fsdp: bool = False,
                   data_axes: tuple = ("data",)) -> P:
    """The spec of one (possibly layer-stacked) param leaf."""
    ndim = len(shape)
    if ndim == 0:
        return P()
    if _EXPERT_RE.match(path):
        # (L, E, K, N) or (E, K, N): expert dim -> model; fsdp on K
        lead = [None] * (ndim - 3)
        spec = lead + [MODEL, tuple(data_axes) if fsdp else None, None]
        return guard(shape, P(*spec), mesh, path)
    for pat, last2, fsdp_dim in _RULES:
        if re.fullmatch(pat, path):
            if ndim == 1:
                return P(None)
            lead = [None] * (ndim - 2)
            last = list(last2)
            if fsdp and fsdp_dim is not None and last[fsdp_dim] is None:
                last[fsdp_dim] = tuple(data_axes)
            return guard(shape, P(*(lead + last)), mesh, path)
    return P(*([None] * ndim))


def param_specs(params: Any, mesh, fsdp: bool = False) -> Any:
    """The tree of specs matching ``params`` (tensors of any device)."""
    data_axes = _data_axes(mesh)
    return map_with_path(
        lambda path, leaf: spec_for_param(path, tuple(leaf.shape), mesh,
                                          fsdp=fsdp, data_axes=data_axes),
        params)


# --- batch / cache rules ---------------------------------------------------------

def batch_spec(shape, mesh, path: str = "batch") -> P:
    """Leading dim over ("pod", "data"); scalars replicated."""
    if len(shape) == 0:
        return P()
    spec = [_data_axes(mesh)] + [None] * (len(shape) - 1)
    return guard(shape, P(*spec), mesh, path)


def batch_specs(batch: Any, mesh) -> Any:
    return map_with_path(
        lambda path, leaf: batch_spec(tuple(leaf.shape), mesh, path), batch)


def cache_spec(path: str, shape, mesh) -> P:
    """(L, B, S, KV, Dh) KV caches / (L, B, ...) recurrent states."""
    data_axes = _data_axes(mesh)
    ndim = len(shape)
    if ndim >= 3 and re.search(r"(^|/)(k|v|ck|cv)$", path):
        # batch -> data, seq -> model (sequence-parallel decode)
        spec = [None, data_axes, MODEL] + [None] * (ndim - 3)
        return guard(shape, P(*spec), mesh, path)
    if ndim >= 2:
        spec = [None, data_axes] + [None] * (ndim - 2)
        return guard(shape, P(*spec), mesh, path)
    return P(*([None] * ndim))


def cache_specs(cache: Any, mesh) -> Any:
    return map_with_path(
        lambda path, leaf: cache_spec(path, tuple(leaf.shape), mesh), cache)


def opt_state_specs(opt_state, pspecs, mesh, zero1: bool = False):
    """``AdamWState(step, m, v)``'s specs: the moments shadow the param
    specs; ZeRO-1 adds the data axes on the first unsharded dim (of size
    > 1) of each moment."""
    data_axes = _data_axes(mesh)

    def momspec(_, spec: P, leaf):
        shape = tuple(leaf.shape)
        if not zero1:
            return guard(shape, spec, mesh, "opt")
        s = list(spec) + [None] * (len(shape) - len(spec))
        used = {a for e in s if e is not None
                for a in (e if isinstance(e, tuple) else (e,))}
        free = tuple(a for a in data_axes if a not in used)
        if free:
            for i, a in enumerate(s):
                if a is None and shape[i] > 1:
                    s[i] = free
                    break
        return guard(shape, P(*s), mesh, "opt")

    m = map_with_path(momspec, pspecs, opt_state.m)
    v = map_with_path(momspec, pspecs, opt_state.v)
    return type(opt_state)(step=P(), m=m, v=v)


# --- placements over a DeviceMesh ----------------------------------------------

def placements(spec: P, mesh) -> list:
    """DTensor placements of ``spec`` over the ``DeviceMesh`` ``mesh``: per
    mesh dim ``Shard(d)`` where the spec puts that axis on tensor dim
    ``d``, else ``Replicate()``. A dim split over several axes names them
    in the mesh's order (the major axis first), as DTensor splits it."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    dim_of = {}
    for d, axis in enumerate(spec):
        axes = () if axis is None else (
            tuple(axis) if isinstance(axis, (tuple, list)) else (axis,))
        if list(axes) != sorted(axes, key=names.index):
            raise ValueError(f"spec {spec}: axes {axes} against the mesh's "
                             f"order {names}")
        for a in axes:
            dim_of[a] = d
    return [Shard(dim_of[a]) if a in dim_of else Replicate() for a in names]


def named(specs: Any, mesh) -> Any:
    """The tree of placements matching a tree of specs."""
    return map_with_path(lambda _, s: placements(s, mesh), specs)


def distribute(tree: Any, pls: Any, mesh) -> Any:
    """``tree``'s tensors as DTensors with the placements ``pls`` (a tree
    of ``named``'s): every rank holds the full value (the same seed, the
    same bytes), so each keeps its own shards and nothing is sent — the
    counterpart of the reference's ``device_put`` onto shardings."""
    from torch.distributed.tensor import distribute_tensor

    def one(_, t, pl):
        if not isinstance(t, torch.Tensor):
            return t
        return distribute_tensor(t.to(mesh.device_type), mesh, pl,
                                 src_data_rank=None)
    return map_with_path(one, tree, pls)


@functools.cache
def dtensor_type() -> type:
    """torch's ``DTensor`` class (imported at first use)."""
    from torch.distributed.tensor import DTensor
    return DTensor


def is_dtensor(x) -> bool:
    return isinstance(x, dtensor_type())


# --- in-step hints ----------------------------------------------------------------

_CURRENT: list = []


@contextlib.contextmanager
def use_mesh(mesh):
    """The current mesh for ``constrain`` / ``data_group_count`` (the
    reference's ``with mesh:``), with DTensor's implicit replication of the
    plain tensors the model makes inside."""
    from torch.distributed.tensor.experimental import implicit_replication
    _CURRENT.append(mesh)
    try:
        with implicit_replication():
            yield mesh
    finally:
        _CURRENT.pop()


def current_mesh():
    """The mesh of the innermost ``use_mesh``, or None."""
    return _CURRENT[-1] if _CURRENT else None


def data_group_count(n_tokens: int) -> int:
    """Size of the data-parallel axis group for the MoE's grouped dispatch
    (1 outside a mesh), halved until it divides ``n_tokens``."""
    mesh = current_mesh()
    if mesh is None:
        return 1
    g = _axis_size(mesh_view(mesh), _data_axes(mesh))
    while g > 1 and n_tokens % g:
        g //= 2
    return max(g, 1)


def redistribute(x, spec: P, mesh=None):
    """DTensor ``x`` brought to ``spec`` (guarded against its shape) on
    ``mesh`` (default its own); a plain tensor as it is."""
    if not is_dtensor(x):
        return x
    mesh = mesh if mesh is not None else x.device_mesh
    return x.redistribute(mesh, placements(guard(tuple(x.shape), spec, mesh),
                                           mesh))


def whole(x):
    """A DTensor's full value as a plain tensor on every rank (gathered;
    differentiable, its gradient the same on every rank); a plain tensor
    as it is; a ``FlashWeight`` with each of its planes so."""
    if isinstance(x, FlashWeight):
        return FlashWeight(*(whole(t) for t in (x.q, x.parity, x.scale)))
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    mesh = x.device_mesh
    return x.redistribute(mesh, [Replicate()] * mesh.ndim).to_local()


def gather_data(w):
    """DTensor weight ``w`` whole along the data axes ("pod", "data"),
    its "model" shards kept: FSDP's gather before a weight is used (the
    gradient goes back to ``w``'s shards through DTensor's backward). Left
    to DTensor, a product of batch-sharded activations with a weight
    sharded along its contraction over "data" moves the activations
    instead, and every chip then holds the whole batch. Anything else as
    it is."""
    if not is_dtensor(w):
        return w
    from torch.distributed.tensor import Replicate
    names = w.device_mesh.mesh_dim_names
    pls = [Replicate() if names[i] in DATA_AXES else p
           for i, p in enumerate(w.placements)]
    if pls == list(w.placements):
        return w
    return w.redistribute(w.device_mesh, pls)


def contiguous_stride(shape) -> tuple:
    """The strides of a contiguous tensor of ``shape`` (nothing made)."""
    stride, n = [], 1
    for size in reversed(tuple(shape)):
        stride.append(n)
        n *= max(size, 1)
    return tuple(reversed(stride))


def replicated(t, mesh):
    """``t`` as a DTensor on ``mesh``: a plain tensor (the same on every
    rank) replicated; a DTensor as it is."""
    if is_dtensor(t):
        return t
    from torch.distributed.tensor import DTensor, Replicate
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def from_shard(local, mesh, pls):
    """One rank's ``local`` shard as a DTensor on ``mesh`` with placements
    ``pls``: its global shape ``local``'s times the shards, contiguous
    strides; nothing checked or sent (``DTensor.from_local`` with
    ``run_check=False``)."""
    from torch.distributed.tensor import DTensor
    shape = list(local.shape)
    for i, p in enumerate(pls):
        if p.is_shard():
            shape[p.dim] *= mesh.size(i)
    return DTensor.from_local(local, mesh, pls, run_check=False,
                              shape=torch.Size(shape),
                              stride=contiguous_stride(shape))


def split_last(x, n):
    """``x (..., n * d)`` as ``(..., n, d)`` (heads out of a projection).
    A DTensor is reshaped on its local shards: a shard of the last dim
    that splits the n blocks whole becomes a shard of the n dim, any other
    is gathered first (``fit_dim``). DTensor's own view refuses to split a
    sharded dim on some torch releases, in the backward too."""
    if not is_dtensor(x):
        return x.reshape(*x.shape[:-1], n, x.shape[-1] // n)
    x = fit_dim(x, x.ndim - 1, n)
    local = x.to_local()
    ways = x.shape[-1] // local.shape[-1]
    return from_shard(local.reshape(*local.shape[:-1], n // ways,
                                    x.shape[-1] // n), x.device_mesh,
                      list(x.placements))


def merge_last(x):
    """``x (..., n, d)`` as ``(..., n * d)`` (heads into a projection's
    input): ``split_last``'s inverse. A DTensor is reshaped on its local
    shards, a shard of the d dim gathered first."""
    if not is_dtensor(x):
        return x.reshape(*x.shape[:-2], x.shape[-2] * x.shape[-1])
    x = fit_dim(x, x.ndim - 1, 1)
    local = x.to_local()
    return from_shard(local.reshape(*local.shape[:-2], -1), x.device_mesh,
                      list(x.placements))


def rows_whole_inside(x):
    """DTensor ``x`` (B, ..., K) with every shard of a dim between the
    first and the last gathered, so that flattening its leading dims into
    rows keeps a plain shard of the rows (a sequence split by DTensor, one
    of its choices for a replicated operand, would otherwise flatten into
    strided rows), and its local shard contiguous (DTensor views a local
    shard to flatten it); anything else as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    pls = [Replicate() if p.is_shard() and 0 < p.dim < x.ndim - 1 else p
           for p in x.placements]
    if pls != list(x.placements):
        x = x.redistribute(x.device_mesh, pls)
    return from_shard(x.to_local().contiguous(), x.device_mesh, pls)


def product_placements(x_pls, w_pls, last: int, k_dim: int, n_dim: int):
    """(the activation's placements for a product, the product's) of
    activations placed ``x_pls`` (their contraction dim ``last``) with a
    weight placed ``w_pls`` (its K dim ``k_dim``, N dim ``n_dim``): per
    mesh dim, N split -> the activation whole, the product split along its
    last dim; K split -> the activation split along K, the product a
    pending sum; another weight dim split (an expert bank's) -> the
    activation whole, the product a pending sum; the weight whole -> the
    activation as it is (gathered where split along K or in strided
    shards), the product placed so."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    need, out = [], []
    for px, pw in zip(x_pls, w_pls):
        if pw.is_shard(n_dim):
            need.append(Replicate()), out.append(Shard(last))
        elif pw.is_shard(k_dim):
            need.append(Shard(last)), out.append(Partial())
        elif pw.is_shard():
            need.append(Replicate()), out.append(Partial())
        elif px.is_shard(last) or type(px) not in (Shard, Replicate,
                                                   Partial):
            need.append(Replicate()), out.append(Replicate())
        else:
            need.append(px), out.append(px)
    return need, out


def matmul(x, w):
    """``x (..., K) @ w (K, N)`` over a mesh, by ``product_placements``'
    tensor-parallel rules, on each rank's local shards, ``w`` gathered
    along the data axes first (``gather_data``). DTensor's own choice of
    a strategy would be searched op by op, may split rows it cannot put
    back, and on three mesh dims is slow to find. Differentiable: ``w``'s
    gradient is a pending sum over the mesh dims that split ``x``'s rows
    or hold a pending sum of it, ``x``'s over those that split N. Plain
    tensors are the same on every rank."""
    from torch.distributed.tensor import Partial, Replicate
    mesh = (x if is_dtensor(x) else w).device_mesh
    x, w = replicated(x, mesh), gather_data(replicated(w, mesh))
    last = x.ndim - 1
    need, out = product_placements(x.placements, w.placements, last, 0, 1)
    x_grad = [Partial() if pw.is_shard(1) else
              Replicate() if n.is_partial() else n
              for n, pw in zip(need, w.placements)]
    w_grad = [Partial() if n.is_partial() or (n.is_shard() and n.dim != last)
              else pw for n, pw in zip(need, w.placements)]
    x = x.redistribute(mesh, need)
    y = (x.to_local(grad_placements=x_grad)
         @ w.to_local(grad_placements=w_grad))
    return from_shard(y, mesh, out)


def like(t, ref):
    """Plain ``t``, the same full value on every rank, as a DTensor with
    ``ref``'s mesh and shards (each rank keeps its own; a pending sum of
    ``ref``'s is replicated); ``t`` itself when ``ref`` is a plain tensor.
    The inverse of ``whole``."""
    if not is_dtensor(ref):
        return t
    from torch.distributed.tensor import DTensor, Replicate
    mesh = ref.device_mesh
    pls = [Replicate() if p.is_partial() else p for p in ref.placements]
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim).redistribute(
        mesh, pls)


def per_shard(fn, dims: tuple, x, *rest, **kw):
    """``fn(x, *rest, **kw)`` on each rank's local shards, for a function
    that works on every index of the tensor dims ``dims`` by itself (a
    batch row, an attention head): DTensor ``x`` and ``rest`` are brought
    to one placement over each mesh dim — a shard of one of ``dims`` where
    all of them are sharded so, else whole — the function runs on their
    local tensors, and its result (shaped as ``x`` along the dims those
    placements split) is a DTensor with those placements.
    Differentiable."""
    from torch.distributed.tensor import DTensor, Replicate
    mesh = x.device_mesh
    pls = []
    for i, p in enumerate(x.placements):
        same = all(t.placements[i] == p for t in rest)
        pls.append(p if same and p.is_shard() and p.dim in dims
                   else Replicate())
    local = [t.redistribute(mesh, pls).to_local() for t in (x,) + rest]
    return DTensor.from_local(fn(*local, **kw), mesh, pls, run_check=False)


def along(fn, x, dim: int):
    """``fn(x)`` for a function that works along tensor dim ``dim`` alone
    (a roll, a pad: every other dim's index by itself, the result placed
    as ``x`` on them): a DTensor's shards along ``dim`` are gathered and
    ``fn`` runs on its local shard."""
    if not is_dtensor(x):
        return fn(x)
    x = fit_dim(x, dim, 1)
    return from_shard(fn(x.to_local()), x.device_mesh, list(x.placements))


def local_rows(fn, *rows, **whole_kw):
    """``fn(*rows, **whole_kw)`` on each rank's own batch rows, for a
    function that computes every batch row (dim 0) by itself (a scan over
    the sequence, a causal conv, one token's attention): the ``rows``
    tensors are split along dim 0 over the mesh dims that split the first
    DTensor among them so, whole along every other dim; each ``whole_kw``
    tensor (or dict of tensors: parameters) is whole. The function runs on
    local tensors, where DTensor's ops are not all available on every
    torch release; its result (a tensor or a tuple of them, batch rows
    leading) is split along dim 0 as the rows were. Without a DTensor
    among ``rows`` it is ``fn`` itself. Differentiable."""
    first = next((t for t in rows if is_dtensor(t)), None)
    if first is None:
        return fn(*rows, **whole_kw)
    from torch.distributed.tensor import Replicate, Shard
    mesh = first.device_mesh
    pls = [Shard(0) if type(p) is Shard and p.dim == 0 else Replicate()
           for p in first.placements]
    whole_ = [Replicate()] * mesh.ndim

    def local(t, placed):
        if isinstance(t, dict):
            return {k: local(v, placed) for k, v in t.items()}
        if not isinstance(t, torch.Tensor):
            return t
        return replicated(t, mesh).redistribute(mesh, placed).to_local()
    out = fn(*(local(t, pls) for t in rows),
             **{k: local(v, whole_) for k, v in whole_kw.items()})
    if isinstance(out, tuple):
        return tuple(from_shard(t, mesh, pls) for t in out)
    return from_shard(out, mesh, pls)


def write_rows_(cache, dim, index, src):
    """``cache.index_copy_(dim, index, src)``, in place. A DTensor cache
    (a step over a mesh; DTensor's own ``index_copy_`` re-labels a cache
    split along ``dim`` as whole without gathering it) is written on its
    local shards: ``src`` brought to the cache's placements, whole along
    ``dim``, and where mesh dims split the cache along ``dim`` each rank
    writes the rows of ``index`` (global positions, distinct, in one
    shard: a decode step's one row) that it holds. Nothing is sent but
    ``src``'s redistribution."""
    if not is_dtensor(cache):
        return cache.index_copy_(dim, index, src)
    from torch.distributed.tensor import Replicate
    mesh = cache.device_mesh
    pls = [Replicate() if p.is_shard(dim) else p for p in cache.placements]
    src = replicated(src, mesh).redistribute(mesh, pls).to_local().to(
        cache.dtype)
    index = whole(index).long()
    local = cache.to_local()
    split = [i for i, p in enumerate(cache.placements)
             if p.is_shard(dim) and mesh.size(i) > 1]
    if not split:
        local.index_copy_(dim, index, src)
        return cache
    chunk = 0
    for i in split:
        chunk = chunk * mesh.size(i) + mesh.get_local_rank(i)
    n = local.shape[dim]
    rows = index - chunk * n
    mine = ((rows >= 0) & (rows < n)).reshape(
        [-1 if d == dim else 1 for d in range(local.ndim)])
    rows = rows.clamp(0, n - 1)
    local.index_copy_(dim, rows, torch.where(
        mine, src, local.index_select(dim, rows)))
    return cache


def gather_rows(table, ids):
    """``table[ids]`` for a DTensor ``table`` and ids (a DTensor or a plain
    tensor, the same on every rank): the table gathered whole, indexed by
    each rank's own ids, the rows placed as the ids are (a trailing dim
    whole). The table's gradient is declared a pending sum over the mesh
    dims that split the ids (each rank's rows hold its own ids' part)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    mesh = table.device_mesh
    if is_dtensor(ids):
        id_pls, ids = ids.placements, ids.to_local()
    else:
        id_pls = [Replicate()] * mesh.ndim
    grads = [Partial() if p.is_shard() else Replicate() for p in id_pls]
    full = table.redistribute(mesh, [Replicate()] * mesh.ndim).to_local(
        grad_placements=grads)
    return DTensor.from_local(full[ids.long()], mesh, id_pls,
                              run_check=False)


def fit_dim(x, dim: int, n: int):
    """DTensor ``x`` gathered whole along tensor dim ``dim`` unless the
    mesh dims that shard it split ``n`` (the count of blocks the dim is
    about to be reshaped into) evenly; a plain tensor as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard
    mesh = x.device_mesh
    on = [i for i, p in enumerate(x.placements)
          if isinstance(p, Shard) and p.dim == dim]
    ways = 1
    for i in on:
        ways *= mesh.size(i)
    if n % ways == 0:
        return x
    pls = [Replicate() if i in on else p for i, p in enumerate(x.placements)]
    return x.redistribute(mesh, pls)


def constrain(x, *spec):
    """The reference's sharding constraint: a DTensor redistributed to
    ``P(*spec)`` (guarded) inside a mesh; the identity on a plain tensor
    and outside a mesh."""
    mesh = current_mesh()
    if mesh is None or not is_dtensor(x):
        return x
    return redistribute(x, P(*spec), mesh)


def constrain_spec(x, spec: P):
    """``constrain`` against an explicit spec."""
    return constrain(x, *spec) if len(spec) else x


class _PinGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, spec):
        ctx.spec = spec
        return w.view_as(w)

    @staticmethod
    def backward(ctx, dw):
        return redistribute(dw, ctx.spec), None


def pin_grad(w, spec):
    """Identity on ``w``; its COTANGENT redistributed to ``spec`` (the
    reference's custom-vjp pin: the partial weight gradient reduce-
    scattered to the param's shards, not all-reduced whole). The identity
    both ways on a plain tensor."""
    if not is_dtensor(w) or not w.requires_grad:
        return w
    return _PinGrad.apply(w, P(*spec))


# --- tensor-parallel streamed serving (sharded page store) --------------------

def tp_shard_axis(entry: str) -> int | None:
    """The (K, N) axis of store entry ``entry`` (``layers/ffn/w_up@3``;
    the ``@idx`` suffix is ignored) that shards for tensor-parallel
    streamed serving: 1 (column-parallel: w_gate / w_up, the d_ff axis) for
    a ``(None, MODEL)`` rule, 0 (row-parallel: w_down, the K axis, closed
    by one all-reduce) for a ``(MODEL, None)`` rule, None (replicated on
    every shard's pool) for the ``attn_flash/*`` copies and the rest."""
    base = entry.partition("@")[0]
    if base.startswith("attn_flash/"):
        return None                      # Alg.2 attn copies stay replicated
    for pat, last2, _ in _RULES:
        if re.fullmatch(pat, base):
            if last2 == (None, MODEL):
                return 1
            if last2 == (MODEL, None):
                return 0
            return None
    if _EXPERT_RE.match(base):
        # expert bank slices keep their per-matrix axis (the expert dim is
        # already split into per-entry store slices)
        leaf = base.rsplit("/", 1)[-1]
        if leaf in ("w_gate", "w_up"):
            return 1
        if leaf in ("w_down",):
            return 0
    return None
