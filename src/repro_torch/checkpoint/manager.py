"""Checkpointing: atomic, versioned, async — the port of
``repro/checkpoint/manager.py``, reading and writing its on-disk format
byte for byte, so a checkpoint written by either package restores in the
other.

Layout (one directory per step):
    <root>/step_00000100/
        manifest.json        tree structure + dtypes + shapes + step + extras
        arrays.npz           flat {index -> host numpy array}
    <root>/LATEST            text file: last durable step directory name

Guarantees:
  * atomic: writes go to a tmp dir, fsync'd, then os.rename (POSIX atomic) —
    a crash mid-save never corrupts LATEST.
  * device-independent: arrays are stored as full host arrays; ``restore``
    puts them on the ``device`` the new job asks for.
  * async: ``save_async`` snapshots to host memory synchronously and
    writes in a background thread.
  * retention: keep the last ``keep`` checkpoints.
  * sharded state: a state with DTensor leaves (training over a mesh) is
    saved by every rank of the process group together: each leaf's full
    value is gathered (``full_tensor``) in the calling thread, rank 0
    writes the same bytes as an unsharded save, and the others wait for it
    at a barrier (after ``save``, or at the ``wait`` that joins a
    ``save_async``). ``restore(template, placements=, mesh=)`` puts the
    arrays onto a mesh (the reference's ``shardings=``).

A state is a tree of nested dicts, tuples, NamedTuples (the optimizer's
``AdamWState``), lists, ``None`` and ``FlashWeight``s over tensor (or
numpy, or Python scalar) leaves. Leaves
are stored in JAX's pytree order (dict keys sorted; a FlashWeight's
children ``(q, parity, scale)``), and the manifest's ``treedef`` is the
string ``str(jax.tree_util.tree_structure(tree))`` would give, built here
without JAX; ``restore`` refuses a template whose string differs. bf16 is
stored as a ``uint16`` view and re-viewed from the manifest's ``dtypes``.
The JAX deploy's parity planes are ``uint32`` holding bytes (its encoder's
sum widens), the port's ``uint8``: a FlashWeight's parity is written
widened to ``uint32`` and narrowed on restore, so a deployed tree's
checkpoint is the JAX package's, byte for byte.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.tiering import FlashWeight
from repro_torch.launch.sharding import distribute, is_dtensor

# npz cannot round-trip bf16 / fp8 (numpy has no such dtypes): they are
# stored as a same-width integer view, named in the manifest by the JAX
# package's dtype names.
_VIEW_AS = {torch.bfloat16: ("bfloat16", np.uint16, torch.int16),
            torch.float8_e4m3fn: ("float8_e4m3fn", np.uint8, torch.uint8),
            torch.float8_e5m2: ("float8_e5m2", np.uint8, torch.uint8)}
_FROM_NAME = {name: (torch_dt, np_view)
              for torch_dt, (name, np_view, _) in _VIEW_AS.items()}
_FLASH_NODE = "CustomNode(FlashWeight[None], [*, *, *])"


def _flatten(tree: Any) -> tuple[list, str]:
    """(leaves, treedef token) in JAX's pytree order and notation; each
    leaf as (leaf, widen), widen set on a FlashWeight's parity."""
    leaves: list = []

    def rec(t) -> str:
        if t is None:
            return "None"
        if isinstance(t, dict):
            keys = sorted(t)
            return "{" + ", ".join(f"{k!r}: {rec(t[k])}" for k in keys) + "}"
        if isinstance(t, tuple) and hasattr(t, "_fields"):   # NamedTuple
            inner = ", ".join(rec(v) for v in t)
            return f"CustomNode(namedtuple[{type(t).__name__}], [{inner}])"
        if isinstance(t, tuple):
            inner = ", ".join(rec(v) for v in t)
            return "(" + inner + ("," if len(t) == 1 else "") + ")"
        if isinstance(t, list):
            return "[" + ", ".join(rec(v) for v in t) + "]"
        if isinstance(t, FlashWeight):
            leaves.extend(((t.q, False), (t.parity, True), (t.scale, False)))
            return _FLASH_NODE
        leaves.append((t, False))
        return "*"

    token = f"PyTreeDef({rec(tree)})"
    return leaves, token


def _treedef_token(tree: Any) -> str:
    return _flatten(tree)[1]


def _to_host(leaf, widen: bool) -> tuple[np.ndarray, str]:
    """One leaf -> (the array npz stores, the manifest's dtype name);
    ``widen``: a parity plane, stored as uint32. Always a copy: ``.cpu()``
    of a CPU tensor is the tensor itself, and a train step updates its
    params and moments in place while ``save_async`` writes them."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True).contiguous()
        if t.dtype in _VIEW_AS:
            name, np_view, t_view = _VIEW_AS[t.dtype]
            return t.view(t_view).numpy().view(np_view), name
        a = t.numpy()
    else:
        a = np.array(leaf, order="C")       # keeps a 0-d leaf 0-d
    if widen:
        a = a.astype(np.uint32)
    return a, str(a.dtype)


def _from_host(a: np.ndarray, name: str, device) -> torch.Tensor:
    if name in _FROM_NAME:
        torch_dt, np_view = _FROM_NAME[name]
        a = a.view(np_view)
        t = torch.from_numpy(np.array(a.view(np.int16 if np_view == np.uint16
                                             else np.uint8), order="C"))
        return t.view(torch_dt).to(device)
    return torch.from_numpy(np.array(a, order="C")).to(device)


def _narrow_parity(a: np.ndarray) -> np.ndarray:
    if a.dtype != np.uint8:
        if a.size and int(a.max()) > 255:
            raise ValueError("parity plane holds values past one byte")
        a = a.astype(np.uint8)
    return a


def _unflatten(template: Any, host: list, dtypes: list, device) -> Any:
    """Rebuild ``template``'s structure from the stored leaves."""
    it = iter(zip(host, dtypes))

    def leaf():
        a, name = next(it)
        return _from_host(a, name, device)

    def rec(t):
        if t is None:
            return None
        if isinstance(t, dict):
            # children in sorted-key order, the dict in the template's
            out = {k: None for k in t}
            for k in sorted(t):
                out[k] = rec(t[k])
            return out
        if isinstance(t, tuple) and hasattr(t, "_fields"):   # NamedTuple
            return type(t)(*(rec(v) for v in t))
        if isinstance(t, (tuple, list)):
            return type(t)(rec(v) for v in t)
        if isinstance(t, FlashWeight):
            q = leaf()
            a, _ = next(it)
            parity = torch.from_numpy(np.array(_narrow_parity(a),
                                               order="C")).to(device)
            return FlashWeight(q=q, parity=parity, scale=leaf())
        return leaf()

    return rec(template)


class CheckpointManager:
    def __init__(self, root: str | os.PathLike, keep: int = 3):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._lock = threading.Lock()
        self._pending: threading.Thread | None = None
        self._barrier = False       # a sharded save_async not yet joined

    # --- save ------------------------------------------------------------------

    def _step_dir(self, step: int) -> Path:
        return self.root / f"step_{step:08d}"

    def _snapshot(self, state: Any):
        """(host leaves or None, treedef token, sharded): a sharded state's
        leaves are gathered on every rank (a collective), and only rank 0
        keeps host copies (it alone writes)."""
        leaves, token = _flatten(state)
        sharded = any(is_dtensor(x) for x, _ in leaves)
        if sharded:
            full = [(x.full_tensor() if is_dtensor(x) else x, w)
                    for x, w in leaves]
            if dist.get_rank() != 0:
                return None, token, True
            leaves = full
        host = [_to_host(*x) for x in leaves]       # device->host snapshot
        return host, token, sharded

    def save(self, step: int, state: Any, extras: dict | None = None):
        """Blocking save. ``state`` is any tree of tensors (see above).
        Joins a pending ``save_async`` first, so an older step's write never
        lands after this one's (LATEST would go back to it). A sharded
        state: every rank calls it, and it returns on each once the write
        is durable."""
        self.wait()
        host, token, sharded = self._snapshot(state)
        if host is not None:
            self._write(step, host, token, extras or {})
        if sharded:
            dist.barrier()

    def save_async(self, step: int, state: Any, extras: dict | None = None):
        """Snapshot now, write in background. Joins any previous pending write
        first (at most one write in flight — bounded host memory). A
        sharded state: every rank calls it (and, later, ``wait``)."""
        self.wait()
        host, token, sharded = self._snapshot(state)
        self._barrier = sharded
        if host is None:
            return

        def work():
            self._write(step, host, token, extras or {})

        self._pending = threading.Thread(target=work, daemon=True)
        self._pending.start()

    def wait(self):
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if self._barrier:
            self._barrier = False
            dist.barrier()

    def _write(self, step: int, host_leaves, token: str, extras: dict):
        with self._lock:
            final = self._step_dir(step)
            tmp = self.root / f".tmp_step_{step:08d}"
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            np.savez(tmp / "arrays.npz",
                     **{str(i): a for i, (a, _) in enumerate(host_leaves)})
            manifest = {
                "step": step,
                "treedef": token,
                "n_leaves": len(host_leaves),
                "extras": extras,
                "shapes": [list(a.shape) for a, _ in host_leaves],
                "dtypes": [name for _, name in host_leaves],
            }
            (tmp / "manifest.json").write_text(json.dumps(manifest))
            for f in tmp.iterdir():                     # durability
                with open(f, "rb") as fh:
                    os.fsync(fh.fileno())
            if final.exists():
                shutil.rmtree(final)
            os.rename(tmp, final)
            latest_tmp = self.root / ".LATEST.tmp"
            latest_tmp.write_text(final.name)
            os.rename(latest_tmp, self.root / "LATEST")
            self._gc()

    def _gc(self):
        steps = sorted(self.all_steps())
        for s in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # --- restore -----------------------------------------------------------------

    def all_steps(self) -> list[int]:
        return [int(p.name.split("_")[1]) for p in self.root.glob("step_*")]

    def latest_step(self) -> int | None:
        latest = self.root / "LATEST"
        if latest.exists():
            name = latest.read_text().strip()
            if (self.root / name / "manifest.json").exists():
                return int(name.split("_")[1])
        steps = self.all_steps()
        return max(steps) if steps else None

    def restore(self, template: Any, step: int | None = None,
                device="cuda", placements: Any = None,
                mesh=None) -> tuple[Any, dict]:
        """Restore into the structure of ``template`` (its leaves are read
        for nothing but their place), every tensor on ``device``; with a
        ``mesh`` (a ``DeviceMesh``) every tensor a DTensor on it with the
        placements of its leaf in ``placements`` (a tree of
        ``launch.sharding.named``'s, the template's structure): each rank
        reads the full arrays and keeps its own shards."""
        if mesh is not None:
            device = mesh.device_type
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.root}")
        d = self._step_dir(step)
        manifest = json.loads((d / "manifest.json").read_text())
        t_leaves, token = _flatten(template)
        if manifest["treedef"] != token:
            raise ValueError("checkpoint tree structure mismatch")
        with np.load(d / "arrays.npz") as z:
            host = [z[str(i)] for i in range(manifest["n_leaves"])]
        if len(host) != len(t_leaves):
            raise ValueError("leaf count mismatch")
        out = _unflatten(template, host, manifest["dtypes"], device)
        if mesh is not None:
            out = distribute(out, placements, mesh)
        return out, manifest["extras"]
