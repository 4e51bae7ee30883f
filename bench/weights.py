"""The benchmark's weights, drawn from the seed: every leaf of a
configuration's parameter tree is cut into blocks along its leading dims
(a layer of a stacked leaf, all of one layer's experts together), and
block ``i`` of leaf ``path`` is drawn on the device from its own generator,
seeded by ``(seed, path, i)``. So the program's deployment and the
reference draw the same numbers, and the reference can redraw any one
block alone.

A leaf is ``Leaf(path, shape, init, lead, flash, ecc)``: ``init`` is
``("normal", std)`` (std ``None``: ``sqrt(2 / (K + N))`` of the trailing
matrix) or ``("const", value)``; ``lead`` how many leading dims index
blocks; ``flash`` whether the leaf lives in the flash tier, ``ecc``
whether SEC-DED corrects its reads there. The families' leaf lists are in
``reference/<family>.py``.
"""
from __future__ import annotations

import dataclasses
import hashlib
import importlib
import math

import torch


@dataclasses.dataclass(frozen=True)
class Leaf:
    path: str
    shape: tuple
    init: tuple
    lead: int = 0
    flash: bool = False
    ecc: bool = True

    @property
    def n_blocks(self) -> int:
        return math.prod(self.shape[:self.lead])

    @property
    def block_shape(self) -> tuple:
        return tuple(self.shape[self.lead:])


def family(model: dict):
    """The reference module of the configuration's family."""
    return importlib.import_module(f"bench.reference.{model['family']}")


def leaves(model: dict) -> list[Leaf]:
    return family(model).leaves(model)


def block_seed(seed: int, path: str, i: int) -> int:
    digest = hashlib.sha256(f"{seed}/{path}/{i}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def draw(leaf: Leaf, seed: int, i: int, device) -> torch.Tensor:
    """Block ``i`` of ``leaf`` as served: bf16, on ``device``."""
    shape = leaf.block_shape
    kind, value = leaf.init
    if kind == "const":
        return torch.full(shape, value, dtype=torch.bfloat16, device=device)
    std = value if value is not None else math.sqrt(
        2.0 / (shape[-2] + shape[-1]))
    gen = torch.Generator(device=device)
    gen.manual_seed(block_seed(seed, leaf.path, i))
    w = torch.randn(shape, generator=gen, device=device,
                    dtype=torch.float32)
    return w.mul_(std).to(torch.bfloat16)


def put(tree: dict, path: str, value) -> None:
    node = tree
    *parents, last = path.split("/")
    for key in parents:
        node = node.setdefault(key, {})
    node[last] = value
