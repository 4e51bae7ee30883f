"""Carrying the JAX package's arrays into the port, as numpy.

The port never imports JAX; a caller that has both (the tests) converts
JAX arrays to numpy first (``jax.tree.map(np.asarray, tree)``) and hands
the numpy tree here. bf16 crosses as a ``uint16`` view, because
``torch.from_numpy`` rejects the ``ml_dtypes.bfloat16`` dtype JAX uses.
Like the port's other entry points, every function here puts its tensors on
``cuda`` unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.tiering import FlashWeight


def tensor_from_numpy(a, device="cuda") -> torch.Tensor:
    """One numpy array (bf16 included) -> a tensor on ``device``."""
    a = np.array(a, order="C")          # a copy; a 0-d array stays 0-d
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_numpy(tree, device="cuda"):
    """A JAX param pytree as numpy (nested dicts) -> the same tree of
    tensors: the port's param layout is the JAX one."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return tensor_from_numpy(tree, device)


def parity_from_numpy(parity, device="cuda") -> torch.Tensor:
    """A JAX parity plane -> the port's uint8 one. ``ecc.encode`` in the
    JAX package returns uint32 (its ``jnp.sum`` widens), holding bytes."""
    parity = np.asarray(parity)
    if parity.dtype != np.uint8:
        if parity.size and int(parity.max()) > 255:
            raise ValueError("parity plane holds values past one byte")
        parity = parity.astype(np.uint8)
    return tensor_from_numpy(parity, device)


def flash_from_numpy(fw, device="cuda") -> FlashWeight:
    """A JAX ``FlashWeight`` whose leaves are numpy -> the port's."""
    return FlashWeight(q=tensor_from_numpy(fw.q, device),
                       parity=parity_from_numpy(fw.parity, device),
                       scale=tensor_from_numpy(fw.scale, device))


def deployed_from_numpy(tree, device="cuda"):
    """A JAX ``deploy`` output as numpy -> the port's tiered tree
    (``FlashWeight`` leaves converted, DRAM leaves as tensors)."""
    if isinstance(tree, dict):
        return {k: deployed_from_numpy(v, device) for k, v in tree.items()}
    if hasattr(tree, "parity"):
        return flash_from_numpy(tree, device)
    return tensor_from_numpy(tree, device)
