"""Captured CUDA graphs of the port's steps — the counterpart of the
reference's ``jax.jit`` of its serving and decode steps.

A step body over tensors that keep their addresses (static inputs filled
before each call, state written in place) is captured once with
``torch.cuda.graph`` and replayed: one launch of the whole step in place
of its thousands of small launches from Python.

``capture`` first runs the body once eagerly on a side stream, as
PyTorch's recipe asks (it builds and loads the kernels and makes the
cuBLAS handles), under ``torch.cuda.set_sync_debug_mode("error")``, so a
host read left in the body raises instead of being captured. The kernel
wrappers count their launches in Python, where they launch: the warm-up's
launches and the capture's (into the graph) tick the counters, a replay
runs no Python and ticks none. A replay's kernels show in a profile of the
card, one record each. Nothing here falls back to eager: a failed capture
or replay raises.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class Captured:
    """A captured step: its graph and the outputs the body returned during
    the capture (tensors in the graph's memory pool, overwritten by each
    replay)."""
    graph: object
    outputs: object

    def replay(self):
        """Launch the graph on the current stream; returns the outputs."""
        self.graph.replay()
        return self.outputs


def can_capture_generator() -> bool:
    """Whether this build can register a ``torch.Generator`` with a graph
    (a non-greedy sampler draws inside the captured step)."""
    return hasattr(torch.cuda.CUDAGraph, "register_generator_state")


def capture(body, generator: torch.Generator | None = None) -> Captured:
    """Warm ``body()`` up once, then capture it. Call it on the stream the
    replays will run on; the capture itself runs on ``torch.cuda.graph``'s
    side stream after a device synchronise. ``generator``: a CUDA
    ``torch.Generator`` the body draws from, registered with the graph so
    each replay advances it."""
    stream = torch.cuda.current_stream()
    side = torch.cuda.Stream()
    side.wait_stream(stream)
    mode = torch.cuda.get_sync_debug_mode()
    with torch.cuda.stream(side):
        torch.cuda.set_sync_debug_mode("error")
        try:
            body()
        finally:
            torch.cuda.set_sync_debug_mode(mode)
    stream.wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    if generator is not None:
        if not can_capture_generator():
            raise RuntimeError("this PyTorch build cannot register a "
                               "generator with a CUDA graph")
        graph.register_generator_state(generator)
    with torch.cuda.graph(graph):
        outputs = body()
    return Captured(graph, outputs)
