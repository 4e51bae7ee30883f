"""Data pipeline: deterministic, sharded, prefetching token streams — a
copy of ``repro/data/pipeline.py`` (pure numpy), so the port's batches are
the reference's byte for byte for every ``(seed, step, host_id)``.

Sources:
  * ``SyntheticLM``  — counter-based PRNG token stream (no state to shard;
                       step -> batch is a pure function, so restart/elastic
                       resume is exact by construction).
  * ``FileTokens``   — memory-mapped binary token file with epoch shuffling.

Both yield *per-host* shards of the global batch: host h of H gets rows
[h*B/H, (h+1)*B/H). A background thread prefetches ``prefetch`` batches
ahead (the access pattern is known ahead of time, so prefetch is
schedule-driven, not predictive).
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    n_hosts: int = 1
    host_id: int = 0
    seed: int = 0
    path: str | None = None      # None -> synthetic
    prefetch: int = 2

    @property
    def host_batch(self) -> int:
        assert self.global_batch % self.n_hosts == 0
        return self.global_batch // self.n_hosts


class SyntheticLM:
    """Pure-function batches: batch(step) is deterministic in (seed, step).

    The "labels" are tokens shifted by one inside the same sampled block, so
    a model CAN learn them (used by convergence tests: loss must drop).
    """

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def batch(self, step: int) -> dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, cfg.host_id]))
        b, s = cfg.host_batch, cfg.seq_len
        # Markov-ish stream: next token = (3*tok + noise) % V, learnable.
        toks = np.empty((b, s + 1), np.int32)
        toks[:, 0] = rng.integers(0, cfg.vocab_size, b)
        noise = rng.integers(0, 7, (b, s))
        for t in range(s):
            toks[:, t + 1] = (3 * toks[:, t] + noise[:, t]) % cfg.vocab_size
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


class FileTokens:
    """Binary int32 token file, sequence-chunked, shuffled per epoch."""

    def __init__(self, cfg: DataConfig):
        assert cfg.path is not None
        self.cfg = cfg
        self.tokens = np.memmap(cfg.path, dtype=np.int32, mode="r")
        self.n_seqs = (len(self.tokens) - 1) // cfg.seq_len
        if self.n_seqs < cfg.global_batch:
            raise ValueError("file too small for one global batch")

    def batch(self, step: int) -> dict[str, np.ndarray]:
        cfg = self.cfg
        steps_per_epoch = self.n_seqs // cfg.global_batch
        epoch, idx = divmod(step, steps_per_epoch)
        rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, epoch]))
        order = rng.permutation(self.n_seqs)
        rows = order[idx * cfg.global_batch:(idx + 1) * cfg.global_batch]
        rows = rows[cfg.host_id * cfg.host_batch:
                    (cfg.host_id + 1) * cfg.host_batch]
        toks = np.stack([
            self.tokens[r * cfg.seq_len: r * cfg.seq_len + cfg.seq_len + 1]
            for r in rows])
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch(step)
            step += 1


def make_source(cfg: DataConfig):
    return FileTokens(cfg) if cfg.path else SyntheticLM(cfg)


class Prefetcher:
    """Background-thread prefetch over any step->batch source; resumable
    from an arbitrary step (checkpoint restart hands us the step)."""

    def __init__(self, source, start_step: int = 0, depth: int = 2):
        self.source = source
        self.q: queue.Queue = queue.Queue(maxsize=max(depth, 1))
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        step = self._step
        while not self._stop.is_set():
            batch = self.source.batch(step)
            while not self._stop.is_set():
                try:
                    self.q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def next(self) -> tuple[int, dict[str, np.ndarray]]:
        return self.q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)
