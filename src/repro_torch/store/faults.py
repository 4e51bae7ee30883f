"""FaultPlane: deterministic NAND read-fault injection for the PageStore —
the port of ``repro/store/faults.py``. The injector draws from numpy's
``default_rng`` with the reference's seeds, so the same (config, page id,
read nonce) flips the same bits in both packages.

NVLLM's bet — FFN compute directly on raw NAND reads with integrated ECC —
only survives production if uncorrectable errors, slow reads, and worn
pages are events the serving stack absorbs, not crashes (Cambricon-LLM and
the HBF agenda both flag flash reliability as the gating concern for
flash-resident weights). ``FaultInjector`` is the chaos source: armed via
``PageStore.attach_injector``, it perturbs the READ path only — the
programmed die stays pristine, standing in for the DRAM-tier good copy
relocation re-programs from — with four deterministic, seedable fault
modes:

  * transient read-disturb bit flips (``read_rber``): a fresh Bernoulli
    draw per (page, read) — overwhelmingly single-bit, corrected by the
    Hamming(72,64) path; the rare multi-bit codeword is detected
    uncorrectable and CLEARS on re-read (the read-retry contract);
  * stuck pages (``stuck_page_rate``): a deterministic per-page-id subset
    whose every read carries >= 2 flips per hit codeword — retries never
    clear them, forcing escalation to relocation / degraded fallback;
  * slow reads (``slow_read_every``): every Nth ``read_pages`` call
    sleeps ``slow_read_s`` — the latency-outlier tail that exercises
    stall accounting and the frontend watchdog;
  * transient ``IOError`` bursts (``io_error_every``/``io_error_burst``):
    every Nth call raises for ``burst`` consecutive calls — the channel
    fault the streamer's worker must retry instead of
    poisoning their queues; a burst longer than the worker's retry
    budget forces the typed ``StoreFault`` escalation.

Faults target only ECC-PROTECTED weight payload pages (the q tiles —
the dominant ~8/9 of the image). Parity and scale runs model the stronger
metadata code real NAND controllers use and read clean; corrupting an
unprotected f32 scale would silently poison tokens with no detection
story, which is a different (checksum) design than the paper's.

Determinism: stuck membership and stuck flip positions are pure functions
of (seed, page id); transient draws are keyed on (seed, page id, a
per-page read nonce) so a RE-read of the same page gets an independent
draw (transients clear) while the overall fault mix is reproducible.
"""
from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np

from repro_torch.obs.registry import Sample


class StoreFault(RuntimeError):
    """A store/stream fetch failed past its retry budget — the typed
    escalation workers hand their consumer instead of a bare exception
    (the step loop treats it as a retryable step fault)."""


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Knobs for one ``FaultInjector``. All-zero defaults inject nothing."""
    seed: int = 0
    read_rber: float = 0.0          # per-bit transient flip prob per read
    stuck_page_rate: float = 0.0    # fraction of pages permanently UECC
    stuck_codewords: int = 4        # codewords hit per stuck-page read
    slow_read_every: int = 0        # every Nth read_pages call sleeps...
    slow_read_s: float = 0.002      # ...this long (0 disables)
    io_error_every: int = 0         # every Nth read_pages call raises...
    io_error_burst: int = 1         # ...for this many consecutive calls


class FaultInjector:
    """Deterministic read-time fault source (see module docstring).

    Thread-safe: ``read_pages`` is called from the streamer's worker and
    the engine's thread; only the counters and nonces are shared mutable
    state.
    """

    def __init__(self, cfg: FaultConfig | None = None, **kw):
        self.cfg = cfg or FaultConfig(**kw)
        self._lock = threading.Lock()
        self._calls = 0
        self._nonce: dict[int, int] = {}     # pid -> reads seen (transient key)
        self._stuck_memo: dict[int, bool] = {}
        self.transient_flips = 0
        self.stuck_reads = 0
        self.slow_reads = 0
        self.io_errors = 0

    # --- per-call gate (latency + channel faults) -----------------------------

    def pre_read(self, n_ids: int) -> None:
        """Called once per ``read_pages`` call, BEFORE any data moves:
        the slow-read sleep and the transient IOError raise."""
        cfg = self.cfg
        with self._lock:
            self._calls += 1
            c = self._calls
        if cfg.io_error_every > 0 and c >= cfg.io_error_every \
                and c % cfg.io_error_every < cfg.io_error_burst:
            # a burst starts at every Nth call and holds for ``burst``
            # consecutive calls — longer than a worker's retry budget, it
            # forces the StoreFault escalation path.
            with self._lock:
                self.io_errors += 1
            raise IOError(
                f"injected transient NAND channel fault (call {c})")
        if cfg.slow_read_every > 0 and c % cfg.slow_read_every == 0:
            with self._lock:
                self.slow_reads += 1
            time.sleep(cfg.slow_read_s)

    # --- per-page corruption --------------------------------------------------

    def is_stuck(self, pid: int) -> bool:
        """Deterministic stuck-page membership (pure in (seed, pid))."""
        if self.cfg.stuck_page_rate <= 0.0:
            return False
        hit = self._stuck_memo.get(pid)
        if hit is None:
            rng = np.random.default_rng((self.cfg.seed << 20) ^ (pid * 2 + 1))
            hit = bool(rng.random() < self.cfg.stuck_page_rate)
            self._stuck_memo[pid] = hit
        return hit

    def mark_good(self, pid: int) -> None:
        """Pin ``pid`` as not-stuck: relocation targets model a real
        controller's bad-block remapping onto VALIDATED spare blocks, so
        a re-programmed page must not roll stuck membership again (else a
        high stuck rate relocates forever)."""
        self._stuck_memo[pid] = False

    def corrupt_page(self, pid: int, row: np.ndarray) -> None:
        """Flip bits IN PLACE in one freshly-read protected page.

        ``row`` is a (page_bytes,) uint8 copy owned by the caller — the
        die data itself is never touched. Stuck damage is a pure function
        of pid (persists across re-reads); transient damage re-draws per
        read (clears on re-read)."""
        cfg = self.cfg
        if self.is_stuck(pid):
            # 2 flips inside each hit codeword: guaranteed detected-
            # uncorrectable. A codeword is 8 K-axis bytes of ONE column
            # of the (T, T) row-major tile — byte i of codeword (g, n)
            # sits at flat offset (8*g + i) * T + n, NOT contiguous.
            t = int(round(row.size ** 0.5))          # square tile side
            assert t * t == row.size, "page is not a square tile"
            rng = np.random.default_rng((cfg.seed << 21) ^ (pid * 2))
            n_cw = row.size // 8                     # (T//8 groups) * T cols
            cws = rng.choice(n_cw, size=min(cfg.stuck_codewords, n_cw),
                             replace=False)
            for cw in cws:
                g, col = int(cw) // t, int(cw) % t
                bits = rng.choice(64, size=2, replace=False)
                for b in bits:
                    row[(8 * g + b // 8) * t + col] ^= np.uint8(1 << (b % 8))
            with self._lock:
                self.stuck_reads += 1
        if cfg.read_rber > 0.0:
            with self._lock:
                nonce = self._nonce.get(pid, 0)
                self._nonce[pid] = nonce + 1
            rng = np.random.default_rng(
                (cfg.seed << 22) ^ (pid << 8) ^ nonce)
            nflip = rng.binomial(row.size * 8, cfg.read_rber)
            if nflip:
                pos = rng.choice(row.size * 8, size=nflip, replace=False)
                np.bitwise_xor.at(row, pos // 8,
                                  (1 << (pos % 8)).astype(np.uint8))
                with self._lock:
                    self.transient_flips += int(nflip)

    def stats(self) -> dict:
        with self._lock:
            return {"fault_calls": self._calls,
                    "fault_transient_flips": self.transient_flips,
                    "fault_stuck_reads": self.stuck_reads,
                    "fault_slow_reads": self.slow_reads,
                    "fault_io_errors": self.io_errors}

    def obs_samples(self):
        """ObsPlane scrape samples (lock-free: metrics reads must not
        contend with the injected read path)."""
        yield Sample("fault_calls_total", "counter", float(self._calls))
        yield Sample("fault_transient_flips_total", "counter",
                     float(self.transient_flips))
        yield Sample("fault_stuck_reads_total", "counter",
                     float(self.stuck_reads))
        yield Sample("fault_slow_reads_total", "counter",
                     float(self.slow_reads))
        yield Sample("fault_io_errors_total", "counter",
                     float(self.io_errors))
