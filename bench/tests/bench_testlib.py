"""Shared set-up of the benchmark's CPU tests: the import paths, and a
copy of the benchmark folder with tiny configurations of both families
(the port's OPT_TINY and the qwen3-moe smoke shapes) and a tiny chat mix,
to drive whole runs of the harness on the CPU."""
from __future__ import annotations

import json
import shutil
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "bench"
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

# Algorithm 2 at a page buffer that moves column groups within the tiny
# contexts (C_th = 8 cycles, a group or two every 16 rows of KV growth)
ALG2 = {"page_buffer_bytes": 4096, "column_bytes": 4096, "c_npu_per_column": 8}
ENGINE = {"max_slots": 4, "block_size": 16, "chunk_tokens": 16,
          "token_budget": 64, "kv_aware": True}
TINY = {
    "opt-tiny": {
        "family": "dense", "n_layers": 4, "d_model": 128, "n_heads": 4,
        "n_kv_heads": 4, "head_dim": 32, "d_ff": 512, "vocab_size": 512,
        "norm_type": "layer", "ffn_type": "gelu", "use_rope": False,
        "qk_norm": False, "max_seq": 512, "alg2_groups": 32, "alg2": ALG2,
        "alg2_flash_copies": True},
    "moe-tiny": {
        "family": "moe", "n_layers": 2, "d_model": 64, "n_heads": 4,
        "n_kv_heads": 2, "head_dim": 16, "d_ff": 32, "vocab_size": 512,
        "norm_type": "rms", "ffn_type": "swiglu", "use_rope": True,
        "rope_base": 10000.0, "qk_norm": True, "n_experts": 8, "top_k": 2,
        "max_seq": 256, "alg2_groups": 32, "alg2": ALG2,
        "alg2_flash_copies": False},
}
MIX = {"loop": "closed", "clients": 6,
       "prompt": {"dist": "log_uniform", "min": 8, "max": 64},
       "output": {"dist": "log_uniform", "min": 4, "max": 24}, "pool": 16}
# the long cells' shape at tiny size: one client a slot, and outputs so
# long that no second request fits the sample's token budget beside the
# longest (LONG_CHECK), as 256-512 outputs against 400 in the long cells.
# Its order is seeded, so that the longest request lands in another slot
# from seed to seed.
LONG_MIX = {"loop": "closed", "clients": 4,
            "prompt": {"dist": "uniform", "min": 32, "max": 96},
            "output": {"dist": "uniform", "min": 48, "max": 96}, "pool": 8}
LONG_CHECK = {"requests": 16, "served_tokens": 90, "min_tokens": 40}
NO_METRICS = {"end_to_end": [], "per_layer": []}


def write(path: Path, obj) -> None:
    path.write_text(json.dumps(obj, indent=1))


def tiny_bench(tmp: Path, limits: dict) -> Path:
    """A copy of the benchmark folder under ``tmp`` with the cells
    ``opt-tiny.tiny-chat``, ``moe-tiny.tiny-chat``, ``opt-tiny.tiny-long``
    and ``moe-tiny.tiny-long``."""
    bench = tmp / "bench"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    for name, model in TINY.items():
        write(bench / "configs" / f"{name}.json",
              {"name": name, "source": "test", "config": {},
               "changed_from_source": {}, "model": model,
               "precision": {"rber": 1e-3},
               "engine": dict(ENGINE, max_seq=model["max_seq"])})
        write(bench / "workloads" / f"{name}.tiny-chat.json",
              {"config": name, "traffic": "tiny-chat", "chips": 1,
               "warmup_limit_s": 300,
               "check": {"requests": 24, "served_tokens": 300,
                         "min_tokens": 100, "limits": limits},
               "trace": {"segments": 1, "steps": 4}})
        write(bench / "workloads" / f"{name}.tiny-long.json",
              {"config": name, "traffic": "tiny-long", "chips": 1,
               "warmup_limit_s": 300,
               "check": dict(LONG_CHECK, limits=limits),
               "trace": {"segments": 1, "steps": 4}})
    write(bench / "traffic" / "tiny-chat.json", MIX)
    write(bench / "traffic" / "tiny-long.json", LONG_MIX)
    return bench


def run(bench: Path, cell: str, seed: int = 7, seconds: float = 2.0,
        benchmark=NO_METRICS, log=lambda *a: None, **kw) -> dict:
    from bench import harness

    return harness.run_cell(cell, seed, seconds, False, time.perf_counter(),
                            device="cpu", bench=bench, benchmark=benchmark,
                            log=log, **kw)
