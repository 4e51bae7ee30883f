#!/usr/bin/env python3
"""qwen3-moe-30b-a3b at full width and all 48 layers on one card, resident
and then streamed, through ``build_engine`` (the flash tier encoded as it
is drawn): ``chip_smoke.py``'s phase 20(b) and its streamed half, which
the smoke run leaves out for its time (the host page store's programming
of the 30.8 GiB tier alone takes about 100 s).

    python3 scripts/moe_full_depth.py

Needs one card (it builds the kernels first) and about 70 GiB of host
memory (the store's pages while they are programmed). The resident engine
(``moe_depth_build``, ``moe_depth_serve``): the build's seconds and device
peak beside the byte arithmetic, two prompts compiled, one capture, a
step's 48 x 3 grouped ECDP, 1 ECDP and 48 paged attention. Then, freed,
the streamed engine under a device budget of half the expert store
(``moe_depth_streamed``): every step's logits of the slots with lanes
bit-equal to the resident engine's, 48 x 3 grouped paged ECDP a step, ms
a step, the expert cache's hit rate, the host store's bytes and peak RSS.
Ends with the card's name and power limit and a ``moe_full_depth`` JSON
line.
"""
from __future__ import annotations

import gc
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as c  # noqa: E402


def moe_depth_streamed(torch, reference) -> dict:
    """The streamed half: the same build through ``build_engine(stream=True)``
    under a device budget of half the expert store, the same prompts:
    every step's logits of the slots with lanes bit-equal to the resident
    engine's (``reference``), each step 48 x 3 grouped paged ECDP, 1
    ECDP, 48 paged attention and no dense grouped launch; ms a step, the
    expert cache's hit rate, the host store's bytes and the peak RSS. The
    stall signal reads 0, so both engines plan the same steps (13(b))."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as serve_mod
    from repro_torch.serving.sampler import SampleConfig

    cfg = get_config(c.MOE_ARCH)
    d, f = cfg.d_model, cfg.d_ff
    experts = cfg.n_layers * cfg.n_experts * (2 * c._payload(d, f)
                                              + c._payload(f, d))
    gib = 2 ** 30
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = serve_mod.build_engine(c.MOE_ARCH, smoke=False, device="cuda",
                                 rber=1e-4, stream=True,
                                 device_budget_mib=experts / 2 / 2**20,
                                 sample_cfg=SampleConfig())
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    store = eng.store
    assert eng.streamed_moe and store.total_bytes > experts
    c.log(f"  build_engine(stream=True): {build_s:.1f} s; host store "
        f"{store.total_bytes / gib:.2f} GiB in {store.n_pages} pages "
        f"({store.n_pages * store.page_bytes / gib:.2f} GiB), budget "
        f"{eng.stream_cfg.device_budget_bytes / gib:.2f} GiB (half the "
        f"{experts / gib:.2f} GiB of experts); device peak while deploying "
        f"{peak / gib:.2f} GiB, resident "
        f"{(torch.cuda.memory_allocated() - base) / gib:.2f} GiB; the "
        f"process's host peak RSS so far {c._peak_rss_gib():.2f} GiB")
    eng._stream_stall_s = lambda: 0.0          # the resident engine's plan
    run = c._depth_run(torch, eng, [list(p) for p in reference["prompts"]],
                       c.moe_stream_counts, c.moe_stream_zero_counts)
    steps = len(run["logits"])
    per_step = {"grouped_paged_ecdp": 3 * cfg.n_layers, "grouped_ecdp": 0,
                "ecdp": 1, "paged_attn": cfg.n_layers}
    assert run["launches"] == {k: steps * n for k, n in per_step.items()}, \
        (run["launches"], steps)
    assert run["out"] == reference["out"], (run["out"], reference["out"])
    assert [{k: v for k, v in e.items() if k != "stall_frac"}
            for e in run["stats"]] == reference["stats"]
    c._same_live_logits(torch, f"{cfg.name} streamed", run, reference)
    st = eng.expert_stats()
    eng.close()
    rss = c._peak_rss_gib()
    store_bytes = store.total_bytes
    del eng, store
    gc.collect()
    torch.cuda.empty_cache()
    ms = sum(run["wall"]) / steps * 1e3
    c.log(f"  streamed: {steps} steps, {ms:.1f} ms a step; logits of the "
        f"slots with lanes and the tokens bit-equal to the resident "
        f"engine's at all {steps} steps; launches {run['launches']} = "
        f"{steps} x {per_step}; experts: hit rate "
        f"{st['expert_hit_rate']:.3f} ({st['expert_hits']} hits, "
        f"{st['expert_misses']} misses), fetched "
        f"{st['expert_bytes_fetched'] / gib:.2f} GiB, H2D "
        f"{st['pool_bytes_staged'] / gib:.2f} GiB in {st['pool_h2d_s']:.2f} "
        f"s; the process's host peak RSS {rss:.2f} GiB")
    return dict(steps=steps, build_s=build_s, build_peak_bytes=peak,
                ms_per_step=ms, step_ms=[w * 1e3 for w in run["wall"]],
                launches=run["launches"], per_step=per_step,
                store_bytes=store_bytes, expert_bytes=experts,
                budget_bytes=int(experts / 2), peak_rss_gib=rss,
                experts={k: st[k] for k in (
                    "expert_hit_rate", "expert_hits", "expert_misses",
                    "expert_bytes_fetched", "pool_h2d_s",
                    "pool_bytes_staged")})



def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("moe_full_depth: needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch.kernels import build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    c.log(f"  {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    build.build_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    resident = c.moe_depth_serve(torch, c.moe_depth_build(torch),
                                 reference=True)
    reference = dict(resident.pop("reference"), prompts=resident["prompts"])
    streamed = moe_depth_streamed(torch, reference)
    c.log(f"  resident and streamed in {time.perf_counter() - t0:.1f} s")
    print(smi, flush=True)
    print(json.dumps({"moe_full_depth": dict(resident=resident,
                                             streamed=streamed)}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
