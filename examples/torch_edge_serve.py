"""Edge serving example on the PyTorch port: the paper's decode-dominated
edge workload on the NVLLM engine — tiered INT8+ECC weights, continuous
batching over a block-paged KV pool, chunked prefill, and the
KV-cache-aware scheduler (Algorithm 2) visibly offloading Q/K/V/O
column-groups to the in-flash pipeline as contexts grow; then the flash
tier served streamed from a host page store larger than the device budget,
and speculative streaming (the same steps as ``examples/edge_serve.py``,
through ``repro_torch``).

    PYTHONPATH=src python examples/torch_edge_serve.py [--device cpu]

Each step is ONE mixed-batch step for ALL slots — prefilling slots consume
their prompt in chunks while decoding slots emit a token each step, so a
late-arriving long prompt never stalls a generation in flight. It runs on
the card unless ``--device cpu``. The params are drawn from a CPU
generator on every device, so the card and the CPU serve the same model.

The speculative part's prompt is margin-scanned on this model. A greedy
step whose two best logits nearly tie can emit different tokens in a
vanilla and a speculative engine, whose verify lanes round their sums
otherwise; the JAX example's ``[255] * 8`` was picked on the JAX init's
model, and the port's tests' ``[28] * 8`` on that model carried across.
This model is the port generator's own: over ``[t] * 8`` for t < 500,
``[201] * 8`` keeps every one of its 32 greedy tokens 0.53 logits ahead
of the next (``[28] * 8`` holds a tie within 8e-4 here).
"""
import argparse
import time

import numpy as np
import torch

import repro_torch.core.scheduler as sched
from repro_torch.configs.paper_models import OPT_TINY
from repro_torch.models import dense
from repro_torch.serving.engine import Engine
from repro_torch.serving.sampler import SampleConfig
from repro_torch.serving.spec import SpecConfig
from repro_torch.store import PageStore, StreamConfig

SPEC_PROMPT = [201] * 8                  # repetitive: drafts land


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    device = ap.parse_args(argv).device

    params = dense.init(OPT_TINY, torch.Generator().manual_seed(0),
                        device=device)
    # aggressive scheduler config so Alg. 2 is visible at toy scale
    cfg = sched.SchedulerConfig(page_buffer_bytes=128, column_bytes=128,
                                c_npu_per_column=16, h=8)   # c_th=16
    # temperature 0.7 samples inside the step: a captured step needs
    # graphs.can_capture_generator(), which a PyTorch build may lack, so
    # this engine runs eager (compiled=False)
    eng = Engine(OPT_TINY, params, max_slots=2, max_seq=192, rber=1e-4,
                 sample_cfg=SampleConfig(temperature=0.7, top_k=50),
                 sched_cfg=cfg, kv_aware=True, seed=0, device=device,
                 compiled=False,
                 admission_cfg=sched.AdmissionConfig(chunk_tokens=16,
                                                     token_budget=24))
    print(f"paged KV pool: {eng.pool.n_blocks} blocks x "
          f"{eng.pool.block_size} tokens, {eng.pool.n_slots} slots")

    rng = np.random.default_rng(0)
    print("submitting a short-prompt, long-generation workload "
          "(the edge pattern, paper Fig. 1b)...")
    r1 = eng.submit(rng.integers(1, 500, 5).tolist(), max_new=48)
    r2 = eng.submit(rng.integers(1, 500, 7).tolist(), max_new=32)
    eng.step()                        # the first step warms up
    t0 = time.perf_counter()
    n_decoded = 0
    while (n := eng.step()):
        n_decoded += n
    dt = time.perf_counter() - t0
    outs = {r.rid: r.out for r in eng.requests.values()}
    print(f"request {r1}: {len(outs[r1])} tokens; "
          f"request {r2}: {len(outs[r2])} tokens")
    print(f"decode: {n_decoded / dt:.1f} tok/s steady-state, "
          f"step traces {eng.step_traces} (-1: eager)")

    # a long prompt arriving late: chunked prefill through the SAME step
    long_prompt = rng.integers(1, 500, 64).tolist()
    r3 = eng.submit(long_prompt, max_new=8)
    chunks = 0
    while eng.requests[r3].prefilling:
        eng.step()
        chunks += 1
    eng.run()
    print(f"late 64-token prompt prefilled over {chunks} chunked steps, "
          f"then decoded {len(eng.requests[r3].out)} tokens")
    assert chunks > 1, "the late prompt must be prefilled in chunks"
    fr = [s["npu_fraction"] for s in eng.stats]
    kv = [s["kv_len"] for s in eng.stats]
    print("KV length trace:     ", kv[::6])
    print("NPU-fraction trace:  ", [f"{f:.2f}" for f in fr[::6]])
    assert fr[-1] < fr[0], "Alg. 2 should offload as the KV cache grows"
    print(f"Alg. 2 moved {100*(fr[0]-fr[-1]):.0f}% of Q/K/V/O column-groups "
          "to the in-flash ERDPE")

    # --- FlashStore: serve with the flash tier BIGGER than device memory ---
    # The paper's §3.5 deployment shape: FFN weights never materialize on
    # device as a whole — they live in the page store (host-resident "NAND
    # die") and stream under compute per layer group.
    probe = PageStore()                 # programming populates total_bytes
    Engine(OPT_TINY, params, max_slots=2, max_seq=192, weight_store=probe,
           stream_cfg=StreamConfig(pin_edges=False), device=device).close()
    budget = int(probe.total_bytes * 0.6)
    store = PageStore()
    seng = Engine(OPT_TINY, params, max_slots=2, max_seq=192, rber=0.0,
                  weight_store=store, device=device,
                  stream_cfg=StreamConfig(device_budget_bytes=budget,
                                          group_size=1))
    print(f"\nstreamed serving: flash tier {store.total_bytes/2**20:.2f} MiB "
          f"vs device weight budget {budget/2**20:.2f} MiB")
    seng.submit(rng.integers(1, 500, 6).tolist(), max_new=24)
    seng.run()
    st = seng.stream_stats()
    print(f"streamed {st['bytes_streamed']/2**20:.1f} MiB under compute "
          f"(stall {st['stall_s']*1e3:.0f} ms vs stream "
          f"{st['stream_s']*1e3:.0f} ms), {st['pages_read']} page reads over "
          f"{st['planes']} planes -> {st['nand_seconds']*1e3:.2f} ms "
          "analytical NAND time")
    assert store.total_bytes > budget, "model should exceed the budget"
    seng.close()

    # --- Speculative decoding: amortize ONE weight stream over k tokens ---
    # Streamed serving is weight-stream-bound: every decoded token pays a
    # full pass over the flash tier. With spec_cfg, the n-gram drafter
    # packs k proposals into the decoding slot's chunk lanes, ONE forward
    # pass (= one window rotation) verifies all of them, and the step
    # emits n_accept + 1 tokens — same greedy stream, fewer passes.
    def streamed(**kw):
        return Engine(OPT_TINY, params, max_slots=1, max_seq=192, rber=0.0,
                      kv_aware=False, weight_store=PageStore(),
                      device=device,
                      stream_cfg=StreamConfig(device_budget_bytes=budget,
                                              group_size=1), **kw)

    vanilla = streamed()
    vanilla.submit(list(SPEC_PROMPT), max_new=32)
    want = next(iter(vanilla.requests.values()))
    vanilla.run()
    v_steps = len(vanilla.stats)
    vanilla.close()

    spec = streamed(spec_cfg=SpecConfig(k=4))
    spec.submit(list(SPEC_PROMPT), max_new=32)
    got = next(iter(spec.requests.values()))
    spec.run()
    sp = spec.spec_stats()
    spec.close()
    assert got.out == want.out, "speculation must not change greedy tokens"
    print(f"\nspeculative streaming: the same 32 greedy tokens in "
          f"{len(spec.stats)} steps instead of {v_steps} "
          f"({100*sp['spec_acceptance_rate']:.0f}% of drafts accepted, "
          f"{sp['spec_tokens_per_step']:.2f} tokens per weight pass)")
    print("edge_serve OK")


if __name__ == "__main__":
    main()
