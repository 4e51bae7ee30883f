"""Serving entry point: tiered NVLLM deployment + continuous batching + Alg. 2 —
the port of ``repro/launch/serve.py``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-8b \
        --smoke --requests 6 --max-new 12 --rber 1e-4 [--device cpu]

Deploys the model into the tiered INT8+ECC form, spins the engine with a
stream of synthetic requests, and reports tokens/s plus the KV-cache-aware
scheduler trace (NPU fraction over time). It runs on the card
(``--device cuda``, the default; the step captured in one CUDA graph)
unless ``--device cpu`` asks for the plain kernel versions.

``--stream [--device-budget-mib N]`` keeps the flash tier HOST-resident in
the page store and streams it under compute per layer group.
``--auto-depth`` re-picks the prefetch depth from the first steps'
stall/stream telemetry. ``--spec-k K [--drafter ngram|model]`` serves
SPECULATIVELY: K draft tokens per decoding slot verified in one forward
pass, emitting n_accept+1 tokens per step. ``--store-image IMAGE --ckpt
DIR`` serves a die image and DRAM-tier checkpoint written by ``deploy
--store`` (either package's). ``--serve-http PORT`` swaps the synthetic
burst for the ServeFront frontend: continuous batching behind a stdlib
HTTP server with SSE token streaming, hash-based prefix caching
(``--no-prefix-cache`` to disable), disconnect-driven cancellation, and
``--max-waiting`` backpressure. ``--fault-*`` arms read-time NAND fault
injection on the streamed store. ``--trace-out trace.json`` records the
ObsPlane Chrome trace; ``--stats-interval S`` prints a structured ``stats
{json}`` line every S seconds; the HTTP frontend also serves Prometheus
text on ``GET /v1/metrics``.

The engine serves dense- and MoE-family archs (``--arch
qwen3-moe-30b-a3b``, ``phi3.5-moe-42b-a6.6b``), resident or, with
``--stream`` / ``--store-image``, streamed: a MoE arch then pages only its
routed experts out of the store (the expert cache and its prefetcher).
``--shards S`` (with ``--stream`` / ``--store-image``) serves the streamed
plane tensor-parallel over S distinct devices of ``--device``: the page
pool and every FFN sharded — a MoE arch's routed experts each split into
S slices of d_ff, run through the grouped paged ECDP on each shard — and
one f32 all-reduce a layer; a host with fewer devices is refused, and so
is an FFN the shards cannot split into whole 128-wide tiles (the engine's
"cannot partition"). From Python, ``build_engine(...,
mesh=[dev] * S)`` runs the shards on the devices listed, which may repeat
one. Like the reference, ``--smoke`` is always on at the command line:
full width is ``build_engine(arch, smoke=False)``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import threading
import time

import numpy as np
import torch

from repro_torch.configs import OPT_TINY, get_config
from repro_torch.core.tiering import deploy_init, init_template
from repro_torch.models import family_module
from repro_torch.serving.engine import Engine
from repro_torch.serving.sampler import SampleConfig


def build_engine(arch: str = "opt-tiny", smoke: bool = True,
                 rber: float = 0.0, seed: int = 0, kv_aware: bool = True,
                 stream: bool = False,
                 device_budget_mib: float | None = None,
                 group_size: int = 1, auto_depth: bool = False,
                 spec_k: int = 0, drafter: str = "ngram",
                 adaptive_k: bool = False,
                 store_image: str | None = None, ckpt: str | None = None,
                 shards: int = 1, prefix_cache: bool = False,
                 max_waiting: int | None = None,
                 sample_cfg: SampleConfig | None = None,
                 fault_cfg=None, device="cuda", mesh=None) -> Engine:
    """Deploy ``arch`` into the tiered form and construct the serving
    engine on ``device`` — shared by the burst loop (``serve``) and the
    HTTP frontend (``--serve-http``). Params are the family's ``init``
    drawn from a generator on ``device`` seeded by ``seed``, the flash
    tier encoded as it is drawn (``tiering.deploy_init``: the tier and
    tokens are those of ``Engine(cfg, init(...))``, and no flash leaf
    exists in bf16), or, with ``store_image``, the die image's flash tier
    and the DRAM tier restored from ``ckpt``. ``fault_cfg`` (a
    store.faults FaultConfig) arms
    read-time NAND fault injection on the streamed page store — attached
    AFTER programming, so program-time rber and injected read faults
    compose. ``shards`` > 1 serves the streamed plane tensor-parallel over
    ``mesh`` (a device list, which may repeat one) or, by default, over
    ``shards`` distinct devices of ``device``'s type."""
    cfg = OPT_TINY if arch == "opt-tiny" else get_config(arch, smoke=smoke)
    if cfg.family not in ("dense", "moe"):
        raise SystemExit("engine serves dense- and moe-family archs")
    if shards > 1 and not (stream or store_image is not None):
        raise SystemExit("--shards serves through the streamed planes; "
                         "add --stream (or --store-image)")
    if shards > 1 and mesh is None:
        from repro_torch.launch.mesh import make_model_mesh
        try:
            mesh = make_model_mesh(shards, device)
        except ValueError as e:
            raise SystemExit(f"--shards {shards}: {e}") from None
    mod = family_module(cfg.family)

    def generator(s):
        return torch.Generator(device=device).manual_seed(s)

    store = stream_cfg = None
    if store_image is not None:
        # the zero-RSS deployment shape end to end: mmap the persisted die
        # image (flash tier stays on disk until its pages are read),
        # restore only the DRAM tier from the deploy checkpoint, and let
        # the engine rebuild StoreRefs from the page table.
        from repro_torch.checkpoint.manager import CheckpointManager
        from repro_torch.core.tiering import dram_tier
        from repro_torch.store import PageStore
        if ckpt is None:
            raise SystemExit("--store-image needs --ckpt (the deploy "
                             "output directory holding the DRAM tier)")
        if rber:
            raise SystemExit("--rber applies at flash-programming time; a "
                             "die image already carries its own injected "
                             "errors (re-run deploy --store with --rber)")
        store = PageStore.open(
            store_image, n_shards=(shards if shards > 1 else None))
        params, _ = CheckpointManager(ckpt).restore(
            dram_tier(init_template(cfg)), device=device)
        stream = True
    else:
        # flash leaves arrive encoded, and the engine's deploy passes them
        # through: resident, FlashWeights on ``device``; streamed, StoreRefs
        # to the host pages of ``store``, which ``deploy_init`` programs a
        # leaf at a time (the device never holds the tier)
        if stream:
            from repro_torch.store import PageStore
            store = PageStore()
        params, _ = deploy_init(cfg, generator(seed), rber=rber, seed=seed,
                                store=store, device=device)
    if stream:
        # flash tier host-resident in the page store, streamed per layer
        # group under a device weight budget, or (MoE) expert-paged by the
        # router
        from repro_torch.store import StreamConfig
        budget = (None if device_budget_mib is None
                  else int(device_budget_mib * 2**20))
        stream_cfg = StreamConfig(device_budget_bytes=budget,
                                  group_size=group_size,
                                  auto_depth=auto_depth, n_shards=shards)
    spec_cfg = draft_cfg = draft_params = None
    if spec_k > 0:
        from repro_torch.serving.spec import SpecConfig
        spec_cfg = SpecConfig(k=spec_k, drafter=drafter,
                              adaptive_k=adaptive_k)
        if drafter == "model":
            if cfg.family != "dense":
                raise SystemExit("drafter='model' needs a dense-family "
                                 "target (the draft model is dense)")
            # a ~4x-smaller resident draft model of the same family
            draft_cfg = dataclasses.replace(
                cfg, name=f"{cfg.name}-draft",
                n_layers=max(cfg.n_layers // 4, 1),
                d_model=max(cfg.d_model // 2, 64),
                n_heads=max(cfg.n_heads // 2, 1),
                n_kv_heads=max(cfg.n_kv_heads // 2, 1),
                d_ff=max(cfg.d_ff // 2, 128))
            draft_params = mod.init(draft_cfg, generator(seed + 1),
                                    device=device)
    if sample_cfg is None:
        sample_cfg = SampleConfig(temperature=0.8, top_k=40)
    eng = Engine(cfg, params, max_slots=4, max_seq=256, rber=rber,
                 sample_cfg=sample_cfg, kv_aware=kv_aware, seed=seed,
                 weight_store=store, stream_cfg=stream_cfg,
                 spec_cfg=spec_cfg, draft_cfg=draft_cfg,
                 draft_params=draft_params, prefix_cache=prefix_cache,
                 max_waiting=max_waiting, device=device, mesh=mesh)
    if fault_cfg is not None:
        if not eng.streamed:
            raise SystemExit("--fault-* injects read-time NAND faults: "
                             "they need the streamed page store (add "
                             "--stream or --store-image)")
        from repro_torch.store.faults import FaultInjector
        eng.store.attach_injector(FaultInjector(fault_cfg))
    return eng


def _start_stats_logger(line_fn, interval_s: float) -> threading.Event:
    """``--stats-interval``: a daemon thread printing one structured
    ``stats {...json...}`` line every ``interval_s`` seconds. Returns the
    stop event; a raising ``line_fn`` skips that tick only."""
    stop = threading.Event()

    def run():
        while not stop.wait(interval_s):
            try:
                print("stats " + json.dumps(line_fn()), flush=True)
            except Exception:            # noqa: BLE001 - observation only
                pass

    threading.Thread(target=run, daemon=True, name="stats-logger").start()
    return stop


def serve(arch: str = "opt-tiny", smoke: bool = True, n_requests: int = 6,
          max_new: int = 12, rber: float = 0.0, seed: int = 0,
          kv_aware: bool = True, stream: bool = False,
          device_budget_mib: float | None = None,
          group_size: int = 1, auto_depth: bool = False,
          spec_k: int = 0, drafter: str = "ngram",
          adaptive_k: bool = False,
          store_image: str | None = None, ckpt: str | None = None,
          shards: int = 1, fault_cfg=None,
          stats_interval: float = 0.0, device="cuda", mesh=None) -> dict:
    eng = build_engine(arch, smoke=smoke, rber=rber, seed=seed,
                       kv_aware=kv_aware, stream=stream,
                       device_budget_mib=device_budget_mib,
                       group_size=group_size, auto_depth=auto_depth,
                       spec_k=spec_k, drafter=drafter,
                       adaptive_k=adaptive_k, store_image=store_image,
                       ckpt=ckpt, shards=shards, fault_cfg=fault_cfg,
                       device=device, mesh=mesh)
    cfg = eng.cfg
    rng = np.random.default_rng(seed)
    # submit enqueues: the whole burst goes in up front and the engine's
    # waiting->running queue admits as slots/blocks free up
    first_tok: dict[int, int] = {}
    for _ in range(n_requests):
        prompt = rng.integers(1, cfg.vocab_size, rng.integers(3, 10)).tolist()
        eng.submit(prompt, max_new=max_new)
    t0 = time.time()
    n_processed = n_steps = 0
    stats_stop = None
    if stats_interval > 0:
        stats_stop = _start_stats_logger(
            lambda: {"ts": round(time.time(), 3),
                     "steps": eng._steps_done,
                     "waiting": len(eng.waiting),
                     "running": len(eng.pool.active),
                     "done": sum(r.done for r in eng.requests.values()),
                     "phase_s": dict(eng.timeline.summary()
                                     ["phase_seconds"])},
            stats_interval)
    while any(not r.done for r in eng.requests.values()):
        n_processed += eng.step()        # prefill lanes + decode lanes
        n_steps += 1
        for r in eng.requests.values():          # first-token step (TTFT)
            if r.out and r.rid not in first_tok:
                first_tok[r.rid] = n_steps
    dt = time.time() - t0
    if stats_stop is not None:
        stats_stop.set()
    outs = {r.rid: r.out for r in eng.requests.values()}
    n_generated = sum(len(o) for o in outs.values())
    out = {"outputs": outs, "tokens": n_generated, "seconds": dt,
           "tps": n_generated / max(dt, 1e-9),
           "processed": n_processed,
           "processed_tps": n_processed / max(dt, 1e-9),
           "stats": eng.stats,
           "ttft_steps": first_tok, "traces": eng.step_traces}
    if eng.streamed:
        out["stream"] = eng.stream_stats()
        if eng.streamed_moe:
            out["experts"] = eng.expert_stats()
    if spec_k > 0:
        out["spec"] = eng.spec_stats()
    eng.close()
    return out


def serve_http(port: int, arch: str = "opt-tiny", prefix_cache: bool = True,
               max_waiting: int = 64, step_timeout: float | None = None,
               stats_interval: float = 0.0, **engine_kw):
    """``--serve-http``: the ServeFront continuous-batching loop behind
    the stdlib HTTP frontend. Binds, prints the resolved address, and
    serves until interrupted; client disconnects cancel their requests and
    drain-close on exit serves what's left. ``step_timeout`` arms the step
    watchdog."""
    from repro_torch.runtime.fault import FaultPolicy
    from repro_torch.serving.server import ServeFront, make_http_server
    eng = build_engine(arch, prefix_cache=prefix_cache, **engine_kw)
    policy = None
    if step_timeout is not None:
        policy = FaultPolicy(max_retries=2, retry_on=(Exception,),
                             straggler_tolerance=10 ** 9,
                             timeout_s=step_timeout)
    front = ServeFront(eng, max_waiting=max_waiting, fault_policy=policy)
    server = make_http_server(front, port)
    host, bound = server.server_address[:2]
    print(f"serving {arch} on http://{host}:{bound} "
          f"(POST /v1/generate, GET /v1/stats, GET /v1/health, "
          f"GET /v1/metrics; "
          f"prefix_cache={'on' if prefix_cache else 'off'}, "
          f"max_waiting={max_waiting})", flush=True)
    stats_stop = None
    if stats_interval > 0:
        def _line(front=front):
            st = front.stats()
            return {"ts": round(time.time(), 3), "steps": st["steps"],
                    "live": st["live_handles"], "waiting": st["waiting"],
                    "running": st["running"], "finished": st["finished"],
                    "cancelled": st["cancelled"],
                    "failed": st["requests_failed"],
                    "ttft_p50_s": front._h_ttft.percentile(0.5),
                    "ttft_p95_s": front._h_ttft.percentile(0.95),
                    "tpot_p50_s": front._h_tpot.percentile(0.5)}
        stats_stop = _start_stats_logger(_line, stats_interval)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        if stats_stop is not None:
            stats_stop.set()
        server.shutdown()
        server.server_close()
        front.close(drain=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="opt-tiny")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=12)
    # None = mode default: 1e-4 normally, 0 with --store-image (injection
    # happened at deploy time; an EXPLICIT nonzero rber there is an error)
    ap.add_argument("--rber", type=float, default=None)
    ap.add_argument("--no-kv-aware", dest="kv_aware", action="store_false")
    ap.add_argument("--stream", action="store_true",
                    help="serve the flash tier from a host-resident page "
                         "store, streamed per layer group")
    ap.add_argument("--device-budget-mib", type=float, default=None,
                    help="device weight budget for --stream (window + "
                         "residency cache); default unbounded")
    ap.add_argument("--group-size", type=int, default=1,
                    help="layers per streamed group (--stream)")
    ap.add_argument("--shards", type=int, default=1,
                    help="tensor-parallel shards for --stream: the page "
                         "pool and every FFN partitioned over N devices, "
                         "each holding 1/N of every window's FFN pages")
    ap.add_argument("--auto-depth", action="store_true",
                    help="re-pick prefetch depth from the first steps' "
                         "stall/stream telemetry (--stream)")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="speculative decoding: draft tokens verified per "
                         "slot per step (0 = off)")
    ap.add_argument("--drafter", choices=("ngram", "model"), default="ngram",
                    help="draft proposer for --spec-k: in-graph prompt "
                         "lookup, or a small resident draft model")
    ap.add_argument("--adaptive-k", action="store_true",
                    help="scale each slot's verify-lane count by its "
                         "recent acceptance-rate EMA (--spec-k)")
    ap.add_argument("--store-image", default=None, metavar="IMAGE",
                    help="serve straight off a persisted NAND die image "
                         "(deploy --store): mmap'd read-only, StoreRefs "
                         "rebuilt from its page table; implies --stream")
    ap.add_argument("--ckpt", default=None,
                    help="deploy output dir holding the DRAM tier "
                         "(required with --store-image)")
    ap.add_argument("--serve-http", type=int, default=None, metavar="PORT",
                    help="run the ServeFront HTTP frontend instead of the "
                         "synthetic burst: POST /v1/generate streams "
                         "tokens as SSE, GET /v1/stats reports telemetry "
                         "(0 = pick a free port)")
    ap.add_argument("--no-prefix-cache", dest="prefix_cache",
                    action="store_false",
                    help="disable hash-based prefix caching over the "
                         "paged KV pool (--serve-http; default on)")
    ap.add_argument("--max-waiting", type=int, default=64,
                    help="backpressure bound: live requests the frontend "
                         "holds before add_request blocks (--serve-http)")
    ap.add_argument("--fault-read-rber", type=float, default=0.0,
                    help="chaos: per-bit transient read error rate "
                         "injected on every flash page read (corrected "
                         "by ECC or the read-retry path; needs --stream)")
    ap.add_argument("--fault-stuck-rate", type=float, default=0.0,
                    help="chaos: fraction of pages with STUCK "
                         "uncorrectable codewords (retry cannot clear; "
                         "escalates to relocation / DRAM fallback)")
    ap.add_argument("--fault-slow-every", type=int, default=0,
                    help="chaos: every Nth store read sleeps (tail-"
                         "latency injection; 0 = off)")
    ap.add_argument("--fault-io-every", type=int, default=0,
                    help="chaos: every Nth store read raises a transient "
                         "IOError (streamer retries absorb it; 0 = off)")
    ap.add_argument("--step-timeout", type=float, default=None,
                    help="arm the serving step watchdog: a step producing "
                         "no result within S seconds faults and retries "
                         "(--serve-http)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="ObsPlane: record Chrome trace_event spans "
                         "(engine step phases, weight-stream fetches, "
                         "pool uploads, per-plane NAND reads, request "
                         "lifecycles) and write a Perfetto-loadable "
                         "JSONL trace on exit")
    ap.add_argument("--stats-interval", type=float, default=0.0,
                    metavar="S",
                    help="ObsPlane: print one structured 'stats {json}' "
                         "line every S seconds (0 = off)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="serve on the card (kernels, captured step) or on "
                         "the CPU (plain kernel versions)")
    args = ap.parse_args()
    # the DRAM projections are full f32 GEMMs, as in the reference
    torch.backends.cuda.matmul.allow_tf32 = False
    rber = args.rber
    if rber is None:
        rber = 0.0 if args.store_image else 1e-4
    fault_cfg = None
    if (args.fault_read_rber or args.fault_stuck_rate
            or args.fault_slow_every or args.fault_io_every):
        from repro_torch.store.faults import FaultConfig
        fault_cfg = FaultConfig(read_rber=args.fault_read_rber,
                                stuck_page_rate=args.fault_stuck_rate,
                                slow_read_every=args.fault_slow_every,
                                io_error_every=args.fault_io_every)
    tracer = None
    if args.trace_out:
        from repro_torch import obs
        tracer = obs.Tracer(enabled=True)
        obs.set_default_tracer(tracer)
    try:
        if args.serve_http is not None:
            serve_http(args.serve_http, arch=args.arch,
                       prefix_cache=args.prefix_cache,
                       max_waiting=args.max_waiting, smoke=args.smoke,
                       rber=rber, kv_aware=args.kv_aware,
                       stream=args.stream,
                       device_budget_mib=args.device_budget_mib,
                       group_size=args.group_size,
                       auto_depth=args.auto_depth,
                       spec_k=args.spec_k, drafter=args.drafter,
                       adaptive_k=args.adaptive_k,
                       store_image=args.store_image, ckpt=args.ckpt,
                       shards=args.shards, fault_cfg=fault_cfg,
                       step_timeout=args.step_timeout,
                       stats_interval=args.stats_interval,
                       device=args.device)
            return
        out = serve(args.arch, smoke=args.smoke, n_requests=args.requests,
                    max_new=args.max_new, rber=rber,
                    kv_aware=args.kv_aware, stream=args.stream,
                    device_budget_mib=args.device_budget_mib,
                    group_size=args.group_size, auto_depth=args.auto_depth,
                    spec_k=args.spec_k, drafter=args.drafter,
                    adaptive_k=args.adaptive_k,
                    store_image=args.store_image, ckpt=args.ckpt,
                    shards=args.shards, fault_cfg=fault_cfg,
                    stats_interval=args.stats_interval, device=args.device)
    finally:
        if tracer is not None:
            n = tracer.export(args.trace_out)
            print(f"wrote {n} trace events to {args.trace_out} "
                  f"(load in Perfetto / chrome://tracing)")
    print(f"served {len(out['outputs'])} requests, {out['tokens']} generated "
          f"tokens in {out['seconds']:.1f}s ({out['tps']:.1f} generated "
          f"tok/s, {out['processed_tps']:.1f} processed tok/s on "
          f"{args.device}), step traces={out['traces']}")
    if "experts" in out:
        ex = out["experts"]
        print(f"expert paging: {ex['expert_hit_rate']*100:.0f}% cache hit "
              f"rate, {ex['expert_bytes_fetched']/2**20:.2f} MiB fetched "
              f"({ex['expert_bytes_per_token']/2**10:.1f} KiB/token vs "
              f"{ex['all_experts_bytes_per_token']/2**10:.1f} KiB/token "
              f"all-experts), {ex['misroute_stalls']} misroute stalls, "
              f"{ex['expert_prefetches']} prefetches, "
              f"{out['stream']['pages_read']} page reads -> "
              f"{out['stream']['nand_seconds']*1e3:.2f} ms NAND")
    elif "stream" in out:
        st = out["stream"]
        print(f"streamed {st['bytes_streamed']/2**20:.1f} MiB "
              f"(stall {st['stall_s']*1e3:.0f} ms / stream "
              f"{st['stream_s']*1e3:.0f} ms), cache {st['cache_hits']} hits "
              f"/ {st['cache_misses']} misses, {st['pages_read']} page reads "
              f"over {st['planes']} planes -> "
              f"{st['nand_seconds']*1e3:.2f} ms analytical NAND time, "
              f"prefetch depth {st['prefetch_depth']}"
              + (" (auto)" if args.auto_depth else ""))
    if args.spec_k > 0:
        sp = out["spec"]
        print(f"speculative k={args.spec_k} ({args.drafter}): "
              f"{100*sp['spec_acceptance_rate']:.0f}% drafts accepted, "
              f"{sp['spec_tokens_per_step']:.2f} tokens per verify step "
              f"({sp['spec_emitted']} tokens over "
              f"{sp['spec_verify_steps']} weight passes)")
    tt = sorted(out["ttft_steps"].values())
    print(f"TTFT (steps to first token) per request: {tt}")
    fr = [s["npu_fraction"] for s in out["stats"]]
    print(f"scheduler npu_fraction trace: {fr[:8]} ... {fr[-3:]}")


if __name__ == "__main__":
    main()
