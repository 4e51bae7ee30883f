"""One run of one cell: deploy the configuration from the seed, serve the
cell's traffic through the captured resident engine until it is steady,
measure a window, read the profile (``trace``), check the window's output
against the plain reference, and return the result line.

Everything a cell needs is found by name: ``workloads/<cell>.json`` names
its configuration (``configs/<config>.json``) and traffic mix
(``traffic/<traffic>.json``); the benchmark's ``BENCHMARK.json`` lists the
metrics, each read by ``end_to_end/<name>.py`` or ``metrics/<name>.py``
(``read(ctx)``, None when there is nothing to read).
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import sys
import time
from pathlib import Path

from bench import check, devtrace, roofline, stats, traffic
from bench import weights as wts

HERE = Path(__file__).resolve().parent

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Record:
    """One request as its client saw it."""
    index: int
    client: int
    rid: int
    prompt: list
    max_new: int
    submit: float
    stamps: list = dataclasses.field(default_factory=list)
    segs: list = dataclasses.field(default_factory=list)
    out: list = dataclasses.field(default_factory=list)
    done: float | None = None
    slot: int | None = None           # the engine's slot that served it


@dataclasses.dataclass
class StepRow:
    """One engine step of the window: the engine's host phases, the
    clients' own host seconds around it, its work, and the (start, end)
    CUDA events around its replay (``trace``)."""
    phases: dict
    bench_s: float
    work: object                      # roofline.Step
    replay: object = None


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


def load_cell(name: str, bench: Path = HERE):
    cell = load_json(bench / "workloads" / f"{name}.json")
    config = load_json(bench / "configs" / f"{cell['config']}.json")
    mix = load_json(bench / "traffic" / f"{cell['traffic']}.json")
    return cell, config, mix


def cell_metrics(name: str, benchmark: dict):
    """(end-to-end, per-layer) metric entries that apply to cell ``name``."""
    def applies(m):
        return "workloads" not in m or name in m["workloads"]
    return ([m for m in benchmark["end_to_end"] if applies(m)],
            [m for m in benchmark["per_layer"] if applies(m)])


def reader(bench: Path, kind: str, name: str):
    path = bench / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench_{kind}_{name}".replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list[str]:
    return sorted({k.split(".")[0] for k in list(sys.modules)}
                  & set(FORBIDDEN))


def arch_config(config: dict):
    from repro_torch.configs.base import ArchConfig

    m = config["model"]
    fields = {f.name for f in dataclasses.fields(ArchConfig)}
    return ArchConfig(name=config["name"],
                      **{k: v for k, v in m.items() if k in fields})


def deploy_tree(config: dict, seed: int, device) -> dict:
    """The configuration's parameter tree from the seed: DRAM leaves in
    bf16, flash leaves encoded by the port's ``FlashEncoder`` one (K, N)
    matrix at a time as their blocks are drawn (the bf16 block is dropped
    once encoded), at the configuration's RBER."""
    import torch
    from repro_torch.core.tiering import FlashEncoder, flash_seed

    rber = config["precision"]["rber"]
    tree: dict = {}
    for leaf in wts.leaves(config["model"]):
        if leaf.flash:
            enc = FlashEncoder(leaf.shape, device, rber,
                               flash_seed(seed, leaf.path))
            k, n = leaf.shape[-2:]
            j = 0
            for i in range(leaf.n_blocks):
                for mat in wts.draw(leaf, seed, i, device).reshape(-1, k, n):
                    enc.put(j, mat)
                    j += 1
            value = enc.finish()
        elif leaf.init[0] == "const":
            value = torch.full(leaf.shape, leaf.init[1],
                               dtype=torch.bfloat16, device=device)
        else:
            value = torch.empty(leaf.shape, dtype=torch.bfloat16,
                                device=device)
            flat = value.view((leaf.n_blocks,) + leaf.block_shape)
            for i in range(leaf.n_blocks):
                flat[i] = wts.draw(leaf, seed, i, device)
        wts.put(tree, leaf.path, value)
    return tree


def build_engine(config: dict, seed: int, device):
    import torch
    from repro_torch.core import scheduler as sched
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.sampler import SampleConfig

    m, e = config["model"], config["engine"]
    tree = deploy_tree(config, seed, device)
    eng = Engine(
        arch_config(config), tree, max_slots=e["max_slots"],
        max_seq=e["max_seq"], sample_cfg=SampleConfig(),
        sched_cfg=sched.SchedulerConfig(h=m["alg2_groups"], **m["alg2"]),
        kv_aware=e["kv_aware"], rber=config["precision"]["rber"], seed=seed,
        block_size=e["block_size"],
        admission_cfg=sched.AdmissionConfig(
            chunk_tokens=e["chunk_tokens"], token_budget=e["token_budget"]),
        device=device, compiled=True)
    del tree
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return eng


class Clients:
    """The closed loop: ``n`` clients, each with one request in flight,
    drawing the next from the seed's stream when the last completes. The
    loop is the only thread; the engine steps when it is called."""

    def __init__(self, eng, stream, n: int, groups: int):
        self.eng, self.stream, self.groups = eng, stream, groups
        self.active: list = [None] * n
        self.finished: list[Record] = []
        self.ran: list = []             # (record, context, lanes) of the
                                        # last step

    def _rows(self, req) -> int:
        return req.pos + max(len(req.out) - 1, 0)

    def submit(self):
        for c, rec in enumerate(self.active):
            if rec is None:
                q = self.stream.next()
                t = time.perf_counter()
                rid = self.eng.submit(q.prompt, max_new=q.max_new)
                self.active[c] = Record(q.index, c, rid, q.prompt, q.max_new,
                                        t)

    def step(self):
        """Submit for idle clients, step once, hand every new token its
        stamp. Returns (stamp, roofline.Step, the clients' own host
        seconds around the step)."""
        t0 = time.perf_counter()
        self.submit()
        eng = self.eng
        n_on = round((eng.stats[-1]["npu_fraction"] if eng.stats else 1.0)
                     * self.groups)
        before = [self._rows(eng.requests[r.rid]) if r else 0
                  for r in self.active]
        t1 = time.perf_counter()
        eng.step()
        t = time.perf_counter()
        lanes = self._collect(t, before, n_on)
        return (t, roofline.Step(lanes, n_on),
                (t1 - t0) + (time.perf_counter() - t))

    def _collect(self, t: float, before: list, n_on: int) -> list:
        """Stamp the step's new tokens, retire completed requests, and
        return the step's (context, lanes, emits) per request that ran."""
        eng = self.eng
        lanes, self.ran = [], []
        for c, rec in enumerate(self.active):
            req = eng.requests[rec.rid]
            rows = self._rows(req)
            new = len(req.out) - len(rec.stamps)
            if rows > before[c]:
                rec.slot = req.slot
                rec.segs.append((rows, n_on))
                lanes.append((before[c], rows - before[c], new > 0))
                self.ran.append((rec, before[c], rows - before[c]))
            rec.stamps.extend([t] * new)
            if req.done:
                rec.out, rec.done = list(req.out), t
                eng.forget(rec.rid)
                self.finished.append(rec)
                self.active[c] = None
        return lanes


def _sync(device):
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool,
             t_start: float, device="cuda", bench: Path = HERE,
             benchmark: dict | None = None, log=print,
             control: bool = False) -> dict:
    """One run; returns the result line's object (``checks`` last).
    ``control`` also judges the control on the same sample, its picks in
    the program's place, by the same rule (``result["control"]``: its
    ``correct``, ``checks`` and every reading of both sides; not for a
    benchmark run)."""
    import torch

    seed = seed % (1 << 62)
    cell, config, mix = load_cell(cell_name, bench)
    if benchmark is None:
        benchmark = load_json(bench.parent / "BENCHMARK.json")
    e2e, per_layer = cell_metrics(cell_name, benchmark)
    model = config["model"]
    cuda = torch.device(device).type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if cuda:
        from repro_torch.kernels import build
        build.BUILD_DIR = bench.parent / "build" / "repro_torch_kernels"
        build.build_all()
        torch.cuda.reset_peak_memory_stats()

    t_build = time.perf_counter()
    eng = build_engine(config, seed, device)
    log(f"deploy and engine: {time.perf_counter() - t_build:.1f} s "
        f"(process {t_build - t_start:.1f} s before)")
    stream = traffic.Stream(mix, model["vocab_size"], seed)
    clients = Clients(eng, stream, mix["clients"], model["alg2_groups"])

    # warm-up: the capture, every client through a request, and Algorithm
    # 2's bitmap where the mix holds it
    target = min(traffic.max_context(mix), config["engine"]["max_seq"])
    t_warm = time.perf_counter()
    while (len({r.client for r in clients.finished}) < mix["clients"]
           or max((s["kv_len"] for s in eng.stats), default=0) < target):
        clients.step()
        if time.perf_counter() - t_warm > cell["warmup_limit_s"]:
            raise RuntimeError("warm-up did not reach the steady state")
    warm_steps = len(eng.stats)
    log(f"warm-up: {warm_steps} steps, {time.perf_counter() - t_warm:.1f} s,"
        f" {len(clients.finished)} requests finished")

    # the window (and, traced, the stretches of steps after it): CUDA
    # events around each replay
    pending: list = []
    if trace and cuda:
        time_replays(torch, eng.captured, pending)
    rows: list[StepRow] = []
    _sync(device)
    t_open = time.perf_counter()
    setup_s = t_open - t_start
    t = t_open
    while t - t_open < seconds:
        t, work, bench_s = clients.step()
        rows.append(StepRow(dict(eng._phases), bench_s, work,
                            pending.pop() if pending else None))
    t_close = t
    recs_all = clients.finished + [r for r in clients.active if r]
    gaps = stats.itl(recs_all, t_open, t_close)
    log(f"window: {len(rows)} steps, {t_close - t_open:.3f} s from "
        f"{time.time() - (time.perf_counter() - t_open):.1f} (epoch); "
        f"inter-token gaps (ms) p50/p90/p95/p99 " + "/".join(
            f"{1e3 * stats.percentile(gaps, p):.2f}" for p in (50, 90, 95, 99))
        + f" of {len(gaps)}")
    _sync(device)

    segments, timed = [], None
    if trace and cuda:
        # a stretch timed by CUDA events alone (the profiler stretches a
        # replay's span), then the profiled stretches
        spec = cell["trace"]
        timed = run_steps(clients, spec["segments"] * spec["steps"],
                          pending)
        segments = profile_segments(torch, clients, spec, pending)
        del eng.captured.replay
        log("replay ms, median: window {:.3f}, timed {:.3f}, profiled "
            "{:.3f}".format(*(stats.percentile(v, 50) for v in (
                replay_ms(rows), segment_replay_ms(timed),
                [t for g in segments for t in segment_replay_ms(g)]))))

    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": (torch.cuda.get_device_name() if cuda
                            else "cpu"),
                   "count": 1,
                   "memory_peak_bytes": (int(torch.cuda.max_memory_allocated())
                                         if cuda else 0)}
    if trace:
        device_info["busy_s"] = sum(s.busy_s for s in segments)
        device_info["window_s"] = sum(s.wall_s for s in segments)

    bad = forbidden_modules()
    if bad:
        raise SystemExit(f"loaded in the measuring process: {bad}")

    in_window = [r for r in clients.finished if t_open < r.done <= t_close]
    attempted = len(in_window) + sum(r is not None for r in clients.active)
    # a request the engine retired short of its tokens
    failed = sum(len(r.out) != r.max_new for r in in_window)
    stats_all = list(eng.stats)
    eng.close()
    del eng, clients.eng
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # correctness: the plain reference over a sample of the window's
    # requests
    t_ref = time.perf_counter()
    recs = check.sample(in_window, seed, cell["check"])
    modes = ("ref", "control") if control else ("ref",)
    if recs:
        got = check.gaps(model, seed, config["precision"]["rber"], recs,
                         device, modes)
    else:
        got = {m: {} for m in modes}
        got["tokens"] = 0
    alg2_off = check.alg2_steps_off(stats_all, model)
    checks, correct = judge(got["ref"], alg2_off, got["tokens"],
                            cell["check"])
    log(f"reference: {len(recs)} requests from slots "
        f"{sorted({r.slot for r in recs})}, {got['tokens']} served tokens, "
        f"{time.perf_counter() - t_ref:.1f} s")
    if segments and model["family"] == "moe":
        t_ref = time.perf_counter()
        check.routed_experts(model, seed, config["precision"]["rber"],
                             [timed] + segments, device)
        log(f"routes of the profiled steps: "
            f"{time.perf_counter() - t_ref:.1f} s")

    ctx = dict(records=clients.finished + [r for r in clients.active if r],
               t_open=t_open, t_close=t_close, setup_s=setup_s,
               steps=rows, segments=segments, timed=timed, model=model,
               cell=cell,
               roofline=roofline, devtrace=devtrace)
    metrics = {}
    for m in (per_layer if trace else e2e):
        kind = "metrics" if trace else "end_to_end"
        value = reader(bench, kind, m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": failed, "metrics": metrics,
              "device": device_info}
    if trace and segments:
        result["breakdown"] = breakdown(segments, rows)
    if control:
        c_checks, c_correct = judge(got["control"], alg2_off, got["tokens"],
                                    cell["check"])
        result["control"] = {"correct": c_correct, "checks": c_checks,
                             "readings": got["control"],
                             "program_readings": got["ref"]}
    result["checks"] = checks
    return result


def judge(readings: dict, alg2_off: int, tokens: int, spec: dict):
    """(checks, correct): each number the cell compares beside its limit,
    and whether all hold. ``readings`` are the gaps of the tokens judged
    (the program's, or the control's in its place)."""
    checks = {name: {"value": readings.get(name), "limit": lim}
              for name, lim in spec["limits"].items()}
    checks["alg2_steps_off"] = {"value": alg2_off, "limit": 0}
    checks["tokens_compared"] = {"value": tokens,
                                 "limit": spec["min_tokens"]}
    correct = (all(checks[k]["value"] is not None
                   and checks[k]["value"] <= lim
                   for k, lim in spec["limits"].items())
               and alg2_off == 0 and tokens >= spec["min_tokens"])
    return checks, bool(correct)


def time_replays(torch, captured, pending: list) -> None:
    """CUDA events around each replay of the captured step, appended to
    ``pending`` (an instance attribute over ``Captured.replay``; deleting
    it restores the method)."""
    replay = captured.replay

    def timed():
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = replay()
        ev[1].record()
        pending.append(ev)
        return out
    captured.replay = timed


@dataclasses.dataclass
class Stretch:
    """Steps run past the window: each step's work, the requests that ran
    in it (``ran``: (record, context, lanes)), the CUDA events around its
    replay (``replays``), and each request's tokens when the stretch
    ended (``tokens``: what the reference's routes need)."""
    works: list
    ran: list
    replays: list
    tokens: dict


def run_steps(clients, n: int, pending: list) -> Stretch:
    works, ran, replays = [], [], []
    for _ in range(n):
        works.append(clients.step()[1])
        ran.append(list(clients.ran))
        replays.append(pending.pop() if pending else None)
    tokens = {id(rec): rec.prompt + (
        rec.out if rec.done is not None
        else list(clients.eng.requests[rec.rid].out))
        for step in ran for rec, _, _ in step}
    return Stretch(works, ran, replays, tokens)


def profile_segments(torch, clients, spec: dict, pending: list):
    """``spec['segments']`` profiles (device activity only) of
    ``spec['steps']`` steps each, continuing the traffic past the window;
    each a ``devtrace.Segment`` with its ``Stretch``'s fields."""
    from torch.profiler import ProfilerActivity, profile

    out = []
    for _ in range(spec["segments"]):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            steps = run_steps(clients, spec["steps"], pending)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        seg = devtrace.Segment(prof, wall, spec["steps"])
        seg.works, seg.ran = steps.works, steps.ran
        seg.replays, seg.tokens = steps.replays, steps.tokens
        out.append(seg)
    return out


def breakdown(segments, rows) -> dict:
    """The profiled steps' ten longest device ops (seconds summed by
    name), and what the host did while the device idled between the
    window's replays (seconds summed over the window): the clients' own
    bookkeeping, the engine's plan and dispatch, and the rest of each gap
    (the engine's bookkeeping after it read the step's result)."""
    ops: dict = {}
    for s in segments:
        for k, v in s.op_s().items():
            ops[k] = ops.get(k, 0.0) + v
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    gap = sum(a.replay[1].elapsed_time(b.replay[0])
              for a, b in zip(rows, rows[1:])
              if a.replay is not None and b.replay is not None) / 1e3
    host = {"bench: the clients' bookkeeping":
            sum(r.bench_s for r in rows[1:]),
            "engine.step: plan": sum(r.phases.get("plan", 0.0)
                                     for r in rows[1:]),
            "engine.step: dispatch": sum(r.phases.get("dispatch", 0.0)
                                         for r in rows[1:])}
    host["engine.step: after the device's result (the rest)"] = max(
        gap - sum(host.values()), 0.0)
    idle = sorted(host.items(), key=lambda kv: -kv[1])
    return {"device_ops": [[k[:120], v] for k, v in top],
            "idle_gaps": [[k, v] for k, v in idle]}


def replay_ms(rows) -> list[float]:
    return [r.replay[0].elapsed_time(r.replay[1]) for r in rows
            if r.replay is not None]


def segment_replay_ms(seg) -> list[float]:
    return [ev[0].elapsed_time(ev[1]) for ev in seg.replays
            if ev is not None]

