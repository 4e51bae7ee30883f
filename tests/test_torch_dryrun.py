"""The port's cost tools: ``launch/roofline`` (``model_flops`` equal to the
reference's for all 40 cells; the H100 roofline terms), ``launch/cost``
(the counting rules on hand-sized cases; each kernel's plain version
counted once at its boundary, its outputs shaped as the plain version's),
``launch/dryrun`` (all 40 smoke cells; a smoke prefill's matmul flops
against its config; the depth extrapolation and the microbatch loop body
against direct counts; meta against fake counts; the command line) and
``launch/report``."""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import SHAPES as JSHAPES
from repro.launch import roofline as jrl
from repro_torch.configs import ARCHS, SHAPES, ShapeSpec, get_config
from repro_torch.core import ecc
from repro_torch.kernels import decode_attn, ecdp, grouped_ecdp, paged_attn
from repro_torch.kernels import paged_ecdp
from repro_torch.launch import cost, dryrun, report, steps
from repro_torch.launch import roofline as rl

ROOT = Path(__file__).resolve().parents[1]


# --- roofline -------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_equal_the_reference(arch):
    for name in SHAPES:
        assert rl.model_flops(get_config(arch), SHAPES[name]) == \
            jrl.model_flops(jget_config(arch), JSHAPES[name]), name


def test_roofline_terms_by_hand():
    t = rl.roofline_terms(989e12, 6.7e12, {}, 1, 494.5e12)
    assert t["compute_s"] == 1.0 and t["memory_s"] == 2.0
    assert t["collective_s"] == 0.0 and t["dominant"] == "memory_s"
    assert t["step_time_lower_bound_s"] == 2.0
    assert t["useful_flops_ratio"] == 0.5 and t["roofline_fraction"] == 0.25
    assert t["collectives_by_op"] == {} and t["wire_bytes_per_chip"] == 0.0
    assert set(t) == set(jrl.roofline_terms(1.0, 1.0, {}, 1, 1.0))
    w = rl.roofline_terms(0.0, 0.0, {"all-reduce": 900e9}, 2, 0.0)
    assert w["collective_s"] == 2.0 and w["dominant"] == "collective_s"
    assert (rl.PEAK_FLOPS, rl.HBM_BW, rl.LINK_BW) == (989e12, 3.35e12, 450e9)


# --- cost.count on hand-sized cases --------------------------------------------

def test_count_matmul_elementwise_view_reduction():
    a, b = torch.randn(8, 16), torch.randn(16, 4)
    c = cost.count(lambda x, y: x @ y, a, b)
    assert c.cost.flops == 2 * 8 * 16 * 4
    assert c.cost.bytes == 4 * (8 * 16 + 16 * 4 + 8 * 4)
    assert c.flops_by_kind == {"matmul": 2 * 8 * 16 * 4}
    assert c.argument_bytes == 4 * (8 * 16 + 16 * 4)
    c = cost.count(lambda x: x * 2.0 + 1.0, a)
    assert c.cost.flops == 2 * 128 and c.cost.bytes == 2 * 2 * 512
    c = cost.count(lambda x: x.view(4, 32).t().unsqueeze(0).detach(), a)
    assert (c.cost.flops, c.cost.bytes, c.n_ops) == (0.0, 0.0, 0)
    c = cost.count(lambda x: x.sum(-1), a)
    assert c.cost.flops == 128 and c.cost.bytes == 4 * (128 + 8)
    c = cost.count(lambda x: x.expand(3, 8, 16) + 1.0, a)   # a broadcast read
    assert c.cost.bytes == 4 * (128 + 3 * 128)


def test_count_slice_writes_move_twice_the_update():
    def write(buf, x, idx):
        buf[2:4] = x
        buf.index_copy_(0, idx, x)
        buf[idx] = x
        return buf

    c = cost.count(write, torch.zeros(100, 16), torch.ones(2, 16),
                   torch.tensor([5, 7]))
    assert c.cost.bytes == 3 * 2 * (2 * 16 * 4) and c.cost.flops == 0


def test_count_peak_live_bytes():
    def f(x):
        y = x * 2.0                  # 512 B live beside x
        z = y + 1.0                  # and 512 more
        del y
        return z * 3.0               # y released: peak stays at three

    c = cost.count(f, torch.zeros(8, 16))
    assert c.argument_bytes == 512 and c.peak_live_bytes == 3 * 512


def _flash(k, n, lead=()):
    wq = torch.randint(-127, 128, lead + (k, n), dtype=torch.int8)
    par = torch.stack([ecc.encode(ecc.weights_to_bytes(w))
                       for w in wq.reshape(-1, k, n)]).reshape(
                           lead + (k // 8, n))
    return wq, par, torch.rand(lead + (1, n)) + 0.5


def _pool(kn, n_exp=None):
    """A page pool holding random weight pages and (E, ...) or single page
    tables for a (K, N) weight (tile 128)."""
    k, n = kn
    pages = (k // 128) * (n // 128) + 2
    e = n_exp or 1
    pool = torch.randint(-127, 128, (pages * e, 16384), dtype=torch.int8)
    q = torch.arange(pages * e, dtype=torch.int32).reshape(e, pages)
    q_tbl = q[:, :pages - 2].reshape(e, k // 128, n // 128).contiguous()
    p_slots, s_slots = q[:, -2:-1].contiguous(), q[:, -1:].contiguous()
    pool[:, :] = 0                    # scales 0.0, parity of zero words 0
    if n_exp is None:
        return pool, q_tbl[0], p_slots[0], s_slots[0]
    return pool, q_tbl, p_slots, s_slots


def _kernel_cases():
    m, k, n, e = 6, 128, 128, 3
    a = torch.randn(m, k).bfloat16()
    rows = torch.tensor([0, 2, 2, 6], dtype=torch.int32)
    q = torch.randn(2, 4, 8, 64).bfloat16()
    kp = torch.randn(9, 16, 4, 64).bfloat16()
    tbl = torch.tensor([[1, 2, 3], [4, 5, 6]], dtype=torch.int32)
    ctx = torch.tensor([40, 3], dtype=torch.int32)
    kc = torch.randn(2, 48, 4, 64).bfloat16()
    return [
        (ecdp, "ecdp_matmul_plain", (a, *_flash(k, n)), 2 * m * k * n),
        (grouped_ecdp, "grouped_ecdp_plain", (a, rows, *_flash(k, n, (e,))),
         2 * m * k * n),
        (paged_ecdp, "paged_ecdp_matmul_plain", (a, *_pool((k, n)), (k, n)),
         2 * m * k * n),
        (paged_ecdp, "grouped_paged_ecdp_plain",
         (a, rows, *_pool((k, n), e), (k, n)), 2 * m * k * n),
        (paged_attn, "paged_attn_plain", (q, kp, kp.clone(), tbl, ctx),
         4 * 2 * 4 * 8 * 48 * 64),
        (decode_attn, "decode_attn_plain", (q, kc, kc.clone(), ctx),
         4 * 2 * 4 * 8 * 48 * 64),
    ]


@pytest.mark.parametrize("case", _kernel_cases(), ids=lambda c: c[1])
def test_plain_versions_counted_at_their_boundaries(case):
    mod, name, args, flops = case
    want = getattr(mod, name)(*args)           # the plain version itself
    c = cost.count(lambda *a: getattr(mod, name)(*a), *args)
    assert getattr(mod, name) is not None and c.boundaries == {name: 1}
    got, exp = cost._tensors(c.out), cost._tensors(want)
    assert [(t.shape, t.dtype) for t in got] == \
        [(t.shape, t.dtype) for t in exp]
    assert c.cost.flops == flops and c.flops_by_kind == {"kernel": flops}
    assert c.cost.bytes == sum(cost._nbytes(t) for t in
                               cost._tensors(args) + got)
    assert c.n_ops == 2 if len(got) == 1 else c.n_ops == 4   # the empties
    assert getattr(mod, name).__name__ == name       # restored


def test_a_wrapper_reaches_the_boundary():
    a = torch.randn(4, 128).bfloat16()
    c = cost.count(ecdp.ecdp_matmul, a, *_flash(128, 64))
    assert c.boundaries == {"ecdp_matmul_plain": 1}
    assert c.cost.flops == 2 * 4 * 128 * 64


def test_repeats_charges_each_trip_the_first_ones_cost():
    calls = []

    def body(x):
        calls.append(1)
        return (x * 2.0).sum()

    ns = types.SimpleNamespace(body=body)

    def loop(x):
        return [ns.body(x[i]) for i in range(4)]

    x = torch.randn(4, 8)
    plain = cost.count(loop, x)
    calls.clear()
    looped = cost.count(loop, x, loops=((ns, "body"),))
    assert len(calls) == 1 and ns.body is body
    assert (looped.cost.flops, looped.cost.bytes, looped.n_ops) == \
        (plain.cost.flops, plain.cost.bytes, plain.n_ops)


# --- the dry-run ----------------------------------------------------------------

SMOKE_CELLS = [(a, s) for a in ARCHS for s in SHAPES]


@pytest.fixture(scope="module")
def smoke_rows(tmp_path_factory):
    deployed: dict = {}
    rows = [dryrun.run_cell(a, s, smoke=True, deployed=deployed)
            for a, s in SMOKE_CELLS]
    out = tmp_path_factory.mktemp("dryrun")
    for r in rows:
        (out / f"{r['arch']}_{r['shape']}_{r['mesh']}.json").write_text(
            json.dumps(r))
    return rows, out


def test_all_smoke_cells_count(smoke_rows):
    rows, _ = smoke_rows
    assert [r["status"] for r in rows].count("error") == 0, \
        [(r["arch"], r["shape"], r.get("error")) for r in rows]
    assert sum(r["status"] == "ok" for r in rows) == 32
    assert sum(r["status"] == "skipped" for r in rows) == 8
    for r in rows:
        if r["status"] != "ok":
            continue
        assert set(r["roofline"]) == set(jrl.roofline_terms(1, 1, {}, 1, 1))
        assert r["roofline"]["collective_s"] == 0 and r["n_collectives"] == 0
        m = r["memory"]
        assert 0 < m["argument_size_in_bytes"] <= m["peak_live_bytes"]
        assert r["fits_card"] is True
        calls = r["counted"]["plain_version_calls"]
        if r["kind"] == "train":
            assert calls == {}                     # no kernel in training
        else:
            assert calls.get("ecdp_matmul_plain", 0) >= 1   # lm_head


def test_report_renders_the_smoke_json(smoke_rows, capsys):
    _, out = smoke_rows
    rows = report.load(str(out))
    assert len(rows) == 40
    assert report.summary(rows).startswith("40 cells: 32 counted")
    table = report.dryrun_table(rows)
    assert table.count("\n") == 41 and "skip (sub-quadratic rule)" in table
    assert report.roofline_table(rows).count("\n") == 41
    sys.argv = ["report", str(out)]
    report.main()
    assert "### Roofline (one H100)" in capsys.readouterr().out


def test_smoke_prefill_matmul_flops_from_the_config():
    """granite-8b smoke prefill (2 x 64 tokens): the DRAM tier's Q/K/V/O
    products and the attention's QK^T and PV (matmuls), the flash tier's
    FFN and lm_head (the ECDP boundary), each from the config."""
    cfg = get_config("granite-8b", smoke=True)
    b, s = 2, 64
    t, d, h, kv, dh, f = (b * s, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                          cfg.head_dim, cfg.d_ff)
    proj = 2 * t * d * (h * dh + 2 * kv * dh) + 2 * t * h * dh * d
    attn = 2 * (2 * b * h * s * s * dh)
    ffn = 3 * 2 * t * d * f
    head = 2 * t * d * cfg.vocab_size
    got = dryrun.count_cell("granite-8b", "prefill_32k", smoke=True)
    kinds = got["flops_by_kind"]
    assert kinds["matmul"] == cfg.n_layers * (proj + attn)
    assert kinds["kernel"] == cfg.n_layers * ffn + head
    assert got["boundaries"] == {"ecdp_matmul_plain": 3 * cfg.n_layers + 1}


EXTRAPOLATED = [
    ("granite-8b", ShapeSpec("t", "train", 64, 4), dict(n_layers=5)),
    ("granite-8b", ShapeSpec("p", "prefill", 64, 2), dict(n_layers=5)),
    ("qwen3-moe-30b-a3b", ShapeSpec("d", "decode", 64, 2),
     dict(n_layers=4)),
    ("recurrentgemma-9b", ShapeSpec("t", "train", 32, 2),
     dict(n_layers=11)),
    ("seamless-m4t-medium", ShapeSpec("t", "train", 32, 2),
     dict(n_layers=3, n_enc_layers=4)),
    ("llama3-405b", ShapeSpec("t", "train", 32, 4),
     dict(n_layers=16, remat_groups=4)),
]


@pytest.mark.parametrize("arch,shape,cut", EXTRAPOLATED,
                         ids=[f"{a}-{s.kind}" for a, s, _ in EXTRAPOLATED])
def test_extrapolated_counts_equal_direct_counts(arch, shape, cut):
    cfg = dataclasses.replace(get_config(arch, smoke=True), **cut)
    knobs = dict(n_micro=2)
    ex = dryrun.count_cell(arch, shape.name, cfg=cfg, shape=shape,
                           knobs=knobs)
    assert ex["axes"], "counted directly: nothing extrapolated"
    step, args, ctx = dryrun.build_cell(arch, shape.name, cfg=cfg,
                                        shape=shape, knobs=knobs)
    with ctx:
        d = cost.count(step, *args)
    assert ex["cost"].flops == d.cost.flops
    assert ex["cost"].bytes == d.cost.bytes
    assert ex["argument_bytes"] == d.argument_bytes
    # the peak is each phase's live bytes (linear in depth) at its busiest
    # phase, which can change with depth: at smoke width granite-8b's
    # training peak extrapolates 2.1 % under its direct count (phase 16(b)
    # holds the full-width count against the card's own peak)
    assert abs(ex["peak_live_bytes"] / d.peak_live_bytes - 1) < 0.05


def test_microbatches_as_one_loop_body_equal_the_unrolled_loop():
    cfg = get_config("granite-8b", smoke=True)
    shape, knobs = ShapeSpec("t", "train", 32, 8), dict(n_micro=4)
    step, args, ctx = dryrun.build_cell("granite-8b", "t", cfg=cfg,
                                        shape=shape, knobs=knobs)
    with ctx:
        unrolled = cost.count(step, *args)
        once = cost.count(step, *args, loops=((steps, "accumulate_grads"),))
    assert (once.cost.flops, once.cost.bytes, once.n_ops) == \
        (unrolled.cost.flops, unrolled.cost.bytes, unrolled.n_ops)
    # the unrolled loop keeps each microbatch's 0-d f32 loss
    assert 0 <= unrolled.peak_live_bytes - once.peak_live_bytes <= 4 * 4


@pytest.mark.parametrize("arch,shape", [
    ("granite-8b", "train_4k"), ("qwen3-moe-30b-a3b", "prefill_32k"),
    ("rwkv6-3b", "decode_32k"), ("recurrentgemma-9b", "long_500k"),
    ("seamless-m4t-medium", "decode_32k")])
def test_meta_counts_equal_fake_counts(arch, shape):
    meta = dryrun.count_cell(arch, shape, smoke=True)
    fake = dryrun.count_cell(arch, shape, smoke=True, on="fake")
    for k in ("argument_bytes", "peak_live_bytes", "boundaries",
              "flops_by_kind"):
        assert meta[k] == fake[k], k
    assert (meta["cost"].flops, meta["cost"].bytes) == \
        (fake["cost"].flops, fake["cost"].bytes)


def test_dryrun_smoke_subprocess(tmp_path):
    """The reference's plumbing check through the port's entry point:
    ``--mesh card`` keeps the one-card cell (``1xH100``), and ``--mesh
    both`` counts the reference's two production meshes (16x16 and
    2x16x16, named as the reference names them)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("WORLD_SIZE", None)
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
           "granite-8b", "--shape", "train_4k", "--smoke", "--out",
           str(tmp_path)]
    r = subprocess.run(cmd + ["--mesh", "card"], capture_output=True,
                       text=True, timeout=300, env=env, cwd=ROOT)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert "[ok" in r.stdout
    rec = json.loads((tmp_path / "granite-8b_train_4k_1xH100_smoke.json")
                     .read_text())
    assert rec["status"] == "ok" and rec["mesh"] == "1xH100"
    assert rec["n_collectives"] == 0
    r = subprocess.run(cmd + ["--mesh", "both"], capture_output=True,
                       text=True, timeout=300, env=env, cwd=ROOT)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    for mesh in ("16x16", "2x16x16"):
        rec = json.loads((tmp_path / f"granite-8b_train_4k_{mesh}_smoke.json")
                         .read_text())
        assert rec["status"] == "ok" and rec["mesh"] == mesh
