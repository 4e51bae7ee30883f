"""On the card: the harness drives the tiny configurations through the
captured engine and the CUDA kernels, traced, and the result holds
together (correct, device time read from the profile, shares within
100 %). Skips without a card."""
from __future__ import annotations

import time

import pytest

import bench_testlib as lib

pytestmark = pytest.mark.gpu

LIMITS = {"opt-tiny": {"max_gap": 0.04}, "moe-tiny": {"mismatch_share": 0.12}}


@pytest.mark.parametrize("cell", ("opt-tiny.tiny-chat", "moe-tiny.tiny-chat"))
def test_a_traced_run_on_the_card(tmp_path, cell):
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import json

    from bench import harness

    bench = lib.tiny_bench(tmp_path, LIMITS[cell.split(".")[0]])
    benchmark = json.loads((lib.ROOT / "BENCHMARK.json").read_text())
    benchmark["per_layer"] = [dict(m, workloads=[cell])
                              for m in benchmark["per_layer"]]
    out = harness.run_cell(cell, 5, 2.0, True, time.perf_counter(),
                           device="cuda", bench=bench, benchmark=benchmark,
                           log=lambda *a: None)
    assert out["correct"], out["checks"]
    assert out["device"]["busy_s"] > 0
    assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
    for name, m in out["metrics"].items():
        if m["unit"] == "%":
            assert 0 <= m["value"] <= 100, (name, m)
    assert out["breakdown"]["device_ops"]
