"""The harness finds configurations, cells, traffic mixes and metric
readers by name from their own files: a new configuration, cell and
per-layer metric added as new files in a copy of the benchmark run with
no existing file edited."""
from __future__ import annotations

import hashlib
import json

import bench_testlib as lib
from bench import harness


def digest(root):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()
                                                     ).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_a_new_config_cell_and_metric_as_new_files(tmp_path):
    bench = lib.tiny_bench(tmp_path, {"max_gap": 1.0})
    before = digest(bench)
    # a new configuration, mix and cell: files only
    lib.write(bench / "configs" / "opt-tiny-2l.json",
              {"name": "opt-tiny-2l", "source": "test", "config": {},
               "changed_from_source": {},
               "model": dict(lib.TINY["opt-tiny"], n_layers=2),
               "precision": {"rber": 0.0},
               "engine": dict(lib.ENGINE, max_seq=512)})
    lib.write(bench / "traffic" / "tiny-burst.json",
              dict(lib.MIX, clients=4, pool=8))
    lib.write(bench / "workloads" / "opt-tiny-2l.tiny-burst.json",
              {"config": "opt-tiny-2l", "traffic": "tiny-burst", "chips": 1,
               "warmup_limit_s": 300,
               "check": {"requests": 8, "served_tokens": 60,
                         "min_tokens": 10, "limits": {"max_gap": 1.0}},
               "trace": {"segments": 1, "steps": 2}})
    # a new per-layer metric: its own reader file
    (bench / "metrics" / "steps_in_window.py").write_text(
        "def read(ctx):\n    return float(len(ctx['steps']))\n")
    benchmark = {"end_to_end": [{"name": "output_tokens_per_s",
                                 "unit": "tokens/s"}],
                 "per_layer": [{"name": "steps_in_window", "unit": "steps"},
                               {"name": "lanes_per_step", "unit": "lanes",
                                "workloads": ["opt-tiny-2l.tiny-burst"]},
                               {"name": "npu_fraction", "unit": "%",
                                "workloads": ["elsewhere"]}]}
    out = lib.run(bench, "opt-tiny-2l.tiny-burst", benchmark=benchmark)
    assert out["metrics"]["output_tokens_per_s"]["value"] > 0
    traced = harness.run_cell("opt-tiny-2l.tiny-burst", 7, 1.0, True,
                              __import__("time").perf_counter(),
                              device="cpu", bench=bench,
                              benchmark=benchmark, log=lambda *a: None)
    assert traced["metrics"]["steps_in_window"]["value"] > 0
    assert traced["metrics"]["lanes_per_step"]["unit"] == "lanes"
    assert "npu_fraction" not in traced["metrics"]
    assert list(traced)[-1] == "checks"
    after = digest(bench)
    assert {k: v for k, v in after.items() if k in before} == before
    assert json.loads((lib.BENCH / "configs" / "opt-6.7b.json").read_text()
                      )["model"]["n_layers"] == 32
