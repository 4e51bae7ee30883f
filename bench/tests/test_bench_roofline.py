"""The yardstick's work counts against counts worked by hand: one
OPT-6.7B layer at 64 lanes (Algorithm 2 all on the NPU, then 12 of 32
groups), one qwen3-moe-30b-a3b layer over a known route, and the
least-time rule."""
from __future__ import annotations

import json

import pytest

import bench_testlib as lib
from bench import roofline as rl


def model(name):
    return json.loads((lib.BENCH / "configs" / f"{name}.json").read_text()
                      )["model"]


def by_kernel(calls):
    out = {}
    for k, b, f, p in calls:
        ob, of, _ = out.get(k, (0.0, 0.0, p))
        out[k] = (ob + b, of + f, p)
    return out


def test_opt_layer_at_64_lanes_all_on_the_npu():
    m = model("opt-6.7b")
    step = rl.Step([(100, 16, True)] * 4, n_on=32)
    k = by_kernel(rl.layer_calls(m, step))
    # Q, K, V, O in f32: 4 x 4096 x 4096 x 4 bytes, 2 x 64 x 4096^2 flops
    assert k["dram_gemm"] == (4 * 67108864.0, 4 * 2147483648.0, "f32")
    assert "ecdp" in k                       # the FFN only
    # w_up: 4096 x 16384 int8 + a parity byte per 8 + f32 scales per column
    up = 4096 * 16384 * 9 / 8 + 4 * 16384
    down = 16384 * 4096 * 9 / 8 + 4 * 4096
    assert k["ecdp"][0] == up + down == 75563008 + 75513856
    assert k["ecdp"][1] == 2 * 2 * 64 * 4096 * 16384
    # each request's 100 cached rows of K and V, bf16, read once
    assert k["paged_attn"][0] == 4 * 100 * 2 * 32 * 128 * 2
    assert k["paged_attn"][1] == 4 * 4 * 16 * 100 * 32 * 128
    assert k["attention_chunk"][1] == 4 * 4 * (16 * 17 / 2) * 32 * 128


def test_opt_layer_split_by_algorithm_2():
    m = model("opt-6.7b")
    k = by_kernel(rl.layer_calls(m, rl.Step([(0, 16, False)] * 4, n_on=12)))
    on = 12 / 32
    q = 4096 * 4096
    assert k["dram_gemm"][0] == pytest.approx(2 * 4 * q + 2 * 4 * q * on)
    flash_qo = 2 * (q * 9 / 8 + 4 * 4096) * (1 - on)
    ffn = 2 * 4096 * 16384 * 9 / 8 + 4 * (16384 + 4096)
    assert k["ecdp"][0] == pytest.approx(flash_qo + ffn)
    assert "paged_attn" not in k             # no cached context yet


def test_lm_head_counts_the_rows_that_emit():
    m = model("opt-6.7b")
    step = rl.Step([(10, 1, True), (10, 1, True), (0, 16, False)], 32)
    calls = rl.step_calls(m, step)
    head = [c for c in calls if c[0] == "ecdp" and c[1] ==
            4096 * 50272 * 9 / 8 + 4 * 50272]
    assert len(head) == 1 and head[0][2] == 2 * 2 * 4096 * 50272
    assert len(calls) == 32 * len(rl.layer_calls(m, step)) + 1


def test_qwen3_moe_layer_over_a_known_route():
    m = model("qwen3-moe-30b-a3b")
    # 64 tokens routed top-8 to 100 distinct experts: each read raw (no
    # parity), 3 matrices of 2048 x 768 int8 and their f32 scales
    (call,) = rl.expert_calls(m, 64, 100)
    assert call[1] == 100 * (3 * 2048 * 768 + 4 * (2 * 768 + 2048))
    assert call[2] == 2 * 64 * 8 * 3 * 2048 * 768
    assert rl.least_s(call[1], call[2], call[3]) == call[1] / 3.35e12
    step = rl.Step([(0, 16, False)] * 4, 32, experts=[100] * 48)
    k = by_kernel(rl.layer_calls(m, step))
    assert k["dram_gemm"][0] == 4 * (2048 * 4096 * 2 + 2048 * 512 * 2)
    assert k["router"][0] == 2048 * 128 * 2
    assert k["grouped_ecdp"] == call[1:]


def test_a_moe_step_counts_each_layers_own_experts():
    m = model("qwen3-moe-30b-a3b")
    experts = list(range(1, 49))
    step = rl.Step([(5, 1, True)] * 4, 32, experts=experts)
    grouped = [c for c in rl.step_calls(m, step) if c[0] == "grouped_ecdp"]
    assert [c[1] for c in grouped] == [
        e * (3 * 2048 * 768 + 4 * (2 * 768 + 2048)) for e in experts]


def test_a_moe_step_without_its_routes_has_no_count():
    m = model("qwen3-moe-30b-a3b")
    with pytest.raises(ValueError, match="routes"):
        rl.step_calls(m, rl.Step([(5, 1, True)] * 4, 32))


def test_least_time_is_the_larger_bound():
    assert rl.least_s(3.35e12, 0, "bf16") == 1.0
    assert rl.least_s(0, 989e12, "bf16") == 1.0
    assert rl.least_s(0, 67e12, "f32") == 1.0
    calls = [("a", 3.35e12, 0.0, "bf16"), ("b", 0.0, 67e12, "f32")]
    assert rl.least_time(calls) == 2.0 and rl.least_time(calls, "b") == 1.0
