"""The port's analytic NVLLM model (``repro_torch.simulator``) against the
reference's (``repro.simulator``): every constant, config field and
property, Table 2's totals and every throughput, time and energy equal bit
for bit (the same float arithmetic in the same order), and the paper's
claims (tests/test_simulator.py's scenarios) on the port."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from repro.configs import paper_models as jpm
from repro.simulator import baselines as jbl
from repro.simulator import hw as jhw
from repro.simulator.system import NVLLMSystem as JSystem
from repro.simulator.system import WorkloadPoint as JPoint
from repro_torch.configs import paper_models as tpm
from repro_torch.configs.paper_models import LLAMA2_7B, OPT_13B, OPT_FAMILY
from repro_torch.simulator import baselines as bl
from repro_torch.simulator import hw
from repro_torch.simulator.system import NVLLMSystem, WorkloadPoint

HW_CONFIGS = ("NVLLM_8C", "NVLLM_12C", "NVLLM_16C")
BASELINES = ("GPU_SSD", "GPU_DRAM", "CAMBRICON", "AIF", "AIF_MINUS")
MODELS = [(c.name, j, c)
          for j, c in zip([*jpm.OPT_FAMILY, jpm.LLAMA2_7B],
                          [*tpm.OPT_FAMILY, tpm.LLAMA2_7B])]
KV_LENS = (64, 2048, 8192)


# --- the reference's scenarios (tests/test_simulator.py) on the port ----------

def test_table3_envelope():
    assert abs(hw.NVLLM_8C.total_gops / 1e9 - 307.2) < 1
    assert abs(hw.NVLLM_16C.total_gops / 1e9 - 486.4) < 1
    assert abs(hw.NVLLM_8C.nand_bw / 1e9 - 102.4) < 1


def test_area_overhead():
    assert abs(hw.cmos_area_overhead() * 100 - 2.7) < 0.2


def test_fig6a_bands():
    nv = NVLLMSystem(hw.NVLLM_8C)
    wp = WorkloadPoint(kv_len=64)
    for cfg in OPT_FAMILY:
        r = nv.decode_tps(cfg, wp) / bl.GPU_SSD.decode_tps(cfg)
        assert 16.7 <= r <= 37.9, (cfg.name, r)
        assert nv.decode_tps(cfg, wp) / bl.GPU_DRAM.decode_tps(cfg) >= 2.5


def test_fig6b_anchors():
    nv16 = NVLLMSystem(hw.NVLLM_16C)
    t16 = nv16.decode_tps(LLAMA2_7B, WorkloadPoint(kv_len=64))
    assert abs(t16 / bl.CAMBRICON.decode_tps(LLAMA2_7B) - 4.7) < 0.5
    assert abs(t16 / bl.AIF.decode_tps(LLAMA2_7B) - 1.3) < 0.15
    assert abs(bl.CAMBRICON.decode_tps(LLAMA2_7B) - 3.6) < 0.3
    assert abs(bl.AIF.decode_tps(LLAMA2_7B) - 13.1) < 0.8


def test_fig8b_energy():
    nv = NVLLMSystem(hw.NVLLM_8C)
    wp = WorkloadPoint(kv_len=64)
    ratios = [bl.CAMBRICON.movement_energy_per_token(c)
              / nv.movement_energy_per_token(c, wp) for c in OPT_FAMILY]
    assert abs(float(np.mean(ratios)) - 5.63) < 0.6


def test_scaling_monotonic():
    wp = WorkloadPoint(kv_len=64)
    for cfg in OPT_FAMILY:
        tps = [NVLLMSystem(c).decode_tps(cfg, wp)
               for c in (hw.NVLLM_8C, hw.NVLLM_12C, hw.NVLLM_16C)]
        assert tps[0] <= tps[1] <= tps[2] + 1e-9


def test_kv_aware_flat_throughput():
    on = NVLLMSystem(hw.NVLLM_16C, kv_aware=True)
    off = NVLLMSystem(hw.NVLLM_16C, kv_aware=False)
    t_on = [on.decode_tps(OPT_13B, WorkloadPoint(kv_len=k))
            for k in (64, 2048, 8192)]
    t_off = [off.decode_tps(OPT_13B, WorkloadPoint(kv_len=k))
             for k in (64, 2048, 8192)]
    assert t_on[-1] / t_on[0] > t_off[-1] / t_off[0]
    assert t_on[-1] >= t_off[-1]


def test_prefill_compute_bound():
    nv = NVLLMSystem(hw.NVLLM_16C)
    t1 = nv.prefill_time(OPT_13B, 512)
    t2 = nv.prefill_time(OPT_13B, 1024)
    assert 1.8 < t2 / t1 < 2.2          # linear in tokens when compute-bound


# --- bit for bit against the reference ----------------------------------------

def _constants(mod) -> dict:
    return {k: v for k, v in vars(mod).items()
            if k.isupper() and isinstance(v, (int, float, str, dict))}


def test_hw_constants_equal_the_reference():
    ours, ref = _constants(hw), _constants(jhw)
    assert ours.keys() == ref.keys()
    for k in ref:
        assert ours[k] == ref[k] and type(ours[k]) is type(ref[k]), k
    assert hw.table2_totals() == jhw.table2_totals()
    for name in HW_CONFIGS:
        assert hw.cmos_area_overhead(getattr(hw, name)) == \
            jhw.cmos_area_overhead(getattr(jhw, name))
    for reads in ([], [0, 3, 1], [7] * 32):
        assert hw.nand_read_seconds(reads) == jhw.nand_read_seconds(reads)


@pytest.mark.parametrize("name", HW_CONFIGS)
def test_hw_config_equals_the_reference(name):
    ours, ref = getattr(hw, name), getattr(jhw, name)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    for prop in ("nand_bw", "nand_gops", "npu_gops", "total_gops"):
        assert getattr(ours, prop) == getattr(ref, prop), prop


@pytest.mark.parametrize("name", HW_CONFIGS)
@pytest.mark.parametrize("kv_aware", [True, False])
def test_system_equals_the_reference(name, kv_aware):
    ours = NVLLMSystem(getattr(hw, name), kv_aware=kv_aware)
    ref = JSystem(getattr(jhw, name), kv_aware=kv_aware)
    for label, jcfg, cfg in MODELS:
        for kv in KV_LENS:
            wp, jwp = WorkloadPoint(kv_len=kv), JPoint(kv_len=kv)
            assert ours.decode_token_time(cfg, wp) == \
                ref.decode_token_time(jcfg, jwp), (label, kv)
            assert ours.decode_tps(cfg, wp) == ref.decode_tps(jcfg, jwp)
            assert ours.movement_energy_per_token(cfg, wp) == \
                ref.movement_energy_per_token(jcfg, jwp), (label, kv)
            assert ours.prefill_time(cfg, kv) == ref.prefill_time(jcfg, kv)
        assert ours.inference_time(cfg, 128, 16) == \
            ref.inference_time(jcfg, 128, 16), label


@pytest.mark.parametrize("name", BASELINES)
def test_baseline_equals_the_reference(name):
    ours, ref = getattr(bl, name), getattr(jbl, name)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    for label, jcfg, cfg in MODELS:
        for kv in KV_LENS:
            assert ours.decode_token_time(cfg, kv) == \
                ref.decode_token_time(jcfg, kv), (label, kv)
            assert ours.decode_tps(cfg, kv) == ref.decode_tps(jcfg, kv)
            assert ours.movement_energy_per_token(cfg, kv) == \
                ref.movement_energy_per_token(jcfg, kv), (label, kv)
            assert ours.prefill_time(cfg, kv) == ref.prefill_time(jcfg, kv)
        assert ours.inference_time(cfg, 128, 16) == \
            ref.inference_time(jcfg, 128, 16), label
