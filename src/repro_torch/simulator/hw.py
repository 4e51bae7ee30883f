"""Hardware constants for the NVLLM analytical performance model (§4.1) —
a copy of ``repro/simulator/hw.py``, constant for constant (the port
imports nothing of the JAX package; the tests hold every constant, field
and property equal to the reference's). Pure Python: nothing here runs on
the card, and no figure here is the H100's.

NAND (3D-FPIM-derived, validated against the paper's own numbers):
  * plane read: 16 KiB page / 5.12 us  =  3.125 GB/s per plane
  * NVLLM 32 planes -> 100 GB/s internal BW (paper: "up to 100 GB/s") ✓
  * NAND CMOS @ 350 MHz, NPU @ 500 MHz; each OoO-ECDP sustains 32 MACs/cycle
    (solved from Table 3 + the paper's 307–486 GOPS aggregate:
    307.2 = 8 ECDP x 350MHz x 64 op/cyc + 4 NPU-ECDP x 500MHz x 64 op/cyc,
    486.4 = 16 ECDP x ... — both endpoints match exactly).

GPU out-of-core baselines (FlexGen, Table 1): effective streaming bandwidth
is below the raw link speed because of storage access granularity (§1), and
FlexGen adds a fixed per-token host-orchestration cost. Both constants are
calibrated so the measured endpoints of Fig. 6(a) (37.9x at OPT-1.3B, 22.4x
at OPT-30B vs GPU-SSD) are reproduced; everything in between is then a
prediction, not a fit.

Energy (Fig. 8(b)): pJ/byte per movement path; e_chan covers the SSD-style
flash-channel + controller + DRAM-staging round-trip that Cambricon-LLM
pays and NVLLM's W2W bonding eliminates. With FFN fraction ~0.7 these give
the paper's 5.63x aggregate data-movement-energy reduction.
"""
from __future__ import annotations

import dataclasses

PAGE_BYTES = 16 * 1024
PLANE_READ_S = 5.12e-6
PLANE_BW = PAGE_BYTES / PLANE_READ_S            # 3.125 GB/s per plane

NAND_CMOS_HZ = 350e6
NPU_HZ = 500e6
ECDP_MACS_PER_CYCLE = 32                        # per OoO-ECDP lane group
OPS_PER_MAC = 2

LPDDR5X_BW = 68.3e9                             # 2ch LPDDR5X-8533
DRAM_KV_DTYPE_BYTES = 2                         # bf16 KV cache

# --- GPU-centric baselines (A800 + FlexGen, Table 1) ---
A800_HBM_BW = 2039e9
PCIE4_X16_BW = 32e9
NVME_BW = 8e9
GPU_SSD_EFF_BW = 3.63e9     # effective: granularity + SSD->host->GPU hops
GPU_SSD_TOKEN_OVERHEAD_S = 0.247
GPU_DRAM_EFF_BW = 26e9      # effective PCIe4 x16 streaming
GPU_DRAM_TOKEN_OVERHEAD_S = 0.060

# --- SSD-like in-flash baselines (Fig. 6(b), LLaMA2-7B anchors) ---
CAMBRICON_EFF_BW = 24.76e9   # 8ch shared between in-flash compute + fetches
CAMBRICON_TOKEN_OVERHEAD_S = 0.016
AIF_EFF_BW = 102.4e9        # paper: 102.4 GB/s internal
AIF_TOKEN_OVERHEAD_S = 0.013
AIF_MINUS_EFF_BW = 72.7e9   # reduced ECC/read optimizations
AIF_MINUS_TOKEN_OVERHEAD_S = 0.013

# --- energy per byte moved (pJ/B) ---
E_NAND_READ = 8.0           # 3D NAND array -> bonded CMOS (W2W, ~1 pJ/bit)
E_CHAN_SSD = 85.0           # ONFI channel + controller + DRAM staging
E_DRAM = 40.0               # LPDDR5X round trip (~5 pJ/bit)
E_IO_NVLLM = 10.0           # NAND-CMOS <-> NPU die hop (sparse, §4.5)


@dataclasses.dataclass(frozen=True)
class NVLLMConfig:
    """Table 3 scaling configurations."""
    name: str
    n_ecdp: int            # in-flash OoO-ECDP units
    n_clusters: int
    n_planes: int
    npu_ecdp: int = 4      # NPU-side (w/o ECC)

    @property
    def nand_bw(self) -> float:
        return self.n_planes * PLANE_BW

    @property
    def nand_gops(self) -> float:
        return self.n_ecdp * NAND_CMOS_HZ * ECDP_MACS_PER_CYCLE * OPS_PER_MAC

    @property
    def npu_gops(self) -> float:
        return self.npu_ecdp * NPU_HZ * ECDP_MACS_PER_CYCLE * OPS_PER_MAC

    @property
    def total_gops(self) -> float:
        return self.nand_gops + self.npu_gops


def nand_read_seconds(plane_reads) -> float:
    """Analytical NAND time for a per-plane page-read histogram.

    Planes read in parallel (§3.2 multi-plane reads), so the array time is
    set by the SLOWEST plane: max(reads per plane) * PLANE_READ_S. The
    FlashStore page store feeds its per-plane counters through this to
    report an analytical NAND-time next to streamed-serving wall-clock.
    """
    reads = list(plane_reads)
    return (max(reads) * PLANE_READ_S) if reads else 0.0


NVLLM_8C = NVLLMConfig("NVLLM", n_ecdp=8, n_clusters=8, n_planes=32)
NVLLM_12C = NVLLMConfig("NVLLM-12C", n_ecdp=12, n_clusters=12, n_planes=48)
NVLLM_16C = NVLLMConfig("NVLLM-16C", n_ecdp=16, n_clusters=16, n_planes=64)

# --- Table 2: synthesized area/power (TSMC 28nm) -------------------------------
PLANE_AREA_MM2 = 3.07
TABLE2 = {
    "NPU": {
        "SFU": (8_618, 2.730),
        "Dot-Product Unit": (144_712, 170.400),
        "SRAM": (304_217, 67.000),
        "Others": (1_767, 0.019),
    },
    "NAND CMOS": {
        "RISC-V CPU": (685_284, 2.762),
        "Dot-Product Unit": (289_424, 340.800),
        "Detector (x8)": (82_256, 159.688),
        "Corrector (x8)": (323_608, 107.656),
        "SRAM": (1_292_922, 284.750),
        "Others": (18_089, 0.021),
    },
}


def table2_totals() -> dict:
    out = {}
    for blk, mods in TABLE2.items():
        area = sum(a for a, _ in mods.values())
        power = sum(p for _, p in mods.values())
        out[blk] = {"area_um2": area, "power_mw": power}
    return out


def cmos_area_overhead(cfg: NVLLMConfig = NVLLM_8C) -> float:
    """In-flash logic area / total NAND CMOS area under the array (2.7%)."""
    ncw_um2 = table2_totals()["NAND CMOS"]["area_um2"]
    total_um2 = cfg.n_planes * PLANE_AREA_MM2 * 1e6
    return ncw_um2 / total_um2
