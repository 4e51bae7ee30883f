#!/usr/bin/env python3
"""Where the ECDP's tensor-core body spends its time, by knock-out.

Builds copies of ``src/repro_torch/kernels/csrc/ecdp_core.cuh`` and
``ecdp.cu`` with one part of the bf16 body taken out, and times each with
ECC on and off (CUDA events, L2 flushed before each call: chip_smoke's
``Timer``) at the OPT-6.7B flash matmul shapes of a serving step (M=64;
lm_head M=4) and of prefill (M=512):

  base      the body as it is
  no_loads  the cp.async copies dropped (the stages keep stale bytes)
  no_mma    the products dropped (their B conversion and ldmatrix with them)
  no_store  the output stores dropped (the split-K reduce still runs)

A knocked-out variant computes garbage: only its time is read, and with
ECC on, stale or garbage bytes send the correction down its rare path, so
the knock-outs are read with ECC off. Each time includes the split-K
reduce. Needs one card and nvcc:

    python3 scripts/ecdp_variants.py

Prints one line per shape and, last, the times as one JSON object.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

VARIANTS = {
    "base": [],
    "no_loads": [(
        '  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\\n" '
        '::"r"(d),\n               "l"(src), "r"(ok ? 16 : 0));', "")],
    "no_mma": [(
        "for (int j = 0; j < 4; ++j) mma_bf16(acc[mt][j], af, b0[j], b1[j]);",
        "for (int j = 0; j < 4; ++j)\n"
        "          acc[mt][j][0] += __uint_as_float(af[0] ^ b0[j] ^ b1[j]);")],
    "no_store": [(
        "    dst[(size_t)(m0 + r) * N] = whole ? v * sc : v;",
        "    if (v == 1234.5f) dst[(size_t)(m0 + r) * N] = whole ? v * sc : v;")],
}
SHAPES = [("wq/wo", 64, 4096, 4096), ("w_up", 64, 4096, 16384),
          ("w_down", 64, 16384, 4096), ("lm_head", 4, 4096, 50272),
          ("w_up@M512", 512, 4096, 16384), ("w_down@M512", 512, 16384, 4096),
          ("lm_head@M512", 512, 4096, 50272)]


def build_variants(build, ecdp, tmp: Path) -> dict:
    core = (build.CSRC / "ecdp_core.cuh").read_text()
    procs = {}
    for name, edits in VARIANTS.items():
        src = core
        for old, new in edits:
            if src.count(old) != 1:
                raise SystemExit(f"{name}: the text to alter has moved")
            src = src.replace(old, new)
        d = tmp / name
        d.mkdir()
        (d / "ecdp_core.cuh").write_text(src)
        (d / "ecdp.cu").write_text((build.CSRC / "ecdp.cu").read_text())
        procs[name] = subprocess.Popen(
            build.nvcc_command(d / "ecdp.cu", d / "ecdp.so"),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{out}")
        libs[name] = ecdp._bind(ctypes.CDLL(str(tmp / name / "ecdp.so")))
    return libs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("ecdp_variants: needs a CUDA card", file=sys.stderr)
        return 1
    from chip_smoke import Timer
    from repro_torch.core.tiering import encode_flash
    from repro_torch.kernels import build, ecdp

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    timer = Timer(torch)
    gen = torch.Generator(device="cuda").manual_seed(1)
    weights = {}
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_variants(build, ecdp, Path(tmp))
        for label, m, k, n in SHAPES:
            if (k, n) not in weights:
                weights[(k, n)] = encode_flash(
                    torch.randn((k, n), generator=gen, device="cuda"),
                    rber=1e-4, seed=1)
            fw = weights[(k, n)]
            a = torch.randn((m, k), generator=gen, device="cuda"
                            ).to(torch.bfloat16)
            row = {}
            for name, lib in libs.items():
                for ecc_on in (True, False):
                    row[f"{name}{'' if ecc_on else '/ecc_off'}"] = timer(
                        lambda: ecdp._launch(lib, a, fw.q, fw.parity,
                                             fw.scale, ecc_on))
            results[label] = row
            print(f"{label:13s} " + " | ".join(
                f"{key} {t:.4f}" for key, t in row.items()), flush=True)
    print(json.dumps({"device": smi, "ms": results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
