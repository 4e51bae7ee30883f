"""Render the dry-run's tables from its JSON — the port of
``repro/launch/report.py``, over ``launch/dryrun.py``'s records.

    PYTHONPATH=src python -m repro_torch.launch.report [build/dryrun_torch]

Prints markdown: a summary, the dry-run table (arguments, peak, whether
the cell fits one H100, dominant term, bound) and the roofline table.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

_ORDER = {"train_4k": 0, "prefill_32k": 1, "decode_32k": 2, "long_500k": 3}


def _gib(b):
    return "-" if b is None else f"{b / 2**30:.2f}"


def _sorted(rows: list[dict]) -> list[dict]:
    return sorted(rows, key=lambda r: (r["arch"], _ORDER.get(r["shape"], 9),
                                       r["mesh"]))


def load(outdir: str) -> list[dict]:
    rows = []
    for f in sorted(Path(outdir).glob("*.json")):
        if f.name.endswith("_smoke.json"):
            continue
        rows.append(json.loads(f.read_text()))
    return rows


def dryrun_table(rows: list[dict]) -> str:
    out = ["| arch | shape | mesh | status | count s | args GiB | peak GiB "
           "| fits | dominant | t_bound ms |",
           "|---|---|---|---|---|---|---|---|---|---|"]
    for r in _sorted(rows):
        if r["status"] == "skipped":
            out.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                       "skip (sub-quadratic rule) | - | - | - | - | - | - |")
            continue
        if r["status"] == "error":
            out.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                       f"error: {r.get('error', '')[:60]} | - | - | - | - "
                       "| - | - |")
            continue
        m, rf = r["memory"], r["roofline"]
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | {r['status']} | "
            f"{r['build_s'] + r['count_s']:.1f} | "
            f"{_gib(m['argument_size_in_bytes'])} | "
            f"{_gib(m['peak_live_bytes'])} | "
            f"{'yes' if r['fits_card'] else 'no'} | "
            f"{rf['dominant'].replace('_s', '')} | "
            f"{rf['step_time_lower_bound_s'] * 1e3:.1f} |")
    return "\n".join(out)


def roofline_table(rows: list[dict], mesh: str = "1xH100") -> str:
    out = ["| arch | shape | compute s | memory s | collective s | dominant "
           "| MODEL_FLOPS | useful ratio | roofline frac |",
           "|---|---|---|---|---|---|---|---|---|"]
    for r in _sorted(rows):
        if r["mesh"] != mesh or r["status"] == "error":
            continue
        if r["status"] == "skipped":
            out.append(f"| {r['arch']} | {r['shape']} | - | - | - | "
                       f"skip | - | - | - |")
            continue
        rf = r["roofline"]
        out.append(
            f"| {r['arch']} | {r['shape']} | {rf['compute_s']:.3g} | "
            f"{rf['memory_s']:.3g} | {rf['collective_s']:.3g} | "
            f"{rf['dominant'].replace('_s', '')} | "
            f"{rf['model_flops']:.3g} | {rf['useful_flops_ratio']:.2f} | "
            f"{rf['roofline_fraction']:.4f} |")
    return "\n".join(out)


def summary(rows: list[dict]) -> str:
    n_ok = sum(r["status"] == "ok" for r in rows)
    n_skip = sum(r["status"] == "skipped" for r in rows)
    n_err = sum(r["status"] == "error" for r in rows)
    n_fit = sum(bool(r.get("fits_card")) for r in rows)
    return (f"{len(rows)} cells: {n_ok} counted ({n_fit} fit one H100 80GB), "
            f"{n_skip} skipped (documented sub-quadratic rule), "
            f"{n_err} errors")


def main():
    outdir = sys.argv[1] if len(sys.argv) > 1 else "build/dryrun_torch"
    rows = load(outdir)
    print("### Summary\n")
    print(summary(rows))
    print("\n### Dry-run (one H100)\n")
    print(dryrun_table(rows))
    print("\n### Roofline (one H100)\n")
    print(roofline_table(rows))


if __name__ == "__main__":
    main()
