"""Render the dry-run's tables from its JSON — the port of
``repro/launch/report.py``, over ``launch/dryrun.py``'s records.

    PYTHONPATH=src python -m repro_torch.launch.report [build/dryrun_torch]

Prints markdown: a summary, the dry-run table (arguments, peak, whether
the cell fits one H100, collectives, wire bytes, dominant term, bound),
the roofline table of each mesh present (one H100, 16x16, 2x16x16) and,
for the mesh cells, the collectives table (count, wire bytes by kind, the
collective term). Every number is one chip's.
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
           "| fits | collectives | wire GiB | dominant | t_bound ms |",
           "|---|---|---|---|---|---|---|---|---|---|---|---|"]
    for r in _sorted(rows):
        if r["status"] == "skipped":
            out.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                       "skip (sub-quadratic rule) |" + " - |" * 8)
            continue
        if r["status"] == "error":
            out.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                       f"error: {r.get('error', '')[:60]} |" + " - |" * 8)
            continue
        m, rf = r["memory"], r["roofline"]
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | {r['status']} | "
            f"{r['build_s'] + r['count_s']:.1f} | "
            f"{_gib(m['argument_size_in_bytes'])} | "
            f"{_gib(m['peak_live_bytes'])} | "
            f"{'yes' if r['fits_card'] else 'no'} | "
            f"{r['n_collectives']:.0f} | "
            f"{_gib(rf['wire_bytes_per_chip'])} | "
            f"{rf['dominant'].replace('_s', '')} | "
            f"{rf['step_time_lower_bound_s'] * 1e3:.1f} |")
    return "\n".join(out)


_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
          "collective-permute")


def collectives_table(rows: list[dict]) -> str:
    """The mesh cells' collectives: count, wire GiB by kind (count in
    parentheses), the collective term and the dominant term."""
    out = ["| arch | shape | mesh | collectives | " + " | ".join(
        f"{k} GiB" for k in _KINDS) + " | collective s | dominant |",
           "|---|---|---|---|" + "---|" * len(_KINDS) + "---|---|"]
    for r in _sorted(rows):
        if r["mesh"] == "1xH100" or r["status"] != "ok":
            continue
        rf, n = r["roofline"], r.get("collectives", {})
        wire = rf["collectives_by_op"]
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
            f"{r['n_collectives']:.0f} | " + " | ".join(
                f"{_gib(wire[k])} ({n.get(k, 0):.0f})" if k in wire else "-"
                for k in _KINDS)
            + f" | {rf['collective_s']:.3g} | "
              f"{rf['dominant'].replace('_s', '')} |")
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
    return (f"{len(rows)} cells: {n_ok} counted ({n_fit} fit one H100 80GB "
            "per chip), "
            f"{n_skip} skipped (documented sub-quadratic rule), "
            f"{n_err} errors")


def main():
    outdir = sys.argv[1] if len(sys.argv) > 1 else "build/dryrun_torch"
    rows = load(outdir)
    meshes = sorted({r["mesh"] for r in rows}, key=lambda m: m != "1xH100")
    print("### Summary\n")
    print(summary(rows))
    print("\n### Dry-run (per chip)\n")
    print(dryrun_table(rows))
    for mesh in meshes:
        name = "one H100" if mesh == "1xH100" else mesh
        print(f"\n### Roofline ({name})\n")
        print(roofline_table(rows, mesh))
    if any(m != "1xH100" for m in meshes):
        print("\n### Collectives (per chip, mesh cells)\n")
        print(collectives_table(rows))


if __name__ == "__main__":
    main()
