"""The dry run's tables: the roofline table and the skips, from a
directory of ``launch/dryrun.py`` records.

Port of ``experiments/make_report.py``.  Usage:

    python -m repro_torch.launch.make_report [DIR] [--tag TAG] > tables.md

(``DIR`` defaults to the dry run's ``dryrun_out``).  The terms come from
the H100 SXM data-sheet constants (``core/roofline.py``), not from a
measurement.  The multi-pod table waits for the multi-device port
(ROADMAP 1.11).
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.launch.dryrun import DEFAULT_OUT, MESH


def load(directory: str = DEFAULT_OUT, tag_filter=None) -> list[dict]:
    recs = []
    for path in sorted(glob.glob(os.path.join(directory, "*.json"))):
        with open(path) as f:
            r = json.load(f)
        if tag_filter and r.get("tag") not in tag_filter:
            continue
        recs.append(r)
    return recs


def fmt_roofline_table(recs, mesh: str = MESH) -> str:
    rows = []
    for r in recs:
        if r.get("skipped") or r.get("failed") or r["mesh"] != mesh:
            continue
        rf = r["roofline"]
        rows.append((
            r["arch"], r["shape"], rf["dominant"][:4],
            1e3 * rf["compute_s"], 1e3 * rf["memory_s"],
            1e3 * rf["collective_s"], rf["roofline_fraction"],
            rf["useful_flops_ratio"],
            r.get("memory", {}).get("per_chip_gib", float("nan")),
            r.get("t_trace_s", float("nan"))))
    rows.sort()
    out = ["| arch | shape | dom | compute ms | memory ms | coll ms | "
           "roofline frac | MODEL/counted flops | GiB/card | trace s |",
           "|---|---|---|---|---|---|---|---|---|---|"]
    for a, s, d, c, m, w, f, u, g, t in rows:
        out.append(f"| {a} | {s} | {d} | {c:.1f} | {m:.1f} | {w:.1f} | "
                   f"{f:.4f} | {u:.2f} | {g:.1f} | {t:.1f} |")
    return "\n".join(out)


def fmt_grid(recs, mesh: str = MESH) -> str:
    """One row an architecture, one column a shape: the dominant term,
    the roofline fraction, the bound (max of the terms) in seconds and the
    trace's peak GiB; "skip" for a documented skip."""
    from repro_torch.configs.base import SHAPES
    cells = {(r["arch"], r["shape"]): r for r in recs
             if r.get("mesh") == mesh or r.get("skipped")}
    out = ["| arch | " + " | ".join(SHAPES) + " |",
           "|---|" + "---|" * len(SHAPES)]
    for arch in sorted({a for a, _ in cells}):
        row = []
        for shape in SHAPES:
            r = cells.get((arch, shape))
            if r is None:
                row.append("—")
            elif r.get("skipped"):
                row.append("skip")
            elif r.get("failed"):
                row.append("FAILED")
            else:
                rf = r["roofline"]
                bound = max(rf["compute_s"], rf["memory_s"],
                            rf["collective_s"])
                row.append(f"{rf['dominant'][:4]} "
                           f"{rf['roofline_fraction']:.3f}, {bound:.4g} s, "
                           f"{r['memory']['per_chip_gib']:.1f} GiB")
        out.append(f"| {arch} | " + " | ".join(row) + " |")
    return "\n".join(out)


def fmt_skips(recs) -> str:
    out = []
    seen = set()
    for r in recs:
        if r.get("skipped") and (r["arch"], r["shape"]) not in seen:
            seen.add((r["arch"], r["shape"]))
            out.append(f"| {r['arch']} | {r['shape']} | {r['reason'][:80]} |")
    return "\n".join(["| arch | shape | reason |", "|---|---|---|"] + out)


def fmt_failures(recs) -> str:
    return "\n".join(f"| {r['arch']} | {r['shape']} | {r['error'][:80]} |"
                     for r in recs if r.get("failed"))


def report(directory: str = DEFAULT_OUT, tag: str = "baseline") -> str:
    recs = load(directory, {tag})
    parts = [f"## {tag} — one card (NVIDIA H100 SXM data-sheet constants, "
             f"not measured)\n", fmt_roofline_table(recs),
             "\n## the grid: dominant term, roofline fraction, bound, peak\n",
             fmt_grid(recs)]
    failed = fmt_failures(recs)
    if failed:
        parts += ["\n## failed cells\n", "| arch | shape | error |\n"
                  "|---|---|---|\n" + failed]
    parts += ["\n## documented skips\n", fmt_skips(load(directory))]
    return "\n".join(parts)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("directory", nargs="?", default=DEFAULT_OUT)
    p.add_argument("--tag", default="baseline")
    args = p.parse_args(argv)
    print(report(args.directory, args.tag))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
