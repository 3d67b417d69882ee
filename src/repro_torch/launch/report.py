"""Render the dry-run's JSONs (``python -m repro_torch.launch.dryrun``,
results/dryrun/*.json) into the §Dry-run / §Roofline markdown tables.

Port of ``repro.launch.report``: the same two tables from the same keys,
string for string.

  PYTHONPATH=src python -m repro_torch.launch.report [--dir results/dryrun]
"""

from __future__ import annotations

import argparse
import glob
import json
import os

__all__ = ["dryrun_table", "fmt_bytes", "fmt_s", "load", "main", "roofline_table"]


def fmt_bytes(b):
    if b is None:
        return "-"
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(b) < 1024:
            return f"{b:.1f}{unit}"
        b /= 1024
    return f"{b:.1f}PB"


def fmt_s(x):
    if x == 0:
        return "0"
    return f"{x:.2e}"


def load(dirpath):
    rows = []
    for path in sorted(glob.glob(os.path.join(dirpath, "*.json"))):
        with open(path) as f:
            rows.append(json.load(f))
    return rows


def roofline_table(rows, mesh="pod1_16x16"):
    out = [
        "| arch | shape | compute s | memory s | collective s | dominant | "
        "useful ratio | MFU@roofline | bytes/dev |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        if r.get("mesh") != mesh:
            continue
        if r["status"] == "skip":
            out.append(
                f"| {r['arch']} | {r['shape']} | — | — | — | *skip* | — | — | — |"
            )
            continue
        if r["status"] != "ok":
            out.append(
                f"| {r['arch']} | {r['shape']} | — | — | — | **ERROR** | — | — | — |"
            )
            continue
        rl = r["roofline"]
        out.append(
            f"| {r['arch']} | {r['shape']} | {fmt_s(rl['compute_s'])} | "
            f"{fmt_s(rl['memory_s'])} | {fmt_s(rl['collective_s'])} | "
            f"{rl['dominant']} | {rl['useful_flops_ratio']:.3f} | "
            f"{rl['mfu_at_roofline']*100:.2f}% | "
            f"{fmt_bytes(r['memory']['total_bytes'])} |"
        )
    return "\n".join(out)


def dryrun_table(rows):
    out = [
        "| arch | shape | mesh | status | args/dev | temp/dev | flops/dev | "
        "coll traffic/dev | #coll |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        if r["status"] == "skip":
            out.append(
                f"| {r['arch']} | {r['shape']} | {r['mesh']} | skip ({r['reason'][:40]}…) "
                f"| — | — | — | — | — |"
            )
            continue
        if r["status"] != "ok":
            out.append(
                f"| {r['arch']} | {r['shape']} | {r['mesh']} | **ERROR** "
                "| — | — | — | — | — |"
            )
            continue
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | ok | "
            f"{fmt_bytes(r['memory']['argument_bytes'])} | "
            f"{fmt_bytes(r['memory']['temp_bytes'])} | "
            f"{r['cost']['flops']:.2e} | "
            f"{fmt_bytes(r['collective_traffic_bytes'])} | {r['collective_count']} |"
        )
    return "\n".join(out)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="results/dryrun")
    ap.add_argument("--section", choices=["roofline", "dryrun", "both"], default="both")
    args = ap.parse_args()
    rows = load(args.dir)
    if args.section in ("roofline", "both"):
        print("### Roofline (single-pod 16x16)\n")
        print(roofline_table(rows))
        print()
    if args.section in ("dryrun", "both"):
        print("### Dry-run (both meshes)\n")
        print(dryrun_table(rows))


if __name__ == "__main__":
    main()
