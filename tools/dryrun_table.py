#!/usr/bin/env python3
"""Tabulate the dry run's records of both production meshes, one row a pair.

    python3 tools/dryrun_table.py results/dryrun16 results/dryrun32

Reads the JSON records ``python -m repro_torch.launch.dryrun --all [--multi-pod]
[--mode streaming] --out DIR`` wrote into each directory and prints a
Markdown table: per pair and directory, a rank's argument and peak GiB
(whether the peak fits 80 GiB), dot TFLOP, collective GB by kind
(all-gather / all-reduce / reduce-scatter / all-to-all) and the trace's
seconds; with ``--brief`` (first), the peak, whether it fits and the dot
TFLOP alone, so that four directories (both modes on both meshes) fit one
table:

    python3 tools/dryrun_table.py --brief vmap16 vmap32 stream16 stream32

Predictions for one NVIDIA H100 80GB HBM3 rank from a fake trace, not
measurements.
"""
from __future__ import annotations

import glob
import json
import os
import sys

GIB = 2 ** 30
KINDS = (("all-gather", "AG"), ("all-reduce", "AR"),
         ("reduce-scatter", "RS"), ("all-to-all", "A2A"))


def _records(directory: str) -> dict:
    out = {}
    for path in glob.glob(os.path.join(directory, "*.json")):
        with open(path) as f:
            rec = json.load(f)
        out[(rec["arch"], rec["shape"])] = rec
    return out


def _cell(rec, brief: bool = False) -> str:
    if rec is None:
        return "not run"
    if not rec.get("ok"):
        return f"FAIL: {rec.get('error', '')[:60]}"
    if brief:
        fits = "yes" if rec["peak_bytes"] <= 80 * GIB else "no"
        return (f"{rec['peak_bytes'] / GIB:.2f} | {fits} | "
                f"{rec['dot_flops'] / 1e12:.2f}")
    coll = rec["collectives"]["bytes"]
    fits = "yes" if rec["peak_bytes"] <= 80 * GIB else "no"
    gb = " / ".join(f"{coll.get(k, 0) / 1e9:.2f}" for k, _ in KINDS)
    return (f"{rec['argument_size_in_bytes'] / GIB:.2f} | "
            f"{rec['peak_bytes'] / GIB:.2f} | {fits} | "
            f"{rec['dot_flops'] / 1e12:.2f} | {gb} | {rec['trace_s']:.1f}")


def main(argv) -> int:
    brief = bool(argv) and argv[0] == "--brief"
    argv = argv[1:] if brief else argv
    meshes = [_records(d) for d in argv]
    keys = sorted(set().union(*meshes))
    names = " / ".join(n for _, n in KINDS)
    head = ["arch", "shape"]
    for d in argv:
        tag = os.path.basename(os.path.normpath(d))
        head += ([f"{tag} peak GiB", "fits", "dot TFLOP"] if brief else
                 [f"{tag} args GiB", "peak GiB", "fits 80 GiB", "dot TFLOP",
                  f"{names} GB", "trace s"])
    print("| " + " | ".join(head) + " |")
    print("|" + "---|" * len(head))
    for arch, shape in keys:
        cells = [_cell(m.get((arch, shape)), brief) for m in meshes]
        print(f"| {arch} | {shape} | " + " | ".join(cells) + " |")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
