"""CLI: ``python -m repro_torch.analysis [paths...]``.

Prints one ``path:line: severity RULE: message  [fix: hint]`` line per
finding and a summary, and exits 1 when any error-severity finding survives
noqa filtering.  ``--jsonl PATH`` also writes the findings as records of
kind ``"analysis"`` in ``repro_torch.defense.telemetry``'s format
(``{"t", "kind", "step", ...}``).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import List, Optional

from repro_torch.analysis.engine import collect_files, run_analysis
from repro_torch.analysis.findings import Finding

DEFAULT_PATHS = ["src/repro_torch"]


def write_jsonl(findings: List[Finding], path: str) -> None:
    with open(path, "w", encoding="utf-8") as fh:
        for f in findings:
            rec = {"t": time.time(), "kind": "analysis", "step": 0}
            rec.update(f.to_record())
            fh.write(json.dumps(rec) + "\n")


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="repo-aware static analysis of the PyTorch/CUDA port: "
                    "plugin contracts, telemetry kinds, mesh axes, seed "
                    "provenance, kernel caps against the CUDA sources")
    ap.add_argument("paths", nargs="*", default=DEFAULT_PATHS,
                    help="files or directories to analyze (default: "
                         "src/repro_torch)")
    ap.add_argument("--jsonl", metavar="PATH",
                    help="also write findings as telemetry-style JSONL")
    ap.add_argument("--no-contracts", action="store_true",
                    help="skip the registry contract audit")
    ap.add_argument("--scan-modules", action="store_true",
                    help="import each FILE argument and audit the plugin "
                         "classes it defines (fixture hook)")
    args = ap.parse_args(argv)

    paths = args.paths or DEFAULT_PATHS
    t0 = time.perf_counter()
    findings = run_analysis(paths, contracts=not args.no_contracts,
                            scan_modules=args.scan_modules)
    for f in findings:
        print(f.render())
    if args.jsonl:
        write_jsonl(findings, args.jsonl)

    errors = sum(1 for f in findings if f.severity == "error")
    warnings = len(findings) - errors
    print(f"repro_torch.analysis: {errors} error(s), {warnings} warning(s) "
          f"in {len(paths)} path(s)")
    print(f"repro_torch.analysis: {len(collect_files(paths)[0])} file(s) in "
          f"{time.perf_counter() - t0:.2f} s")
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
