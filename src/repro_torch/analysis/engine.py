"""File collection and analyzer orchestration for ``python -m
repro_torch.analysis``.

Port of ``repro/analysis/engine.py``.  The AST analyzers (prng, axes,
layout, telemetry_kinds) are pure per-file passes; the contract analyzer
imports the live registries.  Directory arguments are walked recursively
for ``*.py``, skipping ``__pycache__``, hidden directories and anything
under a ``fixtures`` directory: the seeded-violation corpus in
``tests/fixtures/torch_analysis/`` stays analyzable on demand (explicit
file arguments are always analyzed) without failing a run over the tree.
"""
from __future__ import annotations

import ast
import os
from typing import Dict, List, Sequence, Tuple

from repro_torch.analysis import axes, layout, prng, telemetry_kinds
from repro_torch.analysis.findings import Finding, apply_noqa

_SKIP_DIR_PARTS = frozenset({"__pycache__", "fixtures"})


def collect_files(paths: Sequence[str]) -> Tuple[List[str], bool]:
    """Expand path arguments to the .py files to analyze.

    Returns ``(files, saw_directory)``; explicit file arguments are always
    included, directory walks apply the skip rules.
    """
    files: List[str] = []
    saw_dir = False
    for p in paths:
        if os.path.isdir(p):
            saw_dir = True
            for root, dirnames, filenames in os.walk(p):
                dirnames[:] = sorted(
                    d for d in dirnames
                    if not d.startswith(".") and d not in _SKIP_DIR_PARTS)
                for fn in sorted(filenames):
                    if fn.endswith(".py"):
                        files.append(os.path.join(root, fn))
        else:
            files.append(p)
    seen = set()
    unique = []
    for f in files:
        key = os.path.abspath(f)
        if key not in seen:
            seen.add(key)
            unique.append(f)
    return unique, saw_dir


def is_library_code(path: str) -> bool:
    """Library code (PRNG004 applies): anything under src/repro_torch."""
    norm = os.path.normpath(os.path.abspath(path)).replace("\\", "/")
    return "/src/repro_torch/" in norm


def analyze_file(path: str, source: str) -> List[Finding]:
    """Run the per-file AST analyzers (noqa NOT yet applied)."""
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return [Finding(rule="PARSE001", path=path, line=e.lineno or 1,
                        message=f"file does not parse: {e.msg}",
                        hint="fix the syntax error")]
    findings: List[Finding] = []
    findings.extend(prng.analyze(path, tree,
                                 library_code=is_library_code(path)))
    findings.extend(axes.analyze(path, tree))
    findings.extend(layout.analyze(path, tree))
    findings.extend(telemetry_kinds.analyze(path, tree))
    return findings


def run_analysis(paths: Sequence[str], *, contracts: bool = True,
                 scan_modules: bool = False) -> List[Finding]:
    """Analyze ``paths`` and return noqa-filtered findings, sorted.

    ``contracts=True`` also audits the live plugin registries
    (CONTRACT*/PALLAS003) whenever a directory argument is present.
    ``scan_modules=True`` instead imports each explicit FILE argument and
    audits the plugin classes it defines (the broken-contract fixtures).
    """
    files, saw_dir = collect_files(paths)
    source_lines: Dict[str, List[str]] = {}
    findings: List[Finding] = []

    for path in files:
        try:
            with open(path, "r", encoding="utf-8") as fh:
                source = fh.read()
        except OSError as e:
            findings.append(Finding(
                rule="PARSE001", path=path, line=1,
                message=f"unreadable: {e}", hint="pass readable .py files"))
            continue
        source_lines[path] = source.splitlines()
        findings.extend(analyze_file(path, source))

    if scan_modules:
        from repro_torch.analysis import contracts as contracts_mod
        for path in files:
            findings.extend(contracts_mod.check_module(path))
    elif contracts and saw_dir:
        from repro_torch.analysis import contracts as contracts_mod
        findings.extend(contracts_mod.check_registry())

    # Contract findings anchor to files we may not have read yet; load
    # them so class-def-line noqa comments apply there too.
    for f in findings:
        if f.path not in source_lines and os.path.isfile(f.path):
            try:
                with open(f.path, "r", encoding="utf-8") as fh:
                    source_lines[f.path] = fh.read().splitlines()
            except OSError:
                pass

    kept = apply_noqa(findings, source_lines)
    kept.sort(key=lambda f: (f.path, f.line, f.rule, f.message))
    return kept
