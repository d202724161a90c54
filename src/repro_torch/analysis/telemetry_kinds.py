"""Telemetry record-kind analyzer (rule CONTRACT010).

Port of ``repro/analysis/telemetry_kinds.py``.  Every record on the
observability bus carries a ``kind`` that consumers dispatch on
(``repro_torch/obs/schema.py`` is the registry).  A typo'd kind at a
``TelemetryWriter.log`` / ``Recorder.emit`` call site does not fail at run
time, since the writer serializes it all the same: it silently forks the
record stream away from every reader.  CONTRACT010 pins the literal first
argument of each ``.log(...)``/``.emit(...)`` call of the bus's shape
(``.log(<str literal>, <step>, ...)``) to the ``SCHEMA`` registry.

Only attribute calls named ``log`` or ``emit`` with at least two positional
arguments whose first is a string literal are checked, which leaves out
math and ``logging`` calls; a genuine collision can be silenced with
``# repro: noqa[CONTRACT010]``.
"""
from __future__ import annotations

import ast
from typing import FrozenSet, List

from repro_torch.analysis.findings import Finding

_METHOD_NAMES = frozenset({"log", "emit"})


def known_kinds() -> FrozenSet[str]:
    """The registered kind vocabulary (imported when called, so that the
    analyzer has no import-time dependency on the obs package)."""
    from repro_torch.obs.schema import SCHEMA
    return frozenset(SCHEMA)


def analyze(path: str, tree: ast.Module) -> List[Finding]:
    kinds = known_kinds()
    findings: List[Finding] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        if not (isinstance(fn, ast.Attribute) and fn.attr in _METHOD_NAMES):
            continue
        if len(node.args) < 2:
            continue
        first = node.args[0]
        if not (isinstance(first, ast.Constant)
                and isinstance(first.value, str)):
            continue
        kind = first.value
        if kind not in kinds:
            findings.append(Finding(
                rule="CONTRACT010", path=path, line=node.lineno,
                message=f".{fn.attr}() call uses unregistered telemetry "
                        f"kind {kind!r} (known: {', '.join(sorted(kinds))})",
                hint="register the kind in repro_torch/obs/schema.py "
                     "SCHEMA, or fix the typo at the call site"))
    return findings
