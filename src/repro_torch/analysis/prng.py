"""Seed-provenance analyzer (rules PRNG003, PRNG004).

Port of two of the four rules of ``repro/analysis/prng.py``.  The port
draws from ``torch.Generator`` objects seeded from the scenario's seed, so
a run is a function of its seed.  Two faults break that:

* PRNG003: ``hash()`` / ``id()`` / ``time.*()`` / ``random.*`` /
  ``np.random.*`` flowing into ``torch.manual_seed``,
  ``torch.cuda.manual_seed[_all]``, ``<generator>.manual_seed(...)`` or a
  ``seed=`` keyword (a seed that varies with ``PYTHONHASHSEED``, the
  address space or the clock);
* PRNG004: a constant seed (an int literal, or a module-level int
  constant) in one of those calls in library code (``src/repro_torch``):
  library seeds are threaded in by the caller; tests and scripts may fix
  them.

PRNG001 and PRNG002 have no counterpart (``findings.py`` says why).
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional

from repro_torch.analysis.astutil import (ImportTable, const_int,
                                          dotted_name,
                                          module_int_constants)
from repro_torch.analysis.findings import Finding

# Calls whose arguments are a seed: any ``.manual_seed(...)`` or
# ``.manual_seed_all(...)`` (torch's module-level functions and every
# generator's method).
_SEED_METHODS = frozenset({"manual_seed", "manual_seed_all"})

_TIME_FNS = frozenset({"time.time", "time.time_ns", "time.monotonic",
                       "time.monotonic_ns", "time.perf_counter",
                       "time.perf_counter_ns"})


def _is_seed_call(call: ast.Call) -> bool:
    return isinstance(call.func, ast.Attribute) \
        and call.func.attr in _SEED_METHODS


def _nondeterministic_source(expr: ast.expr,
                             imports: ImportTable) -> Optional[str]:
    for call in [n for n in ast.walk(expr) if isinstance(n, ast.Call)]:
        name = dotted_name(call.func)
        if name in ("hash", "id"):
            return f"{name}()"
        if name is None:
            continue
        resolved = imports.expand(name)
        if resolved in _TIME_FNS:
            return f"{resolved}()"
        if resolved.startswith("random.") \
                or resolved.startswith("numpy.random."):
            return f"{resolved}()"
    return None


def _seed_sources(path: str, call: ast.Call,
                  imports: ImportTable) -> List[Finding]:
    exprs: List[ast.expr] = []
    if _is_seed_call(call):
        exprs.extend(call.args)
        exprs.extend(kw.value for kw in call.keywords)
    else:
        exprs.extend(kw.value for kw in call.keywords if kw.arg == "seed")
    findings = []
    for expr in exprs:
        bad = _nondeterministic_source(expr, imports)
        if bad is not None:
            findings.append(Finding(
                rule="PRNG003", path=path, line=expr.lineno,
                message=f"nondeterministic {bad} feeds a generator seed "
                        "(varies per process/run)",
                hint="derive the value from stable data instead (e.g. "
                     "zlib.crc32 of a path string, or a threaded seed)"))
    return findings


def _constant_seed(path: str, call: ast.Call,
                   consts: Dict[str, int]) -> List[Finding]:
    if not _is_seed_call(call) or len(call.args) != 1 or call.keywords:
        return []
    value = const_int(call.args[0], consts)
    if value is None:
        return []
    return [Finding(
        rule="PRNG004", path=path, line=call.lineno,
        message=f"constant seed .{call.func.attr}({value}) in library "
                "code",
        hint="thread the seed in from the caller (tests and scripts may "
             "hard-code seeds; library code may not)")]


def analyze(path: str, tree: ast.Module, *, library_code: bool
            ) -> List[Finding]:
    """Run the seed-provenance rules over one parsed file."""
    imports = ImportTable(tree)
    consts = module_int_constants(tree)
    findings: List[Finding] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        findings.extend(_seed_sources(path, node, imports))
        if library_code:
            findings.extend(_constant_seed(path, node, consts))
    return findings
