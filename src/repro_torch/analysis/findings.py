"""Finding records and the ``# repro: noqa[RULE]`` escape hatch.

Port of ``repro/analysis/findings.py``.  Every analyzer emits
:class:`Finding` values, one per violation, carrying the rule id, severity,
anchor location, message and a fix hint.  ``to_record()`` gives the dict the
CLI writes as JSONL, in ``repro_torch.defense.telemetry``'s
one-record-per-line format.

Suppression is in-band and auditable: a ``# repro: noqa[RULE1,RULE2]``
comment on the flagged line silences exactly those rules there (a bare
``# repro: noqa`` silences all rules on the line); anything after the
bracket is the audit reason.  Contract findings anchor to the class or
function definition line, so the same mechanism covers them.

``RULES`` holds only the rules this package checks.  Three of the
reference's have no counterpart here:

* PRNG001 (a key consumed twice) and PRNG002 (a split result unused): a JAX
  key is a value that must be consumed once, but a ``torch.Generator``
  advances its own state at every draw, so a generator used twice draws
  two different streams and there is no split to leave unused;
* PALLAS001 (a ``BlockSpec`` lane dimension off the 128-lane TPU tile): no
  Python of the port sets a block shape.  The tiles are ``constexpr``s of
  the CUDA sources, which PALLAS003 holds against the Python caps.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple

SEVERITIES = ("error", "warning")

# Every rule id: severity and one-line meaning.
RULES: Dict[str, Tuple[str, str]] = {
    "PARSE001": ("error", "a file the gate was given does not read, parse "
                          "or import"),
    "PRNG003": ("error", "nondeterministic Python value (hash/id/time/"
                         "random) feeds a generator seed"),
    "PRNG004": ("error", "constant-literal seed in library code (seeds "
                         "must be threaded, not baked in)"),
    "AXIS001": ("error", "axis-name literal handed to a mesh outside the "
                         "dist/sharding.py AXIS_VOCAB"),
    "AXIS002": ("error", "dist.launch.spawn's arguments do not match the "
                         "rank function's (rank, world, *args) parameters"),
    "PALLAS002": ("error", "kernel cap constant assigned outside its "
                           "owning module"),
    "PALLAS003": ("error", "kernel cap in Python disagrees with the CUDA "
                           "sources (or a kernel source / ref oracle is "
                           "missing)"),
    "CONTRACT001": ("error", "emits_scores metadata inconsistent with the "
                             "reduce_sharded_with_scores override"),
    "CONTRACT002": ("error", "has_kernel metadata inconsistent with "
                             "_reduce_kernel / the kernels it reaches"),
    "CONTRACT003": ("error", "supports_streaming metadata inconsistent "
                             "with train/streaming.py's implemented rules"),
    "CONTRACT004": ("error", "uses_b/uses_q metadata inconsistent with "
                             "the params the rule actually reads"),
    "CONTRACT005": ("error", "attack closure does not match the "
                             "(gen, u, step=None) signature contract"),
    "CONTRACT006": ("error", "topology param_names does not cover the "
                             "topology_params keys run() actually reads"),
    "CONTRACT007": ("error", "fused_gate metadata inconsistent with the "
                             "reduce_sharded_gated_with_scores override"),
    "CONTRACT008": ("error", "attack_allowlist/STREAMING_ATTACKS entry "
                             "names an unregistered attack"),
    "CONTRACT009": ("error", "serving block allocator hands out or takes "
                             "back the reserved null block 0"),
    "CONTRACT010": ("error", "telemetry .log/.emit call site uses a record "
                             "kind not registered in repro_torch/obs/"
                             "schema.py"),
    "CONTRACT011": ("error", "topology fault_allowlist inconsistent with "
                             "repro_torch.faults (unregistered kind, or "
                             "fault support declared without run() "
                             "injecting plan.faults / vice versa)"),
    "CONTRACT012": ("error", "codec contract violated (encode/decode/"
                             "payload_bytes not implemented, or stateful "
                             "metadata inconsistent with the init_state "
                             "override)"),
}


@dataclasses.dataclass(frozen=True)
class Finding:
    """One analyzer violation (machine-readable; sorts by location)."""
    rule: str                       # rule id, e.g. "PRNG003"
    path: str                       # file the finding anchors to
    line: int                       # 1-indexed anchor line
    message: str                    # what is wrong, concretely
    hint: str = ""                  # how to fix it (or how to noqa it)
    severity: str = ""              # "" = the rule's registered severity

    def __post_init__(self):
        if self.rule not in RULES:
            raise ValueError(f"unknown analysis rule id {self.rule!r}")
        if not self.severity:
            object.__setattr__(self, "severity", RULES[self.rule][0])
        if self.severity not in SEVERITIES:
            raise ValueError(f"unknown severity {self.severity!r}")

    def to_record(self) -> dict:
        """JSONL record body (telemetry-writer compatible value types)."""
        return {"rule": self.rule, "severity": self.severity,
                "path": self.path, "line": int(self.line),
                "message": self.message, "hint": self.hint}

    def render(self) -> str:
        tail = f"  [fix: {self.hint}]" if self.hint else ""
        return (f"{self.path}:{self.line}: {self.severity} "
                f"{self.rule}: {self.message}{tail}")


# "# repro: noqa" | "# repro: noqa[PRNG003]" | "# repro: noqa[A,B] reason"
_NOQA_RE = re.compile(
    r"#\s*repro:\s*noqa(?:\[(?P<rules>[A-Z0-9_,\s]+)\])?")


def noqa_rules_of_line(line: str) -> Optional[FrozenSet[str]]:
    """Rules suppressed by this source line's noqa comment.

    Returns None when the line carries no repro-noqa comment, an empty
    frozenset for a bare ``# repro: noqa`` (suppress everything on the
    line), or the frozen set of named rule ids.
    """
    m = _NOQA_RE.search(line)
    if m is None:
        return None
    rules = m.group("rules")
    if not rules:
        return frozenset()
    return frozenset(r.strip() for r in rules.split(",") if r.strip())


def apply_noqa(findings: Sequence[Finding],
               source_lines: Dict[str, List[str]]) -> List[Finding]:
    """Drop findings suppressed by a noqa comment on their anchor line.

    ``source_lines`` maps path -> file lines; findings for paths not in the
    map (e.g. synthesized anchors) pass through unsuppressed.
    """
    kept = []
    for f in findings:
        lines = source_lines.get(f.path)
        if lines is not None and 1 <= f.line <= len(lines):
            suppressed = noqa_rules_of_line(lines[f.line - 1])
            if suppressed is not None and (not suppressed
                                           or f.rule in suppressed):
                continue
        kept.append(f)
    return kept
