"""Telemetry record-kind schema (the `kind` vocabulary of the JSONL bus), a
copy of ``repro/obs/schema.py`` so both packages write the same records.

Every record the observability bus emits — whether through the legacy
``TelemetryWriter.log`` sink or the :class:`repro_torch.obs.Recorder` — carries a
``kind`` naming its record family.  ``SCHEMA`` is the registry of those
families: one entry per kind, mapping to the field names consumers may rely
on (advisory — a record may carry extra fields, but a consumer reading a
SCHEMA-listed field on a record of that kind gets a stable meaning).

:func:`check_kind` runs on every ``Recorder.emit``, so a typo'd kind fails
at its call site instead of silently forking the record stream.
"""
from __future__ import annotations

from typing import Dict, FrozenSet

# kind -> well-known fields (beyond the envelope keys "t"/"kind"/"step").
SCHEMA: Dict[str, FrozenSet[str]] = {
    # one sync-PS defended train step (topologies.SyncPS)
    "train": frozenset({"loss", "grad_norm", "suspicion", "reputation",
                        "active", "q_hat"}),
    # one buffered-async step (topologies.AsyncPS)
    "async": frozenset({"staleness_frac", "suspicion", "reputation",
                        "active", "q_hat"}),
    # one streaming-scan step (topologies.Streaming)
    "streaming": frozenset({"loss", "suspicion"}),
    # adapt_b fired: the online q-hat re-tuned the rule (topologies.SyncPS)
    "adapt": frozenset({"b", "q", "q_hat"}),
    # one ServeEngine iteration (queue depth / throughput)
    "serve": frozenset({"active", "queued", "produced", "free_blocks",
                        "admitted", "retired", "arch", "batch",
                        "prompt_len", "new_tokens", "wall_s", "tok_s",
                        "mesh"}),
    # one batched decode call (reserved for decode-step-level records)
    "decode": frozenset({"tokens", "slots", "ms"}),
    # per-step replicated robust-decode defense state (RobustDecoder)
    "robust_decode": frozenset({"rule", "k", "b", "scores", "reputation",
                                "active"}),
    # a point-in-time metric sample (Recorder close-time registry dump)
    "metric": frozenset({"name", "value", "labels", "type"}),
    # one timed span (Recorder.span with tracing enabled)
    "span": frozenset({"name", "ms", "labels"}),
    # one deadline-quorum collection round that saw faults (repro.faults;
    # lost_round marks rounds dropped for lack of a 2-worker quorum)
    "fault": frozenset({"present", "crashed", "retries", "timeouts",
                        "b_eff", "q_eff", "m_fresh", "lost_round"}),
    # one compressed aggregation round's wire accounting (repro.compress;
    # bytes counts flaky-retry resends, ratio = bytes / dense_bytes)
    "compress": frozenset({"codec", "bytes", "dense_bytes", "ratio"}),
    # a run restored from a checkpoint (topologies.SyncPS --resume;
    # fallback=True means the newest checkpoint was corrupt and the
    # rotated .prev one was used)
    "resume": frozenset({"path", "fallback", "b", "q"}),
    # a repro.analysis finding (python -m repro.analysis --jsonl)
    "analysis": frozenset({"rule", "severity", "path", "line", "message",
                           "hint"}),
}

def check_kind(kind: str) -> str:
    """Validate a record kind against the registry; returns it unchanged."""
    if kind not in SCHEMA:
        raise ValueError(
            f"unregistered telemetry kind {kind!r}; known kinds: "
            f"{', '.join(sorted(SCHEMA))} (register new kinds in "
            "repro_torch/obs/schema.py)")
    return kind
