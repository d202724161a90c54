"""``repro_torch.defense`` — online Byzantine detection, worker reputation
and telemetry (port of ``repro.defense``).

  ``scores``     — the per-worker suspicion normalizers behind every rule's
                   ``reduce_with_scores`` hook;
  ``reputation`` — EMA trust state with hysteresis ejection/readmission,
                   threaded through the defended train step;
  ``detector``   — online q̂ estimation from score bimodality and the
                   empirical Δ-resilience monitor (``core/bounds.py``);
  ``telemetry``  — per-step JSONL records, in the reference's format.
"""
from repro_torch.defense.detector import (estimate_q,  # noqa: F401
                                          resilience_monitor)
from repro_torch.defense.reputation import (  # noqa: F401
    DefenseConfig, init_reputation, suspicion_of, update_reputation,
)
from repro_torch.defense.scores import (  # noqa: F401
    distance_ratio_scores, drop_frequency_scores,
)
from repro_torch.defense.telemetry import (TelemetryWriter,  # noqa: F401
                                           read_jsonl)
