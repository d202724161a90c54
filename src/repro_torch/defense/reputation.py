"""EMA worker reputation: per-step suspicion into a persistent trust state
with hysteresis ejection and readmission.

Port of ``repro/defense/reputation.py``.  The state is the EMA

    rep_t = decay * rep_{t-1} + (1 - decay) * (1 - score_t)

with ``rep = 1`` fully trusted.  A worker is ejected when its reputation
falls below ``eject_below`` (after ``warmup_steps`` updates) and readmitted
only once it recovers to ``readmit_above``, so a worker near the threshold
does not flap in and out.  Ejected workers keep being scored, so a
transiently faulty worker earns its way back.

The state is a dict of tensors on the training device: ``reputation``,
``active`` (1 = in the aggregation) and ``presence`` are (m,) f32, ``steps``
is a 0-dim int32.  The gate that replaces ejected rows is
``core/selection.py::gate_matrix``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class DefenseConfig:
    """Serializable spec of the online defense."""
    reputation_decay: float = 0.9     # EMA decay toward the previous state
    eject_below: float = 0.5          # eject when reputation falls below
    readmit_above: float = 0.7        # readmit only after recovering above
    warmup_steps: int = 2             # no ejection before this many updates
    detector_min_gap: float = 0.2     # q-hat bimodality gap threshold
    telemetry_path: Optional[str] = None  # JSONL sink (None = off)
    # When True the sync_ps loop raises an under-provisioned b to the
    # detector's q̂ once q̂ > b for ``adapt_patience`` consecutive steps.
    adapt_b: bool = False
    adapt_patience: int = 2           # consecutive q̂ > b steps before adapting

    def __post_init__(self):
        if not 0.0 < self.reputation_decay < 1.0:
            raise ValueError(f"reputation_decay must be in (0, 1), got "
                             f"{self.reputation_decay}")
        if self.readmit_above < self.eject_below:
            raise ValueError("readmit_above must be >= eject_below "
                             "(hysteresis band)")
        if self.adapt_patience < 1:
            raise ValueError("adapt_patience must be >= 1, got "
                             f"{self.adapt_patience}")


def init_reputation(m: int, device=None) -> dict:
    """Fresh reputation state for m workers (all trusted, all active)."""
    ones = torch.ones((m,), dtype=torch.float32, device=device)
    return {
        "reputation": ones.clone(),
        "active": ones.clone(),               # 1 = in the aggregation
        "steps": torch.zeros((), dtype=torch.int32, device=device),
        # EMA availability, a liveness signal distinct from suspicion:
        # missing a round never lowers ``reputation`` (update_presence).
        "presence": ones,
    }


def update_reputation(state: dict, scores: torch.Tensor,
                      cfg: DefenseConfig) -> dict:
    """One EMA + hysteresis update from per-step suspicion ``scores``
    ((m,), in [0, 1]).  Extra keys of ``state`` pass through untouched."""
    d = cfg.reputation_decay
    rep = d * state["reputation"] + (1.0 - d) * (1.0 - scores)
    steps = state["steps"] + 1
    can_eject = (steps > cfg.warmup_steps).float()
    ejected = (rep < cfg.eject_below).float() * can_eject
    readmitted = (rep >= cfg.readmit_above).float()
    active = torch.clamp(state["active"] * (1.0 - ejected) + readmitted,
                         0.0, 1.0)
    return {**state, "reputation": rep, "active": active, "steps": steps}


def update_presence(state: dict, present: torch.Tensor,
                    cfg: DefenseConfig) -> dict:
    """Fold one round's (m,) 0/1 deadline outcome into the availability
    EMA.  Touches only ``presence``: absence must not feed the suspicion
    and ejection machinery."""
    d = cfg.reputation_decay
    prev = state.get("presence", torch.ones_like(state["reputation"]))
    pres = d * prev + (1.0 - d) * present.float()
    return {**state, "presence": pres}


def suspicion_of(state: dict) -> torch.Tensor:
    """The smoothed suspicion view of the state (1 - reputation)."""
    return 1.0 - state["reputation"]
