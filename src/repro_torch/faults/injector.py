"""Deadline-quorum collection: the runtime half of repro_torch.faults.

A copy of ``repro/faults/injector.py``: numpy only, so the same
``(faults, m, seed)`` gives the same :class:`FaultRound` sequence in both
packages, bit for bit.

The topology loops simulate one collection round per training step.  Every
worker owes one submission per round, due by the round's deadline; the
injector decides deterministically who makes it:

* ``crash(step)``  — present for rounds < step, absent forever after;
* ``silent``       — never present (omission from round 0);
* ``straggler(delay_steps, jitter)`` — a submission takes
  ``1 + delay_steps (+ uniform jitter)`` rounds to produce, so the worker
  meets the deadline only once per cycle (phase-offset by worker index so
  co-located stragglers don't synchronize);
* ``flaky(p_drop)`` — each send is lost with probability ``p_drop``; the
  collector retries with exponential backoff up to ``max_retries`` resends
  within the deadline.  Failed-then-retried sends count ``retries``; a
  worker whose every attempt dropped counts a ``timeout`` and is absent.

Determinism contract: ``collect(step)`` draws from a PRNG seeded by
``(seed, step)`` — stateless across rounds — so a resumed run replays the
exact fault sequence of the uninterrupted run (the bit-for-bit recovery
property tests/test_faults.py pins).

The aggregation then runs over the m' present workers with the rule's
b/q re-resolved against m' (:func:`resolve_quorum` via ``core/bounds.py``)
— phocas's trim width shrinks with the quorum instead of silently trimming
honest survivors, and a crashed Byzantine worker stops counting against
the attack budget.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from repro_torch.core.bounds import quorum_b, quorum_q
from repro_torch.faults.spec import FaultSpec, expand_faults

DEFAULT_MAX_RETRIES = 3

_NEVER = np.iinfo(np.int64).max


@dataclasses.dataclass
class FaultRound:
    """What one collection round observed."""
    present: np.ndarray     # (m,) bool — who made the deadline
    m_eff: int              # present.sum()
    retries: int            # flaky resends that eventually landed
    timeouts: int           # workers absent because every attempt dropped
    crashed: int            # permanently-gone workers (crash/silent) so far

    @property
    def degraded(self) -> bool:
        return self.m_eff < self.present.shape[0]

    @property
    def index(self) -> np.ndarray:
        """Present-worker indices, ascending (compaction order — surviving
        Byzantine prefix workers stay a prefix)."""
        return np.nonzero(self.present)[0]


class FaultInjector:
    """Deterministic per-round presence oracle for one training run."""

    def __init__(self, faults: Tuple[FaultSpec, ...], num_workers: int,
                 seed: int, *, max_retries: int = DEFAULT_MAX_RETRIES):
        m = num_workers
        self.m = m
        self.seed = int(seed)
        self.max_retries = int(max_retries)
        # Per-worker primitive fault parameters (vectorized presence math).
        self._crash_at = np.full(m, _NEVER, np.int64)
        self._strag_delay = np.zeros(m, np.int64)   # 0 = not a straggler
        self._strag_jitter = np.zeros(m, np.int64)
        self._flaky_p = np.zeros(m, np.float64)
        for kind, w, f in expand_faults(tuple(faults)):
            if kind == "crash":
                self._crash_at[w] = f.step
            elif kind == "silent":
                self._crash_at[w] = 0
            elif kind == "straggler":
                self._strag_delay[w] = f.delay_steps
                self._strag_jitter[w] = f.jitter
            elif kind == "flaky":
                self._flaky_p[w] = f.p_drop
            else:   # registry grew a kind the injector does not simulate
                raise NotImplementedError(
                    f"fault kind {kind!r} is registered but the injector "
                    "has no presence model for it")

    def collect(self, step: int) -> FaultRound:
        """Run one deadline-quorum collection round (host-side, O(m))."""
        rng = np.random.default_rng((self.seed, step))
        present = step < self._crash_at
        crashed = int(np.sum(~present))

        strag = self._strag_delay > 0
        if strag.any():
            jitter = rng.integers(0, self._strag_jitter + 1, self.m)
            cycle = 1 + self._strag_delay + jitter
            # Phase-offset by worker index so co-located stragglers
            # desynchronize; a worker is present when its cycle completes.
            arrives = (step + np.arange(self.m)) % cycle == 0
            present &= ~strag | arrives

        retries = timeouts = 0
        flaky = (self._flaky_p > 0) & present
        if flaky.any():
            # Attempt k lands with prob (1 - p); exponential backoff keeps
            # attempt k+1 inside the deadline for k <= max_retries.
            attempts = rng.random((self.max_retries + 1, self.m))
            landed = attempts >= self._flaky_p[None, :]
            ok = landed.any(axis=0)
            first = np.argmax(landed, axis=0)          # resends before landing
            retries = int(np.sum(first[flaky & ok]))
            timeouts = int(np.sum(flaky & ~ok))
            present &= ~flaky | ok

        return FaultRound(present=present, m_eff=int(np.sum(present)),
                          retries=retries, timeouts=timeouts,
                          crashed=crashed)


def make_injector(faults, num_workers: int, seed: int,
                  *, max_retries: int = DEFAULT_MAX_RETRIES
                  ) -> Optional[FaultInjector]:
    """An injector for the plan's fault axis, or None when it is empty —
    the no-faults loop must not pay even the O(m) presence math."""
    if not faults:
        return None
    return FaultInjector(tuple(faults), num_workers, seed,
                         max_retries=max_retries)


def resolve_quorum(robust_cfg, present: np.ndarray):
    """Re-resolve a RobustConfig against the round's live quorum.

    Returns ``(effective_cfg, q_attack_eff)`` where the rule's b/q are
    clamped to what ``core/bounds.py`` permits for m' present workers and
    the attack's ``num_byzantine`` shrinks to the Byzantine prefix workers
    that actually showed up (compaction preserves order, so surviving
    attackers stay rows ``0..q_eff-1`` of the compacted matrix).
    """
    import dataclasses as _dc

    from repro_torch.core import registry

    m_eff = int(np.sum(present))
    rule_meta = registry.get_rule(robust_cfg.rule)
    b_eff = quorum_b(m_eff, robust_cfg.b) if rule_meta.uses_b \
        else robust_cfg.b
    q_eff = quorum_q(m_eff, robust_cfg.q) if rule_meta.uses_q \
        else robust_cfg.q
    atk = robust_cfg.attack
    q_atk = int(np.sum(present[:atk.num_byzantine])) \
        if atk.name not in ("none", "") else 0
    if q_atk != atk.num_byzantine:
        atk = _dc.replace(atk, num_byzantine=q_atk)
    if (b_eff, q_eff, atk) == (robust_cfg.b, robust_cfg.q,
                               robust_cfg.attack):
        return robust_cfg, q_atk
    return _dc.replace(robust_cfg, b=b_eff, q=q_eff, attack=atk), q_atk
