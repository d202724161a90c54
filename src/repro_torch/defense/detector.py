"""Online Byzantine-count estimation and empirical Δ-resilience monitoring.

Port of ``repro/defense/detector.py``.

* :func:`estimate_q` reads q̂ off the bimodality of the per-worker suspicion
  scores: Byzantine workers cluster near 1, benign ones near 0, and the
  largest gap in the sorted scores splits the two modes.  A clean run has no
  decisive gap and q̂ = 0.
* :func:`resilience_monitor` holds one aggregation step to the paper's Δ
  bound (``core/bounds.py``): it estimates the benign variance V̂ from the
  low-suspicion rows, evaluates the rule's bound at (m, q̂, b), and compares
  the aggregate's squared deviation from the benign center with it.
"""
from __future__ import annotations

from typing import Optional

import torch


def estimate_q(scores: torch.Tensor, *, min_gap: float = 0.2
               ) -> torch.Tensor:
    """Estimate the Byzantine count from score bimodality; 0-dim int32.

    Sort suspicion descending; the largest gap among splits with q̂ <= m/2
    splits the suspicious mode from the benign one, and q̂ = the number of
    workers above it.  A gap is decisive when it reaches ``min_gap``, or when
    it spans 60% of the scores' spread and that spread reaches
    ``min_gap / 2`` (attenuated attacks land their mode well below 1).
    Otherwise q̂ = 0.
    """
    m = scores.shape[0]
    s = -torch.sort(-scores).values                 # descending
    gaps = s[:-1] - s[1:]                           # gap after position i
    valid = torch.arange(m - 1, device=scores.device) < (m // 2)
    gaps = torch.where(valid, gaps, -torch.inf)
    i = torch.argmax(gaps)                          # first of equal maxima
    spread = s[0] - s[-1]
    decisive = (gaps[i] >= min_gap) | (
        (gaps[i] >= 0.6 * spread) & (spread >= 0.5 * min_gap))
    return torch.where(decisive, i + 1, 0).to(torch.int32)


def _delta_bound(rule_name: str, m: int, q: int, b: int,
                 V: float) -> Optional[float]:
    """The paper's Δ bound for a rule at (m, q, b), or None where the theory
    has none (host-side helper over ``core/bounds.py``)."""
    from repro_torch.core import bounds
    try:
        if rule_name == "trmean":
            return bounds.delta_trmean(m, q, b, V)
        if rule_name in ("phocas", "mediam"):
            return bounds.delta_phocas(m, q, b, V)
        if rule_name in ("krum", "multikrum"):
            return bounds.delta_krum(m, q, V)
    except ValueError:
        return None      # assumption violated (2q >= m, b < q, ...)
    return None


def resilience_monitor(mat, agg, scores, *, rule_name: str, b: int,
                       min_gap: float = 0.2, codec: str = "none",
                       codec_ratio: float = 0.01) -> dict:
    """Empirical Δ-resilience check for one aggregation step (host-side).

    ``mat`` is the (m, d) worker matrix the rule saw (post-attack), ``agg``
    the (d,) aggregate, ``scores`` the (m,) suspicion; tensors or arrays.  A
    lossy ``codec`` widens the bound by the ω term of
    ``bounds.delta_compressed``.

    Returns ``q_hat``, the benign variance estimate ``v_hat``, the
    aggregate's squared deviation ``sq_dev`` from the benign center, the Δ
    bound at (m, q̂, b) (None where none applies) and ``within_bound``.
    """
    mat = torch.as_tensor(mat, dtype=torch.float32)
    agg = torch.as_tensor(agg, dtype=torch.float32, device=mat.device)
    scores = torch.as_tensor(scores, dtype=torch.float32, device=mat.device)
    m = mat.shape[0]
    q_hat = int(estimate_q(scores, min_gap=min_gap))
    # Presumed-benign population: everything below the detector's split.
    order = torch.argsort(-scores, stable=True)
    benign = mat[order[q_hat:]]
    center = benign.mean(dim=0)
    # V̂: per-worker variance around the benign mean, summed over the
    # dimensions (the V of Definition 5 / Theorems 1-2).
    v_hat = float(((benign - center[None]) ** 2).sum(dim=1).mean())
    sq_dev = float(((agg - center) ** 2).sum())
    bound = _delta_bound(rule_name, m, q_hat, b, v_hat)
    if bound is not None and codec not in ("none", "", "dense"):
        from repro_torch.core.bounds import codec_omega, delta_compressed
        omega = codec_omega(codec, ratio=codec_ratio, d=mat.shape[1])
        bound = delta_compressed(bound, omega, v_hat)
    return {
        "q_hat": q_hat,
        "v_hat": v_hat,
        "sq_dev": sq_dev,
        "delta_bound": bound,
        "within_bound": (sq_dev <= bound) if bound is not None else None,
    }
