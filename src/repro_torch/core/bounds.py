"""Theoretical Δ-resilience bounds from the paper (Lemma 1, Theorems 1-2).

Port of ``repro/core/bounds.py``, unchanged: pure Python, used by the
defense detector (``repro_torch.defense.detector._delta_bound``) to hold the
aggregate against the paper's own theory.
"""
from __future__ import annotations


def check_classic_assumption(m: int, q: int) -> bool:
    """Krum's assumption: 2q + 2 < m (Lemma 1)."""
    return 2 * q + 2 < m


def check_dimensional_assumption(m: int, q: int) -> bool:
    """Trmean/Phocas assumption: 2q < m per dimension (Theorems 1-2)."""
    return 2 * q < m


def delta_krum(m: int, q: int, V: float) -> float:
    """Δ₀ for Krum (Lemma 1, Blanchard et al. Proposition 1)."""
    if not check_classic_assumption(m, q):
        raise ValueError(f"Krum needs 2q+2 < m (m={m}, q={q})")
    return (6 * m - 6 * q
            + (4 * q * (m - q - 2) + 4 * q ** 2 * (m - q - 1)) / (m - 2 * q - 2)) * V


def delta_trmean(m: int, q: int, b: int, V: float) -> float:
    """Δ₁ = 2(b+1)(m-q)/(m-b-q)² · V (Theorem 1). Requires b >= q, 2q < m."""
    if not check_dimensional_assumption(m, q):
        raise ValueError(f"Trmean needs 2q < m (m={m}, q={q})")
    if b < q:
        raise ValueError(f"bound proved for b >= q (b={b}, q={q})")
    return 2.0 * (b + 1) * (m - q) / (m - b - q) ** 2 * V


def delta_phocas(m: int, q: int, b: int, V: float) -> float:
    """Δ₂ = [4 + 12(b+1)(m-q)/(m-b-q)²] · V (Theorem 2)."""
    if not check_dimensional_assumption(m, q):
        raise ValueError(f"Phocas needs 2q < m (m={m}, q={q})")
    if b < q:
        raise ValueError(f"bound proved for b >= q (b={b}, q={q})")
    return (4.0 + 12.0 * (b + 1) * (m - q) / (m - b - q) ** 2) * V


def quorum_b(m_eff: int, b: int) -> int:
    """Trim width re-resolved against a live quorum of m_eff workers.

    Trimmed-mean-family rules drop the b largest and b smallest entries per
    dimension, so they need 2b < m_eff, i.e. b <= ceil(m_eff/2) - 1.  When
    workers crash or miss a round's deadline, keeping the configured b would
    silently trim honest survivors; this clamps b to the widest trim the
    present workers support (never negative, never wider than configured).
    """
    if m_eff <= 0:
        return 0
    return max(0, min(b, (m_eff + 1) // 2 - 1))


def quorum_q(m_eff: int, q: int) -> int:
    """Byzantine budget re-resolved against a live quorum of m_eff workers.

    Clamped so Krum's classic assumption 2q + 2 < m_eff keeps holding for
    the present workers (q <= m_eff - 3); dimensional rules' 2q < m_eff is
    implied.  Never negative, never above the configured q.
    """
    if m_eff <= 0:
        return 0
    return max(0, min(q, m_eff - 3))


def codec_omega(codec: str, *, ratio: float = 0.01, d: int = 0) -> float:
    """Worst-case relative compression-error energy ω for a codec.

    ω bounds ‖u − dec(enc(u))‖² ≤ ω·‖u‖² per worker row, before error
    feedback re-injects the residual:

    * ``none``/``dense`` — lossless, ω = 0;
    * ``topk`` — dropping all but the top k = ratio·d magnitude entries
      keeps at least a ratio fraction of the energy when mass is spread
      worst-case uniformly, so ω = 1 − ratio;
    * ``signbit`` — magnitude is intentionally not transmitted (signSGD
      semantics), so the full energy is "error" relative to the dense
      row: ω = 1 (the aggregate direction, not magnitude, is what the
      signvote analysis bounds);
    * ``int8`` — stochastic rounding to 255 levels of [−max|u|, max|u|]:
      per-coordinate error ≤ scale = max|u|/127, summed worst-case over
      d coordinates against ‖u‖² ≥ max|u|², giving ω = d/(4·127²)
      (the d=0 default returns the per-coordinate factor).
    """
    c = codec.lower()
    if c in ("none", "", "dense"):
        return 0.0
    if c == "topk":
        return max(0.0, 1.0 - ratio)
    if c == "signbit":
        return 1.0
    if c == "int8":
        return max(d, 1) / (4.0 * 127.0 ** 2)
    raise ValueError(f"no ω model for codec {codec!r}")


def delta_compressed(delta: float, omega: float, V: float) -> float:
    """Δ-resilience bound inflated by codec error: Δ' = Δ + 2ω·V.

    The codec perturbs every *correct* worker's row by at most ω·‖u‖²
    relative energy, which widens the correct-gradient scatter the
    paper's Theorems 1-2 charge to V; the robust rule then pays that
    widening at most twice (once in selection, once in averaging).
    ω ≤ 0 returns Δ exactly (lossless codecs leave the bound alone).
    """
    if omega <= 0.0:
        return delta
    return delta + 2.0 * omega * V


def sgd_convex_error_floor(mu: float, L: float, gamma: float, delta: float) -> float:
    """Constant error term of Theorem 3: (μ+L)/(μL) · γ · √Δ."""
    return (mu + L) / (mu * L) * gamma * delta ** 0.5


def sgd_nonconvex_floor(delta: float) -> float:
    """Stationarity floor of Theorem 4 (the +Δ term)."""
    return delta
