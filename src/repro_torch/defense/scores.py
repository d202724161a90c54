"""Per-worker suspicion scores, the defense's common currency.

The score contract: shape ``(m,)``, values in ``[0, 1]``, 0 = conforming,
1 = maximally suspicious.  The normalizers live in ``repro_torch.core
.registry`` (rules are in the core layer and must not import upward); this
module re-exports them under their defense-facing names.
"""
from repro_torch.core.registry import (  # noqa: F401
    distance_ratio_scores, drop_frequency_scores,
)
