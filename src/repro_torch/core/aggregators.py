"""The coordinate-wise aggregation rules (the paper's core contribution).

Port of the coordinate-wise half of ``repro/core/aggregators.py``.  Every
rule consumes a worker-gradient matrix ``u`` of shape ``(m, ...)`` and
returns the aggregate of shape ``(...)`` in f32:

* ``mean``   — plain averaging, NOT resilient (Proposition 1);
* ``median`` — coordinate-wise median;
* ``trmean`` — Definition 7, b-trimmed coordinate-wise mean;
* ``phocas`` — Definition 8, mean of the (m-b) values nearest the b-trimmed
  mean, per coordinate.

trmean and phocas have CUDA kernels (``repro_torch.kernels``), reached through
``backend="pallas"``, or ``"auto"`` on a CUDA tensor.  They also emit the
defense's suspicion scores: how often the trim dropped each worker, from the
counts kernels on the kernel backend and from ``selection.trim_family`` on the
plain one.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import selection
from repro_torch.core.registry import (AggregatorRule, drop_frequency_scores,
                                       register_rule)


def mean(u: torch.Tensor) -> torch.Tensor:
    """Plain averaging — the non-robust default."""
    return u.float().mean(dim=0)


def median(u: torch.Tensor) -> torch.Tensor:
    """Coordinate-wise median (= trmean with maximal b for odd m)."""
    return selection.matrix_median(u)


def trmean(u: torch.Tensor, b: int) -> torch.Tensor:
    """Coordinate-wise b-trimmed mean (Definition 7)."""
    return selection.trim_family(u, b, "trmean")[0]


def phocas(u: torch.Tensor, b: int) -> torch.Tensor:
    """Phocas (Definition 8)."""
    return selection.trim_family(u, b, "phocas")[0]


# ---------------------------------------------------------------------------
# Selection statistics (the defense's suspicion signal)
# ---------------------------------------------------------------------------

def trmean_stats(u: torch.Tensor, b: int):
    """``(agg, drop_counts, ncoords)``: ``drop_counts[i]`` counts the
    coordinates where worker i was among the b smallest or b largest."""
    return selection.trim_family(u, b, "trmean", with_scores=True)


def phocas_stats(u: torch.Tensor, b: int):
    """``(agg, drop_counts, ncoords)``: ``drop_counts[i]`` counts the
    coordinates where worker i was among the b farthest from the center."""
    return selection.trim_family(u, b, "phocas", with_scores=True)


def trim_mask_scores(stats_fn, mat: torch.Tensor, b: int, baseline: float):
    """``stats_fn(mat, b) -> (agg, drop_counts, ncoords)``, normalized to
    ``(agg, scores)``.  The reference sums counts and coordinates over the
    sharded axes first; this package has no sharded layout yet."""
    agg, counts, ncoords = stats_fn(mat, b)
    return agg, drop_frequency_scores(counts, ncoords, baseline)


def fused_trim_family_scores(mat: torch.Tensor, b: int, kind: str,
                             baseline: float,
                             active: Optional[torch.Tensor]):
    """One-pass defended path for the trim family: raw drop-count scores
    AND the gated aggregate from one ``selection.trim_family`` pass."""
    return trim_mask_scores(
        lambda u, b_: selection.trim_family(u, b_, kind, active=active,
                                            with_scores=True),
        mat, b, baseline)


@register_rule
class MeanRule(AggregatorRule):
    """Plain averaging — NOT Byzantine resilient (Proposition 1)."""
    name = "mean"

    def _reduce_plain(self, u):
        return mean(u)


@register_rule
class MedianRule(AggregatorRule):
    """Coordinate-wise median — dimensional resilient."""
    name = "median"

    def _reduce_plain(self, u):
        return median(u)


class _TrimFamilyRule(AggregatorRule):
    """Score and gate plumbing shared by trmean and phocas.

    Subclasses set ``trim_kind`` and ``_baseline(m)``, the drop frequency an
    exchangeable benign worker expects.  On the kernel backend the counts
    come from the counts kernel and a gated aggregate, once a worker is
    ejected, from a second kernel launch (the base-class composition); on
    the plain backend one ``selection.trim_family`` pass gives both.
    """
    trim_kind = ""
    uses_b = True
    has_kernel = True
    emits_scores = True
    fused_gate = True

    def _baseline(self, m: int) -> float:
        raise NotImplementedError

    def _reduce_plain(self, u):
        return selection.trim_family(u, self.params.b, self.trim_kind)[0]

    def _reduce_kernel(self, u):
        from repro_torch.kernels import ops
        fn = getattr(ops, self.trim_kind)
        m = u.shape[0]
        return fn(u.reshape(m, -1), self.params.b).reshape(u.shape[1:])

    def _kernel_stats(self, u, b):
        """(agg, drop_counts, ncoords) from the rule's counts kernel."""
        from repro_torch.kernels import ops
        fn = getattr(ops, f"{self.trim_kind}_with_counts")
        agg, counts = fn(u.reshape(u.shape[0], -1), b)
        return agg.reshape(u.shape[1:]), counts, selection.ncoords_of(u)

    def _stats(self, u, b):
        if self.uses_kernel(u):
            return self._kernel_stats(u, b)
        return selection.trim_family(u, b, self.trim_kind, with_scores=True)

    def reduce_with_scores(self, u):
        return trim_mask_scores(self._stats, u, self.params.b,
                                self._baseline(u.shape[0]))

    def reduce_gated_with_scores(self, u, active):
        if self.uses_kernel(u):
            return super().reduce_gated_with_scores(u, active)
        return fused_trim_family_scores(u, self.params.b, self.trim_kind,
                                        self._baseline(u.shape[0]), active)


@register_rule
class TrmeanRule(_TrimFamilyRule):
    """b-trimmed coordinate-wise mean (Definition 7)."""
    name = "trmean"
    trim_kind = "trmean"

    def _baseline(self, m: int) -> float:
        # each coordinate trims exactly 2b of m values
        return 2.0 * self.params.b / m


@register_rule
class PhocasRule(_TrimFamilyRule):
    """Phocas (Definition 8)."""
    name = "phocas"
    trim_kind = "phocas"

    def _baseline(self, m: int) -> float:
        # each coordinate drops the b farthest of m values
        return float(self.params.b) / m
