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
``backend="pallas"``, or ``"auto"`` on a CUDA tensor.
"""
from __future__ import annotations

import torch

from repro_torch.core import selection
from repro_torch.core.registry import AggregatorRule, register_rule


def mean(u: torch.Tensor) -> torch.Tensor:
    """Plain averaging — the non-robust default."""
    return u.float().mean(dim=0)


def median(u: torch.Tensor) -> torch.Tensor:
    """Coordinate-wise median (= trmean with maximal b for odd m)."""
    return selection.matrix_median(u)


def trmean(u: torch.Tensor, b: int) -> torch.Tensor:
    """Coordinate-wise b-trimmed mean (Definition 7)."""
    return selection.trim_family(u, b, "trmean")


def phocas(u: torch.Tensor, b: int) -> torch.Tensor:
    """Phocas (Definition 8)."""
    return selection.trim_family(u, b, "phocas")


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


@register_rule
class TrmeanRule(AggregatorRule):
    """b-trimmed coordinate-wise mean (Definition 7)."""
    name = "trmean"
    uses_b = True
    has_kernel = True

    def _reduce_plain(self, u):
        return trmean(u, self.params.b)

    def _reduce_kernel(self, u):
        from repro_torch.kernels import ops
        m = u.shape[0]
        return ops.trmean(u.reshape(m, -1), self.params.b).reshape(
            u.shape[1:])


@register_rule
class PhocasRule(AggregatorRule):
    """Phocas (Definition 8)."""
    name = "phocas"
    uses_b = True
    has_kernel = True

    def _reduce_plain(self, u):
        return phocas(u, self.params.b)

    def _reduce_kernel(self, u):
        from repro_torch.kernels import ops
        m = u.shape[0]
        return ops.phocas(u.reshape(m, -1), self.params.b).reshape(
            u.shape[1:])
