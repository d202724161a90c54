"""Mean-around-median ("mediam"): Xie et al. 2018, "Generalized
Byzantine-tolerant SGD", the paper's companion.

Per coordinate: the coordinate-wise median is the center; the (m - b) values
nearest to it are averaged.  Structurally Phocas (Definition 8) with the
median in place of the b-trimmed mean.  It subclasses the trim-family base,
so the center, the nearest-(m - b) window, the drop-count scores and the
defense gate's median row all come from one ``selection.trim_family`` pass.
It declares no kernel, as in the reference, so it never reaches
``repro_torch.kernels``.
"""
from __future__ import annotations

from repro_torch.core.aggregators import _TrimFamilyRule
from repro_torch.core.registry import register_rule


@register_rule
class MeanAroundMedian(_TrimFamilyRule):
    name = "mediam"
    coordinate_wise = True
    resilience = "dimensional"
    has_kernel = False
    trim_kind = "mediam"

    def _baseline(self, m: int) -> float:
        # each coordinate drops the b farthest of m values
        return float(self.params.b) / m
