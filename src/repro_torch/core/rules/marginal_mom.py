"""Marginal median-of-means ("mom"): the marginal-median family of Xie et
al. 2018 crossed with the classic median-of-means estimator.

Workers are split round-robin into g = min(2b + 1, m) groups; each group's
gradients are averaged, then the coordinate-wise median of the g group means
is taken.  A Byzantine worker poisons at most one group, so b of them corrupt
at most b of the 2b + 1 means per coordinate, a strict minority.
"""
from __future__ import annotations

import torch

from repro_torch.core import selection
from repro_torch.core.registry import AggregatorRule, register_rule


@register_rule
class MarginalMedianOfMeans(AggregatorRule):
    name = "mom"
    coordinate_wise = True
    resilience = "dimensional"
    uses_b = True

    def _reduce_plain(self, u: torch.Tensor) -> torch.Tensor:
        m = u.shape[0]
        b = self.params.b
        selection.validate_b(m, b)
        uf = u.float()
        g = min(2 * b + 1, m)
        if g <= 1:
            return uf.mean(dim=0)
        gid = torch.arange(m, device=u.device) % g
        onehot = (gid[None, :] == torch.arange(g, device=u.device)[:, None]
                  ).float()
        counts = onehot.sum(dim=1)                             # (g,)
        sums = torch.tensordot(onehot, uf, dims=([1], [0]))    # (g, ...)
        means = sums / counts.reshape((g,) + (1,) * (uf.dim() - 1))
        return selection.matrix_median(means)
