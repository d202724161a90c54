"""Byzantine-robust majority sign voting ("signvote"): the signSGD
aggregation of Bernstein et al. 2018, the compressed-domain rule.

Port of ``repro/core/rules/signvote.py``.  Per coordinate every worker casts
its sign as a vote; the aggregate is the majority sign (ties give 0).  The
vote reads nothing but the sign bits, so under the ``signbit`` codec the
rule aggregates losslessly in the compressed domain.  Flipping a
coordinate's outcome needs a majority of its m votes, so q < m/2 Byzantine
workers cannot move a coordinate the benign majority agrees on; magnitude is
not reconstructed, which makes the rule immune to scale inflation.

Suspicion: a worker's disagreement frequency with the majority sign,
baselined against the fleet's median disagreement.  The tally is a torch
reduction, as the reference's is an XLA one outside any Pallas kernel; the
rule declares no kernel.

On a slice of a mesh the disagreement counts and the coordinate total are
summed over the sharded axes before they are normalized.  The tally is not:
each rank holds every worker's vote on its coordinates, so its slice-local
majority is exact, and summing the tallies of different slices (as the
reference's sharded hooks do, ROADMAP queue 3) would mix coordinates.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.core.registry import AggregatorRule, register_rule
from repro_torch.core.selection import vector_median


def _vote_stats(mat: torch.Tensor, active: Optional[torch.Tensor],
                psum_axes: Sequence = ()):
    """Sign matrix, majority votes and per-worker disagreement counts (with
    the coordinate total, summed over ``psum_axes``).

    Scores observe the RAW signs while the majority is taken over the gated
    votes: an ejected worker's ballot counts as a 0 vote.
    """
    mat = mat.reshape(mat.shape[0], -1).float()
    signs = torch.sign(mat)
    votes = signs if active is None else signs * active[:, None]
    majority = torch.sign(votes.sum(dim=0))
    disagree = ((signs != majority[None, :]) & (signs != 0.0)).sum(
        dim=1).float()
    if not psum_axes:
        return majority, disagree, float(mat.shape[1])
    from repro_torch.core.aggregators import psum_counts
    ncoords = torch.tensor(float(mat.shape[1]), device=mat.device)
    return (majority, *psum_counts(disagree, ncoords, psum_axes))


def _normalize(disagree: torch.Tensor, ncoords) -> torch.Tensor:
    """Median-baselined disagreement frequency -> suspicion in [0, 1];
    ``ncoords`` is a float, or a tensor summed over a mesh's axes."""
    freq = disagree / (torch.clamp(ncoords, min=1.0)
                       if torch.is_tensor(ncoords) else max(ncoords, 1.0))
    base = vector_median(freq)
    return torch.clamp((freq - base) / torch.clamp(1.0 - base, min=1e-6),
                       0.0, 1.0)


@register_rule
class SignVote(AggregatorRule):
    name = "signvote"
    coordinate_wise = True
    resilience = "dimensional"
    emits_scores = True
    fused_gate = True           # one shared sign pass serves all outputs

    def _reduce_plain(self, u):
        return torch.sign(torch.sign(u.float()).sum(dim=0))

    def reduce_sharded_with_scores(self, mat, psum_axes=()):
        return self.reduce_sharded_gated_with_scores(mat, None, psum_axes)

    def reduce_sharded_gated_with_scores(self, mat, active, psum_axes=()):
        majority, disagree, n = _vote_stats(mat, active, psum_axes)
        return majority.reshape(mat.shape[1:]), _normalize(disagree, n)
