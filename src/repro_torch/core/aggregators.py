"""The built-in aggregation rules (the paper's core contribution and its
baselines).

Port of ``repro/core/aggregators.py``.  Every rule consumes a worker-gradient
matrix ``u`` of shape ``(m, ...)`` and returns the aggregate of shape
``(...)`` in f32:

* ``mean``   — plain averaging, NOT resilient (Proposition 1);
* ``median`` — coordinate-wise median;
* ``trmean`` — Definition 7, b-trimmed coordinate-wise mean;
* ``phocas`` — Definition 8, mean of the (m-b) values nearest the b-trimmed
  mean, per coordinate;
* ``krum`` / ``multikrum`` — Definition 3 / Blanchard et al. baselines, over
  the full gradient vector;
* ``geomedian`` — the geometric median by Weiszfeld iterations.

trmean and phocas have CUDA kernels (``repro_torch.kernels``), reached through
``backend="pallas"``, or ``"auto"`` on a CUDA tensor.  They also emit the
defense's suspicion scores: how often the trim dropped each worker, from the
counts kernels on the kernel backend and from ``selection.trim_family`` on the
plain one.  krum and multikrum take their pairwise distances from the Krum
Gram kernel on the kernel backend, for the plain and the defended hooks alike;
the Weiszfeld loop is plain PyTorch, as in the reference, where it lies
outside any Pallas kernel.

Each rule's score hooks are written once, for the (m, D_slice) matrix one
rank of a mesh owns (``reduce_sharded*``, ``psum_axes`` the mesh axes its
statistics are summed over); the local hooks are those with no axes.  The
trim family sums its drop counts and coordinate totals before it normalizes;
krum and multikrum sum each slice's (m, m) distances (the Gram kernel's, on
the kernel backend), and with a gate the distances to the median row in the
same collective; geomedian sums its row norms and Weiszfeld distances.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.core import selection
from repro_torch.core.registry import (AggregatorRule, RuleParams,
                                       distance_ratio_scores,
                                       drop_frequency_scores, make_rule,
                                       register_rule)
from repro_torch.core.selection import vector_median
from repro_torch.kernels.krum.ref import pairwise_sq_dists_ref


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


def _psum(x: torch.Tensor, psum_axes: Sequence) -> torch.Tensor:
    """``x`` summed over ``psum_axes``; ``x`` itself when there are none."""
    if not psum_axes:
        return x
    from repro_torch.dist.collectives import psum_axes as psum
    return psum(x, psum_axes)


def psum_counts(counts: torch.Tensor, ncoords: torch.Tensor,
                psum_axes: Sequence):
    """(m,) per-worker counts and the coordinate total summed over
    ``psum_axes`` in one collective, in f64 so that the integer sums are
    exact at any width; returned as f32, as the local counts are."""
    if not psum_axes:
        return counts, ncoords
    packed = torch.cat([counts.double(), ncoords.double().reshape(1)])
    packed = _psum(packed, psum_axes).float()
    return packed[:-1], packed[-1]


def trim_mask_scores(stats_fn, mat: torch.Tensor, b: int, baseline: float,
                     psum_axes: Sequence = ()):
    """``stats_fn(mat, b) -> (agg, drop_counts, ncoords)``, with the counts
    and coordinates summed over ``psum_axes`` and normalized to ``(agg,
    scores)``."""
    agg, counts, ncoords = stats_fn(mat, b)
    counts, ncoords = psum_counts(counts, ncoords, psum_axes)
    return agg, drop_frequency_scores(counts, ncoords, baseline)


def fused_trim_family_scores(mat: torch.Tensor, b: int, kind: str,
                             baseline: float,
                             active: Optional[torch.Tensor],
                             psum_axes: Sequence = ()):
    """One-pass defended path for the trim family: raw drop-count scores
    AND the gated aggregate from one ``selection.trim_family`` pass."""
    return trim_mask_scores(
        lambda u, b_: selection.trim_family(u, b_, kind, active=active,
                                            with_scores=True),
        mat, b, baseline, psum_axes)


# ---------------------------------------------------------------------------
# Vector-wise (classic) rules: the Krum family and the geometric median
# ---------------------------------------------------------------------------

def _flat(u: torch.Tensor) -> torch.Tensor:
    return u.reshape(u.shape[0], -1).float()


def _pairwise_sq_dists(u: torch.Tensor) -> torch.Tensor:
    """(m, m) squared Euclidean distances via the Gram matrix, in f32."""
    return pairwise_sq_dists_ref(u.reshape(u.shape[0], -1))


def _krum_k(m: int, q: int) -> int:
    k = m - q - 2
    if k <= 0:
        raise ValueError(f"Krum requires m - q - 2 > 0 (m={m}, q={q})")
    return k


def _inf_diag(m: int, like: torch.Tensor) -> torch.Tensor:
    return torch.diag(torch.full((m,), torch.inf, dtype=like.dtype,
                                 device=like.device))


def _nearest_sums(d2: torch.Tensor, k: int) -> torch.Tensor:
    """Each row's k smallest entries summed, after a sort that puts NaN
    last (as ``jnp.sort`` does)."""
    return torch.sort(d2, dim=1).values[:, :k].sum(dim=1)


def krum_scores_from_d2(d2: torch.Tensor, q: int) -> torch.Tensor:
    """(m,) Krum scores from (m, m) squared distances: the sum of each
    worker's m - q - 2 smallest distances to the others."""
    m = d2.shape[0]
    return _nearest_sums(d2 + _inf_diag(m, d2), _krum_k(m, q))


def lowest_scores(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k lowest scores, the lower index first on ties and NaN
    last: the order of the reference's ``jax.lax.top_k(-scores, k)``.  A
    stable sort, since ``torch.topk``'s order on ties is not specified."""
    return torch.sort(scores, stable=True).indices[:k]


def krum_scores(u: torch.Tensor, q: int) -> torch.Tensor:
    """Per-worker Krum score: sum of squared distances to the m-q-2 nearest
    others."""
    return krum_scores_from_d2(_pairwise_sq_dists(u), q)


def krum(u: torch.Tensor, q: int) -> torch.Tensor:
    """Krum (Definition 3): the candidate with minimal score.  NOT
    dimensional-Byzantine resilient (Proposition 3); a baseline."""
    return _flat(u)[torch.argmin(krum_scores(u, q))].reshape(u.shape[1:])


def multikrum(u: torch.Tensor, q: int, k: Optional[int] = None
              ) -> torch.Tensor:
    """Multi-Krum: the mean of the k lowest-score candidates (Blanchard et
    al.); k = m - q - 2 by default."""
    if k is None:
        k = u.shape[0] - q - 2
    idx = lowest_scores(krum_scores(u, q), k)
    return _flat(u)[idx].mean(dim=0).reshape(u.shape[1:])


def krum_gated_scores(mat: torch.Tensor, active: torch.Tensor, q: int,
                      d2: Optional[torch.Tensor] = None,
                      psum_axes: Sequence = ()):
    """Raw AND reputation-gated Krum score sums from one distance matrix.

    The port of the reference's ``krum_gated_scores_sharded``.  The gated
    matrix replaces ejected rows by the raw median row ``med``, so its
    distances follow from the raw ones and each row's distance
    ``e_i = ||mat_i - med||^2`` to the median::

        d2_A(i, j) = a_i a_j d2(i, j) + a_i (1 - a_j) e_i
                                      + (1 - a_i) a_j e_j

    an O(m d) correction in place of a second O(m^2 d) pass.  ``d2`` is the
    raw (m, m) distance matrix of ``mat`` when the caller has it (the Gram
    kernel's); on a slice, ``d2`` and ``e`` are summed over ``psum_axes``
    together, as one (m + 1, m) block.
    """
    m = mat.shape[0]
    k = _krum_k(m, q)
    if d2 is None:
        d2 = _pairwise_sq_dists(mat)
    med = selection.matrix_median(mat)
    e = ((mat - med[None]) ** 2).sum(dim=1)
    if psum_axes:
        block = _psum(torch.cat([d2, e[None, :]]), psum_axes)
        d2, e = block[:m], block[m]
    a = active.to(d2.dtype)
    d2_gated = (a[:, None] * a[None, :] * d2
                + a[:, None] * (1.0 - a[None, :]) * e[:, None]
                + (1.0 - a[:, None]) * a[None, :] * e[None, :])
    inf_diag = _inf_diag(m, d2)
    return (_nearest_sums(d2 + inf_diag, k),
            _nearest_sums(d2_gated + inf_diag, k))


# Pre-Weiszfeld row clipping: rows whose norm exceeds this multiple of the
# median row norm are rescaled onto that cap.  Under the omniscient attack's
# 1e20 rows the unclipped fixed point cannot localize in a few iterations;
# benign rows share the median's norm scale, so clean runs are unchanged.
WEISZFELD_CLIP_FACTOR = 4.0


def clip_rows_to_norm_quantile(mat: torch.Tensor,
                               factor: float = WEISZFELD_CLIP_FACTOR,
                               eps: float = 1e-12,
                               psum_axes: Sequence = ()) -> torch.Tensor:
    """Rescale the rows of an (m, d) matrix (a slice of the full vectors,
    whose squared norms are summed over ``psum_axes``) so that no row's norm
    exceeds ``factor`` x the median row norm.  The median is
    ``jnp.median``'s: a NaN norm makes it NaN and leaves every row
    unclipped, as in the reference; so does a zero median, which carries no
    scale."""
    norms = torch.sqrt(_psum((mat * mat).sum(dim=1), psum_axes))
    cap = factor * vector_median(norms)
    scale = torch.where(
        cap > 0.0, torch.clamp(cap / torch.clamp(norms, min=eps), max=1.0),
        torch.ones_like(norms))
    return mat * scale[:, None]


def _row_sq_dists(mat: torch.Tensor, z: torch.Tensor,
                  psum_axes: Sequence) -> torch.Tensor:
    """(m,) squared distances of the rows to ``z``, summed over
    ``psum_axes``."""
    return _psum(((mat - z[None]) ** 2).sum(dim=1), psum_axes)


def geomedian_weiszfeld(mat: torch.Tensor, iters: int = 8, eps: float = 1e-8,
                        with_dists: bool = False, psum_axes: Sequence = ()):
    """Weiszfeld iterations on an (m, d) f32 matrix, from the mean, after
    the rows are norm-clipped (:func:`clip_rows_to_norm_quantile`).

    The port of the reference's ``geomedian_sharded``: on a slice the
    squared distances are summed over ``psum_axes``, so the weights see the
    full vectors while the iterate stays slice-local.  With
    ``with_dists=True`` also returns each worker's distance to the final
    iterate (the inverse Weiszfeld weight, the rule's suspicion statistic).
    """
    mat = clip_rows_to_norm_quantile(mat, psum_axes=psum_axes)
    z = mat.mean(dim=0)
    for _ in range(iters):
        d2 = _row_sq_dists(mat, z, psum_axes)
        w = 1.0 / torch.clamp(torch.sqrt(d2), min=eps)
        z = (mat * w[:, None]).sum(dim=0) / w.sum()
    if not with_dists:
        return z
    return z, torch.sqrt(_row_sq_dists(mat, z, psum_axes))


def geomedian(u: torch.Tensor, iters: int = 8,
              eps: float = 1e-8) -> torch.Tensor:
    """Geometric median via Weiszfeld iterations (Chen et al. family)."""
    return geomedian_weiszfeld(_flat(u), iters, eps).reshape(u.shape[1:])


@register_rule
class MeanRule(AggregatorRule):
    """Plain averaging — NOT Byzantine resilient (Proposition 1)."""
    name = "mean"
    resilience = "none"
    supports_streaming = True

    def _reduce_plain(self, u):
        return mean(u)


@register_rule
class MedianRule(AggregatorRule):
    """Coordinate-wise median — dimensional resilient."""
    name = "median"
    resilience = "dimensional"

    def _reduce_plain(self, u):
        return median(u)


class _TrimFamilyRule(AggregatorRule):
    """Score and gate plumbing shared by trmean, phocas and mediam.

    Subclasses set ``trim_kind`` (a ``selection.trim_family`` kind) and
    ``_baseline(m)``, the drop frequency an exchangeable benign worker
    expects.  On the plain backend one ``selection.trim_family`` pass gives
    the aggregate and the counts; the kernel backend is
    :class:`_TrimKernelRule`'s.
    """
    trim_kind = ""
    resilience = "dimensional"
    uses_b = True
    emits_scores = True
    fused_gate = True

    def _baseline(self, m: int) -> float:
        raise NotImplementedError

    def _reduce_plain(self, u):
        return selection.trim_family(u, self.params.b, self.trim_kind)[0]

    def _stats(self, u, b):
        return selection.trim_family(u, b, self.trim_kind, with_scores=True)

    def reduce_sharded_with_scores(self, mat, psum_axes=()):
        return trim_mask_scores(self._stats, mat, self.params.b,
                                self._baseline(mat.shape[0]), psum_axes)

    def reduce_sharded_gated_with_scores(self, mat, active, psum_axes=()):
        if self.uses_kernel(mat):
            return super().reduce_sharded_gated_with_scores(mat, active,
                                                            psum_axes)
        return fused_trim_family_scores(mat, self.params.b, self.trim_kind,
                                        self._baseline(mat.shape[0]), active,
                                        psum_axes)


class _TrimKernelRule(_TrimFamilyRule):
    """The trim-family rules with CUDA kernels, trmean and phocas: the
    kernel hooks live here and not on the family base, so that mediam, which
    has no kernel, inherits none (as the reference puts ``_reduce_pallas``
    on these two rules only).  On the kernel backend the counts come from
    the counts kernel and a gated aggregate, once a worker is ejected, from
    a second kernel launch (the base-class composition)."""
    has_kernel = True

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
        return super()._stats(u, b)


@register_rule
class TrmeanRule(_TrimKernelRule):
    """b-trimmed coordinate-wise mean (Definition 7)."""
    name = "trmean"
    trim_kind = "trmean"
    supports_streaming = True

    def _baseline(self, m: int) -> float:
        # each coordinate trims exactly 2b of m values
        return 2.0 * self.params.b / m


@register_rule
class PhocasRule(_TrimKernelRule):
    """Phocas (Definition 8)."""
    name = "phocas"
    trim_kind = "phocas"
    supports_streaming = True

    def _baseline(self, m: int) -> float:
        # each coordinate drops the b farthest of m values
        return float(self.params.b) / m


class _KrumFamilyRule(AggregatorRule):
    """Distance plumbing shared by krum and multikrum: on the kernel backend
    every hook, plain and defended, takes its (m, m) distances from the
    Gram kernel, so a step launches it once."""
    coordinate_wise = False
    resilience = "classic"
    uses_q = True
    has_kernel = True
    emits_scores = True
    fused_gate = True

    def _d2(self, mat: torch.Tensor) -> torch.Tensor:
        if self.uses_kernel(mat):
            from repro_torch.kernels import ops
            return ops.pairwise_sq_dists(mat)
        return _pairwise_sq_dists(mat)

    def _raw_scores(self, mat: torch.Tensor, psum_axes) -> torch.Tensor:
        """Krum scores of the (m, d_slice) ``mat`` from its distances
        summed over ``psum_axes``."""
        return krum_scores_from_d2(_psum(self._d2(mat), psum_axes),
                                   self.params.q)

    def _select(self, mat: torch.Tensor, scores: torch.Tensor):
        """The aggregate of the (m, d) ``mat`` the rule picks by ``scores``."""
        raise NotImplementedError

    def reduce_sharded(self, mat, psum_axes=()):
        flat = _flat(mat)
        return self._select(flat, self._raw_scores(flat, psum_axes)
                            ).reshape(mat.shape[1:])

    def reduce_sharded_with_scores(self, mat, psum_axes=()):
        flat = _flat(mat)
        raw = self._raw_scores(flat, psum_axes)
        return (self._select(flat, raw).reshape(mat.shape[1:]),
                distance_ratio_scores(raw))

    def reduce_sharded_gated_with_scores(self, mat, active, psum_axes=()):
        if active is None:
            return self.reduce_sharded_with_scores(mat, psum_axes)
        flat = _flat(mat)
        raw, gated = krum_gated_scores(flat, active, self.params.q,
                                       d2=self._d2(flat),
                                       psum_axes=psum_axes)
        agg = self._select(selection.gate_matrix(flat, active), gated)
        return agg.reshape(mat.shape[1:]), distance_ratio_scores(raw)


@register_rule
class KrumRule(_KrumFamilyRule):
    """Krum (Definition 3) — classic resilience only (Proposition 3)."""
    name = "krum"

    def _select(self, mat, scores):
        return mat[torch.argmin(scores)]

    def _reduce_plain(self, u):
        return krum(u, self.params.q)

    def _reduce_kernel(self, u):
        from repro_torch.kernels import ops
        return ops.krum(u.reshape(u.shape[0], -1),
                        self.params.q).reshape(u.shape[1:])


@register_rule
class MultikrumRule(_KrumFamilyRule):
    """Multi-Krum: the mean of the k lowest-score candidates."""
    name = "multikrum"

    def _k(self, m: int) -> int:
        k = self.params.multikrum_k
        return m - self.params.q - 2 if k is None else k

    def _select(self, mat, scores):
        return mat[lowest_scores(scores, self._k(mat.shape[0]))].mean(dim=0)

    def _reduce_plain(self, u):
        return multikrum(u, self.params.q, self.params.multikrum_k)

    def _reduce_kernel(self, u):
        from repro_torch.kernels import ops
        return ops.multikrum(u.reshape(u.shape[0], -1), self.params.q,
                             self.params.multikrum_k).reshape(u.shape[1:])


@register_rule
class GeomedianRule(AggregatorRule):
    """Geometric median (Weiszfeld) — Chen et al. family baseline."""
    name = "geomedian"
    coordinate_wise = False
    resilience = "classic"
    emits_scores = True
    fused_gate = True

    def _reduce_plain(self, u):
        return geomedian(u, iters=self.params.geomedian_iters)

    def reduce_sharded(self, mat, psum_axes=()):
        return geomedian_weiszfeld(_flat(mat), self.params.geomedian_iters,
                                   psum_axes=psum_axes).reshape(mat.shape[1:])

    def reduce_sharded_with_scores(self, mat, psum_axes=()):
        # Weiszfeld weight = 1/distance: far (down-weighted) = suspicious.
        z, dists = geomedian_weiszfeld(_flat(mat),
                                       self.params.geomedian_iters,
                                       with_dists=True, psum_axes=psum_axes)
        return z.reshape(mat.shape[1:]), distance_ratio_scores(dists)

    def reduce_sharded_gated_with_scores(self, mat, active, psum_axes=()):
        """One Weiszfeld run: the center of the gated matrix, and the RAW
        rows' distances to it as the scores."""
        if active is None:
            return self.reduce_sharded_with_scores(mat, psum_axes)
        flat = _flat(mat)
        z = geomedian_weiszfeld(selection.gate_matrix(flat, active),
                                self.params.geomedian_iters,
                                psum_axes=psum_axes)
        d2 = _row_sq_dists(flat, z, psum_axes)
        return z.reshape(mat.shape[1:]), distance_ratio_scores(torch.sqrt(d2))


# ---------------------------------------------------------------------------
# Name-based lookup (registry-backed)
# ---------------------------------------------------------------------------

def get_aggregator(name: str, *, b: int = 0, q: int = 0,
                   multikrum_k: Optional[int] = None,
                   geomedian_iters: int = 8, backend: str = "xla"):
    """Return a unary ``(m, ...) -> (...)`` aggregation closure by name.

    Thin compatibility wrapper over the registry: any rule registered via
    ``@register_rule`` (including single-file plugins) resolves here.
    Defaults to the plain torch path, as the reference's defaults to its
    jnp path; pass ``backend="auto"`` or ``"pallas"`` for the kernels.
    """
    rule = make_rule(name, RuleParams(b=b, q=q, multikrum_k=multikrum_k,
                                      geomedian_iters=geomedian_iters,
                                      backend=backend))
    return rule.reduce


# Deprecated: static snapshots kept for backwards compatibility.  The source
# of truth is the registry (registry.coordinate_wise_rules() / ...), which
# also covers plugin rules.
COORDINATE_WISE = frozenset({"mean", "median", "trmean", "phocas"})
VECTOR_WISE = frozenset({"krum", "multikrum", "geomedian"})
