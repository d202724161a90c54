"""Per-coordinate selection over the worker axis, in plain PyTorch.

Port of ``repro/core/selection.py``.  Every coordinate-wise rule, its drop
counts (the defense's suspicion statistic) and the reputation gate are built
from the same pieces:

* :func:`worker_rows` splits an (m, *shape) block into m f32 rows with NaN
  mapped to +inf, so a NaN submission sorts last and is trimmed instead of
  poisoning the kept sum;
* :func:`sorted_rows` sorts the rows coordinate-wise with ``torch.sort``;
* :func:`trimmed_mean_of_sorted` and :func:`nearest_window_sum` read the
  trmean and phocas windows off the sorted rows as masked sums in ascending
  order, never as differences of prefix sums, which an adversarial 1e20 row
  would cancel away in f32;
* :func:`stable_ranks` gives each worker's stable-argsort rank by the
  reference's pairwise ``(key, worker index)`` predicate, which names the
  workers a trim drops;
* :func:`gate_matrix` replaces ejected workers' rows by the median row.

The CUDA kernels in ``repro_torch/kernels`` compute the same arithmetic in
registers; this module is the plain path (``backend="xla"``).
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch

# Above this worker count the O(m^2) pairwise ranks give way to a stable
# double argsort, as in the reference (equal results for non-NaN keys).
PAIRWISE_MAX_M = 64


def worker_rows(u: torch.Tensor) -> List[torch.Tensor]:
    """Split an (m, *shape) block into m f32 rows, NaN mapped to +inf."""
    uf = u.float()
    return list(torch.where(torch.isnan(uf), torch.inf, uf).unbind(0))


def sorted_rows(rows: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Sort m same-shaped rows coordinate-wise ascending; returns m rows."""
    return list(torch.sort(torch.stack(list(rows)), dim=0).values.unbind(0))


def stable_ranks(keys: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Stable-argsort ranks of m same-shaped rows, as m int32 rows.

    ``ranks[i]`` counts the workers j with ``k_j < k_i``, or ``k_j == k_i``
    and ``j < i``: the reference's pairwise predicate, so a NaN key ranks as
    it does there (it compares false both ways).  An argsort would place it
    last instead.  Above ``PAIRWISE_MAX_M`` workers a stable double argsort
    takes over, as in the reference.
    """
    k = torch.stack(list(keys))
    m = k.shape[0]
    if m > PAIRWISE_MAX_M:
        order = torch.argsort(k, dim=0, stable=True)
        return list(torch.argsort(order, dim=0, stable=True)
                    .to(torch.int32).unbind(0))
    idx = torch.arange(m, device=k.device).reshape((m,) + (1,) * (k.dim() - 1))
    ranks = torch.zeros(k.shape, dtype=torch.int32, device=k.device)
    for j in range(m):
        ranks += ((k[j] < k) | ((k[j] == k) & (j < idx))).to(torch.int32)
    return list(ranks.unbind(0))


def median_of_sorted(srows: Sequence[torch.Tensor]) -> torch.Tensor:
    """Coordinate-wise median from an already-sorted row list."""
    m = len(srows)
    if m % 2:
        return srows[m // 2]
    return 0.5 * (srows[m // 2 - 1] + srows[m // 2])


def trimmed_mean_of_sorted(srows: Sequence[torch.Tensor],
                           b: int) -> torch.Tensor:
    """b-trimmed mean (Definition 7) from an already-sorted row list."""
    kept = srows[b:len(srows) - b]
    if len(kept) == 1:
        return kept[0]
    return sum(kept[1:], start=kept[0]) / len(kept)


def nearest_window_sum(srows: Sequence[torch.Tensor], center: torch.Tensor,
                       drop: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sum of the (m - drop) values nearest ``center`` per coordinate.

    The nearest set is a contiguous window of the sorted order, so only
    drop+1 candidate windows exist.  Each is scored by its worst distance;
    the strictly smallest score wins, so ties go to the leftmost window.

    Returns ``(window_sum, window_start)``.
    """
    m = len(srows)
    k = m - drop
    if drop == 0:
        return (sum(srows[1:], start=srows[0]),
                torch.zeros_like(center, dtype=torch.int32))
    widths = [torch.maximum(center - srows[j], srows[j + k - 1] - center)
              for j in range(drop + 1)]
    best = widths[0]
    bestj = torch.zeros_like(center, dtype=torch.int32)
    for j in range(1, drop + 1):
        better = widths[j] < best
        best = torch.where(better, widths[j], best)
        bestj = torch.where(better, j, bestj)
    # Masked accumulation over the sorted rows, NOT a prefix-sum difference.
    total = torch.zeros_like(center)
    for p in range(m):
        keep = (bestj <= p) & (p < bestj + k)
        total = total + torch.where(keep, srows[p], 0.0)
    return total, bestj


def ncoords_of(u: torch.Tensor) -> torch.Tensor:
    """Count of coordinates per worker (trailing-shape product), as f32."""
    return torch.tensor(float(math.prod(u.shape[1:]) or 1),
                        dtype=torch.float32, device=u.device)


def _count_per_worker(drop_masks: Sequence[torch.Tensor]) -> torch.Tensor:
    """(m,) f32 count of the coordinates each worker's mask drops (summed
    as integers, so exact)."""
    return torch.stack([d.sum() for d in drop_masks]).float()


def trim_drop_masks(ranks: Sequence[torch.Tensor], b: int,
                    kind: str) -> List[torch.Tensor]:
    """Which coordinates drop each worker, from its stable ranks: trmean
    drops the b smallest and b largest values, phocas the b largest
    distances."""
    m = len(ranks)
    if kind == "trmean":
        return [(r < b) | (r >= m - b) for r in ranks]
    return [r >= m - b for r in ranks]


def validate_b(m: int, b: int) -> None:
    if not 0 <= b <= (m + 1) // 2 - 1:
        raise ValueError(f"b={b} out of range [0, ceil(m/2)-1] for m={m}")


_KINDS = ("trmean", "phocas")


def _gate_rows(rows: List[torch.Tensor], med: torch.Tensor,
               active: torch.Tensor) -> List[torch.Tensor]:
    """Rows of ejected workers (``active[i] == 0``) replaced by ``med``."""
    keep = active.reshape((len(rows),) + (1,) * med.dim()) > 0
    return list(torch.where(keep, torch.stack(rows), med).unbind(0))


def trim_family(u: torch.Tensor, b: int, kind: str, *,
                active: Optional[torch.Tensor] = None,
                with_scores: bool = False):
    """One shared selection pass behind trmean and phocas.

    From one sorted block of the raw (m, *shape) matrix: the rule's center
    and aggregate, with ``with_scores`` the per-worker drop counts of the
    RAW submissions (the defense's score statistic), and with ``active``
    the aggregate of the gated matrix, whose ejected rows are replaced by
    the raw median row.

    Returns ``(agg, drop_counts, ncoords)``; ``drop_counts`` is None unless
    ``with_scores``.  As in the reference, b = 0 is the plain mean in worker
    order, and still gated.
    """
    if kind not in _KINDS:
        raise ValueError(f"unknown trim-family rule kind {kind!r}")
    m = u.shape[0]
    validate_b(m, b)
    rows = worker_rows(u)
    counts = None
    if b == 0:
        if with_scores:
            counts = torch.zeros((m,), dtype=torch.float32, device=u.device)
        if active is not None:
            rows = _gate_rows(rows, median_of_sorted(sorted_rows(rows)),
                              active)
        return sum(rows[1:], start=rows[0]) / m, counts, ncoords_of(u)

    srows = sorted_rows(rows)
    center = trimmed_mean_of_sorted(srows, b)
    if with_scores:
        keys = rows if kind == "trmean" else [
            (r - center).abs() for r in rows]
        counts = _count_per_worker(
            trim_drop_masks(stable_ranks(keys), b, kind))
    if active is not None:
        # Ejected rows -> the raw matrix's median row, read off the sorted
        # block; then re-sort and re-center.
        rows = _gate_rows(rows, median_of_sorted(srows), active)
        srows = sorted_rows(rows)
        center = trimmed_mean_of_sorted(srows, b)
    if kind == "trmean":
        return center, counts, ncoords_of(u)
    total, _ = nearest_window_sum(srows, center, b)
    return total / (m - b), counts, ncoords_of(u)


def matrix_median(u: torch.Tensor) -> torch.Tensor:
    """Coordinate-wise median of an (m, *shape) block."""
    return median_of_sorted(sorted_rows(worker_rows(u)))


def gate_matrix(mat: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """Replace ejected workers' rows before an aggregation rule runs.

    ``active`` is the (m,) 0/1 mask of the reputation state.  Ejected rows
    become the matrix's coordinate-wise median; the rule still sees m rows.
    An all-ones mask returns the input, as the reference's concrete-mask
    short-circuit does: the gate costs nothing until a worker is ejected.
    PyTorch runs eagerly, so the mask is always concrete and this reads the
    (m,) mask to the host once per defended step.
    """
    if bool((active > 0).all()):
        return mat
    med = matrix_median(mat)
    keep = active.reshape((mat.shape[0],) + (1,) * (mat.dim() - 1))
    return torch.where(keep > 0, mat, med[None].to(mat.dtype))
