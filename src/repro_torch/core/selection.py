"""Per-coordinate selection over the worker axis, in plain PyTorch.

Port of ``repro/core/selection.py`` for the aggregates only (no drop scores
and no reputation gate; those come with the defense loop).  Every
coordinate-wise rule is built from the same pieces:

* :func:`worker_rows` splits an (m, *shape) block into m f32 rows with NaN
  mapped to +inf, so a NaN submission sorts last and is trimmed instead of
  poisoning the kept sum;
* :func:`sorted_rows` sorts the rows coordinate-wise with ``torch.sort``;
* :func:`trimmed_mean_of_sorted` and :func:`nearest_window_sum` read the
  trmean and phocas windows off the sorted rows as masked sums in ascending
  order, never as differences of prefix sums, which an adversarial 1e20 row
  would cancel away in f32.

The CUDA kernels in ``repro_torch/kernels`` compute the same arithmetic in
registers; this module is the plain path (``backend="xla"``).
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch


def worker_rows(u: torch.Tensor) -> List[torch.Tensor]:
    """Split an (m, *shape) block into m f32 rows, NaN mapped to +inf."""
    uf = u.float()
    return list(torch.where(torch.isnan(uf), torch.inf, uf).unbind(0))


def sorted_rows(rows: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Sort m same-shaped rows coordinate-wise ascending; returns m rows."""
    return list(torch.sort(torch.stack(list(rows)), dim=0).values.unbind(0))


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


def validate_b(m: int, b: int) -> None:
    if not 0 <= b <= (m + 1) // 2 - 1:
        raise ValueError(f"b={b} out of range [0, ceil(m/2)-1] for m={m}")


_KINDS = ("trmean", "phocas")


def trim_family(u: torch.Tensor, b: int, kind: str) -> torch.Tensor:
    """The trmean / phocas aggregate of an (m, *shape) block.

    The reference's ``trim_family`` with ``with_scores=False`` and
    ``active=None``; returns the aggregate only.
    """
    if kind not in _KINDS:
        raise ValueError(f"unknown trim-family rule kind {kind!r}")
    m = u.shape[0]
    validate_b(m, b)
    rows = worker_rows(u)
    if b == 0:
        return sum(rows[1:], start=rows[0]) / m
    srows = sorted_rows(rows)
    center = trimmed_mean_of_sorted(srows, b)
    if kind == "trmean":
        return center
    total, _ = nearest_window_sum(srows, center, b)
    return total / (m - b)


def matrix_median(u: torch.Tensor) -> torch.Tensor:
    """Coordinate-wise median of an (m, *shape) block."""
    return median_of_sorted(sorted_rows(worker_rows(u)))
