"""Plain PyTorch versions of the phocas kernels K1 and K3, from the plain
selection path's pieces: NaN mapped to +inf, ``torch.sort``, the leftmost
nearest window on ties, and its masked sum in ascending order, for every b
including 0, as the kernels do.  K3's counts rank the raw rows' distances to
the center with ``stable_ranks``."""
from __future__ import annotations

import torch

from repro_torch.core.selection import (_count_per_worker, nearest_window_sum,
                                        sorted_rows, stable_ranks,
                                        trim_drop_masks,
                                        trimmed_mean_of_sorted, worker_rows)


def phocas_ref(u: torch.Tensor, b: int) -> torch.Tensor:
    """(m, d) -> (d,) f32: mean of the m-b values nearest the b-trimmed
    mean."""
    srows = sorted_rows(worker_rows(u))
    center = trimmed_mean_of_sorted(srows, b)
    total, _ = nearest_window_sum(srows, center, b)
    return total / (len(srows) - b)


def phocas_counts_ref(u: torch.Tensor, b: int):
    """(m, d) -> ((d,) f32 Phocas aggregate, (m,) f32 counts): ``counts[i]``
    is the number of coordinates where worker i was among the b farthest
    from the b-trimmed mean (highest worker index first on ties)."""
    rows = worker_rows(u)
    srows = sorted_rows(rows)
    center = trimmed_mean_of_sorted(srows, b)
    total, _ = nearest_window_sum(srows, center, b)
    ranks = stable_ranks([(r - center).abs() for r in rows])
    counts = _count_per_worker(trim_drop_masks(ranks, b, "phocas"))
    return total / (len(rows) - b), counts
