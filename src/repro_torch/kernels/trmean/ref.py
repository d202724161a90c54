"""Plain PyTorch versions of the trmean kernels K2 and K4, from the plain
selection path's pieces: NaN mapped to +inf, ``torch.sort``, and the kept
window summed in ascending order, for every b including 0, as the kernels do.
K4's counts rank the raw rows with ``stable_ranks``."""
from __future__ import annotations

import torch

from repro_torch.core.selection import (_count_per_worker, sorted_rows,
                                        stable_ranks, trim_drop_masks,
                                        trimmed_mean_of_sorted, worker_rows)


def trmean_ref(u: torch.Tensor, b: int) -> torch.Tensor:
    """(m, d) -> (d,) f32: mean of the middle m-2b order statistics."""
    return trimmed_mean_of_sorted(sorted_rows(worker_rows(u)), b)


def trmean_counts_ref(u: torch.Tensor, b: int):
    """(m, d) -> ((d,) f32 trimmed mean, (m,) f32 counts): ``counts[i]`` is
    the number of coordinates where worker i was among the b smallest or b
    largest (highest worker index first on ties at the top, lowest at the
    bottom)."""
    rows = worker_rows(u)
    agg = trimmed_mean_of_sorted(sorted_rows(rows), b)
    counts = _count_per_worker(
        trim_drop_masks(stable_ranks(rows), b, "trmean"))
    return agg, counts
