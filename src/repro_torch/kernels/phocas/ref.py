"""Plain PyTorch version of the phocas kernel (K1), from the plain selection
path's pieces: NaN mapped to +inf, ``torch.sort``, the leftmost nearest
window on ties, and its masked sum in ascending order, for every b including
0, as the kernel does."""
from __future__ import annotations

import torch

from repro_torch.core.selection import (nearest_window_sum, sorted_rows,
                                        trimmed_mean_of_sorted, worker_rows)


def phocas_ref(u: torch.Tensor, b: int) -> torch.Tensor:
    """(m, d) -> (d,) f32: mean of the m-b values nearest the b-trimmed
    mean."""
    srows = sorted_rows(worker_rows(u))
    center = trimmed_mean_of_sorted(srows, b)
    total, _ = nearest_window_sum(srows, center, b)
    return total / (len(srows) - b)
