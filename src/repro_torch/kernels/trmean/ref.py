"""Plain PyTorch version of the trmean kernel (K2), from the plain selection
path's pieces: NaN mapped to +inf, ``torch.sort``, and the kept window summed
in ascending order, for every b including 0, as the kernel does."""
from __future__ import annotations

import torch

from repro_torch.core.selection import (sorted_rows, trimmed_mean_of_sorted,
                                        worker_rows)


def trmean_ref(u: torch.Tensor, b: int) -> torch.Tensor:
    """(m, d) -> (d,) f32: mean of the middle m-2b order statistics."""
    return trimmed_mean_of_sorted(sorted_rows(worker_rows(u)), b)
