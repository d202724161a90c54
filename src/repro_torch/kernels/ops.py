"""Public entry points of the trmean and phocas kernels, the rules' only way
to them (the reference's ``kernels/{trmean,phocas}/ops.py``)."""
from __future__ import annotations

import torch

from repro_torch.kernels.phocas.kernel import (phocas_counts_hopper,
                                               phocas_hopper)
from repro_torch.kernels.trmean.kernel import (trmean_counts_hopper,
                                               trmean_hopper)


def _mean_and_no_counts(u: torch.Tensor):
    return u.float().mean(dim=0), torch.zeros(
        (u.shape[0],), dtype=torch.float32, device=u.device)


def trmean(u: torch.Tensor, b: int) -> torch.Tensor:
    """Coordinate-wise b-trimmed mean; (m, d) -> (d,) f32.

    b = 0 is the plain mean, as in the reference's ``ops.py``.
    """
    if b == 0:
        return u.float().mean(dim=0)
    return trmean_hopper(u, b)


def phocas(u: torch.Tensor, b: int) -> torch.Tensor:
    """Phocas aggregation; (m, d) -> (d,) f32.

    b = 0 is the plain mean, as in the reference's ``ops.py``.
    """
    if b == 0:
        return u.float().mean(dim=0)
    return phocas_hopper(u, b)


def trmean_with_counts(u: torch.Tensor, b: int):
    """Trimmed mean AND per-worker drop counts; (m, d) -> ((d,), (m,)) f32.

    The counts are the defense's suspicion statistic.  b = 0 is the plain
    mean with zero counts, as in the reference's ``ops.py``.
    """
    if b == 0:
        return _mean_and_no_counts(u)
    return trmean_counts_hopper(u, b)


def phocas_with_counts(u: torch.Tensor, b: int):
    """Phocas aggregate AND per-worker drop counts; (m, d) -> ((d,), (m,))
    f32.  b = 0 is the plain mean with zero counts, as in the reference's
    ``ops.py``."""
    if b == 0:
        return _mean_and_no_counts(u)
    return phocas_counts_hopper(u, b)
