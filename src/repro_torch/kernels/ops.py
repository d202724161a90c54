"""Public entry points of the trmean and phocas kernels, the rules' only way
to them (the reference's ``kernels/ops.py``)."""
from __future__ import annotations

import torch

from repro_torch.kernels.phocas.kernel import phocas_hopper
from repro_torch.kernels.trmean.kernel import trmean_hopper


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
