"""Wrappers of the CUDA trmean kernels K2 (``csrc/trmean.cu``) and K4
(``csrc/trmean_counts.cu``).

K2 replaces ``repro/kernels/trmean/kernel.py::trmean_pallas`` and K4
``trmean_counts_pallas``.  Both are bound by device-memory bytes (m*d input
elements read once, d f32 and for K4 m counts written once); the design notes
are in the sources.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.trmean.ref import trmean_counts_ref, trmean_ref


def trmean_hopper(u: torch.Tensor, b: int) -> torch.Tensor:
    """(m, d) f32/f16/bf16 -> (d,) f32 b-trimmed mean.

    Any m up to ``build.MAX_M["trmean"]``.  A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel or raises.
    ``trmean_hopper.launches`` counts kernel launches.
    """
    build.check_matrix(u, b, "trmean")
    if u.device.type == "cpu":
        return trmean_ref(u, b)
    out = build.launch("trmean", u, b)
    trmean_hopper.launches += 1
    return out


def trmean_counts_hopper(u: torch.Tensor, b: int):
    """(m, d) f32/f16/bf16 -> ((d,) f32 b-trimmed mean, (m,) f32 counts of
    the coordinates where each worker was among the b smallest or b
    largest).

    m <= ``build.MAX_M["trmean_counts"]``.  A CPU tensor takes the plain version; a
    CUDA tensor launches the kernel or raises.
    ``trmean_counts_hopper.launches`` counts kernel launches.
    """
    build.check_matrix(u, b, "trmean_counts")
    if u.device.type == "cpu":
        return trmean_counts_ref(u, b)
    out = build.launch("trmean_counts", u, b)
    trmean_counts_hopper.launches += 1
    return out


trmean_hopper.launches = 0
trmean_counts_hopper.launches = 0
