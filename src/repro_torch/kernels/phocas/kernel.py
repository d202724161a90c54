"""Wrappers of the CUDA phocas kernels K1 (``csrc/phocas.cu``) and K3
(``csrc/phocas_counts.cu``).

K1 replaces ``repro/kernels/phocas/kernel.py::phocas_pallas`` and K3
``phocas_counts_pallas``.  Both are bound by device-memory bytes (m*d input
elements read once, d f32 and for K3 m counts written once); the design notes
are in the sources.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.phocas.ref import phocas_counts_ref, phocas_ref


def phocas_hopper(u: torch.Tensor, b: int) -> torch.Tensor:
    """(m, d) f32/f16/bf16 -> (d,) f32 Phocas aggregate.

    Any m up to ``build.MAX_M["phocas"]``.  A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel or raises.
    ``phocas_hopper.launches`` counts kernel launches.
    """
    build.check_matrix(u, b, "phocas")
    if u.device.type == "cpu":
        return phocas_ref(u, b)
    out = build.launch("phocas", u, b)
    phocas_hopper.launches += 1
    return out


def phocas_counts_hopper(u: torch.Tensor, b: int):
    """(m, d) f32/f16/bf16 -> ((d,) f32 Phocas aggregate, (m,) f32 counts of
    the coordinates where each worker was among the b farthest from the
    b-trimmed mean).

    m <= ``build.MAX_M["phocas_counts"]``.  A CPU tensor takes the plain version; a
    CUDA tensor launches the kernel or raises.
    ``phocas_counts_hopper.launches`` counts kernel launches.
    """
    build.check_matrix(u, b, "phocas_counts")
    if u.device.type == "cpu":
        return phocas_counts_ref(u, b)
    out = build.launch("phocas_counts", u, b)
    phocas_counts_hopper.launches += 1
    return out


phocas_hopper.launches = 0
phocas_counts_hopper.launches = 0
