"""Wrapper of the CUDA phocas kernel K1 (``csrc/phocas.cu``).

Replaces ``repro/kernels/phocas/kernel.py::phocas_pallas``.  The kernel is
bound by device-memory bytes (m*d input elements read once, d f32 written
once); the design note is in the source.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.phocas.ref import phocas_ref


def phocas_hopper(u: torch.Tensor, b: int) -> torch.Tensor:
    """(m, d) f32/f16/bf16 -> (d,) f32 Phocas aggregate.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    or raises.  ``phocas_hopper.launches`` counts kernel launches.
    """
    build.check_matrix(u, b)
    if u.device.type == "cpu":
        return phocas_ref(u, b)
    out = build.launch("phocas", u, b)
    phocas_hopper.launches += 1
    return out


phocas_hopper.launches = 0
