"""Wrapper of the CUDA trmean kernel K2 (``csrc/trmean.cu``).

Replaces ``repro/kernels/trmean/kernel.py::trmean_pallas``.  The kernel is
bound by device-memory bytes (m*d input elements read once, d f32 written
once); the design note is in the source.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.trmean.ref import trmean_ref


def trmean_hopper(u: torch.Tensor, b: int) -> torch.Tensor:
    """(m, d) f32/f16/bf16 -> (d,) f32 b-trimmed mean.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    or raises.  ``trmean_hopper.launches`` counts kernel launches.
    """
    build.check_matrix(u, b)
    if u.device.type == "cpu":
        return trmean_ref(u, b)
    out = build.launch("trmean", u, b)
    trmean_hopper.launches += 1
    return out


trmean_hopper.launches = 0
