"""Wrapper of the CUDA Krum Gram kernel K5 (``csrc/krum_gram.cu``).

K5 replaces ``repro/kernels/krum/kernel.py::pairwise_sq_dists_pallas``.  It is
bound by device-memory bytes (m*d input elements read once; the m(m+1)/2
products per coordinate stay far below the card's f32 rate at small m); the
design notes are in the source.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.krum.ref import pairwise_sq_dists_ref


def pairwise_sq_dists_hopper(u: torch.Tensor) -> torch.Tensor:
    """(m, d) f32/f16/bf16 -> (m, m) f32 squared distances, any m.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    or raises (a fake one only counts the kernel's cost,
    ``build.launch_gram``).  ``pairwise_sq_dists_hopper.launches`` counts
    kernel launches.
    """
    build.check_gram_matrix(u)
    if u.device.type == "cpu":
        return pairwise_sq_dists_ref(u)
    out = build.launch_gram(u)
    if not build.is_fake(u):
        pairwise_sq_dists_hopper.launches += 1
    return out


pairwise_sq_dists_hopper.launches = 0
