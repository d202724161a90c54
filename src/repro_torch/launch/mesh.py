"""The production mesh and the card's roofline constants (port of
``repro/launch/mesh.py``).

``make_production_mesh`` returns a mesh *description*
(``dist/sharding.py::Mesh``: axis names and sizes, no devices): the dry run
(``launch/dryrun.py``) traces one rank of it in a fake world.  The meshes
over a live world, ``make_host_mesh`` among them, are ``dist/mesh.py``'s.

The constants are one NVIDIA H100 80GB HBM3's (SXM5, power limit 700.00 W),
from NVIDIA's data sheet: the rates the kernels' bounds in PERF.md divide
by.
"""
from __future__ import annotations

from repro_torch.dist.sharding import Mesh

PEAK_FLOPS_BF16 = 989e12          # FLOP/s, dense bf16 tensor cores
HBM_BW = 3.35e12                  # B/s, HBM3
NVLINK_BW = 450e9                 # B/s per direction (NVLink 4, 18 links)
HBM_BYTES = 80e9                  # bytes of device memory


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16×16 (data, model), or 2×16×16 (pod, data, model)."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))
