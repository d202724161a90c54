"""``repro_torch.dist``: distributed robust aggregation over
``torch.distributed``.

Port of ``repro/dist``: mesh-role derivation and partition-spec rules
(:mod:`repro_torch.dist.sharding`), meshes over the live world with one
process group per axis line (:mod:`repro_torch.dist.mesh`), the per-axis
collectives of both layouts (:mod:`repro_torch.dist.collectives`), and the
launcher that runs a mesh scenario as one rank per mesh device
(:mod:`repro_torch.dist.launch`).
"""
from repro_torch.dist.collectives import (  # noqa: F401
    all_to_all_scatter, axis_size, gather_slices, gather_workers,
    psum_axes, worker_slice_index,
)
from repro_torch.dist.sharding import (  # noqa: F401
    MODEL_AXIS_NAMES, cache_pspec, model_axes_of, param_pspec_fsdp,
    tree_pspecs, worker_axes_of,
)
