"""Seeded AXIS001 violations: axis names outside AXIS_VOCAB."""
from repro_torch.dist import collectives
from repro_torch.dist.collectives import psum_axes
from repro_torch.dist.mesh import make_mesh
from repro_torch.dist.sharding import Mesh


def bad_make(world):
    return make_mesh((world, 1), ("data", "modle"))  # VIOLATION AXIS001


def bad_description():
    return Mesh(("dp", "model"), (4, 2))             # VIOLATION AXIS001


def bad_axis(mesh):
    return mesh.axis("batch")                        # VIOLATION AXIS001


def bad_axes(mesh):
    return mesh.axes(("data",
                      "expert"))                     # VIOLATION AXIS001


def bad_collective(x):
    return psum_axes(x, ("data", "dat"))             # VIOLATION AXIS001


def bad_module_collective(x):
    return collectives.gather_workers(
        x, worker_axes=("pods",))                    # VIOLATION AXIS001
