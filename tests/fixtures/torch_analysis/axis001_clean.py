"""Clean twin of axis001_violation.py: vocabulary names, or names the
check cannot see statically."""
from repro_torch.dist import collectives
from repro_torch.dist.mesh import make_mesh
from repro_torch.dist.sharding import Mesh, worker_axes_of


def make(world, names):
    return make_mesh((world, 1), names)


def description():
    return Mesh(("pod", "data", "model"), (2, 16, 16))


def axes(mesh):
    return mesh.axis("data"), mesh.axes(("data", "model"))


def collective(mesh, x):
    return collectives.gather_workers(x, mesh.axes(worker_axes_of(mesh)))
