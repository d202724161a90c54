"""Meshes over the live ``torch.distributed`` world.

Port of ``repro/launch/mesh.py::make_host_mesh``.  One rank stands for one
device of the reference's mesh: a mesh of shape ``(s_0, ..., s_k)`` needs a
world of ``s_0 * ... * s_k`` ranks, and rank r sits at the row-major
coordinates of r, as ``jax.make_mesh`` lays devices out.  Each axis line of
the grid (the ranks that share every coordinate but one) gets its own
process group, so a collective "over axis a" runs in the group of ranks that
share this rank's other coordinates.  Axes of size 1 get no group: a
collective over them is the identity.

Each axis also records the forms its collectives take
(``dist/collectives.py``): ``"nccl"`` (one call a collective, a real
reduce-scatter) or ``"gloo"`` (CUDA tensors staged in pieces, a
reduce-scatter as an all_reduce and a cut).  By default they follow the
backend of the axis's group, ``dist.get_backend(group)``;
``make_mesh(..., forms=...)`` sets them, so that the NCCL forms can run on
a gloo world of CPU ranks (gloo takes ``reduce_scatter_tensor`` and
``all_gather_into_tensor`` on CPU tensors), and so that the dry run's fake
world, which has no real backend, says which forms it traces.

:func:`use_mesh` makes a mesh the ambient one of the code inside, as the
reference's ``with mesh:`` does around its jitted serve step: the model
layers read it through :func:`model_axis_size`, :func:`data_axis_size`
and :func:`model_axes` (``models/common.py``, ``models/moe.py``).  A pure
:class:`repro_torch.dist.sharding.Mesh` description, with no world, is
ambient too: it gives the axis sizes (the MoE's data-shard grouping) but
no groups, so the layers compute whole there.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import math
import threading
from typing import Any, Dict, Optional, Sequence, Tuple

import torch.distributed as dist

from repro_torch.dist.sharding import Mesh


@dataclasses.dataclass(frozen=True)
class Axis:
    """One mesh axis as this rank sees it: its name and size, this rank's
    coordinate on it, the process group of this rank's line along it (None
    for an axis of size 1) and the forms its collectives take (one of
    ``FORMS``)."""
    name: str
    size: int
    index: int
    group: Any = dataclasses.field(default=None, compare=False, repr=False)
    forms: str = dataclasses.field(default="gloo", compare=False)


@dataclasses.dataclass(frozen=True)
class HostMesh(Mesh):
    """A :class:`Mesh` over the live world: this rank's coordinates, one
    process group per axis line, and each axis's collective forms."""
    rank: int = 0
    coords: Tuple[int, ...] = ()
    groups: Dict[str, Any] = dataclasses.field(default_factory=dict,
                                               compare=False, repr=False)
    forms: Dict[str, str] = dataclasses.field(default_factory=dict,
                                              compare=False)

    def axis(self, name: str) -> Axis:
        i = self.axis_names.index(name)
        return Axis(name, self.axis_sizes[i], self.coords[i],
                    self.groups.get(name), self.forms.get(name, "gloo"))

    def axes(self, names: Sequence[str]) -> Tuple[Axis, ...]:
        return tuple(self.axis(n) for n in names)


def parse_mesh(mesh: str) -> Tuple[int, int]:
    """Parse a ``"DxM"`` mesh string into (data, model) axis sizes."""
    try:
        d, mm = (int(x) for x in mesh.split("x"))
        if d < 1 or mm < 1:
            raise ValueError
    except ValueError:
        raise ValueError(f"mesh must look like '4x2' (data x model), "
                         f"got {mesh!r}") from None
    return d, mm


# The collective forms an axis can take (``dist/collectives.py``).
FORMS = ("gloo", "nccl")


def _backend_forms(group=None) -> str:
    """The forms a group's backend takes: ``"nccl"`` for an NCCL group,
    ``"gloo"`` for any other real backend.  The fake backend has none."""
    backend = dist.get_backend(group)
    if backend == "fake":
        raise ValueError("the fake world has no collective backend: pass "
                         "make_mesh the forms to trace (forms='nccl' or "
                         "'gloo')")
    return "nccl" if backend == "nccl" else "gloo"


def make_mesh(shape: Sequence[int], names: Sequence[str], *,
              forms: Optional[str] = None) -> HostMesh:
    """A mesh of ``shape`` over the initialized world, whose size must be
    the product of ``shape``.  Every rank must call this with the same
    arguments, in the same order as its other group creations: each call
    creates the groups of every axis line, on every rank.  ``forms`` (one
    of ``FORMS``) sets every axis's collective forms; by default each
    axis takes its group's backend's (:func:`_backend_forms`)."""
    if forms is not None and forms not in FORMS:
        raise ValueError(f"forms {forms!r}; valid: {FORMS}")
    shape, names = tuple(int(s) for s in shape), tuple(names)
    if len(shape) != len(names):
        raise ValueError(f"mesh shape {shape} and axis names {names} differ "
                         "in length")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized "
                           "torch.distributed world")
    world = dist.get_world_size()
    if world != math.prod(shape):
        raise ValueError(f"mesh {dict(zip(names, shape))} needs "
                         f"{math.prod(shape)} ranks, the world has {world}")
    rank = dist.get_rank()
    coords = _unravel(rank, shape)
    groups, axis_forms = {}, {}
    for i, name in enumerate(names):
        if shape[i] == 1:
            continue
        others = [range(s) for j, s in enumerate(shape) if j != i]
        for rest in itertools.product(*others):
            line = []
            for c in range(shape[i]):
                at = list(rest)
                at.insert(i, c)
                line.append(_ravel(at, shape))
            group = dist.new_group(line)
            if rank in line:
                groups[name] = group
                axis_forms[name] = forms or _backend_forms(group)
    return HostMesh(axis_names=names, axis_sizes=shape, rank=rank,
                    coords=coords, groups=groups, forms=axis_forms)


def make_host_mesh(data: int = 1, model: int = 1, *,
                   forms: Optional[str] = None) -> HostMesh:
    """A ``(data, model)`` mesh over the initialized world."""
    return make_mesh((data, model), ("data", "model"), forms=forms)


def _unravel(rank: int, shape: Tuple[int, ...]) -> Tuple[int, ...]:
    out = []
    for s in reversed(shape):
        out.append(rank % s)
        rank //= s
    return tuple(reversed(out))


def _ravel(coords: Sequence[int], shape: Tuple[int, ...]) -> int:
    r = 0
    for c, s in zip(coords, shape):
        r = r * s + c
    return r


# ---------------------------------------------------------------------------
# The ambient mesh
# ---------------------------------------------------------------------------

_AMBIENT = threading.local()


@dataclasses.dataclass(frozen=True)
class Ambient:
    """The mesh of the code inside :func:`use_mesh`, whether the
    activations' batch rows are this rank's share of a batch sharded over
    the worker axes (else every rank holds the whole batch), whether
    the residual stream between layers is this rank's block of the
    sequence over the model axes (``models/stack.py::SEQ_SHARD``), and
    the FSDP layout of params that are this rank's FSDP shards
    (``dist/sharding.py::FsdpLayout``; the layers gather them on use),
    None for params that are blocks or whole."""
    mesh: Mesh
    batch_sharded: bool = False
    seq_sharded: bool = False
    fsdp: Any = None


def use_mesh(mesh: Mesh, *, batch_sharded: bool = False, fsdp=None):
    """Make ``mesh`` the ambient mesh of the code inside (thread-local)."""
    return ambient_as(Ambient(mesh, batch_sharded, fsdp=fsdp))


@contextlib.contextmanager
def ambient_as(value: Optional["Ambient"]):
    """Make ``value`` (what :func:`ambient` returned, None for no mesh)
    the ambient of the code inside: a recompute in the backward pass,
    which the autograd engine may run on another thread, re-enters the
    forward's."""
    prev = getattr(_AMBIENT, "value", None)
    _AMBIENT.value = value
    try:
        yield
    finally:
        _AMBIENT.value = prev


def ambient() -> Optional[Ambient]:
    """The innermost :func:`use_mesh`'s :class:`Ambient`, or None."""
    return getattr(_AMBIENT, "value", None)


def _axis_size(name: str) -> int:
    am = ambient()
    if am is None or name not in am.mesh.axis_names:
        return 0
    return am.mesh.shape[name]


def model_axis_size() -> int:
    """Size of the ambient mesh's ``model`` axis (0 when no mesh is
    active or it has none), as the reference's."""
    return _axis_size("model")


def data_axis_size() -> int:
    """Size of the ambient mesh's ``data`` axis (0 when none)."""
    return _axis_size("data")


def model_axes() -> Tuple[Axis, ...]:
    """The ambient world mesh's model axes of size > 1, with their groups:
    the axes a layer's collectives run over.  Empty without a mesh, on a
    pure description, and when every model axis has size 1."""
    from repro_torch.dist.sharding import model_axes_of
    am = ambient()
    if am is None or not isinstance(am.mesh, HostMesh):
        return ()
    return tuple(a for a in am.mesh.axes(model_axes_of(am.mesh))
                 if a.size > 1)


def data_axis() -> Optional[Axis]:
    """The ambient world mesh's ``data`` axis when the batch is sharded
    over it and it has size > 1, else None."""
    am = ambient()
    if (am is None or not am.batch_sharded
            or not isinstance(am.mesh, HostMesh)
            or "data" not in am.mesh.axis_names):
        return None
    ax = am.mesh.axis("data")
    return ax if ax.size > 1 else None
