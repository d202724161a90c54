"""Meshes over the live ``torch.distributed`` world.

Port of ``repro/launch/mesh.py::make_host_mesh``.  One rank stands for one
device of the reference's mesh: a mesh of shape ``(s_0, ..., s_k)`` needs a
world of ``s_0 * ... * s_k`` ranks, and rank r sits at the row-major
coordinates of r, as ``jax.make_mesh`` lays devices out.  Each axis line of
the grid (the ranks that share every coordinate but one) gets its own
process group, so a collective "over axis a" runs in the group of ranks that
share this rank's other coordinates.  Axes of size 1 get no group: a
collective over them is the identity.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Any, Dict, Sequence, Tuple

import torch.distributed as dist

from repro_torch.dist.sharding import Mesh


@dataclasses.dataclass(frozen=True)
class Axis:
    """One mesh axis as this rank sees it: its name and size, this rank's
    coordinate on it, and the process group of this rank's line along it
    (None for an axis of size 1)."""
    name: str
    size: int
    index: int
    group: Any = dataclasses.field(default=None, compare=False, repr=False)


@dataclasses.dataclass(frozen=True)
class HostMesh(Mesh):
    """A :class:`Mesh` over the live world: this rank's coordinates and
    one process group per axis line."""
    rank: int = 0
    coords: Tuple[int, ...] = ()
    groups: Dict[str, Any] = dataclasses.field(default_factory=dict,
                                               compare=False, repr=False)

    def axis(self, name: str) -> Axis:
        i = self.axis_names.index(name)
        return Axis(name, self.axis_sizes[i], self.coords[i],
                    self.groups.get(name))

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


def make_mesh(shape: Sequence[int], names: Sequence[str]) -> HostMesh:
    """A mesh of ``shape`` over the initialized world, whose size must be
    the product of ``shape``.  Every rank must call this with the same
    arguments, in the same order as its other group creations: each call
    creates the groups of every axis line, on every rank."""
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
    groups = {}
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
    return HostMesh(axis_names=names, axis_sizes=shape, rank=rank,
                    coords=coords, groups=groups)


def make_host_mesh(data: int = 1, model: int = 1) -> HostMesh:
    """A ``(data, model)`` mesh over the initialized world."""
    return make_mesh((data, model), ("data", "model"))


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

