"""Collectives over mesh axes, the building blocks of both robust-aggregation
layouts.

Port of ``repro/dist/collectives.py`` onto ``torch.distributed``.  Every
function takes its axes as a sequence of :class:`repro_torch.dist.mesh.Axis`
(``mesh.axes(names)``), in mesh order, and runs one collective per axis in
that axis's process group, in the reference's order of per-axis steps:

  * :func:`gather_workers`: replicated layout, the full (m, D) worker matrix
    on every rank;
  * :func:`all_to_all_scatter` / :func:`gather_slices`: sharded layout, each
    rank's (m, D/m) dimension slice of the worker matrix, and the rebuild of
    the aggregated vector from the (D/m,) slices;
  * :func:`axis_size` / :func:`worker_slice_index`: the geometry of a joint
    worker role (``("pod", "data")``) that spans several axes;
  * :func:`psum_axes`: the sum over axes of the vector-wise rules'
    statistics;
  * :func:`model_cuts` / :func:`cut_to_blocks` / :func:`join_blocks`: a
    rank's block of each leaf that ``tree_pspecs`` shards over the model
    axes, and the all_gather that rebuilds the leaves.

The backend is gloo on the CPU and on the card (every rank of a mesh on one
GPU shares it, which NCCL refuses); gloo stages CUDA tensors through the
host.  Each operation has one form, one that gloo takes for CUDA tensors in
torch 2.11 and 2.13 alike: ``all_reduce``, the list form of ``all_gather``
(``all_gather_into_tensor`` is deprecated in 2.13 for ``all_gather_single``,
which 2.11 lacks) and ``all_to_all_single`` (gloo has no list-form
``all_to_all``).  Collectives over an axis of size 1 are the identity.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.distributed as dist

from repro_torch import tree as tree_util


def axis_size(axes: Sequence) -> int:
    """Product of the sizes of ``axes``."""
    return math.prod(a.size for a in axes)


def _gather_cat(x: torch.Tensor, ax, dim: int) -> torch.Tensor:
    """all_gather over one axis, the parts concatenated along ``dim`` in
    the order of the ranks' coordinates (jax's tiled all_gather)."""
    if ax.size == 1:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(ax.size)]
    dist.all_gather(parts, x, group=ax.group)
    return torch.cat(parts, dim=dim)


def all_gather_axes(x: torch.Tensor, axes: Sequence,
                    dim: int = 0) -> torch.Tensor:
    """Tiled all_gather over ``axes`` along ``dim``, the last axis first,
    so the blocks come out in the joint (row-major) order of the axes."""
    for ax in reversed(tuple(axes)):
        x = _gather_cat(x, ax, dim)
    return x


def gather_workers(x: torch.Tensor, worker_axes: Sequence) -> torch.Tensor:
    """all_gather a (D,) local vector over the worker axes -> (m, D), row w
    from the rank whose joint worker index is w."""
    return all_gather_axes(x[None], worker_axes, 0)


def _all_to_all(u: torch.Tensor, ax, split_dim: int) -> torch.Tensor:
    """jax's tiled ``all_to_all(u, ax, split_dim, concat_axis=0)``: split
    the (R, C) ``u`` along ``split_dim`` into ``ax.size`` chunks, send chunk
    j to the rank at coordinate j, and stack what each rank i sent, in the
    order of i, along dim 0."""
    if ax.size == 1:
        return u
    n = ax.size
    if split_dim == 0:
        send = u.contiguous()
    else:
        send = u.reshape(u.shape[0], n, u.shape[1] // n).transpose(
            0, 1).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=ax.group)
    return recv.reshape(-1, send.shape[-1])


def all_to_all_scatter(x: torch.Tensor,
                       worker_axes: Sequence) -> torch.Tensor:
    """Re-tile a (D,) local vector into this rank's (m, D/m) slice.

    The reference's steps: an all_to_all over the first worker axis splits
    the vector along dim 0, one over each further axis splits the dimension
    slice along dim 1; the received blocks stack along the worker axis.
    The slice this rank ends with is the :func:`worker_slice_index`-th.
    After several axes the stacked rows come out with the LAST axis's
    coordinate outermost; they are put back in the joint worker order of
    :func:`gather_workers` (row w = worker w), where the reference leaves
    them permuted (ROADMAP queue 3).
    """
    axes = tuple(worker_axes)
    m = axis_size(axes)
    d = x.shape[0]
    if d % m:
        raise ValueError(f"flat dim {d} not divisible by m={m}")
    u = _all_to_all(x.reshape(axes[0].size, d // axes[0].size), axes[0], 0)
    for ax in axes[1:]:
        u = _all_to_all(u, ax, 1)
    if len(axes) > 1:
        sizes = [a.size for a in reversed(axes)]
        k = len(sizes)
        u = u.reshape(*sizes, d // m).permute(
            *reversed(range(k)), k).reshape(m, d // m)
    return u


def gather_slices(v: torch.Tensor, worker_axes: Sequence) -> torch.Tensor:
    """Inverse of the dimension tiling of :func:`all_to_all_scatter` for the
    aggregated (D/m,) slice -> (D,)."""
    return all_gather_axes(v, worker_axes, 0)


def worker_slice_index(worker_axes: Sequence) -> int:
    """Linearized (row-major) index of this rank along the joint worker
    axes: the worker it computes, and the dimension slice it owns."""
    idx = 0
    for ax in worker_axes:
        idx = idx * ax.size + ax.index
    return idx


def psum_axes(x: torch.Tensor, axes: Sequence) -> torch.Tensor:
    """Sum ``x`` over ``axes``, one all_reduce per axis in order; returns a
    new tensor."""
    out = x.contiguous().clone()
    for ax in axes:
        if ax.size > 1:
            dist.all_reduce(out, group=ax.group)
    return out


def model_cuts(tree, mesh) -> list:
    """Per leaf of ``tree`` (in ``repro_torch.tree.leaves`` order), the
    ``(dim, model axes)`` that ``tree_pspecs`` shards it on over ``mesh``,
    or None for a replicated leaf."""
    from repro_torch.dist.sharding import spec_leaves, tree_pspecs
    cuts = []
    for spec in spec_leaves(tree_pspecs(tree, mesh)):
        cut = None
        for dim, entry in enumerate(spec):
            if entry is not None:
                names = (entry,) if isinstance(entry, str) else entry
                cut = (dim, mesh.axes(names))
                break
        cuts.append(cut)
    return cuts


def cut_to_blocks(tree, cuts: list):
    """This rank's block of each model-sharded leaf (its joint coordinate
    on the leaf's axes picks the block); a replicated leaf whole."""
    return tree_util.unflatten(tree, [
        x if c is None else x.chunk(axis_size(c[1]), c[0])[
            worker_slice_index(c[1])].contiguous()
        for x, c in zip(tree_util.leaves(tree), cuts)])


def join_blocks(tree, cuts: list):
    """The inverse of :func:`cut_to_blocks`: each model-sharded leaf's
    blocks all_gathered over its axes."""
    return tree_util.unflatten(tree, [
        x if c is None else all_gather_axes(x, c[1], c[0])
        for x, c in zip(tree_util.leaves(tree), cuts)])
