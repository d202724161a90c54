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
    axes, and the all_gather that rebuilds the leaves;
  * :func:`copy_to_model` / :func:`reduce_from_model` /
    :func:`gather_from_model` / :func:`scatter_to_model` /
    :func:`reduce_scatter_to_model`: the tensor-parallel layers' operators
    (Megatron's f and g, a gather, and sequence parallelism's split and
    reduce-scatter), ``torch.autograd.Function``s that differentiate
    under ``torch.func.grad``/``vjp``.  They carry no vmap
    rule: a rank computes one worker group, so nothing vmaps over them.

The backend is gloo on the CPU and on the card (every rank of a mesh on one
GPU shares it, which NCCL refuses); gloo stages CUDA tensors through the
host.  Each operation has one form, one that gloo takes for CUDA tensors in
torch 2.11 and 2.13 alike: ``all_reduce``, the list form of ``all_gather``
(``all_gather_into_tensor`` is deprecated in 2.13 for ``all_gather_single``,
which 2.11 lacks) and ``all_to_all_single`` (gloo has no list-form
``all_to_all``).  Collectives over an axis of size 1 are the identity.
The model-axis sums take bf16 and f16 operands in f32 and round once at
the end, so a sum of tp partial products is rounded as one product is.
gloo stages a CUDA tensor through pinned host buffers, which PyTorch's
host allocator keeps: an all_gather or all_to_all of a CUDA tensor moves
at most ``STAGE_BYTES`` a call, in as many calls as it takes, so that a
rank's staging stays bounded however large the tensor (the bytes moved
are the same).
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.distributed as dist

from repro_torch import tree as tree_util


# Bytes an all_gather or all_to_all call moves for a CUDA tensor.
STAGE_BYTES = 64 << 20


def _chunk(n_rows: int, row_len: int, t: torch.Tensor) -> int:
    """Elements a row of an (n_rows, row_len) collective carries per call:
    the whole row on the CPU, at most STAGE_BYTES a call on the card."""
    if not t.is_cuda:
        return row_len
    return max(1, min(row_len, STAGE_BYTES // (n_rows * t.element_size())))


def axis_size(axes: Sequence) -> int:
    """Product of the sizes of ``axes``."""
    return math.prod(a.size for a in axes)


def _gather_cat(x: torch.Tensor, ax, dim: int) -> torch.Tensor:
    """all_gather over one axis, the parts concatenated along ``dim`` in
    the order of the ranks' coordinates (jax's tiled all_gather)."""
    if ax.size == 1:
        return x
    x = x.contiguous()
    if dim == 0:                # gather straight into the output's rows
        out = x.new_empty((ax.size * x.shape[0], *x.shape[1:]))
        parts = list(out.chunk(ax.size, 0))
    else:
        out, parts = None, [torch.empty_like(x) for _ in range(ax.size)]
    flat, n = x.reshape(-1), x.numel()
    step = _chunk(ax.size, n, x)
    if step >= n:
        dist.all_gather(parts, x, group=ax.group)
    else:
        views = [p.reshape(-1) for p in parts]
        for a in range(0, n, step):
            got = [v[a:a + step] for v in views]
            dist.all_gather(got, flat[a:a + step], group=ax.group)
    return out if out is not None else torch.cat(parts, dim=dim)


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
    rows_s, rows_r = send.reshape(n, -1), recv.reshape(n, -1)
    length = rows_s.shape[1]
    step = _chunk(n, length, send)
    if step >= length:
        dist.all_to_all_single(recv, send, group=ax.group)
    else:
        for a in range(0, length, step):
            piece = rows_s[:, a:a + step].contiguous()
            got = torch.empty_like(piece)
            dist.all_to_all_single(got, piece, group=ax.group)
            rows_r[:, a:a + step] = got
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


# ---------------------------------------------------------------------------
# Tensor-parallel operators over the model axes
# ---------------------------------------------------------------------------

def _psum_f32(x: torch.Tensor, axes) -> torch.Tensor:
    """Sum over ``axes``, narrow float types summed in f32."""
    if x.dtype in (torch.bfloat16, torch.float16):
        return psum_axes(x.float(), axes).to(x.dtype)
    return psum_axes(x, axes)


class _CopyToModel(torch.autograd.Function):
    """Identity forward, sum over the model axes backward: where a
    replicated activation enters a rank's block of a computation."""

    @staticmethod
    def forward(x, axes):
        return x.view_as(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.axes = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return _ReduceFromModel.apply(g, ctx.axes), None


class _ReduceFromModel(torch.autograd.Function):
    """Sum over the model axes forward, identity backward: the partial
    outputs of a row-parallel product."""

    @staticmethod
    def forward(x, axes):
        return _psum_f32(x, axes)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    """all_gather over the model axes along ``dim`` forward, this rank's
    block of the gradient backward (what follows is computed alike on
    every model rank, so each holds the whole gradient; where each rank
    uses other parts of the gathered tensor, the caller puts it through
    :func:`copy_to_model`, which sums the parts' gradients first)."""

    @staticmethod
    def forward(x, axes, dim):
        return all_gather_axes(x, axes, dim)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.axes, ctx.dim = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, g):
        return _block(g, ctx.axes, ctx.dim).contiguous(), None, None


class _ScatterToModel(torch.autograd.Function):
    """This rank's block of ``x`` along ``dim`` forward (``x`` is the same
    on every model rank), the blocks' gradients all_gathered backward."""

    @staticmethod
    def forward(x, axes, dim):
        return _block(x, axes, dim).contiguous()

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.axes, ctx.dim = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, g):
        # through an autograd.Function, so that under ``torch.func`` (the
        # remat recompute's vjp) the collective sees plain tensors
        return _GatherFromModel.apply(g, ctx.axes, ctx.dim), None, None


class _ReduceScatterToModel(torch.autograd.Function):
    """The sum over the model axes, cut to this rank's block along ``dim``,
    forward; the blocks' gradients all_gathered backward.  gloo has no
    reduce_scatter: the sum is all_reduced, then cut."""

    @staticmethod
    def forward(x, axes, dim):
        return _block(_psum_f32(x, axes), axes, dim).contiguous()

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.axes, ctx.dim = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, g):
        return _GatherFromModel.apply(g, ctx.axes, ctx.dim), None, None


def _block(x: torch.Tensor, axes, dim: int) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim`` over ``axes``."""
    return x.chunk(axis_size(axes), dim)[worker_slice_index(axes)]


def copy_to_model(x: torch.Tensor, axes) -> torch.Tensor:
    """Megatron's f over ``axes`` (identity when there are none)."""
    return _CopyToModel.apply(x, tuple(axes)) if axes else x


def reduce_from_model(x: torch.Tensor, axes) -> torch.Tensor:
    """Megatron's g over ``axes`` (identity when there are none)."""
    return _ReduceFromModel.apply(x, tuple(axes)) if axes else x


def gather_from_model(x: torch.Tensor, axes, dim: int = -1) -> torch.Tensor:
    """The blocks of ``x`` over ``axes`` joined along ``dim``, in the order
    of the ranks' joint coordinate (identity when there are none)."""
    if not axes:
        return x
    return _GatherFromModel.apply(x, tuple(axes), dim % x.dim())


def scatter_to_model(x: torch.Tensor, axes, dim: int) -> torch.Tensor:
    """This rank's block along ``dim`` of an ``x`` that every model rank
    holds whole, whose blocks are used apart (identity when there are no
    axes)."""
    if not axes:
        return x
    return _ScatterToModel.apply(x, tuple(axes), dim % x.dim())


def reduce_scatter_to_model(x: torch.Tensor, axes, dim: int) -> torch.Tensor:
    """Megatron-SP's reduce-scatter: the partial outputs summed over
    ``axes`` and cut to this rank's block along ``dim`` (identity when
    there are no axes)."""
    if not axes:
        return x
    return _ReduceScatterToModel.apply(x, tuple(axes), dim % x.dim())
