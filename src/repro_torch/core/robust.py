"""Robust aggregation engine: the local path and the two distributed
layouts.

Port of ``repro/core/robust.py``.  Locally, the worker gradients arrive as a
tree (nested dict) whose leaves are stacked ``(m, *leaf_shape)`` tensors;
:func:`aggregate_stacked_tree` flattens them into one (m, D) matrix in the
reference's ``ravel_pytree`` order (sorted dict keys, each leaf raveled
row-major in its JAX layout), so the attacks hit the same coordinates as in
the reference.

On a mesh (:func:`robust_aggregate_dist`) each rank holds one worker's
gradient tree, and the layout says who aggregates what:

* ``replicated``: the paper's parameter server on every rank.  The flat
  vectors are all_gathered over the worker axes and every rank attacks and
  aggregates the whole (m, D) matrix, with the same generator, so every
  rank computes the same bits.
* ``sharded``: the paper's multi-server partition (§5.1.4) as a robust
  reduce-scatter.  An all_to_all gives each rank an (m, D/m) dimension
  slice, which it attacks and aggregates alone; an all_gather rebuilds the
  aggregate.  The rule sums its per-worker statistics over the worker and
  model axes (``reduce_sharded*``).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch

from repro_torch import tree as tree_util
from repro_torch.core import registry
from repro_torch.core.attacks import (AttackConfig, fold_seed, make_attack,
                                      writing_in_place)
from repro_torch.core.selection import gate_matrix


@dataclasses.dataclass(frozen=True)
class RobustConfig:
    """Serializable spec of the robust-aggregation stage of the train step.

    The fields are the reference's; ``layout`` only matters on a mesh
    (:func:`robust_aggregate_dist`).
    """
    rule: str = "phocas"          # any registered rule name
    b: int = 2                    # trim parameter (trmean/phocas family)
    q: int = 2                    # assumed Byzantine count (krum family)
    multikrum_k: Optional[int] = None
    geomedian_iters: int = 8
    layout: str = "sharded"       # replicated | sharded
    backend: str = "auto"         # auto | pallas | xla
    agg_dtype: str = "float32"    # robust statistics dtype
    attack: AttackConfig = dataclasses.field(default_factory=AttackConfig)

    def rule_params(self) -> registry.RuleParams:
        return registry.RuleParams(b=self.b, q=self.q,
                                   multikrum_k=self.multikrum_k,
                                   geomedian_iters=self.geomedian_iters,
                                   backend=self.backend)

    def rule_obj(self) -> registry.AggregatorRule:
        return registry.make_rule(self.rule, self.rule_params())


def aggregate_matrix(u: torch.Tensor, cfg: RobustConfig,
                     gen: Optional[torch.Generator] = None, *,
                     active: Optional[torch.Tensor] = None,
                     with_scores: bool = False, step=None,
                     owned: bool = False):
    """Aggregate an (m, d) worker matrix, injecting the configured attack.

    ``gen`` draws the random attacks' noise; ``step`` reaches step-aware
    attacks (without it they assume their worst-case phase).  ``active``
    applies the reputation gate after the attack; ``with_scores=True``
    returns ``(agg, scores)``.  Scores observe the RAW submissions while the
    aggregate uses the gated matrix: scoring gated rows would make an
    ejected worker look conforming at once, and it would flap back in.
    ``owned=True`` hands ``u`` over: the attack then writes into it rather
    than into a copy, as it also does into a copy made for ``agg_dtype``.
    """
    attack = make_attack(cfg.attack)
    uf = u.to(getattr(torch, cfg.agg_dtype))
    if attack is not None:
        if gen is None:
            raise ValueError("attack configured but no generator supplied")
        with (writing_in_place() if owned or uf is not u
              else contextlib.nullcontext()):
            uf = attack(gen, uf, step)
    rule = cfg.rule_obj()
    if with_scores:
        return rule.reduce_gated_with_scores(uf, active)
    if active is not None:
        uf = gate_matrix(uf, active)
    return rule.reduce(uf)


def flatten_stacked(stacked) -> torch.Tensor:
    """(m, D) f32 matrix of a tree of stacked leaves, in ravel_pytree order.

    The matrix is allocated once and each leaf copied into its column range
    (casting on the way), so it is never held twice, as an f32 copy of
    every leaf and their concatenation would be."""
    leaves = tree_util.leaves(stacked)
    m = leaves[0].shape[0]
    sizes = [x[0].numel() for x in leaves]
    out = torch.empty((m, sum(sizes)), dtype=torch.float32,
                      device=leaves[0].device)
    start = 0
    for x, n in zip(leaves, sizes):
        out[:, start:start + n].copy_(x.reshape(m, n))
        start += n
    return out


def unflatten_like(vec: torch.Tensor, like):
    """Inverse of one row of :func:`flatten_stacked`: split ``vec`` into the
    leaf shapes (minus the worker axis) and dtypes of ``like``."""
    leaves = tree_util.leaves(like)
    sizes = [x[0].numel() for x in leaves]
    parts = torch.split(vec, sizes)
    out = [p.reshape(x.shape[1:]).to(x.dtype) for p, x in zip(parts, leaves)]
    return tree_util.unflatten(like, out)


def aggregate_stacked_tree(stacked, cfg: RobustConfig,
                           gen: Optional[torch.Generator] = None, *,
                           active: Optional[torch.Tensor] = None,
                           with_scores: bool = False, step=None):
    """Aggregate a tree whose leaves are stacked (m, *leaf_shape) tensors.

    Flattens to a single (m, D) matrix (so vector-wise rules would see the
    full gradient geometry), aggregates, and unflattens.  The matrix is
    this function's own, so the attack writes into it: an LM's is held
    once, not twice.  With
    ``with_scores=True`` returns ``(tree, scores)``.
    """
    out = aggregate_matrix(flatten_stacked(stacked), cfg, gen, active=active,
                           with_scores=with_scores, step=step, owned=True)
    if with_scores:
        agg, scores = out
        return unflatten_like(agg, stacked), scores
    return unflatten_like(out, stacked)


# ---------------------------------------------------------------------------
# Distributed path: one rank of a mesh, inside a torch.distributed world
# ---------------------------------------------------------------------------

def _flat_padded(tree, m: int, dtype: torch.dtype):
    """One rank's tree as a (D + pad,) vector in ``ravel_pytree`` order,
    zero-padded to a multiple of ``m``; returns it and D."""
    leaves = tree_util.leaves(tree)
    d = sum(x.numel() for x in leaves)
    out = torch.zeros((d + (-d) % m,), dtype=dtype, device=leaves[0].device)
    start = 0
    for x in leaves:
        out[start:start + x.numel()].copy_(x.reshape(-1))
        start += x.numel()
    return out, d


def slice_generator(gen: torch.Generator, step, index: int,
                    device) -> torch.Generator:
    """The sharded layout's attack generator for dimension slice ``index``
    at ``step``, seeded from ``gen``'s seed, the step and the slice (the
    port's ``fold_in(key, slice)``).  It depends on no generator state, so
    a resumed run draws the same noise as the uninterrupted one."""
    seed = fold_seed(fold_seed(gen.initial_seed(), int(step or 0)), index)
    return torch.Generator(device=device).manual_seed(seed)


def robust_aggregate_dist(grad_tree, cfg: RobustConfig, worker_axes,
                          model_axes=(), gen: Optional[torch.Generator] = None,
                          active: Optional[torch.Tensor] = None,
                          with_scores: bool = False, step=None):
    """Aggregate the per-worker gradient trees of a mesh, on one rank.

    ``grad_tree`` is this rank's local tree: its worker's gradient, with
    each model-sharded leaf cut to this rank's block.  ``worker_axes`` and
    ``model_axes`` are mesh axes (``HostMesh.axes``); ``gen`` draws the
    attack's noise (the same generator on every rank), ``step`` reaches
    step-aware attacks, ``active`` is the replicated (m,) reputation mask,
    and ``with_scores`` also returns the (m,) scores, summed over the
    layout's sharded axes, so every rank holds the same ones.

    The flat vector is zero-padded to a multiple of m; the padding columns
    take part in the rule and in its coordinate counts, as in the
    reference.  Returns the aggregated local tree with the input's shapes
    and dtypes (and the scores).
    """
    from repro_torch.dist.collectives import (all_to_all_scatter, axis_size,
                                              gather_slices, gather_workers,
                                              worker_slice_index)
    worker_axes, model_axes = tuple(worker_axes), tuple(model_axes)
    m = axis_size(worker_axes)
    flat, d = _flat_padded(grad_tree, m, getattr(torch, cfg.agg_dtype))
    attack = make_attack(cfg.attack)
    if attack is not None and gen is None:
        raise ValueError("attack configured but no generator supplied")
    rule = cfg.rule_obj()

    def reduce(mat, psum_axes):
        # Scores observe the RAW submissions; the aggregate uses the gated
        # matrix (see aggregate_matrix).
        if with_scores:
            return rule.reduce_sharded_gated_with_scores(mat, active,
                                                         psum_axes)
        if active is not None:
            mat = gate_matrix(mat, active)
        return rule.reduce_sharded(mat, psum_axes), None

    if cfg.layout == "replicated":
        mat = gather_workers(flat, worker_axes)               # (m, D)
        if attack is not None:
            with writing_in_place():
                mat = attack(gen, mat, step)
        agg, scores = reduce(mat, model_axes)
    elif cfg.layout == "sharded":
        mat = all_to_all_scatter(flat, worker_axes)           # (m, D/m)
        if attack is not None:
            # Each rank is a server owning a slice of the dimensions, and
            # is attacked on its slice.
            sgen = slice_generator(gen, step, worker_slice_index(worker_axes),
                                   mat.device)
            with writing_in_place():
                mat = attack(sgen, mat, step)
        agg, scores = reduce(mat, worker_axes + model_axes)   # (D/m,)
        agg = gather_slices(agg, worker_axes)                 # (D,)
    else:
        raise ValueError(f"unknown layout {cfg.layout!r}")

    like = tree_util.map(lambda x: x[None], grad_tree)
    out = unflatten_like(agg[:d], like)
    return (out, scores) if with_scores else out
