"""Robust aggregation engine, local path.

Port of the single-device half of ``repro/core/robust.py``.  The worker
gradients arrive as a tree (nested dict) whose leaves are stacked
``(m, *leaf_shape)`` tensors; :func:`aggregate_stacked_tree` flattens them
into one (m, D) matrix in the reference's ``ravel_pytree`` order (sorted dict
keys, each leaf raveled row-major in its JAX layout), so the attacks hit the
same coordinates as in the reference.  The distributed layouts come with
ROADMAP queue 1 item 10.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch

from repro_torch import tree as tree_util
from repro_torch.core import registry
from repro_torch.core.attacks import (AttackConfig, make_attack,
                                      writing_in_place)
from repro_torch.core.selection import gate_matrix


@dataclasses.dataclass(frozen=True)
class RobustConfig:
    """Serializable spec of the robust-aggregation stage of the train step.

    The fields are the reference's; ``layout`` only matters to the
    distributed engine, which this package does not have yet.
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
