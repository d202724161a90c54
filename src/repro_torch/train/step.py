"""Byzantine-resilient synchronous-SGD train step (the paper's PS loop).

Port of ``repro/train/step.py::make_train_step``:

  1. the batch arrives as (m, B/m, ...) worker groups, one per paper worker;
  2. per-worker losses and gradients come from ``torch.func.vmap`` of
     ``grad_and_value`` over the group axis (the m estimates must survive
     to the aggregation stage, so nothing is summed here), inside the MoE's
     ``no_data_grouping`` as in the reference;
  3. the attack corrupts the (m, D) worker-gradient matrix and the robust
     rule aggregates it (``core/robust.py::aggregate_stacked_tree``); with a
     defense config the rule also scores every worker, the aggregate skips
     the ejected ones, and the reputation state and q̂ are updated; with a
     compression config the matrix goes through the codec wire model
     (``compress/pipeline.py``: encode, wire attack, decode) before the rule;
  4. the optimizer applies the aggregate.

On a mesh (``mesh``, a :class:`repro_torch.dist.mesh.HostMesh`) this process
is one rank: it computes the gradient of its own worker group,
``batch[worker_slice_index]``, cuts each leaf that ``tree_pspecs`` shards
over the model axes to its block (a replicated leaf stays whole, as the
reference's ``P(worker_axes, *pspec)`` in_specs give it), aggregates through
``core/robust.py::robust_aggregate_dist`` in the config's layout, and
all_gathers the blocks over the model axes, so the optimizer sees the whole
aggregate on every rank.  The forward and backward pass are replicated
within a model group: the values are the reference's, the memory per rank
is not (tensor-parallel compute is ROADMAP queue 1 item 10b).
"""
from __future__ import annotations

import torch

from repro_torch.compress.pipeline import aggregate_compressed_tree
from repro_torch.compress.spec import make_codec
from repro_torch import tree as tree_util
from repro_torch.core.robust import (RobustConfig, aggregate_stacked_tree,
                                     robust_aggregate_dist)
from repro_torch.models.moe import no_data_grouping
from repro_torch.optim.optimizers import OptConfig, apply_updates, tree_norm


def make_train_step(model, *, robust_cfg: RobustConfig, opt_cfg: OptConfig,
                    num_workers: int, mesh=None, defense_cfg=None,
                    compress_cfg=None):
    """Build the train step; batch leaves are worker-stacked (m, B/m, ...)
    and ``gen`` draws the random attacks' noise.  ``mesh`` (a ``HostMesh``
    over the live world, whose worker axes hold ``num_workers`` ranks) makes
    this process one rank of the distributed step; None aggregates locally.

    Without defense: ``step(params, opt_state, batch, gen) -> (params,
    opt_state, metrics)``.  With a ``repro_torch.defense.DefenseConfig``:
    ``step(params, opt_state, batch, gen, defense) -> (params, opt_state,
    defense, metrics)``, where ``defense`` is the reputation state and the
    metrics gain ``suspicion``, ``reputation``, ``active`` and ``q_hat``.
    With a ``repro_torch.compress.CompressionSpec`` the step also threads
    the codec's error-feedback residual as its trailing argument and
    trailing extra return: ``step(params, opt_state, batch, gen[, defense],
    resid)``, seeded with ``codec.init_state(m, D, device)``.
    """
    m = num_workers
    codec = make_codec(compress_cfg)
    worker_grads = torch.func.vmap(torch.func.grad_and_value(model.loss),
                                   in_dims=(None, 0))

    def grads_of(params, batch):
        groups = tree_util.leaves(batch)[0].shape[0]
        if groups != m:
            raise ValueError(f"batch has {groups} worker groups, expected "
                             f"m={m}")
        with no_data_grouping():
            return worker_grads(params, batch)

    def aggregate(grads, gen, active, with_scores, train_step):
        return aggregate_stacked_tree(grads, robust_cfg, gen, active=active,
                                      with_scores=with_scores,
                                      step=train_step)

    if mesh is not None:
        if codec is not None:
            raise ValueError(
                "gradient compression encodes whole worker rows and cannot "
                "run under a dim-sharded mesh; pass mesh=None")
        grads_of, aggregate = _mesh_stages(mesh, robust_cfg, m,
                                           worker_grads)

    def step(params, opt_state, batch, gen):
        grads, losses = grads_of(params, batch)
        agg = aggregate(grads, gen, None, False, opt_state["step"])
        params, opt_state = apply_updates(opt_cfg, params, agg, opt_state)
        metrics = {"loss": losses.mean(),
                   "loss_per_worker": losses,
                   "grad_norm": tree_norm(agg)}
        return params, opt_state, metrics

    def defense_step(params, opt_state, batch, gen, defense):
        from repro_torch.defense.detector import estimate_q
        from repro_torch.defense.reputation import update_reputation
        grads, losses = grads_of(params, batch)
        agg, scores = aggregate(grads, gen, defense["active"], True,
                                opt_state["step"])
        defense = update_reputation(defense, scores, defense_cfg)
        params, opt_state = apply_updates(opt_cfg, params, agg, opt_state)
        metrics = {"loss": losses.mean(),
                   "loss_per_worker": losses,
                   "grad_norm": tree_norm(agg),
                   "suspicion": scores,
                   "reputation": defense["reputation"],
                   "active": defense["active"],
                   "q_hat": estimate_q(
                       scores, min_gap=defense_cfg.detector_min_gap)}
        return params, opt_state, defense, metrics

    def compress_step(params, opt_state, batch, gen, resid):
        grads, losses = grads_of(params, batch)
        agg, resid = aggregate_compressed_tree(
            grads, robust_cfg, codec, resid, gen, step=opt_state["step"])
        params, opt_state = apply_updates(opt_cfg, params, agg, opt_state)
        metrics = {"loss": losses.mean(),
                   "loss_per_worker": losses,
                   "grad_norm": tree_norm(agg)}
        return params, opt_state, resid, metrics

    def compress_defense_step(params, opt_state, batch, gen, defense, resid):
        from repro_torch.defense.detector import estimate_q
        from repro_torch.defense.reputation import update_reputation
        grads, losses = grads_of(params, batch)
        agg, scores, resid = aggregate_compressed_tree(
            grads, robust_cfg, codec, resid, gen, active=defense["active"],
            with_scores=True, step=opt_state["step"])
        defense = update_reputation(defense, scores, defense_cfg)
        params, opt_state = apply_updates(opt_cfg, params, agg, opt_state)
        metrics = {"loss": losses.mean(),
                   "loss_per_worker": losses,
                   "grad_norm": tree_norm(agg),
                   "suspicion": scores,
                   "reputation": defense["reputation"],
                   "active": defense["active"],
                   "q_hat": estimate_q(
                       scores, min_gap=defense_cfg.detector_min_gap)}
        return params, opt_state, defense, resid, metrics

    if codec is not None:
        return compress_step if defense_cfg is None else compress_defense_step
    return step if defense_cfg is None else defense_step


def _mesh_stages(mesh, robust_cfg: RobustConfig, m: int, worker_grads):
    """The mesh step's ``(grads_of, aggregate)``: this rank's worker
    gradient (and every worker's loss), and its robust aggregation."""
    from repro_torch.dist.collectives import (all_gather_axes, axis_size,
                                              cut_to_blocks, join_blocks,
                                              model_cuts, worker_slice_index)
    from repro_torch.dist.sharding import model_axes_of, worker_axes_of
    wa = mesh.axes(worker_axes_of(mesh))
    ma = mesh.axes(model_axes_of(mesh))
    if axis_size(wa) != m:
        raise ValueError(f"num_workers={m} != mesh worker axes size "
                         f"{axis_size(wa)}")
    widx = worker_slice_index(wa)

    def mesh_grads_of(params, batch):
        groups = tree_util.leaves(batch)[0].shape[0]
        if groups != m:
            raise ValueError(f"batch has {groups} worker groups, expected "
                             f"m={m}")
        # Worker widx's group, as a stack of one through the local vmap.
        own = tree_util.map(lambda x: x[widx:widx + 1], batch)
        with no_data_grouping():
            grads, loss = worker_grads(params, own)
        return (tree_util.map(lambda g: g[0], grads),
                all_gather_axes(loss, wa))

    def aggregate(grads, gen, active, with_scores, train_step):
        cuts = model_cuts(grads, mesh)
        out = robust_aggregate_dist(cut_to_blocks(grads, cuts), robust_cfg,
                                    wa, ma, gen, active=active,
                                    with_scores=with_scores, step=train_step)
        agg, scores = out if with_scores else (out, None)
        agg = join_blocks(agg, cuts)
        return (agg, scores) if with_scores else agg

    return mesh_grads_of, aggregate
