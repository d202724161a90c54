"""Byzantine-resilient synchronous-SGD train step (the paper's PS loop).

Port of ``repro/train/step.py::make_train_step`` for ``mesh=None``:

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
"""
from __future__ import annotations

import torch

from repro_torch.compress.pipeline import aggregate_compressed_tree
from repro_torch.compress.spec import make_codec
from repro_torch import tree as tree_util
from repro_torch.core.robust import RobustConfig, aggregate_stacked_tree
from repro_torch.models.moe import no_data_grouping
from repro_torch.optim.optimizers import OptConfig, apply_updates, tree_norm


def make_train_step(model, *, robust_cfg: RobustConfig, opt_cfg: OptConfig,
                    num_workers: int, defense_cfg=None, compress_cfg=None):
    """Build the train step; batch leaves are worker-stacked (m, B/m, ...)
    and ``gen`` draws the random attacks' noise.

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

    def step(params, opt_state, batch, gen):
        grads, losses = grads_of(params, batch)
        agg = aggregate_stacked_tree(grads, robust_cfg, gen,
                                     step=opt_state["step"])
        params, opt_state = apply_updates(opt_cfg, params, agg, opt_state)
        metrics = {"loss": losses.mean(),
                   "loss_per_worker": losses,
                   "grad_norm": tree_norm(agg)}
        return params, opt_state, metrics

    def defense_step(params, opt_state, batch, gen, defense):
        from repro_torch.defense.detector import estimate_q
        from repro_torch.defense.reputation import update_reputation
        grads, losses = grads_of(params, batch)
        agg, scores = aggregate_stacked_tree(
            grads, robust_cfg, gen, active=defense["active"],
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
