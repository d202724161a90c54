"""Byzantine-resilient synchronous-SGD train step (the paper's PS loop).

Port of ``repro/train/step.py::make_train_step`` for ``mesh=None`` with no
defense and no compression:

  1. the batch arrives as (m, B/m, ...) worker groups, one per paper worker;
  2. per-worker losses and gradients come from ``torch.func.vmap`` of
     ``grad_and_value`` over the group axis (the m estimates must survive
     to the aggregation stage, so nothing is summed here);
  3. the attack corrupts the (m, D) worker-gradient matrix and the robust
     rule aggregates it (``core/robust.py::aggregate_stacked_tree``);
  4. the optimizer applies the aggregate.
"""
from __future__ import annotations

import torch

from repro_torch.core.robust import RobustConfig, aggregate_stacked_tree
from repro_torch.optim.optimizers import OptConfig, apply_updates, tree_norm


def make_train_step(model, *, robust_cfg: RobustConfig, opt_cfg: OptConfig,
                    num_workers: int):
    """Build ``step(params, opt_state, batch, gen) -> (params, opt_state,
    metrics)``; batch leaves are worker-stacked (m, B/m, ...) and ``gen``
    draws the random attacks' noise."""
    m = num_workers
    worker_grads = torch.func.vmap(torch.func.grad_and_value(model.loss),
                                   in_dims=(None, 0))

    def step(params, opt_state, batch, gen):
        if batch["y"].shape[0] != m:
            raise ValueError(f"batch has {batch['y'].shape[0]} worker "
                             f"groups, expected m={m}")
        grads, losses = worker_grads(params, batch)
        agg = aggregate_stacked_tree(grads, robust_cfg, gen,
                                     step=opt_state["step"])
        params, opt_state = apply_updates(opt_cfg, params, agg, opt_state)
        metrics = {"loss": losses.mean(),
                   "loss_per_worker": losses,
                   "grad_norm": tree_norm(agg)}
        return params, opt_state, metrics

    return step
