"""Builtin topology plugins: the paper's synchronous parameter server.

Port of the plain branch of ``repro/experiment/topologies.py::SyncPS``: no
mesh, defense, faults, compression or checkpoints (the spec refuses those
before a run starts).
"""
from __future__ import annotations

import time

import torch

from repro_torch.data.pipeline import make_worker_batches
from repro_torch.experiment.runner import ExperimentResult, Plan
from repro_torch.experiment.topology import Topology, register_topology
from repro_torch.optim.optimizers import init_opt_state
from repro_torch.train.step import make_train_step


@register_topology
class SyncPS(Topology):
    """The paper's synchronous PS loop."""

    name = "sync_ps"

    def run(self, plan: Plan, init_state=None) -> ExperimentResult:
        m = plan.num_workers
        step_fn = make_train_step(plan.model, robust_cfg=plan.robust_cfg,
                                  opt_cfg=plan.opt_cfg, num_workers=m)
        if init_state is not None:
            params, opt_state = init_state
        else:
            gen = torch.Generator(device=plan.device).manual_seed(plan.seed)
            params = plan.model.init(gen)
            opt_state = init_opt_state(plan.opt_cfg, params)
        attack_gen = torch.Generator(device=plan.device).manual_seed(
            plan.seed + 1)

        history: list = []
        metrics: dict = {}
        t0 = time.time()
        for step in range(plan.steps):
            batch = make_worker_batches(plan.batch_fn(step), m)
            params, opt_state, metrics = step_fn(params, opt_state, batch,
                                                 attack_gen)
            if step % plan.record_every == 0 or step == plan.steps - 1:
                row = {"step": step, "loss": float(metrics["loss"]),
                       "grad_norm": float(metrics["grad_norm"]),
                       "wall": time.time() - t0}
                if plan.eval_fn is not None:
                    row["eval"] = float(plan.eval_fn(params))
                history.append(row)
        wall = time.time() - t0

        return ExperimentResult(
            spec=plan.spec, history=history, params=params,
            opt_state=opt_state,
            final_metrics={k: v.tolist() for k, v in metrics.items()},
            robust_cfg=plan.robust_cfg, wall_time=wall)
