"""Builtin topology plugins: the paper's synchronous parameter server.

Port of ``repro/experiment/topologies.py::SyncPS`` without mesh, faults,
compression or checkpoints (the spec refuses those before a run starts): the
plain loop, and the defended one, which threads the reputation state, writes
the ``"train"`` telemetry records and, with ``defense.adapt_b``, raises b (or
q) to the detector's q̂.
"""
from __future__ import annotations

import dataclasses
import time

import torch

from repro_torch.core import registry
from repro_torch.data.pipeline import make_worker_batches
from repro_torch.defense.reputation import init_reputation
from repro_torch.defense.telemetry import TelemetryWriter
from repro_torch.experiment.runner import ExperimentResult, Plan
from repro_torch.experiment.topology import Topology, register_topology
from repro_torch.optim.optimizers import init_opt_state
from repro_torch.train.step import make_train_step


@register_topology
class SyncPS(Topology):
    """The paper's synchronous PS loop."""

    name = "sync_ps"

    def run(self, plan: Plan, init_state=None) -> ExperimentResult:
        """``init_state`` optionally injects ``(params, opt_state)`` or
        ``(params, opt_state, defense_state)``."""
        m = plan.num_workers
        robust_cfg = plan.robust_cfg
        dcfg = plan.defense_cfg

        def build_step(rc):
            return make_train_step(plan.model, robust_cfg=rc,
                                   opt_cfg=plan.opt_cfg, num_workers=m,
                                   defense_cfg=dcfg)

        step_fn = build_step(robust_cfg)
        defense_state = None
        if init_state is not None:
            params, opt_state, *rest = init_state
            defense_state = rest[0] if rest else None
        else:
            gen = torch.Generator(device=plan.device).manual_seed(plan.seed)
            params = plan.model.init(gen)
            opt_state = init_opt_state(plan.opt_cfg, params)
        if dcfg is not None and defense_state is None:
            defense_state = init_reputation(m, device=plan.device)
        attack_gen = torch.Generator(device=plan.device).manual_seed(
            plan.seed + 1)

        # adapt_b: once q̂ exceeds the rule's b (or, for a rule that uses q
        # and not b, its q) for adapt_patience consecutive steps, re-build
        # the step with b = q̂ (capped at the largest valid b) and, for a
        # rule that uses q, q = max(q̂, q) (capped at m - 3).
        adapt = dcfg is not None and dcfg.adapt_b
        rule_meta = registry.get_rule(robust_cfg.rule)
        bmax = (m + 1) // 2 - 1
        pending = 0

        history: list = []
        metrics: dict = {}
        t0 = time.time()
        with TelemetryWriter(plan.telemetry_path) as tel:
            for step in range(plan.steps):
                batch = make_worker_batches(plan.batch_fn(step), m)
                if defense_state is not None:
                    params, opt_state, defense_state, metrics = step_fn(
                        params, opt_state, batch, attack_gen, defense_state)
                    tel.log("train", step, loss=metrics["loss"],
                            grad_norm=metrics["grad_norm"],
                            suspicion=metrics["suspicion"],
                            reputation=metrics["reputation"],
                            active=metrics["active"],
                            q_hat=metrics["q_hat"])
                else:
                    params, opt_state, metrics = step_fn(
                        params, opt_state, batch, attack_gen)
                if step % plan.record_every == 0 or step == plan.steps - 1:
                    row = {"step": step, "loss": float(metrics["loss"]),
                           "grad_norm": float(metrics["grad_norm"]),
                           "wall": time.time() - t0}
                    if "q_hat" in metrics:
                        row["q_hat"] = int(metrics["q_hat"])
                        row["n_active"] = int(metrics["active"].sum())
                    if plan.eval_fn is not None:
                        row["eval"] = float(plan.eval_fn(params))
                    history.append(row)

                if adapt:
                    q_hat = int(metrics["q_hat"])
                    current = (robust_cfg.b if rule_meta.uses_b
                               else robust_cfg.q)
                    pending = pending + 1 if q_hat > current else 0
                    if pending >= dcfg.adapt_patience:
                        pending = 0
                        new_b = (min(q_hat, bmax) if rule_meta.uses_b
                                 else robust_cfg.b)
                        new_q = (min(max(q_hat, robust_cfg.q), m - 3)
                                 if rule_meta.uses_q else robust_cfg.q)
                        # q̂ beyond the cap leaves b/q saturated: nothing to
                        # re-build.
                        if new_b != robust_cfg.b or new_q != robust_cfg.q:
                            robust_cfg = dataclasses.replace(
                                robust_cfg, b=new_b, q=new_q)
                            step_fn = build_step(robust_cfg)
                            history.append(
                                {"step": step, "adapted_b": new_b,
                                 "adapted_q": new_q, "q_hat": q_hat})
                            tel.log("adapt", step, b=new_b, q=new_q,
                                    q_hat=q_hat)
        wall = time.time() - t0

        return ExperimentResult(
            spec=plan.spec, history=history, params=params,
            opt_state=opt_state, defense_state=defense_state,
            final_metrics={k: v.tolist() for k, v in metrics.items()},
            robust_cfg=robust_cfg, wall_time=wall)
