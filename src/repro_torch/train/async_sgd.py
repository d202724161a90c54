"""Asynchronous Byzantine-resilient SGD: a buffered-asynchronous parameter
server (the paper's stated future work).

Port of ``repro/train/async_sgd.py``.  Each worker computes its gradient
against a STALE parameter copy (workers refresh their copy with probability
1/tau per step, a geometric staleness model); the server keeps the latest
gradient of each worker in an m-slot buffer and applies a dimensional-robust
rule over the buffer every step.  Because trmean/Phocas only need the
per-coordinate value multiset, the buffer is the {tilde v_i} set of
Definition 5: staleness perturbs the correct gradients while Byzantine slots
stay arbitrary.  On the card the buffer aggregation reaches the rule's CUDA
kernel through ``aggregate_stacked_tree``, as the synchronous step does.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch import tree as tree_util
from repro_torch.compress.pipeline import aggregate_compressed_tree
from repro_torch.compress.spec import make_codec
from repro_torch.core.robust import RobustConfig, aggregate_stacked_tree
from repro_torch.optim.optimizers import (OptConfig, apply_updates,
                                          init_opt_state, tree_norm)


@dataclasses.dataclass
class AsyncConfig:
    num_workers: int = 20
    staleness: int = 4                 # tau: expected staleness in steps
    update_clip: float = 10.0          # global-norm bound on the applied update
    seed: int = 0


def refresh_draw(gen: torch.Generator, m: int, staleness: int,
                 device) -> torch.Tensor:
    """The (m,) bool mask of workers that refresh their stale copy this
    step: each with probability 1/tau (the reference's
    ``jax.random.bernoulli(k_refresh, 1/tau, (m,))``)."""
    p = 1.0 / max(staleness, 1)
    return torch.rand((m,), generator=gen, device=device) < p


def _rows(mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """An (m,) mask shaped to broadcast over (m, *leaf) rows."""
    return mask.reshape((mask.shape[0],) + (1,) * (x.dim() - 1))


def make_async_train_step(model, *, robust_cfg: RobustConfig,
                          opt_cfg: OptConfig, acfg: AsyncConfig,
                          defense_cfg=None, faulty: bool = False,
                          compress_cfg=None):
    """Returns ``(init_state, step)`` for the buffered-async simulation.

    ``init_state(gen)`` builds the server params/opt, the m workers' stale
    copies (real per-worker copies, since refreshes rewrite rows) and the
    m-slot gradient buffer.  ``step(state, batch, gen, present=None)`` runs
    one server iteration: every worker contributes the gradient of ITS stale
    copy on ITS batch shard (one ``torch.func.vmap`` over workers and their
    params), the server aggregates the buffer, clips the update's global
    norm to ``update_clip``, applies it, and workers refresh w.p. 1/tau.

    With ``defense_cfg`` the state carries the reputation dict: the buffer
    aggregation is reputation-gated and every step updates the EMA.  With
    ``faulty=True`` the step takes the round's (m,) 0/1 presence vector: an
    absent worker's slot keeps its last gradient, and slots whose owner has
    been absent longer than 2·tau rounds are gated out (state gains
    ``last_seen``).  With ``compress_cfg`` the buffer goes through the codec
    wire model before the reduce, and state carries the codec's residual
    under ``"compress"``.
    """
    m = acfg.num_workers
    codec = make_codec(compress_cfg)
    worker_grads = torch.func.vmap(torch.func.grad(model.loss),
                                   in_dims=(0, 0))

    def init_state(gen: torch.Generator) -> dict:
        params = model.init(gen)
        device = gen.device
        state = {
            "params": params,
            "opt": init_opt_state(opt_cfg, params),
            # every worker starts synchronized
            "worker_params": tree_util.map(
                lambda x: x.unsqueeze(0).repeat((m,) + (1,) * x.dim()),
                params),
            "buffer": tree_util.map(
                lambda x: torch.zeros((m,) + tuple(x.shape),
                                      dtype=torch.float32, device=device),
                params),
        }
        if faulty:
            state["last_seen"] = torch.zeros((m,), dtype=torch.int32,
                                             device=device)
        if defense_cfg is not None:
            from repro_torch.defense.reputation import init_reputation
            state["defense"] = init_reputation(m, device=device)
        if codec is not None:
            state["compress"] = codec.init_state(m, tree_util.size(params),
                                                 device=device)
        return state

    def step(state: dict, batch: dict, gen: torch.Generator,
             present: Optional[torch.Tensor] = None):
        grads = tree_util.map(lambda g: g.float(),
                              worker_grads(state["worker_params"], batch))
        rnd = state["opt"]["step"]
        fresh = last_seen = None
        if faulty:
            # Absent workers missed the deadline: their slot keeps the last
            # received gradient.
            buffer = tree_util.map(
                lambda g, old: torch.where(_rows(present, g) > 0, g, old),
                grads, state["buffer"])
            last_seen = torch.where(present > 0, rnd,
                                    state["last_seen"]).to(torch.int32)
            # Gate out slots gone stale beyond the staleness model's own
            # envelope (2·tau): a crashed worker's frozen gradient would
            # otherwise stay in the multiset forever.
            fresh = ((rnd - last_seen)
                     <= 2 * max(acfg.staleness, 1)).float()
        else:
            buffer = grads                          # every slot refreshed

        defense = None
        extra_metrics = {}
        new_state = {}
        if defense_cfg is not None:
            from repro_torch.defense.detector import estimate_q
            from repro_torch.defense.reputation import update_reputation
            active_in = state["defense"]["active"]
            if fresh is not None:
                active_in = active_in * fresh
            if codec is not None:
                agg, scores, new_state["compress"] = \
                    aggregate_compressed_tree(
                        buffer, robust_cfg, codec, state["compress"], gen,
                        active=active_in, with_scores=True, step=rnd)
            else:
                agg, scores = aggregate_stacked_tree(
                    buffer, robust_cfg, gen, active=active_in,
                    with_scores=True, step=rnd)
            defense = update_reputation(state["defense"], scores,
                                        defense_cfg)
            extra_metrics = {
                "suspicion": scores,
                "reputation": defense["reputation"],
                "active": defense["active"],
                "q_hat": estimate_q(
                    scores, min_gap=defense_cfg.detector_min_gap),
            }
        elif codec is not None:
            agg, new_state["compress"] = aggregate_compressed_tree(
                buffer, robust_cfg, codec, state["compress"], gen,
                active=fresh, step=rnd)
        else:
            agg = aggregate_stacked_tree(buffer, robust_cfg, gen,
                                         active=fresh, step=rnd)
        # Bounded-update rule: stale gradients make unbounded steps
        # unstable, so the server clips the aggregate's global norm (a
        # trust region, not a defense).
        if acfg.update_clip:
            scale = torch.clamp(acfg.update_clip
                                / torch.clamp(tree_norm(agg), min=1e-12),
                                max=1.0)
            agg = tree_util.map(lambda x: x * scale, agg)
        params, opt = apply_updates(opt_cfg, state["params"], agg,
                                    state["opt"])

        refresh = refresh_draw(gen, m, acfg.staleness,
                               tree_util.leaves(params)[0].device)
        worker_params = tree_util.map(
            lambda wp, p: torch.where(_rows(refresh, wp), p[None], wp),
            state["worker_params"], params)

        new_state.update({"params": params, "opt": opt,
                          "worker_params": worker_params, "buffer": buffer})
        if faulty:
            new_state["last_seen"] = last_seen
            extra_metrics["m_fresh"] = fresh.sum()
        if defense is not None:
            new_state["defense"] = defense
        metrics = {"staleness_frac": 1.0 - refresh.float().mean(),
                   **extra_metrics}
        return new_state, metrics

    return init_state, step


def run_async_training(model, batch_fn: Callable[[int], dict],
                       robust_cfg: RobustConfig, opt_cfg: OptConfig,
                       acfg: AsyncConfig, steps: int,
                       eval_fn: Optional[Callable] = None,
                       defense_cfg=None, device=None) -> list:
    """Deprecated legacy shim: delegates to the ``async_ps`` topology and
    returns the result's history records.  New code builds a
    ``ScenarioSpec`` with ``topology="async_ps"`` and calls
    ``run_experiment``."""
    from repro_torch.experiment.runner import plan_from_parts
    from repro_torch.experiment.topology import make_topology
    plan = plan_from_parts(
        model=model, batch_fn=batch_fn, robust_cfg=robust_cfg,
        opt_cfg=opt_cfg, num_workers=acfg.num_workers, steps=steps,
        seed=acfg.seed, topology="async_ps",
        topology_params={"staleness": acfg.staleness,
                         "update_clip": acfg.update_clip},
        eval_fn=eval_fn, defense_cfg=defense_cfg, record_every=10,
        telemetry_path=(defense_cfg.telemetry_path
                        if defense_cfg is not None else None),
        device=device)
    return make_topology("async_ps").run(plan).history
