"""Builtin topology plugins: the paper's synchronous parameter server and
serving.

Port of ``repro/experiment/topologies.py``.  ``SyncPS`` without mesh,
faults, compression or checkpoints (the spec refuses those before a run
starts): the plain loop, and the defended one, which threads the reputation
state, writes the ``"train"`` telemetry records and, with
``defense.adapt_b``, raises b (or q) to the detector's q̂.  ``Serve``: Poisson
arrivals through the continuous-batching paged engine, optionally with k
replicas and robust aggregation of their logits.
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
from repro_torch.experiment.spec import SpecError
from repro_torch.experiment.topology import Topology, register_topology
from repro_torch.optim.optimizers import init_opt_state
from repro_torch.train.step import make_train_step


@register_topology
class SyncPS(Topology):
    """The paper's synchronous PS loop."""

    name = "sync_ps"

    def validate_spec(self, spec) -> None:
        super().validate_spec(spec)
        if spec.model.kind == "arch":
            from repro_torch.experiment.spec import not_ported
            raise not_ported("LM training through sync_ps (model.kind="
                             "'arch' on the token stream)", "item 11")

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


def poisson_arrivals(seed: int, num_requests: int, arrival_rate: float,
                     prompt_len: int, vocab_size: int):
    """The serve topology's deterministic load, as in the reference: the
    engine step each request is due (Poisson arrivals at ``arrival_rate``
    requests per step) and its prompt, both from numpy's generator seeded
    with ``seed``."""
    import numpy as np
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / max(arrival_rate, 1e-9), num_requests)
    due = np.cumsum(gaps)
    prompts = rng.integers(0, vocab_size, (num_requests, prompt_len))
    return due, prompts


def drive_arrivals(engine, due, prompts, max_new_tokens: int, steps: int,
                   record_every: int):
    """Submit each prompt once the engine reaches its due step and step the
    engine until every request is done or ``steps`` run out.  Returns
    (history, tokens produced)."""
    history: list = []
    submitted = produced = 0
    for i in range(steps):
        while submitted < len(due) and due[submitted] <= i:
            engine.submit(prompts[submitted].tolist(), max_new_tokens)
            submitted += 1
        if submitted >= len(due) and not engine.scheduler.busy:
            break
        produced += engine.step()
        if i % record_every == 0:
            history.append({
                "step": i, "submitted": submitted,
                "queued": engine.scheduler.queued,
                "active": len(engine.scheduler.active),
                "tokens": produced})
    engine.scheduler.retire_finished()
    return history, produced


@register_topology
class Serve(Topology):
    """Serving as a scenario: Poisson arrivals through the
    continuous-batching paged engine (``repro_torch.serve.ServeEngine``),
    with ``spec.robust`` selecting the logits-aggregation rule when k
    replicas serve each decode step and ``spec.attack`` corrupting
    ``num_byzantine`` of them.  ``spec.steps`` caps engine iterations;
    final metrics are the latency/throughput summary."""

    name = "serve"
    param_names = ("replicas", "max_slots", "max_seq_len", "block_tokens",
                   "num_requests", "arrival_rate", "prompt_len",
                   "max_new_tokens")
    def validate_spec(self, spec) -> None:
        super().validate_spec(spec)
        # corrupt_replica injects Gaussian garbage parameters — the only
        # fault model the serving path simulates.
        atk = spec.effective_attack().name.lower()
        if atk not in ("none", "", "gaussian"):
            raise SpecError(f"attack {atk!r} cannot be simulated on "
                            "topology 'serve' (supported: ('gaussian',))")
        if spec.model.kind != "arch":
            raise SpecError("topology 'serve' decodes an arch-zoo model; "
                            "set model.kind='arch' (+ data.kind='tokens')")
        from repro_torch.configs import get_arch
        from repro_torch.models.stack import paged_supported
        if not paged_supported(get_arch(spec.model.arch)):
            raise SpecError(
                f"arch {spec.model.arch!r} is not paged-serving capable "
                "(SSM/hybrid/MLA/enc-dec/windowed layers); pick an "
                "all-global attention arch like 'granite-8b-reduced'")
        k = int(spec.topology_params.get("replicas", 1))
        if k > 1:
            bmax = (k + 1) // 2 - 1
            if not 0 <= spec.robust.b <= bmax:
                raise SpecError(
                    f"replicated decode with k={k} replicas needs "
                    f"0 <= robust.b <= (k+1)//2-1 = {bmax}, got "
                    f"b={spec.robust.b}")
            q = spec.effective_attack().num_byzantine
            if q > bmax:
                raise SpecError(
                    f"attack corrupts {q} replicas but k={k} replicated "
                    f"decode tolerates at most (k+1)//2-1 = {bmax}")

    def run(self, plan: Plan, init_state=None) -> ExperimentResult:
        """``init_state`` optionally injects ``(params,)``."""
        from repro_torch.obs.metrics import make_recorder
        from repro_torch.serve import (RobustDecoder, ServeEngine,
                                       corrupt_replica, make_replicas)

        tp = plan.topology_params
        replicas = int(tp.get("replicas", 1))
        max_slots = int(tp.get("max_slots", 8))
        max_seq_len = int(tp.get("max_seq_len", 128))
        block_tokens = int(tp.get("block_tokens", 16))
        num_requests = int(tp.get("num_requests", 16))
        # arrival_rate: requests per engine step (Poisson)
        arrival_rate = float(tp.get("arrival_rate", 2.0))
        prompt_len = int(tp.get("prompt_len", 8))
        max_new = int(tp.get("max_new_tokens", 16))

        model = plan.model
        if init_state is None:
            gen = torch.Generator(device=plan.device).manual_seed(plan.seed)
            params = model.init(gen)
        else:
            params = init_state[0]

        decoder = None
        if replicas > 1:
            rc = plan.robust_cfg
            params = make_replicas(params, replicas)
            corrupt = rc.attack.num_byzantine if rc.attack.name == "gaussian" \
                else 0
            for i in range(corrupt):
                gen = torch.Generator(device=plan.device).manual_seed(
                    plan.seed + 1000 + i)
                params = corrupt_replica(params, replicas - 1 - i, gen)
            decoder = RobustDecoder(
                rule=rc.rule, k=replicas, b=rc.b,
                defense=plan.defense_cfg, backend=rc.backend,
                device=plan.device)

        t0 = time.time()
        with make_recorder(plan.telemetry_path, plan.obs) as rec:
            engine = ServeEngine(
                model, params, max_slots=max_slots, max_seq_len=max_seq_len,
                block_tokens=block_tokens, decoder=decoder, telemetry=rec)
            due, prompts = poisson_arrivals(plan.seed, num_requests,
                                            arrival_rate, prompt_len,
                                            model.cfg.vocab_size)
            history, produced = drive_arrivals(engine, due, prompts,
                                               max_new, plan.steps,
                                               plan.record_every)

        wall = time.time() - t0
        done = engine.scheduler.completed
        lat = sorted(r.latency_ms() for r in done) or [0.0]
        ttft = sorted(r.first_token_ms() for r in done) or [0.0]
        pct = lambda xs, q: xs[min(len(xs) - 1,  # noqa: E731
                                   int(q * (len(xs) - 1) + 0.5))]
        metrics = {
            "completed": float(len(done)),
            "tokens": float(produced),
            "tokens_per_sec": produced / max(wall, 1e-9),
            "latency_p50_ms": pct(lat, 0.50),
            "latency_p99_ms": pct(lat, 0.99),
            "ttft_p50_ms": pct(ttft, 0.50),
            "engine_steps": float(engine.steps_run),
        }
        if decoder is not None:
            metrics["ejected_replicas"] = float(
                len(decoder.ejected_replicas()))
        history.append({"step": engine.steps_run, **metrics})

        return ExperimentResult(
            spec=plan.spec, history=history, params=params,
            defense_state=decoder.rep_state if decoder is not None else None,
            final_metrics=metrics, robust_cfg=plan.robust_cfg,
            wall_time=wall, requests=list(done))
