"""Builtin topology plugins: the three training-loop shapes and serving.

Port of ``repro/experiment/topologies.py``.

* ``sync_ps``   — the paper's synchronous parameter server, with the
  defense loop, ``adapt_b``, fault injection with deadline-quorum rounds,
  gradient compression and crash-safe checkpoints with ``resume``; on a
  mesh, one rank of the distributed step (rank 0 alone evaluates and
  writes telemetry and checkpoints; every rank reads a checkpoint to
  resume);
* ``async_ps``  — buffered-async PS with geometric staleness
  (``train/async_sgd.py``);
* ``streaming`` — the memory-bounded sequential pass over workers
  (``train/streaming.py``): O((2b+1)·|θ|) instead of O(m·|θ|);
* ``serve``     — Poisson arrivals through the continuous-batching paged
  engine, optionally with k replicas and robust aggregation of their logits.

Each loop threads the Recorder of ``make_recorder(plan.telemetry_path,
plan.obs)``: JSONL records, counters (``steps``, ``ejections``,
``readmissions``, ``adaptations``, fault counts), gauges (``q_hat``,
``resilience_margin``, ``present_workers``, ``steps_per_sec``, and on
sync_ps the step's cost ``step_flops``/``step_bytes`` and device memory
``device_bytes_in_use``/``device_peak_bytes_in_use``) and timed spans; on
a mesh rank 0 alone writes the JSONL and the metrics snapshot.  With
``plan.verbose`` the loops print their history rows as the reference's do.
The deprecated legacy shims (``Trainer``, ``run_async_training``,
``run_streaming_training``) enter the same loops through
``runner.plan_from_parts``.
"""
from __future__ import annotations

import dataclasses
import time

import torch

from repro_torch import tree as tree_util
from repro_torch.core import registry
from repro_torch.core.attacks import fold_seed
from repro_torch.data.pipeline import make_worker_batches
from repro_torch.experiment.runner import ExperimentResult, Plan
from repro_torch.experiment.spec import SpecError
from repro_torch.experiment.topology import Topology, register_topology
from repro_torch.obs.metrics import make_recorder
from repro_torch.optim.optimizers import init_opt_state
from repro_torch.train.streaming import STREAMING_ATTACKS


def _mask_flips(rec, prev, now, stream: str):
    """Count active-mask transitions into ejection/readmission counters;
    returns the new mask (host list)."""
    now = [bool(x) for x in now.tolist()]
    if prev is not None and len(prev) == len(now):
        ej = sum(1 for w, n in zip(prev, now) if w and not n)
        re = sum(1 for w, n in zip(prev, now) if n and not w)
        if ej:
            rec.count("ejections", ej, stream=stream)
        if re:
            rec.count("readmissions", re, stream=stream)
    return now


def _defense_gauges(rec, *, rule_name: str, m: int, q_hat: int,
                    b: int, q: int) -> None:
    """q̂ and resilience-margin gauges for one defended step.

    ``resilience_margin`` is how many more Byzantine workers the rule
    tolerates beyond the detector's estimate (tolerance − q̂; negative means
    the run left the rule's proven envelope); ``delta_bound_unit_var`` is
    the unit-variance Δ bound at (m, q̂, b), where the theory has one."""
    from repro_torch.defense.detector import _delta_bound
    tolerance = b if registry.get_rule(rule_name).uses_b else q
    rec.gauge("q_hat", q_hat)
    rec.gauge("resilience_margin", tolerance - q_hat, rule=rule_name)
    bound = _delta_bound(rule_name, m, q_hat, b, 1.0)
    if bound is not None:
        rec.gauge("delta_bound_unit_var", bound, rule=rule_name)


def _profile_step_cost(rec, plan: Plan, step_fn, args) -> None:
    """One-shot FLOPs/bytes gauges for the train step (one extra call of
    the step under the counting modes of ``obs/profile.py::compiled_cost``,
    so gated on obs.profile_cost)."""
    if not (rec.metrics_enabled and plan.obs is not None
            and getattr(plan.obs, "profile_cost", False)):
        return
    from repro_torch.obs.profile import compiled_cost
    for name, v in compiled_cost(step_fn, *args).items():
        rec.gauge(f"step_{name}", v)


def _rank_obs(plan: Plan, writer: bool):
    """``plan.obs`` for this process's Recorder: a mesh rank other than 0
    keeps its metrics but writes no snapshot."""
    if plan.obs is None or writer or not plan.obs.metrics_path:
        return plan.obs
    return dataclasses.replace(plan.obs, metrics_path=None)


def _fault_round(rec, injector, step: int):
    """One deadline-quorum collection round, its gauges and counts; None
    without a fault axis."""
    if injector is None:
        return None
    fr = injector.collect(step)
    rec.gauge("present_workers", fr.m_eff)
    if fr.retries:
        rec.count("fault_retries", fr.retries)
    if fr.timeouts:
        rec.count("fault_timeouts", fr.timeouts)
    return fr


def _log_lost_round(rec, fr, step: int) -> None:
    """No quorum this round (fewer than 2 workers present): the server
    cannot aggregate, so the round is lost (params unchanged), not the
    run."""
    rec.count("quorum_failures")
    rec.log("fault", step, present=int(fr.m_eff), crashed=fr.crashed,
            retries=fr.retries, timeouts=fr.timeouts, lost_round=True)


def _log_compress(rec, codec, step: int, dense_dim: int, m_sent: int,
                  retries: int) -> None:
    """One round's wire accounting: ``m_sent`` submissions plus
    ``retries`` resends, against the dense f32 bytes."""
    from repro_torch.compress.pipeline import bytes_per_round
    sent = bytes_per_round(codec, dense_dim, m_sent, retries)
    dense = 4 * dense_dim * (m_sent + retries)
    rec.log("compress", step, codec=codec.name, bytes=sent,
            dense_bytes=dense, ratio=sent / max(dense, 1))


def _rule_tree(robust_cfg) -> dict:
    """The checkpointed slice of the live rule config (adapt_b can move b/q
    mid-run; resume restores them to rebuild the same step)."""
    return {"b": robust_cfg.b, "q": robust_cfg.q}


def _scatter_vec(vec, idx, m: int):
    """Scatter an (m',) per-present-worker vector into an (m,) vector
    (absent workers read 0: no signal this round)."""
    return torch.zeros((m,), dtype=torch.float32,
                       device=vec.device).index_copy(0, idx, vec.float())


def _scatter_defense(full: dict, sub: dict, idx) -> dict:
    """Merge a compacted (m'-row) defense state back into the full m-row
    state: per-worker vectors scatter at the present indices (absent
    workers keep their frozen reputation/active), scalars adopt."""
    out = dict(full)
    for k, v in sub.items():
        old = full[k]
        out[k] = old.index_copy(0, idx, v.to(old.dtype)) \
            if old.dim() == 1 else v
    return out


def _scalarize(metrics: dict) -> dict:
    """Final-step metrics with 0-dim tensors pulled to floats (per-worker
    vectors are dropped: they live in telemetry)."""
    out = {}
    for k, v in metrics.items():
        if isinstance(v, torch.Tensor):
            if v.dim() == 0:
                out[k] = float(v)
        elif isinstance(v, (int, float)):
            out[k] = float(v)
    return out


@register_topology
class SyncPS(Topology):
    """The paper's synchronous PS loop."""

    name = "sync_ps"
    supports_mesh = True
    supports_defense = True
    supports_adapt_b = True
    fault_allowlist = None      # every registered fault kind
    supports_resume = True
    supports_compression = True
    supports_stateful_codecs = True

    def run(self, plan: Plan, init_state=None) -> ExperimentResult:
        """``init_state`` optionally injects ``(params, opt_state)`` or
        ``(params, opt_state, defense_state)``."""
        from repro_torch.compress.spec import make_codec
        from repro_torch.defense.reputation import (init_reputation,
                                                    update_presence)
        from repro_torch.faults.injector import make_injector, resolve_quorum
        from repro_torch.train.step import make_train_step

        m = plan.num_workers
        dev = plan.device
        robust_cfg = plan.robust_cfg
        dcfg = plan.defense_cfg
        rule_meta = registry.get_rule(robust_cfg.rule)
        injector = make_injector(plan.faults, m, plan.seed)
        if injector is not None and plan.mesh is not None:
            raise SpecError("sync_ps cannot drop whole workers from a "
                            "dim-sharded mesh; run faults without mesh")
        codec = make_codec(plan.compress_cfg)
        # On a mesh, rank 0 alone evaluates and writes the telemetry and
        # checkpoints.
        writer = plan.mesh is None or plan.mesh.rank == 0
        # On a tensor-parallel mesh the params and optimizer state stay
        # this rank's blocks; they are joined for eval, checkpoints and
        # the result.
        layout = None
        if plan.mesh is not None:
            from repro_torch.train.step import MeshParams
            layout = MeshParams(plan.model, plan.mesh)
        tp = layout is not None and layout.tp
        join = layout.join if tp else (lambda tree: tree)

        def build_step(rc, workers=m):
            return make_train_step(plan.model, robust_cfg=rc,
                                   opt_cfg=plan.opt_cfg, num_workers=workers,
                                   mesh=plan.mesh, defense_cfg=dcfg,
                                   compress_cfg=plan.compress_cfg)

        def invoke(fn, params, opt_state, batch, dstate, rsub):
            """One engine call, normalized over the four step signatures
            (defense × compression) to (params, opt, dstate, rsub,
            metrics)."""
            if dstate is not None and codec is not None:
                return fn(params, opt_state, batch, attack_gen, dstate, rsub)
            if dstate is not None:
                p, o, d, mt = fn(params, opt_state, batch, attack_gen, dstate)
                return p, o, d, rsub, mt
            if codec is not None:
                p, o, r, mt = fn(params, opt_state, batch, attack_gen, rsub)
                return p, o, dstate, r, mt
            p, o, mt = fn(params, opt_state, batch, attack_gen)
            return p, o, dstate, rsub, mt

        step_fn = build_step(robust_cfg)
        # Degraded-round steps, keyed by the effective (m', b', q', q_atk')
        # quorum: crash patterns repeat, so each shape is built once.
        fault_steps: dict = {}
        defense_state = None
        if init_state is not None:
            params, opt_state, *rest = init_state
            defense_state = rest[0] if rest else None
            if tp:
                params, opt_state = (layout.shard(params),
                                     layout.shard(opt_state))
        elif tp:
            from repro_torch.dist.sharding import init_blocks
            params = init_blocks(plan.model, plan.seed, plan.mesh, dev)
            opt_state = init_opt_state(plan.opt_cfg, params)
        else:
            gen = torch.Generator(device=dev).manual_seed(plan.seed)
            params = plan.model.init(gen)
            opt_state = init_opt_state(plan.opt_cfg, params)
        if dcfg is not None and defense_state is None:
            defense_state = init_reputation(m, device=dev)
        dense_dim = tree_util.size(params) if codec is not None else 0
        resid = (codec.init_state(m, dense_dim, device=dev)
                 if codec is not None else None)
        attack_gen = torch.Generator(device=dev).manual_seed(plan.seed + 1)

        # adapt_b: once q̂ exceeds the rule's b (or, for a rule that uses q
        # and not b, its q) for adapt_patience consecutive steps, re-build
        # the step with b = q̂ (capped at the largest valid b) and, for a
        # rule that uses q, q = max(q̂, q) (capped at m - 3).
        adapt = dcfg is not None and dcfg.adapt_b
        bmax = (m + 1) // 2 - 1
        pending = 0

        history: list = []
        metrics: dict = {}
        prev_active = None
        profiled_cost = False
        start_step = 0
        verbose = plan.verbose and writer
        t0 = time.time()
        with make_recorder(plan.telemetry_path if writer else None,
                           _rank_obs(plan, writer)) as rec:
            if plan.resume_path:
                from repro_torch.checkpoint.io import restore_checkpoint
                like = {"params": join(params), "opt": join(opt_state),
                        "key": attack_gen.get_state(),
                        "rule": _rule_tree(robust_cfg)}
                if defense_state is not None:
                    like["defense"] = defense_state
                if codec is not None and codec.stateful:
                    like["compress"] = resid
                # "key" is the port's generator state: a reference
                # checkpoint restores everything else.
                tree, ck_step, used_prev = restore_checkpoint(
                    plan.resume_path, like,
                    optional=("key", "rule", "compress"), port_only=("key",))
                params, opt_state = tree["params"], tree["opt"]
                if tp:
                    params, opt_state = (layout.shard(params),
                                         layout.shard(opt_state))
                attack_gen.set_state(tree["key"])
                defense_state = tree.get("defense", defense_state)
                resid = tree.get("compress", resid)
                b_r, q_r = tree["rule"]["b"], tree["rule"]["q"]
                if (b_r, q_r) != (robust_cfg.b, robust_cfg.q):
                    # the run had adapted b/q by checkpoint time
                    robust_cfg = dataclasses.replace(robust_cfg, b=b_r,
                                                     q=q_r)
                    step_fn = build_step(robust_cfg)
                start_step = ck_step + 1
                rec.log("resume", ck_step, path=plan.resume_path,
                        fallback=bool(used_prev), b=b_r, q=q_r)
                rec.count("resumes")
                if verbose:
                    src = "prev checkpoint" if used_prev else "checkpoint"
                    print(f"resumed from {src} at step {ck_step} "
                          f"({plan.resume_path})", flush=True)
            for step in range(start_step, plan.steps):
                batch = make_worker_batches(plan.batch_fn(step), m)
                fr = _fault_round(rec, injector, step)
                if fr is not None and defense_state is not None:
                    defense_state = update_presence(
                        defense_state,
                        torch.as_tensor(fr.present, dtype=torch.float32,
                                        device=dev), dcfg)
                if fr is not None and fr.m_eff < 2:
                    _log_lost_round(rec, fr, step)
                    continue
                if fr is not None and fr.degraded:
                    rc_eff, q_atk = resolve_quorum(robust_cfg, fr.present)
                    ck = (fr.m_eff, rc_eff.b, rc_eff.q, q_atk)
                    fn = fault_steps.get(ck)
                    if fn is None:
                        fn = fault_steps[ck] = build_step(rc_eff,
                                                          workers=fr.m_eff)
                    idx = torch.as_tensor(fr.index, device=dev)
                    cbatch = {k: v[idx] for k, v in batch.items()}
                    rec.log("fault", step, present=int(fr.m_eff),
                            crashed=fr.crashed, retries=fr.retries,
                            timeouts=fr.timeouts, b_eff=rc_eff.b,
                            q_eff=rc_eff.q)
                    # EF residual rows travel with their workers: compact
                    # to the present set, scatter back after the step
                    # (absent workers sent nothing, so their residual
                    # stays frozen).
                    stateful = codec is not None and codec.stateful
                    sub_r = resid[idx] if stateful else resid
                    with rec.span("degraded_round", step_num=step,
                                  rule=rc_eff.rule) as sp:
                        if defense_state is not None:
                            sub = {k: (v[idx] if v.dim() == 1 else v)
                                   for k, v in defense_state.items()}
                            params, opt_state, sub, sub_r, metrics = \
                                sp.sync(invoke(fn, params, opt_state,
                                               cbatch, sub, sub_r))
                            defense_state = _scatter_defense(
                                defense_state, sub, idx)
                            metrics = {**metrics,
                                       "suspicion": _scatter_vec(
                                           metrics["suspicion"], idx, m),
                                       "reputation":
                                           defense_state["reputation"],
                                       "active": defense_state["active"]}
                        else:
                            params, opt_state, _, sub_r, metrics = sp.sync(
                                invoke(fn, params, opt_state, cbatch, None,
                                       sub_r))
                    if codec is not None:
                        resid = (resid.index_copy(0, idx, sub_r)
                                 if stateful else sub_r)
                    m_step, rc_step = fr.m_eff, rc_eff
                else:
                    if not profiled_cost:
                        profiled_cost = True
                        args = (params, opt_state, batch, attack_gen)
                        if defense_state is not None:
                            args += (defense_state,)
                        if codec is not None:
                            args += (resid,)
                        _profile_step_cost(rec, plan, step_fn, args)
                        del args      # else the first params live all run
                    with rec.span("train_step", step_num=step,
                                  rule=robust_cfg.rule) as sp:
                        params, opt_state, defense_state, resid, metrics = \
                            sp.sync(invoke(step_fn, params, opt_state, batch,
                                           defense_state, resid))
                    m_step, rc_step = m, robust_cfg
                if defense_state is not None:
                    rec.log("train", step, loss=metrics["loss"],
                            grad_norm=metrics["grad_norm"],
                            suspicion=metrics["suspicion"],
                            reputation=metrics["reputation"],
                            active=metrics["active"],
                            q_hat=metrics["q_hat"])
                    if rec.metrics_enabled:
                        prev_active = _mask_flips(
                            rec, prev_active, metrics["active"], "train")
                        _defense_gauges(
                            rec, rule_name=rc_step.rule, m=m_step,
                            q_hat=int(metrics["q_hat"]), b=rc_step.b,
                            q=rc_step.q)
                rec.count("steps", topology=self.name)
                if codec is not None:
                    _log_compress(rec, codec, step, dense_dim, m_step,
                                  fr.retries if fr is not None else 0)

                if step % plan.record_every == 0 or step == plan.steps - 1:
                    row = {"step": step, "loss": float(metrics["loss"]),
                           "grad_norm": float(metrics["grad_norm"]),
                           "wall": time.time() - t0}
                    if fr is not None:
                        row["present"] = int(fr.m_eff)
                    if "q_hat" in metrics:
                        row["q_hat"] = int(metrics["q_hat"])
                        row["n_active"] = int(metrics["active"].sum())
                    if plan.eval_fn is not None:
                        whole = join(params)
                        if writer:
                            row["eval"] = float(plan.eval_fn(whole))
                    history.append(row)
                    if rec.metrics_enabled:
                        from repro_torch.obs.profile import sample_into
                        sample_into(rec)
                    if verbose:
                        msg = (f"step {step:5d}  loss {row['loss']:.4f}  "
                               f"gnorm {row['grad_norm']:.3e}")
                        if "q_hat" in row:
                            msg += (f"  qhat {row['q_hat']}  "
                                    f"active {row['n_active']}")
                        if "eval" in row:
                            msg += f"  eval {row['eval']:.4f}"
                        print(msg, flush=True)

                if (plan.checkpoint_path and plan.checkpoint_every and step
                        and step % plan.checkpoint_every == 0
                        and (writer or tp)):
                    from repro_torch.checkpoint.io import save_checkpoint
                    # "key" is the generator after this step's draws and
                    # "rule" the live (possibly adapted) b/q: together they
                    # make resume continue bit for bit.
                    tree = {"params": join(params), "opt": join(opt_state),
                            "key": attack_gen.get_state(),
                            "rule": _rule_tree(robust_cfg)}
                    if defense_state is not None:
                        tree["defense"] = defense_state
                    if codec is not None and codec.stateful:
                        # the EF residual is run state: dropping it would
                        # re-inject already-compensated error
                        tree["compress"] = resid
                    if writer:
                        save_checkpoint(plan.checkpoint_path, tree,
                                        step=step)

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
                            rec.log("adapt", step, b=new_b, q=new_q,
                                    q_hat=q_hat)
                            rec.count("adaptations")
                            if verbose:
                                print(f"step {step:5d}  [adapt] "
                                      f"q_hat={q_hat} -> b={new_b} "
                                      f"q={new_q} (re-build)", flush=True)
            wall = time.time() - t0
            rec.gauge("steps_per_sec",
                      (plan.steps - start_step) / max(wall, 1e-9),
                      topology=self.name)
        if tp:
            from repro_torch.dist.launch import check_blocks
            check_blocks(params, plan.mesh, layout.cuts)
            params, opt_state = join(params), join(opt_state)
        elif plan.mesh is not None:
            from repro_torch.dist.launch import check_replicated
            check_replicated(params)

        return ExperimentResult(
            spec=plan.spec, history=history, params=params,
            opt_state=opt_state, defense_state=defense_state,
            final_metrics=_scalarize(metrics), robust_cfg=robust_cfg,
            wall_time=wall)


@register_topology
class AsyncPS(Topology):
    """Buffered-async PS (``train/async_sgd.py``)."""

    name = "async_ps"
    supports_defense = True
    param_names = ("staleness", "update_clip")
    fault_allowlist = None      # every registered fault kind
    supports_compression = True
    supports_stateful_codecs = True

    def run(self, plan: Plan, init_state=None) -> ExperimentResult:
        """``init_state`` optionally injects the async state dict."""
        from repro_torch.compress.spec import make_codec
        from repro_torch.defense.reputation import update_presence
        from repro_torch.faults.injector import make_injector
        from repro_torch.train.async_sgd import (AsyncConfig,
                                                 make_async_train_step)

        m = plan.num_workers
        dev = plan.device
        acfg = AsyncConfig(
            num_workers=m,
            staleness=int(plan.topology_params.get("staleness", 4)),
            update_clip=float(plan.topology_params.get("update_clip", 10.0)),
            seed=plan.seed)
        injector = make_injector(plan.faults, m, plan.seed)
        init_fn, step_fn = make_async_train_step(
            plan.model, robust_cfg=plan.robust_cfg, opt_cfg=plan.opt_cfg,
            acfg=acfg, defense_cfg=plan.defense_cfg,
            faulty=injector is not None, compress_cfg=plan.compress_cfg)
        codec = make_codec(plan.compress_cfg)
        # Parameters from the seed; each step's draws from a generator
        # folded from (seed, step), as the reference folds the step into
        # PRNGKey(seed) (sync_ps draws from seed + 1).
        state = (init_fn(torch.Generator(device=dev).manual_seed(plan.seed))
                 if init_state is None else init_state)
        dense_dim = (tree_util.size(state["params"])
                     if codec is not None else 0)
        history: list = []
        metrics: dict = {}
        prev_active = None
        t0 = time.time()
        with make_recorder(plan.telemetry_path, plan.obs) as rec:
            for i in range(plan.steps):
                batch = make_worker_batches(plan.batch_fn(i), m)
                gen = torch.Generator(device=dev).manual_seed(
                    fold_seed(plan.seed, i))
                fr = _fault_round(rec, injector, i)
                with rec.span("async_step", step_num=i,
                              rule=plan.robust_cfg.rule) as sp:
                    if fr is None:
                        state, metrics = sp.sync(step_fn(state, batch, gen))
                    else:
                        present = torch.as_tensor(
                            fr.present, dtype=torch.float32, device=dev)
                        state, metrics = sp.sync(
                            step_fn(state, batch, gen, present))
                if fr is not None:
                    rec.log("fault", i, present=int(fr.m_eff),
                            crashed=fr.crashed, retries=fr.retries,
                            timeouts=fr.timeouts,
                            m_fresh=metrics["m_fresh"])
                    if plan.defense_cfg is not None:
                        state["defense"] = update_presence(
                            state["defense"], present, plan.defense_cfg)
                rec.count("steps", topology=self.name)
                if codec is not None:
                    # every buffer slot goes on the wire, present or not
                    _log_compress(rec, codec, i, dense_dim, m,
                                  fr.retries if fr is not None else 0)
                if plan.defense_cfg is not None:
                    rec.log("async", i,
                            staleness_frac=metrics["staleness_frac"],
                            suspicion=metrics["suspicion"],
                            reputation=metrics["reputation"],
                            active=metrics["active"],
                            q_hat=metrics["q_hat"])
                    if rec.metrics_enabled:
                        prev_active = _mask_flips(
                            rec, prev_active, metrics["active"], "async")
                        _defense_gauges(
                            rec, rule_name=plan.robust_cfg.rule, m=m,
                            q_hat=int(metrics["q_hat"]),
                            b=plan.robust_cfg.b, q=plan.robust_cfg.q)
                if i % plan.record_every == 0 or i == plan.steps - 1:
                    row = {"step": i, "staleness_frac":
                           float(metrics["staleness_frac"])}
                    if fr is not None:
                        row["present"] = int(fr.m_eff)
                        row["m_fresh"] = int(metrics["m_fresh"])
                    if "q_hat" in metrics:
                        row["q_hat"] = int(metrics["q_hat"])
                    if plan.eval_fn is not None:
                        row["eval"] = float(plan.eval_fn(state["params"]))
                    history.append(row)
                    if plan.verbose and "eval" in row:
                        print(f"step {i:5d}  eval {row['eval']:.4f}",
                              flush=True)
            wall = time.time() - t0
            rec.gauge("steps_per_sec", plan.steps / max(wall, 1e-9),
                      topology=self.name)

        return ExperimentResult(
            spec=plan.spec, history=history, params=state["params"],
            opt_state=state["opt"], defense_state=state.get("defense"),
            final_metrics=_scalarize(metrics), robust_cfg=plan.robust_cfg,
            wall_time=wall)


@register_topology
class Streaming(Topology):
    """Memory-bounded pass over workers (``train/streaming.py``).  With a
    plan's ``mesh`` (set on the plan: a spec's ``mesh`` is refused here, as
    the reference's refuses it) this process is one rank of the FSDP form:
    params and optimizer state are its ``FsdpLayout`` shards across steps
    (joined for eval and the result), and each step gets its rows of
    every worker's batch; rank 0 alone evaluates and writes the
    telemetry."""

    name = "streaming"
    attack_allowlist = STREAMING_ATTACKS
    requires_streaming_rule = True
    fault_allowlist = None      # every registered fault kind
    supports_compression = True
    # supports_stateful_codecs stays False: the O((2b+1)·|θ|) memory
    # contract cannot hold an (m, |θ|) error-feedback residual.

    def run(self, plan: Plan, init_state=None) -> ExperimentResult:
        """``init_state`` optionally injects ``(params, opt_state)``."""
        from repro_torch.compress.spec import make_codec
        from repro_torch.faults.injector import make_injector, resolve_quorum
        from repro_torch.train.streaming import (data_rows,
                                                 make_streaming_train_step)

        m = plan.num_workers
        dev = plan.device
        codec = make_codec(plan.compress_cfg)
        mesh = plan.mesh

        def build_step(rc, workers=m):
            return make_streaming_train_step(
                plan.model, robust_cfg=rc, opt_cfg=plan.opt_cfg,
                num_workers=workers, compress_cfg=plan.compress_cfg,
                mesh=mesh)

        step_fn = build_step(plan.robust_cfg)
        injector = make_injector(plan.faults, m, plan.seed)
        if injector is not None and mesh is not None:
            raise SpecError("streaming cannot drop whole workers on a mesh; "
                            "run faults without mesh")
        fault_steps: dict = {}      # (m', b', q', q_atk') -> step
        if init_state is not None:
            params, opt_state = init_state[:2]
        else:
            params = plan.model.init(
                torch.Generator(device=dev).manual_seed(plan.seed))
            opt_state = init_opt_state(plan.opt_cfg, params)
        writer, join = True, (lambda tree: tree)
        if mesh is not None:
            from repro_torch.dist.sharding import FsdpLayout
            layout = FsdpLayout(plan.model.abstract_params(), mesh,
                                plan.model.tensor_parallel)
            params, opt_state = layout.shard(params), layout.shard(opt_state)
            writer, join = mesh.rank == 0, layout.join
        dense_dim = tree_util.size(params) if codec is not None else 0
        history: list = []
        metrics: dict = {}
        t0 = time.time()
        with make_recorder(plan.telemetry_path if writer else None,
                           _rank_obs(plan, writer)) as rec:
            for i in range(plan.steps):
                batch = make_worker_batches(plan.batch_fn(i), m)
                if mesh is not None:
                    batch = data_rows(batch, mesh)
                fr = _fault_round(rec, injector, i)
                if fr is not None and fr.m_eff < 2:
                    _log_lost_round(rec, fr, i)
                    continue
                seed = fold_seed(plan.seed, i)
                if fr is not None and fr.degraded:
                    rc_eff, q_atk = resolve_quorum(plan.robust_cfg,
                                                   fr.present)
                    ck = (fr.m_eff, rc_eff.b, rc_eff.q, q_atk)
                    fn = fault_steps.get(ck)
                    if fn is None:
                        fn = fault_steps[ck] = build_step(rc_eff,
                                                          workers=fr.m_eff)
                    idx = torch.as_tensor(fr.index, device=dev)
                    cbatch = {k: v[idx] for k, v in batch.items()}
                    rec.log("fault", i, present=int(fr.m_eff),
                            crashed=fr.crashed, retries=fr.retries,
                            timeouts=fr.timeouts, b_eff=rc_eff.b,
                            q_eff=rc_eff.q)
                    with rec.span("degraded_round", step_num=i,
                                  rule=rc_eff.rule) as sp:
                        params, opt_state, metrics = sp.sync(fn(
                            params, opt_state, cbatch, seed))
                else:
                    with rec.span("streaming_step", step_num=i,
                                  rule=plan.robust_cfg.rule) as sp:
                        params, opt_state, metrics = sp.sync(step_fn(
                            params, opt_state, batch, seed))
                rec.count("steps", topology=self.name)
                if codec is not None:
                    _log_compress(rec, codec, i, dense_dim,
                                  fr.m_eff if fr is not None else m,
                                  fr.retries if fr is not None else 0)
                extra = ({"suspicion": metrics["suspicion"]}
                         if "suspicion" in metrics else {})
                rec.log("streaming", i, loss=metrics["loss"], **extra)
                if i % plan.record_every == 0 or i == plan.steps - 1:
                    row = {"step": i, "loss": float(metrics["loss"])}
                    if fr is not None:
                        row["present"] = int(fr.m_eff)
                    if plan.eval_fn is not None:
                        whole = join(params)
                        if writer:
                            row["eval"] = float(plan.eval_fn(whole))
                    history.append(row)
                    if plan.verbose and writer:
                        msg = f"step {i:5d}  loss {row['loss']:.4f}"
                        if "eval" in row:
                            msg += f"  eval {row['eval']:.4f}"
                        print(msg, flush=True)
            wall = time.time() - t0
            rec.gauge("steps_per_sec", plan.steps / max(wall, 1e-9),
                      topology=self.name)
        params, opt_state = join(params), join(opt_state)

        return ExperimentResult(
            spec=plan.spec, history=history, params=params,
            opt_state=opt_state, final_metrics=_scalarize(metrics),
            robust_cfg=plan.robust_cfg, wall_time=wall)


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
    # Replica count lives here (NOT spec.num_workers, which is the training
    # fan-out and must stay >= 2); every key is read via a literal
    # topology_params.get(...) below so repro_torch.analysis CONTRACT006 can
    # cross-check this tuple against the loop body.
    param_names = ("replicas", "max_slots", "max_seq_len", "block_tokens",
                   "num_requests", "arrival_rate", "prompt_len",
                   "max_new_tokens")
    supports_defense = True
    # corrupt_replica injects Gaussian garbage parameters, the only fault
    # model the serving path simulates.
    attack_allowlist = ("gaussian",)

    def validate_spec(self, spec) -> None:
        super().validate_spec(spec)
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

        replicas = int(plan.topology_params.get("replicas", 1))
        max_slots = int(plan.topology_params.get("max_slots", 8))
        max_seq_len = int(plan.topology_params.get("max_seq_len", 128))
        block_tokens = int(plan.topology_params.get("block_tokens", 16))
        num_requests = int(plan.topology_params.get("num_requests", 16))
        # arrival_rate: requests per engine step (Poisson)
        arrival_rate = float(plan.topology_params.get("arrival_rate", 2.0))
        prompt_len = int(plan.topology_params.get("prompt_len", 8))
        max_new = int(plan.topology_params.get("max_new_tokens", 16))

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
