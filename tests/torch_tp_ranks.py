"""Rank body of the gloo world that ``test_torch_tp.py`` spawns.

It lives apart from the test module so that a spawned rank imports
``torch`` and ``repro_torch`` only, never JAX or the reference: the test
process computes the reference's values and hands the rank numpy inputs
(parameters, prompts, batches, spec JSON).  The body runs as one rank of a
(data, model) = (2, 2) mesh under ``repro_torch.dist.launch.spawn``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

MESH = (2, 2)


def _np(x):
    return x.detach().cpu().numpy()


def _bytes(tree) -> int:
    from repro_torch import tree as tree_util
    return sum(x.numel() * x.element_size() for x in tree_util.leaves(tree))


def arch_model(arch: str, changes: dict):
    from repro_torch.configs import get_arch
    from repro_torch.models.registry import build_model
    return build_model(dataclasses.replace(get_arch(arch), **changes))


def _serve(mesh, arch, changes, params, prompts, new_tokens) -> dict:
    """``generate`` and ``generate_stepwise`` on the mesh; the prefill's
    logits and one decode step's (fed the first generated token), gathered
    over the data axis; this rank's param bytes."""
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.serve.engine import (MeshServing, generate,
                                          generate_stepwise)
    model = arch_model(arch, changes)
    params = lm_params_from_numpy(params)
    prompts = torch.tensor(prompts)
    B, S0 = prompts.shape
    toks = generate(model, params, prompts, new_tokens, mesh=mesh)
    stepwise = generate_stepwise(model, params, prompts, new_tokens,
                                 mesh=mesh)
    ms = MeshServing(model, mesh, B)
    blocks = ms.params(params)
    cache = ms.cache(B, S0 + new_tokens, prompts.device)
    step = ms.step()
    _, pre, cache = step(blocks, cache, prompts[ms.rows], torch.arange(S0))
    _, dec, cache = step(blocks, cache, toks[ms.rows, S0:S0 + 1], S0)
    return {"tokens": _np(toks), "stepwise": _np(stepwise),
            "prefill": _np(ms.gather(pre)), "decode": _np(ms.gather(dec)),
            "param_bytes": _bytes(blocks), "batch_sharded": ms.sharded}


def _train(spec_json, init, batches, resume_dir=None,
           cost_path=None) -> dict:
    """The spec's sync_ps run on this world from the reference's params
    on its batches; then one momentum step of the mesh train step from
    this rank's blocks, whose params and optimizer state are counted.
    With ``resume_dir``: the run again, killed after its second step
    (checkpointed every step), then resumed to the end.  With
    ``cost_path``: the run again with metrics on and the step's cost
    counted (one extra call of the step on every rank, through the model
    axis's collectives), rank 0 writing the snapshot there."""
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.data.pipeline import make_worker_batches
    from repro_torch.experiment import ScenarioSpec, resolve
    from repro_torch.experiment.topologies import SyncPS
    from repro_torch.optim import OptConfig
    from repro_torch.optim.optimizers import init_opt_state
    from repro_torch.train.step import MeshParams, make_train_step
    spec = ScenarioSpec.from_json(spec_json)
    plan = resolve(spec, device="cpu")
    feed = [{k: torch.tensor(v) for k, v in b.items()} for b in batches]
    plan.batch_fn = lambda s: feed[s]
    params = lm_params_from_numpy(init)
    res = SyncPS().run(plan, init_state=(
        params, init_opt_state(plan.opt_cfg, params)))

    layout = MeshParams(plan.model, plan.mesh)
    momentum = OptConfig(name="momentum", lr=0.1)
    blocks = layout.shard(params)
    step = make_train_step(plan.model, robust_cfg=plan.robust_cfg,
                           opt_cfg=momentum, num_workers=spec.num_workers,
                           mesh=plan.mesh)
    new, opt, _ = step(blocks, init_opt_state(momentum, blocks),
                       make_worker_batches(feed[0], spec.num_workers),
                       torch.Generator().manual_seed(0))
    out = {"losses": [r["loss"] for r in res.history],
           "params": _flat(res.params), "tp": layout.tp,
           "param_bytes": _bytes(new), "opt_bytes": _bytes(opt["mu"])}
    if resume_dir is not None:
        import os
        path = os.path.join(resume_dir, "tp.pt")
        cut = dataclasses.replace(spec, steps=2, checkpoint_every=1,
                                  checkpoint_path=path)
        plan = resolve(cut, device="cpu")
        plan.batch_fn = lambda s: feed[s]
        SyncPS().run(plan, init_state=(
            params, init_opt_state(plan.opt_cfg, params)))
        whole = dataclasses.replace(cut, steps=spec.steps)
        plan = resolve(whole, device="cpu", resume=path)
        plan.batch_fn = lambda s: feed[s]
        out["resumed"] = _flat(SyncPS().run(plan).params)
    if cost_path is not None:
        from repro_torch.obs import ObsConfig
        plan = resolve(spec, device="cpu", obs=ObsConfig(
            metrics_path=cost_path, profile_cost=True))
        plan.batch_fn = lambda s: feed[s]
        counted = SyncPS().run(plan, init_state=(
            params, init_opt_state(plan.opt_cfg, params)))
        out["counted"] = {"losses": [r["loss"] for r in counted.history],
                          "params": _flat(counted.params),
                          "path": cost_path}
    return out


def _flat(params) -> np.ndarray:
    from repro_torch import tree as tree_util
    return np.concatenate([_np(x).reshape(-1)
                           for x in tree_util.leaves(params)])


def tp_rank(rank: int, world: int, serve_cases: dict,
            train_cases: dict) -> dict:
    """Every serving case, then every training case, on the (2, 2) mesh;
    rank 0 returns the values, every rank its byte counts."""
    from repro_torch.dist.mesh import make_host_mesh
    mesh = make_host_mesh(*MESH)
    out = {"serve": {}, "train": {}}
    for key, case in serve_cases.items():
        got = _serve(mesh, **case)
        out["serve"][key] = got if rank == 0 else {
            "param_bytes": got["param_bytes"]}
    for key, case in train_cases.items():
        got = _train(**case)
        out["train"][key] = got if rank == 0 else {
            k: got[k] for k in ("param_bytes", "opt_bytes")}
    return out
