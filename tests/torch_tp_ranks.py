"""Rank body of the gloo world that ``test_torch_tp.py`` spawns.

It lives apart from the test module so that a spawned rank imports
``torch`` and ``repro_torch`` only, never JAX or the reference: the test
process computes the reference's values and hands the rank numpy inputs
(parameters, prompts, batches, spec JSON).  The body runs as one rank of a
(data, model) = (2, 2) mesh under ``repro_torch.dist.launch.spawn``, then
of a (1, 4) mesh (attention on heads that 4 model ranks do not split) and
of the FSDP streaming step's (4, 1) and (2, 2) meshes, over the same world;
last, of (2, 2) and (4, 1) meshes whose axes take the NCCL collective forms
(``make_mesh(..., forms="nccl")``) on this gloo world.
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


def _serve(mesh, arch, changes, params, prompts, new_tokens,
           audio=None) -> dict:
    """``generate`` and ``generate_stepwise`` on the mesh; the logits of
    the first two steps ``generate`` makes (the prefill and one decode
    step fed the first generated token; or, for the families that step
    their prompt, its first two tokens), gathered over the data axis; with
    ``audio`` (whisper), the logits of a first step against the
    cross-attention K/V that ``prefill_cache`` puts into the mesh's cache;
    this rank's param and cache bytes."""
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.dist.mesh import use_mesh
    from repro_torch.serve.engine import (MeshServing,
                                          batched_prefill_supported,
                                          generate, generate_stepwise)
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
    cache_bytes = _bytes(cache)
    step = ms.step()
    rows = prompts[ms.rows]
    if batched_prefill_supported(model.cfg, S0):
        _, pre, cache = step(blocks, cache, rows, torch.arange(S0))
        _, dec, cache = step(blocks, cache, toks[ms.rows, S0:S0 + 1], S0)
    else:
        _, pre, cache = step(blocks, cache, rows[:, :1], 0)
        _, dec, cache = step(blocks, cache, rows[:, 1:2], 1)
    out = {"tokens": _np(toks), "stepwise": _np(stepwise),
           "prefill": _np(ms.gather(pre)), "decode": _np(ms.gather(dec)),
           "param_bytes": _bytes(blocks), "cache_bytes": cache_bytes,
           "batch_sharded": ms.sharded}
    if audio is not None:
        from repro_torch.models import encdec
        cache = ms.cache(B, S0 + new_tokens, prompts.device)
        with use_mesh(mesh, batch_sharded=ms.sharded), torch.no_grad():
            cache = encdec.prefill_cache(blocks, model.cfg, cache,
                                         torch.tensor(audio)[ms.rows])
        _, lg, _ = step(blocks, cache, rows[:, :1], 0)
        out["audio"] = _np(ms.gather(lg))
    return out


def _grad(mesh, arch, changes, params, batch) -> dict:
    """The loss and gradient of one batch (every rank the whole batch) on
    this rank's blocks, the gradient's blocks joined over the model axis;
    which leaves ``tree_pspecs`` left whole."""
    from repro_torch import tree as tree_util
    from repro_torch.convert import lm_params_from_numpy, lm_params_to_numpy
    from repro_torch.dist.collectives import join_blocks, model_cuts
    from repro_torch.dist.mesh import use_mesh
    from repro_torch.dist.sharding import shard_params
    model = arch_model(arch, changes)
    full = model.abstract_params()
    blocks = shard_params(lm_params_from_numpy(params), mesh, full=full)
    batch = {k: torch.tensor(v) for k, v in batch.items()}
    with use_mesh(mesh):
        grads, loss = torch.func.grad_and_value(model.loss)(blocks, batch)
    cuts = model_cuts(full, mesh)
    whole = tree_util.unflatten(full, [c is None for c in cuts])
    return {"loss": float(loss),
            "grads": lm_params_to_numpy(join_blocks(grads, cuts)),
            "whole": whole}


def _cli(argv: list, alone: bool) -> dict:
    """The serve CLI as a rank of this world (``--mesh 2x2``) and, with
    ``alone``, without ``--mesh``: what each printed."""
    import contextlib
    import io

    from repro_torch.launch.serve import main
    out = {}
    runs = [("mesh", ["--mesh", "x".join(map(str, MESH))])]
    for key, extra in runs + ([("alone", [])] if alone else []):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            main(argv + extra)
        out[key] = buf.getvalue()
    return out


def _train(spec_json, init, batches, resume_dir=None, cost_path=None,
           seq_shard=False) -> dict:
    """The spec's sync_ps run on this world from the reference's params
    on its batches; then one momentum step of the mesh train step from
    this rank's blocks, whose params and optimizer state are counted.
    With ``resume_dir``: the run again, killed after its second step
    (checkpointed every step), then resumed to the end.  With
    ``cost_path``: the run again with metrics on and the step's cost
    counted (one extra call of the step on every rank, through the model
    axis's collectives), rank 0 writing the snapshot there.  With
    ``seq_shard``: the run again with ``models/stack.py::SEQ_SHARD`` on
    (the residual stream's sequence sharded over the model axis)."""
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
    if seq_shard:
        from repro_torch.models import stack
        plan = resolve(spec, device="cpu")
        plan.batch_fn = lambda s: feed[s]
        stack.SEQ_SHARD = True
        try:
            sharded = SyncPS().run(plan, init_state=(
                params, init_opt_state(plan.opt_cfg, params)))
        finally:
            stack.SEQ_SHARD = False
        out["seq"] = {"losses": [r["loss"] for r in sharded.history],
                      "params": _flat(sharded.params)}
    return out


def _heads(mesh, arch, changes, params, batch, prompts) -> dict:
    """On a mesh whose model axis does not split the heads: one batch's
    loss and gradient (joined over the model axis, remat full), the
    serving step's prefill and first decode logits, and the heads each
    attention call of the loss got on this rank (q's and k's)."""
    from repro_torch.convert import lm_params_from_numpy, lm_params_to_numpy
    from repro_torch.dist.collectives import join_blocks, model_cuts
    from repro_torch.dist.mesh import use_mesh
    from repro_torch.models import common as C
    from repro_torch.serve.engine import MeshServing
    from repro_torch.configs import get_arch
    from repro_torch.models.registry import build_model
    model = build_model(dataclasses.replace(get_arch(arch), **changes),
                        remat="full")
    full = model.abstract_params()
    blocks = MeshServing(model, mesh, len(prompts)).params(
        lm_params_from_numpy(params))
    batch = {k: torch.tensor(v) for k, v in batch.items()}
    seen = []
    real = C.attention_core

    def spy(q, k, v, *a, **kw):
        seen.append((q.shape[2], k.shape[2]))
        return real(q, k, v, *a, **kw)

    C.attention_core = spy
    try:
        with use_mesh(mesh):
            grads, loss = torch.func.grad_and_value(model.loss)(blocks,
                                                                batch)
    finally:
        C.attention_core = real
    grads = join_blocks(grads, model_cuts(full, mesh))
    prompts = torch.tensor(prompts).long()
    ms = MeshServing(model, mesh, prompts.shape[0])
    cache = ms.cache(prompts.shape[0], prompts.shape[1] + 1, prompts.device)
    step = ms.step()
    nxt, pre, cache = step(blocks, cache, prompts,
                           torch.arange(prompts.shape[1]))
    _, dec, _ = step(blocks, cache, nxt, prompts.shape[1])
    return {"loss": float(loss), "grads": lm_params_to_numpy(grads),
            "prefill": _np(pre), "decode": _np(dec), "heads": seen}


def _stream(mesh, kind, rule, attack, steps) -> dict:
    """The FSDP streaming step on ``mesh`` (``train/streaming.py``) from
    the seed-0 init of ``kind`` ("mlp", or an arch) on the batches of
    ``stream_setup``: each step's joined params and workers' losses, and
    the bytes of this rank's shards of the params, the momentum and the
    bottom statistic against the whole tree's."""
    from repro_torch import tree as tree_util
    from repro_torch.core.attacks import AttackConfig
    from repro_torch.core.robust import RobustConfig
    from repro_torch.dist.sharding import FsdpLayout
    from repro_torch.optim import OptConfig, init_opt_state
    from repro_torch.train import streaming
    model, batches = stream_setup(kind, mesh.axis_sizes[0])
    rc = RobustConfig(rule=rule, b=1 if mesh.axis_sizes[0] > 2 else 0,
                      q=1, attack=AttackConfig(name=attack, num_byzantine=1))
    opt = OptConfig(name="momentum", lr=0.1)
    whole = model.init(torch.Generator().manual_seed(0))
    layout = FsdpLayout(model.abstract_params(), mesh, model.tensor_parallel)
    params = layout.shard(whole)
    state = layout.shard(init_opt_state(opt, whole))
    step = streaming.make_streaming_train_step(
        model, robust_cfg=rc, opt_cfg=opt, num_workers=mesh.axis_sizes[0],
        mesh=mesh)
    stats = []
    real = streaming._merge_bottom

    def spy(bot, g):
        stats.append(bot.numel() * bot.element_size())
        return real(bot, g)

    streaming._merge_bottom = spy
    out = {"params": [], "losses": []}
    try:
        for s, batch in enumerate(batches[:steps]):
            stats.clear()
            params, state, metrics = step(
                params, state, streaming.data_rows(batch, mesh), s)
            out["params"].append(_flat(layout.join(params)))
            out["losses"].append(_np(metrics["loss_per_worker"]))
    finally:
        streaming._merge_bottom = real
    n = len(tree_util.leaves(whole))
    out["bytes"] = {"params": (_bytes(params), _bytes(whole)),
                    "mu": (_bytes(state["mu"]), _bytes(init_opt_state(
                        opt, whole)["mu"])),
                    "bot": (sum(stats[-n:]) if rc.b else 0,
                            rc.b * _bytes(tree_util.map(
                                lambda x: x.float(), whole)))}
    return out


def stream_setup(kind: str, m: int):
    """The model and three (m, 4, ...) worker-stacked batches (seeded) of
    the streaming cases: 4 rows a worker, one a data rank of a 4-way
    data axis."""
    g = torch.Generator().manual_seed(5)
    if kind == "mlp":
        from repro_torch.models.mlp import build_mlp_model
        model = build_mlp_model((6, 8, 3))
        return model, [{"x": torch.randn((m, 4, 6), generator=g),
                        "y": torch.randint(0, 3, (m, 4), generator=g)}
                       for _ in range(3)]
    from repro_torch.configs import get_arch
    from repro_torch.models.registry import build_model
    model = build_model(get_arch(kind), remat="full")
    out = []
    for _ in range(3):
        t = torch.randint(0, model.cfg.vocab_size, (m, 4, 8), generator=g)
        out.append({"tokens": t, "labels": torch.roll(t, -1, 2)})
    return model, out


def stream_single(kind, rule, attack, m, steps) -> dict:
    """The one-process streaming step of the same case: each step's params
    and workers' losses."""
    from repro_torch.core.attacks import AttackConfig
    from repro_torch.core.robust import RobustConfig
    from repro_torch.optim import OptConfig, init_opt_state
    from repro_torch.train import streaming
    model, batches = stream_setup(kind, m)
    rc = RobustConfig(rule=rule, b=1 if m > 2 else 0, q=1,
                      attack=AttackConfig(name=attack, num_byzantine=1))
    opt = OptConfig(name="momentum", lr=0.1)
    params = model.init(torch.Generator().manual_seed(0))
    state = init_opt_state(opt, params)
    step = streaming.make_streaming_train_step(
        model, robust_cfg=rc, opt_cfg=opt, num_workers=m)
    out = {"params": [], "losses": []}
    if rule == "phocas":        # the first step's worker matrix (attacked)
        grad = torch.func.grad(model.loss)
        out["workers"] = np.stack([_flat(streaming._worker_attack(
            rc.attack, streaming.tree_util.map(lambda x: x.float(), grad(
                params, {k: v[w] for k, v in batches[0].items()})), w, 0))
            for w in range(m)])
    for s, batch in enumerate(batches[:steps]):
        params, state, metrics = step(params, state, batch, s)
        out["params"].append(_flat(params))
        out["losses"].append(_np(metrics["loss_per_worker"]))
    return out


def _flat(params) -> np.ndarray:
    from repro_torch import tree as tree_util
    return np.concatenate([_np(x).reshape(-1)
                           for x in tree_util.leaves(params)])


def tp_rank(rank: int, world: int, serve_cases: dict, train_cases: dict,
            grad_cases: dict, cli_argv: list, head_cases: dict,
            stream_cases: dict, stream_spec: dict) -> dict:
    """Every serving case, every training case, every gradient case and
    the serve CLI on the (2, 2) mesh, the head cases on a (1, 4) mesh, the
    streaming cases on their meshes and ``stream_spec``'s streaming run
    on its own; rank 0 returns the values, every rank its byte counts and
    the heads it attended over."""
    from repro_torch.dist.mesh import make_host_mesh, make_mesh
    mesh = make_host_mesh(*MESH)
    out = {"serve": {}, "train": {}, "grad": {}, "heads": {}, "stream": {}}
    for key, case in serve_cases.items():
        got = _serve(mesh, **case)
        out["serve"][key] = got if rank == 0 else {
            k: got[k] for k in ("param_bytes", "cache_bytes")}
    for key, case in train_cases.items():
        got = _train(**case)
        out["train"][key] = got if rank == 0 else {
            k: got[k] for k in ("param_bytes", "opt_bytes")}
    for key, case in grad_cases.items():
        got = _grad(mesh, **case)
        if rank == 0:
            out["grad"][key] = got
    cli = _cli(cli_argv, alone=rank == 0)
    if rank == 0:
        out["cli"] = cli
    wide = make_mesh((1, 4), ("data", "model"))
    for key, case in head_cases.items():
        got = _heads(wide, **case)
        out["heads"][key] = got if rank == 0 else {"heads": got["heads"]}
    meshes = {}
    for key, (kind, rule, attack, shape, steps) in stream_cases.items():
        if shape not in meshes:
            meshes[shape] = make_mesh(shape, ("data", "model"))
        got = _stream(meshes[shape], kind, rule, attack, steps)
        out["stream"][key] = got if rank == 0 else {"bytes": got["bytes"]}
    res = _stream_spec(**stream_spec)
    if rank == 0:
        out["spec"] = res
    out["nccl"] = _nccl_forms(rank, mesh, train_cases[NCCL_TRAIN],
                              stream_cases[NCCL_STREAM])
    return out


# The training case and the streaming case run again under the NCCL forms.
NCCL_TRAIN = "gemma2-2b-reduced"
NCCL_STREAM = "mlp phocas signflip"


def _nccl_forms(rank, gloo, train_case, stream_case) -> dict:
    """The collectives, a ``SEQ_SHARD`` training run and an FSDP streaming
    run under the NCCL forms (a (2, 2) and a (4, 1) mesh made with
    ``forms="nccl"``), beside the same collectives under ``gloo``'s (the
    (2, 2) mesh of the other cases): each op's two outputs on this rank,
    the runs' values (rank 0), and the tensor-form calls each made."""
    from repro_torch.dist import collectives as C
    from repro_torch.dist.mesh import make_host_mesh, make_mesh
    nccl = make_host_mesh(*MESH, forms="nccl")
    calls = {"all_gather_single": 0, "reduce_scatter_single": 0}
    real = C._all_gather_single, C._reduce_scatter_single

    def gather(*a, **kw):
        calls["all_gather_single"] += 1
        return real[0](*a, **kw)

    def scatter(*a, **kw):
        calls["reduce_scatter_single"] += 1
        return real[1](*a, **kw)

    C._all_gather_single, C._reduce_scatter_single = gather, scatter
    g = torch.Generator().manual_seed(100 + rank)
    x = torch.randn((4, 6, 8), generator=g)
    both = ("data", "model")
    ops = {}
    try:
        for name, fn in {
                "all_gather dim 0": lambda m: C.all_gather_axes(
                    x, m.axes(both), 0),
                "all_gather dim 1": lambda m: C.all_gather_axes(
                    x, m.axes(both), 1),
                "gather_workers": lambda m: C.gather_workers(
                    x.reshape(-1), m.axes(both)),
                "all_to_all_scatter": lambda m: C.all_to_all_scatter(
                    x.reshape(-1), m.axes(both)),
                "gather_from_model": lambda m: C.gather_from_model(
                    x, m.axes(("model",)), 2)}.items():
            ops[name] = (_np(fn(nccl)), _np(fn(gloo)))
        for dt in (torch.float32, torch.bfloat16):
            for names, dim in ((("model",), 0), (("model",), 1),
                               (both, 2)):
                fn = (lambda m: C.reduce_scatter_to_model(
                    x.to(dt), m.axes(names), dim).float())
                key = f"reduce_scatter {str(dt)[6:]} {'+'.join(names)} {dim}"
                ops[key] = (_np(fn(nccl)), _np(fn(gloo)))
        train = _train_nccl(nccl, **train_case)
        kind, rule, attack, shape, steps = stream_case
        stream = _stream(make_mesh(shape, ("data", "model"), forms="nccl"),
                         kind, rule, attack, steps)
    finally:
        C._all_gather_single, C._reduce_scatter_single = real
    out = {"ops": ops, "calls": calls}
    if rank == 0:
        out["train"], out["stream"] = train, stream
    return out


def _train_nccl(mesh, spec_json, init, batches, **_) -> dict:
    """The ``SEQ_SHARD`` run of :func:`_train` on ``mesh``."""
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.experiment import ScenarioSpec, resolve
    from repro_torch.experiment.topologies import SyncPS
    from repro_torch.models import stack
    from repro_torch.optim.optimizers import init_opt_state
    plan = resolve(ScenarioSpec.from_json(spec_json), device="cpu")
    plan.mesh = mesh
    feed = [{k: torch.tensor(v) for k, v in b.items()} for b in batches]
    plan.batch_fn = lambda s: feed[s]
    params = lm_params_from_numpy(init)
    stack.SEQ_SHARD = True
    try:
        res = SyncPS().run(plan, init_state=(
            params, init_opt_state(plan.opt_cfg, params)))
    finally:
        stack.SEQ_SHARD = False
    return {"losses": [r["loss"] for r in res.history],
            "params": _flat(res.params)}


def _stream_spec(spec_json, init, batches) -> dict:
    """The spec's streaming run (the topology, its plan given a (4, 1)
    mesh) from the reference's params on its batches: losses and
    params."""
    from repro_torch.convert import params_from_numpy
    from repro_torch.dist.mesh import make_host_mesh
    from repro_torch.experiment import ScenarioSpec, resolve
    from repro_torch.experiment.topologies import Streaming
    from repro_torch.optim.optimizers import init_opt_state
    plan = resolve(ScenarioSpec.from_json(spec_json), device="cpu")
    plan.mesh = make_host_mesh(4, 1)
    feed = [{"x": torch.tensor(b["x"]), "y": torch.tensor(b["y"]).long()}
            for b in batches]
    plan.batch_fn = lambda s: feed[s]
    params = params_from_numpy(init)
    res = Streaming().run(plan, init_state=(
        params, init_opt_state(plan.opt_cfg, params)))
    return {"losses": [r["loss"] for r in res.history],
            "params": _flat(res.params)}
