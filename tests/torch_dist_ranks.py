"""Rank bodies of the gloo worlds that ``test_torch_distributed.py`` spawns.

They live apart from the test module so that a spawned rank imports
``torch`` and ``repro_torch`` only, never JAX or the reference: the test
process computes the reference's values and hands the ranks numpy inputs.
Each body runs as one rank under ``repro_torch.dist.launch.spawn``, which
has made the gloo world, and returns its results.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

MESHES = {"4x1": ((4, 1), ("data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "2x2x1": ((2, 2, 1), ("pod", "data", "model"))}


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else x


def layouts_rank(rank: int, world: int, cases: list, inputs: dict) -> dict:
    """Every layout case on the three meshes, and the summed drop counts.
    A rank's local tree is its worker's, each leaf cut on its last dim to
    the rank's block of the model axis, as the train step cuts a
    model-sharded leaf."""
    from repro_torch.core.aggregators import psum_counts
    from repro_torch.core.attacks import AttackConfig
    from repro_torch.core.robust import RobustConfig, robust_aggregate_dist
    from repro_torch.core.selection import trim_family
    from repro_torch.dist.collectives import (all_to_all_scatter, axis_size,
                                              worker_slice_index)
    from repro_torch.dist.mesh import make_mesh
    from repro_torch.dist.sharding import model_axes_of, worker_axes_of
    meshes = {k: make_mesh(*v) for k, v in MESHES.items()}
    out = {"cases": {}, "counts": {}}
    for case in cases:
        mesh = meshes[case["mesh"]]
        wa = mesh.axes(worker_axes_of(mesh))
        ma = mesh.axes(model_axes_of(mesh))
        tree = inputs[case["m"]]
        local = {k: torch.tensor(np.split(
            v[worker_slice_index(wa)], axis_size(ma), axis=-1)[
                worker_slice_index(ma)]) for k, v in tree.items()}
        cfg = RobustConfig(rule=case["rule"], b=case["b"], q=case["q"],
                           layout=case["layout"],
                           attack=AttackConfig(**case["attack"]))
        active = (None if case["active"] is None
                  else torch.tensor(case["active"]))
        res = robust_aggregate_dist(
            local, cfg, wa, ma, torch.Generator().manual_seed(3),
            active=active, with_scores=case["with_scores"], step=0)
        agg, scores = res if case["with_scores"] else (res, None)
        out["cases"][case["key"]] = ({k: _np(v) for k, v in agg.items()},
                                     _np(scores))

    # The trim family's drop counts, summed over the sharded layout's axes.
    for name in ("4x1", "2x2x1"):
        mesh = meshes[name]
        wa = mesh.axes(worker_axes_of(mesh))
        ma = mesh.axes(model_axes_of(mesh))
        tree = inputs[4]
        row = np.concatenate([tree[k][worker_slice_index(wa)].reshape(-1)
                              for k in sorted(tree)])
        flat = torch.zeros(20)
        flat[:row.size] = torch.tensor(row)
        mat = all_to_all_scatter(flat, wa)
        for rule in ("trmean", "phocas", "mediam"):
            _, counts, ncoords = trim_family(mat, 1, rule, with_scores=True)
            counts, ncoords = psum_counts(counts, ncoords, wa + ma)
            out["counts"][(name, rule)] = (_np(counts), float(ncoords))

    return out


def replicated_leaf_rank(rank: int, world: int, leaves: dict) -> np.ndarray:
    """Krum's scores on a (3, 2) mesh from the train step's local tree: a
    leaf sharded over the model axis contributes this rank's block, a
    replicated leaf the whole leaf, on both model ranks."""
    from repro_torch.core.robust import RobustConfig, robust_aggregate_dist
    from repro_torch.dist.collectives import worker_slice_index
    from repro_torch.dist.mesh import make_host_mesh
    mesh = make_host_mesh(data=3, model=2)
    wa, ma = mesh.axes(("data",)), mesh.axes(("model",))
    w = worker_slice_index(wa)
    block = np.split(leaves["w"][w], ma[0].size, axis=-1)[ma[0].index]
    local = {"fc": {"w": torch.tensor(block)},
             "norm": {"scale": torch.tensor(leaves["scale"][w])}}
    cfg = RobustConfig(rule="krum", q=0, layout="replicated")
    _, scores = robust_aggregate_dist(local, cfg, wa, ma, with_scores=True)
    return _np(scores)


def _flat_params(params) -> np.ndarray:
    from repro_torch import tree as tree_util
    return np.concatenate([_np(x).reshape(-1)
                           for x in tree_util.leaves(params)])


def _outcome(res) -> dict:
    return {"losses": [r["loss"] for r in res.history],
            "params": _flat_params(res.params),
            "active": (None if res.defense_state is None
                       else _np(res.defense_state["active"]))}


def _reference_start(spec, init: dict, batches: list):
    """``run_experiment`` of ``spec`` on this world, from the reference's
    initial params on the reference's batches (numpy)."""
    from repro_torch.convert import params_from_numpy
    from repro_torch.experiment import resolve
    from repro_torch.experiment.topologies import SyncPS
    from repro_torch.optim.optimizers import init_opt_state
    plan = resolve(spec, device="cpu")
    plan.batch_fn = lambda s: {"x": torch.tensor(batches[s]["x"]),
                               "y": torch.tensor(batches[s]["y"]).long()}
    params = params_from_numpy(init)
    return SyncPS().run(plan, init_state=(
        params, init_opt_state(plan.opt_cfg, params)))


def training_rank(rank: int, world: int, specs: dict, resume_spec,
                  from_reference: dict) -> dict:
    """``run_experiment`` of each spec on this world (the "world already
    made" mode), a resume on a mesh, a mesh the world does not fit, and
    the runs of ``from_reference`` (name -> (spec, init, batches)) started
    from the reference's params and batches."""
    from repro_torch.experiment import run_experiment
    out = {}
    for name, spec in specs.items():
        out[name] = _outcome(run_experiment(spec, device="cpu"))
    whole = run_experiment(resume_spec, device="cpu")
    resumed = run_experiment(resume_spec, device="cpu",
                             resume=resume_spec.checkpoint_path)
    out["resume"] = (_outcome(whole), _outcome(resumed))
    misfit = dataclasses.replace(resume_spec, mesh="4x2",
                                 checkpoint_path="", checkpoint_every=0)
    try:
        run_experiment(misfit, device="cpu")
        out["misfit"] = None
    except ValueError as e:
        out["misfit"] = str(e)
    out["from_reference"] = {
        name: _outcome(_reference_start(*args))
        for name, args in from_reference.items()}
    return out


def mesh4_rank(rank: int, world: int, layouts: tuple,
               training: tuple) -> dict:
    """The 4-rank world's two bodies in turn: :func:`layouts_rank`'s
    arguments ``layouts``, then :func:`training_rank`'s ``training``."""
    return {"layouts": layouts_rank(rank, world, *layouts),
            "training": training_rank(rank, world, *training)}


def kernel_slices_rank(rank: int, world: int) -> dict:
    """K1 and K3 on the card, each rank on its share of the columns of one
    (20, d) matrix; the shares all_gathered and K3's counts summed, beside
    the whole matrix's launches."""
    from repro_torch.core.aggregators import psum_counts
    from repro_torch.dist.collectives import all_gather_axes
    from repro_torch.dist.mesh import make_host_mesh
    from repro_torch.kernels.phocas.kernel import (phocas_counts_hopper,
                                                   phocas_hopper)
    wa = make_host_mesh(data=world).axes(("data",))
    gen = torch.Generator(device="cuda").manual_seed(0)
    u = 3.0 + torch.randn((20, world * 4099), generator=gen, device="cuda")
    u[3] = 1e20                                  # a row the trim drops
    mine = u.chunk(world, dim=1)[rank].contiguous()
    agg = all_gather_axes(phocas_hopper(mine, 8), wa)
    agg_c, counts = phocas_counts_hopper(mine, 8)
    agg_c = all_gather_axes(agg_c, wa)
    counts, ncoords = psum_counts(
        counts, torch.tensor(float(mine.shape[1]), device="cuda"), wa)
    whole = phocas_hopper(u, 8)
    whole_c, whole_counts = phocas_counts_hopper(u, 8)
    out = {"k1": torch.equal(agg.view(torch.int32), whole.view(torch.int32)),
           "k3": torch.equal(agg_c.view(torch.int32),
                             whole_c.view(torch.int32)),
           "counts": _np(counts), "whole_counts": _np(whole_counts),
           "ncoords": float(ncoords), "d": u.shape[1]}
    return out
