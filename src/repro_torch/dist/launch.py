"""Run a mesh scenario as one ``torch.distributed`` rank per mesh device.

:func:`spawn` starts a gloo world of spawned processes
(``torch.multiprocessing``, start method ``spawn``), which meet over a
``file://`` rendezvous in a temporary directory; each runs a function as
its rank, and what each returns comes back to the caller.  A rank that
raises fails the call (``torch.multiprocessing`` ends the others and
re-raises its error here).  ``run_experiment`` of a spec with a ``mesh``
calls :func:`run_spawned` when no world exists: D x M ranks each run
``run_experiment`` as their rank, and rank 0's result is returned.  Every
rank uses the caller's device: all of them share one card.
"""
from __future__ import annotations

import os
import tempfile

import torch
import torch.distributed as dist


def check_replicated(params) -> None:
    """Raise on every rank unless every rank of the world holds ``params``
    bit for bit: rank 0's bytes are broadcast and compared."""
    from repro_torch import tree as tree_util
    flat = torch.cat([x.detach().reshape(-1).view(torch.uint8)
                      for x in tree_util.leaves(params)])
    mine = flat.clone()
    dist.broadcast(flat, src=0)
    differ = torch.tensor([float(not torch.equal(flat, mine))],
                          device=flat.device)
    dist.all_reduce(differ)
    if differ.item():
        raise RuntimeError(f"params differ between ranks: {int(differ.item())}"
                           " rank(s) hold other bits than rank 0")


def _rank_main(rank: int, world: int, workdir: str, fn, args) -> None:
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(workdir, 'rendezvous')}",
        rank=rank, world_size=world)
    try:
        out = fn(rank, world, *args)
        torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, *args) -> list:
    """Run ``fn(rank, world, *args)`` as each rank of a gloo world of
    ``world`` spawned processes; returns what each rank's call returned,
    in rank order.  ``fn`` must be importable by name (a module-level
    function)."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory(prefix="repro-mesh-") as workdir:
        mp.start_processes(_rank_main, args=(world, workdir, fn, args),
                           nprocs=world, join=True, start_method="spawn")
        return [torch.load(os.path.join(workdir, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]


def _run_rank(rank: int, world: int, spec, device, obs, resume):
    from repro_torch.experiment.runner import run_experiment
    res = run_experiment(spec, device=device, obs=obs, resume=resume)
    return res if rank == 0 else None


def run_spawned(spec, *, device=None, obs=None, resume=None):
    """Run ``spec`` (whose ``mesh`` is ``"DxM"``) in a world of D x M
    spawned ranks; returns rank 0's ``ExperimentResult``."""
    from repro_torch.dist.mesh import parse_mesh
    d, mm = parse_mesh(spec.mesh)
    return spawn(_run_rank, d * mm, spec, device, obs, resume)[0]
