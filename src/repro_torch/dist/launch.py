"""Run a mesh scenario as one ``torch.distributed`` rank per mesh device.

:func:`spawn` starts a world of spawned processes (``torch.multiprocessing``,
start method ``spawn``), which meet over a ``file://`` rendezvous in a
temporary directory; each runs a function as its rank, and what each
returns comes back to the caller.  A rank that raises fails the call
(``torch.multiprocessing`` ends the others and re-raises its error here).

The world's backend and each rank's device follow from where the ranks run
(:func:`plan_world`): **NCCL, one rank a card** (rank r on ``cuda:r``)
where the caller's device is CUDA and the host has a card for every rank;
**gloo** everywhere else, every rank on the caller's device: CPU ranks, or
more ranks than cards (all of them on one card, which NCCL refuses).  The
spawner prints which, once.  A failure to make the NCCL world raises: the
run never falls back to gloo.  A rank reads its device with
:func:`rank_device`.

``run_experiment`` of a spec with a ``mesh`` calls :func:`run_spawned` when
no world exists: D x M ranks each run ``run_experiment`` as their rank on
their device, and rank 0's result is returned.  Under ``torchrun`` (a world
that is already made) the world's own backend is used as it is, and on an
NCCL world a CUDA rank computes on ``cuda:$LOCAL_RANK``.  Each rank gets
the caller's ``ObsConfig``: rank 0 alone writes the telemetry and the
metrics snapshot, and with a ``profile_dir`` every rank runs inside its own
profiler window (``<profile_dir>/rank<r>``).
"""
from __future__ import annotations

import os
import sys
import tempfile

import torch
import torch.distributed as dist

# The device :func:`spawn` gave this process's rank (None outside a spawned
# rank, and in one that was spawned with no device).
_RANK_DEVICE = None


def plan_world(device, cards: int, world: int) -> tuple:
    """``(backend, devices)`` of a spawned world of ``world`` ranks whose
    caller computes on ``device`` (None, a string or a ``torch.device``)
    on a host with ``cards`` CUDA cards: ``("nccl", ("cuda:0", ...,
    "cuda:<world-1>"))`` where ``device`` is a CUDA device and ``cards >=
    world``; else ``("gloo", (device,) * world)``, every rank on the
    caller's device."""
    if device is not None and torch.device(device).type == "cuda" \
            and cards >= world:
        return "nccl", tuple(f"cuda:{r}" for r in range(world))
    return "gloo", (device,) * world


def join_torchrun(device) -> bool:
    """Under ``torchrun`` (its ``RANK``, ``LOCAL_RANK``,
    ``LOCAL_WORLD_SIZE`` and rendezvous variables set) with no world made
    yet, make this process its rank of the world: NCCL on
    ``cuda:$LOCAL_RANK`` where ``device`` is CUDA and this host has a card
    for each of its ranks, else gloo (:func:`plan_world` on the host's
    ranks).  Returns whether it made the world; the launch CLIs call it
    before they would spawn."""
    if dist.is_initialized() or "LOCAL_RANK" not in os.environ \
            or "TORCHELASTIC_RUN_ID" not in os.environ:
        return False
    local, local_world = (int(os.environ["LOCAL_RANK"]),
                          int(os.environ["LOCAL_WORLD_SIZE"]))
    cards = torch.cuda.device_count() if device is not None else 0
    backend, devices = plan_world(device, cards, local_world)
    if backend == "nccl":
        torch.cuda.set_device(local)
        dist.init_process_group("nccl", device_id=torch.device(
            devices[local]))
    else:
        dist.init_process_group("gloo")
    if dist.get_rank() == 0:
        print(f"mesh: {dist.get_world_size()} ranks under torchrun, "
              f"{backend}", flush=True)
    return True


def rank_device(device=None):
    """The device this rank computes on: the card :func:`spawn` gave it;
    under ``torchrun`` on an NCCL world, ``cuda:$LOCAL_RANK`` for a CUDA
    ``device``; else ``device`` as it is."""
    if _RANK_DEVICE is not None:
        return _RANK_DEVICE
    if (device is not None and torch.device(device).type == "cuda"
            and dist.is_initialized() and dist.get_backend() == "nccl"
            and "LOCAL_RANK" in os.environ):
        return f"cuda:{int(os.environ['LOCAL_RANK'])}"
    return device


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


def _equal_along(leaves, axes) -> bool:
    """Whether every rank of this rank's lines along ``axes`` holds the
    bits of ``leaves`` (each line's coordinate-0 rank broadcasts them, one
    leaf at a time)."""
    ok = True
    for ax in axes:
        if ax.size == 1:
            continue
        src = dist.get_process_group_ranks(ax.group)[0]
        for x in leaves:
            mine = x.detach().reshape(-1).view(torch.uint8)
            theirs = mine.clone()
            dist.broadcast(theirs, src=src, group=ax.group)
            ok = ok and torch.equal(theirs, mine)
    return ok


def check_blocks(params, mesh, cuts: list) -> None:
    """The two checks of a tensor-parallel mesh run's params (this rank's
    blocks): ranks at the same model coordinate hold the same bits, and
    the leaves left whole (``cuts`` None) are the same bits on every model
    rank, so a model group's joined blocks form one tree.  Raises on every
    rank if either fails."""
    from repro_torch import tree as tree_util
    from repro_torch.dist.sharding import model_axes_of, worker_axes_of
    leaves = tree_util.leaves(params)
    whole = [x for x, c in zip(leaves, cuts) if c is None]
    bad = torch.tensor([
        float(not _equal_along(leaves, mesh.axes(worker_axes_of(mesh)))),
        float(not _equal_along(whole, mesh.axes(model_axes_of(mesh))))],
        device=leaves[0].device)
    dist.all_reduce(bad)
    if bad.any():
        raise RuntimeError(
            f"params differ between ranks: {int(bad[0])} rank(s) hold "
            f"other blocks than the ranks at their model coordinate, "
            f"{int(bad[1])} rank(s) other whole leaves than their model "
            "group")


def _rank_main(rank: int, world: int, workdir: str, fn, args,
               backend: str, devices: tuple) -> None:
    global _RANK_DEVICE
    _RANK_DEVICE = devices[rank]
    # The ranks share the host's cores: each takes its share of them for
    # its intra-op threads (gloo's CPU ranks slow down many times over
    # when every rank runs one thread a core).
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    init = dict(init_method=f"file://{os.path.join(workdir, 'rendezvous')}",
                rank=rank, world_size=world)
    if backend == "nccl":
        torch.cuda.set_device(rank)
        dist.init_process_group("nccl", device_id=torch.device(devices[rank]),
                                **init)
    else:
        dist.init_process_group("gloo", **init)
    try:
        out = fn(rank, world, *args)
        torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    except BaseException:
        # The spawner re-raises one rank's error: the first to fail may be
        # another, whose peers then fail on the closed connections.
        import traceback
        print(f"rank {rank} of {world} failed:\n{traceback.format_exc()}",
              file=sys.stderr, flush=True)
        raise
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, *args, device=None) -> list:
    """Run ``fn(rank, world, *args)`` as each rank of a world of ``world``
    spawned processes; returns what each rank's call returned, in rank
    order.  ``fn`` must be importable by name (a module-level function).
    ``device`` is where the ranks compute (None: they choose it
    themselves, on a gloo world): the backend and each rank's device are
    :func:`plan_world`'s, and a rank reads its device with
    :func:`rank_device`."""
    import torch.multiprocessing as mp
    cards = torch.cuda.device_count() if device is not None else 0
    backend, devices = plan_world(device, cards, world)
    ranks = f"{world} rank{'s' if world != 1 else ''}"
    if backend == "nccl":
        print(f"mesh: {ranks}, nccl, one a card", flush=True)
    else:
        where = f", on {torch.device(devices[0])}" if device is not None \
            else ""
        print(f"mesh: {ranks}, gloo{where}", flush=True)
    with tempfile.TemporaryDirectory(prefix="repro-mesh-") as workdir:
        mp.start_processes(
            _rank_main, args=(world, workdir, fn, args, backend, devices),
            nprocs=world, join=True, start_method="spawn")
        return [torch.load(os.path.join(workdir, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]


def _run_rank(rank: int, world: int, spec, verbose, obs, resume):
    from repro_torch.experiment.runner import run_experiment
    from repro_torch.obs.profile import profile_trace
    with profile_trace(obs.profile_dir if obs is not None else None):
        res = run_experiment(spec, device=rank_device(), verbose=verbose,
                             obs=obs, resume=resume)
    return res if rank == 0 else None


def run_spawned(spec, *, device=None, verbose=False, obs=None, resume=None):
    """Run ``spec`` (whose ``mesh`` is ``"DxM"``) in a world of D x M
    spawned ranks computing on ``device`` (None: ``cuda``), each on its
    own card where :func:`plan_world` gives NCCL; returns rank 0's
    ``ExperimentResult``."""
    from repro_torch.dist.mesh import parse_mesh
    d, mm = parse_mesh(spec.mesh)
    return spawn(_run_rank, d * mm, spec, verbose, obs, resume,
                 device="cuda" if device is None else device)[0]
