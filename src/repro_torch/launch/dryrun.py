"""Multi-pod dry run: trace one rank of every (arch × input shape) on the
production mesh, on fake tensors, and read its per-device costs.

Port of ``repro/launch/dryrun.py``.  The reference lowers and compiles the
SPMD program for 512 fake XLA devices.  Here this process is rank 0 of a
fake ``torch.distributed`` world of the mesh's size (256 or 512 ranks,
``launch/fake.py``), and the rank's own program, the one it would run on
the card, runs once on ``FakeTensorMode`` tensors on device ``cuda``: its
blocks of the params (``dist/sharding.py::shard_params``), the mesh train
step of ``train/step.py`` with the hand-written kernels' route (K1 counted
by its own reckoning, not a sort), the forward for a prefill, and
``serve/engine.py::MeshServing``'s decode step against its cache.  Nothing
is computed, nothing is compiled, and no card is needed.
``launch/trace_analysis.py::trace_cost`` counts the call, the
streaming step's passes over the workers folded as the reference's
analysis folds its scan (``obs/loops.py::iterations``).  K6 stays off
(training and the forward take the plain attention) unless
``REPRO_FLASH_ATTN=1``, which sends the prefill's self-attention to it, as
the reference's flag does.

Each record keeps the reference's keys where they mean the same
(``argument_size_in_bytes`` etc. are the rank's bytes of distinct storages;
``temp_size_in_bytes`` is the peak of live bytes less the arguments);
``trace_s`` stands for ``lower_s``/``compile_s``, ``flops`` and
``bytes_accessed`` (the aten count plus the kernels' reckoning) for the
``xla_*_raw`` keys, and there are no ``loops`` (trace_analysis's
docstring).

``--mode streaming`` traces the reference's memory-bounded mode: the
params (and SGD state) are the rank's FSDP shards
(``dist/sharding.py::FsdpLayout``, ``param_pspec_fsdp``'s bytes); a
training pair runs ``train/streaming.py``'s mesh step, every worker in
turn with its batch rows cut over ``data``, each period's shards gathered
where they are used; a prefill or decode pair runs the forward or the
decode step on the same shards.

The rank's collectives take the NCCL forms by default (``--forms nccl``,
``dist/collectives.py``), as a production H100 mesh runs one rank a card:
one call a collective, a reduce-scatter counted under "reduce-scatter"
with its output bytes, no staged pieces.  ``--forms gloo`` traces the
forms of several ranks on one card (an all_reduce and a cut for a
reduce-scatter, CUDA gathers in pieces of at most ``STAGE_BYTES``), which
is what ``chip_smoke.py`` holds against runs on one card.

Usage (CPU or GPU host; no card is used):
  python -m repro_torch.launch.dryrun --arch gemma2-2b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--layout sharded]

Importing this module imports nothing of torch: on a CPU-only torch build
the fake CUDA device must be registered before torch is first imported
(``fake.prepare_host``, which ``main`` calls first).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
import traceback

from repro_torch.launch import fake

# long_500k skips: pure full-attention archs (DESIGN.md §4)
LONG_SKIP = {"granite-8b", "kimi-k2-1t-a32b", "internvl2-26b",
             "whisper-large-v3", "deepseek-v2-lite-16b"}

_WORLD_MESHES = {}


def pairs():
    from repro_torch.configs import INPUT_SHAPES, list_archs
    for arch in list_archs():
        for shape in INPUT_SHAPES:
            if shape == "long_500k" and arch in LONG_SKIP:
                continue
            yield arch, shape


def _walk(tree, path=()):
    """(the "/"-joined names, leaf) of a tree of dicts and sequences."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, path + (str(i),))
    else:
        yield "/".join(path), tree


def _active_params(cfg, params) -> tuple:
    """(total, active) param counts; active discounts un-routed experts."""
    total = active = 0
    for name, leaf in _walk(params):
        n = math.prod(leaf.shape)
        total += n
        if cfg.is_moe and "moe_w" in name and "shared" not in name:
            active += n * cfg.num_experts_per_tok / cfg.num_experts
        else:
            active += n
    return total, int(active)


def _spec_bytes(shape, dtype, spec, mesh) -> int:
    from repro_torch.dist.sharding import block_shape
    return math.prod(block_shape(shape, spec, mesh)) * dtype.itemsize


def _worker_size(mesh) -> int:
    from repro_torch.dist.sharding import worker_axes_of
    return math.prod(mesh.shape[a] for a in worker_axes_of(mesh))


def param_bytes(params, mesh) -> int:
    """A rank's bytes of ``params`` (whole leaves, or anything with their
    ``shape`` and ``dtype``) cut by ``tree_pspecs``."""
    from repro_torch.dist.sharding import spec_leaves, tree_pspecs
    from repro_torch.tree import leaves
    return sum(_spec_bytes(x.shape, x.dtype, sp, mesh) for x, sp in
               zip(leaves(params), spec_leaves(tree_pspecs(params, mesh))))


def reckon(arch, shape, mesh) -> dict:
    """A rank's bytes of the params, the SGD state, the batch and (decode)
    the cache of pair (``arch``, ``shape``) on ``mesh``, by the sharding
    rules alone (no trace): ``tree_pspecs``, ``cache_pspec``, and the batch
    cut over the worker axes where it divides (training: the (m, B/m, ...)
    worker groups, one a worker)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs import get_arch, get_shape
    from repro_torch.dist.sharding import _map_with_path, cache_pspec
    from repro_torch.models.registry import build_model
    from repro_torch.optim import OptConfig, init_opt_state
    cfg = get_arch(arch) if isinstance(arch, str) else arch
    shape = get_shape(shape) if isinstance(shape, str) else shape
    model = build_model(cfg)
    m = _worker_size(mesh)
    full = model.abstract_params()
    state = init_opt_state(OptConfig(name="sgd", lr=0.01), full)
    # the step count is an int here (an int32 scalar in the reference)
    out = {"params": param_bytes(full, mesh),
           "opt_state": param_bytes({k: v for k, v in state.items()
                                     if k != "step"}, mesh),
           "batch": 0, "cache": 0}
    for s in model.input_specs(shape).values():
        B = s.shape[0]
        rows = B // m if (shape.kind == "train" or B % m == 0) else B
        out["batch"] += rows * math.prod(s.shape[1:]) * s.dtype.itemsize
    if shape.is_decode:
        with FakeTensorMode():
            cache = model.init_cache(shape.global_batch, shape.seq_len)
        sizes = []
        _map_with_path(lambda path, x: sizes.append(_spec_bytes(
            x.shape, x.dtype, cache_pspec(path, x, mesh), mesh)), cache)
        out["cache"] = sum(sizes)
    return out


def fake_tensors():
    """The dry run's ``FakeTensorMode``: a fresh one for each pair."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    return FakeTensorMode()


def _world_mesh(mesh, forms: str):
    """A ``HostMesh`` of ``mesh`` over the fake world whose axes take
    ``forms`` (made once a process and forms: each makes a process group
    per axis line)."""
    from repro_torch.dist.mesh import make_mesh
    key = (tuple(mesh.axis_names), tuple(mesh.axis_sizes), forms)
    if key not in _WORLD_MESHES:
        _WORLD_MESHES[key] = make_mesh(mesh.axis_sizes, mesh.axis_names,
                                       forms=forms)
    return _WORLD_MESHES[key]


def _fake_params(model):
    """The whole parameter tree on fake ``cuda``: drawn from a CPU
    generator (a CUDA one needs a card), then moved."""
    import torch

    from repro_torch import tree as tree_util
    full = model.init(torch.Generator())
    return tree_util.map(lambda x: x.to("cuda"), full)


def _flash_prefill():
    """What ``REPRO_FLASH_ATTN=1`` makes of the prefill: self-attention
    through K6 (``models/common.py::flash_forward``)."""
    if os.environ.get("REPRO_FLASH_ATTN", "0") != "1":
        return contextlib.nullcontext()
    from repro_torch.models.common import flash_forward
    return flash_forward()


def build_traced(arch, shape, mesh, *, layout: str = "sharded",
                 rule: str = "phocas", b: int = 2, remat: str = "full",
                 mode: str = "vmap", attack=None, forms: str = "nccl"):
    """Returns ``(fn, args, meta)``: rank 0's program of pair (``arch``,
    ``shape``) on ``mesh`` and its arguments, ready for
    ``trace_cost(fn, *args)``, and the pair's parameter counts.

    ``arch`` is a name or an ``ArchConfig``, ``shape`` a name or an
    ``InputShape``, ``mesh`` any ``dist/sharding.py::Mesh``.  Call it
    under :func:`fake_tensors`, in the fake world of ``mesh.size`` ranks
    (``fake.init_fake_world``); it refuses a real world.  ``attack`` (an
    ``AttackConfig``, none by default as in the reference) corrupts the
    training step's worker matrix.  ``mode="streaming"``: the FSDP
    streaming program of the module docstring.  ``forms``: the
    collective forms the rank's mesh axes take (the module docstring)."""
    import torch

    from repro_torch.configs import get_arch, get_shape
    from repro_torch.core.robust import RobustConfig
    from repro_torch.dist.mesh import use_mesh
    from repro_torch.dist.sharding import shard_params
    from repro_torch.models.registry import build_model
    from repro_torch.optim import OptConfig, init_opt_state
    from repro_torch.serve.engine import MeshServing
    from repro_torch.train.step import make_train_step
    if mode not in ("vmap", "streaming"):
        raise ValueError(f"mode {mode!r}; valid: vmap, streaming")
    if not fake.in_fake_world():
        raise RuntimeError("build_traced traces rank 0 of a fake world "
                           "(launch/fake.py::init_fake_world); it refuses a "
                           "real torch.distributed world or none")
    import torch.distributed as dist
    if dist.get_world_size() != mesh.size:
        raise RuntimeError(f"mesh {dict(mesh.shape)} needs a fake world of "
                           f"{mesh.size} ranks, this one has "
                           f"{dist.get_world_size()}")
    draws = mode == "vmap" or (attack is not None and attack.name.lower()
                               in ("gaussian", "bitflip", "gambler"))
    if attack is not None and draws and not fake.cuda_build():
        raise RuntimeError("an attack draws from a CUDA generator "
                           "(core/robust.py::slice_generator, or the "
                           "streaming step's), which a CPU-only torch has "
                           "not: trace it where torch is built for CUDA")
    cfg = get_arch(arch) if isinstance(arch, str) else arch
    shape = get_shape(shape) if isinstance(shape, str) else shape
    model = build_model(cfg, remat=remat)
    world = _world_mesh(mesh, forms)
    m = _worker_size(mesh)
    full = _fake_params(model)
    total, active = _active_params(cfg, full)
    fsdp = None
    if mode == "streaming":
        from repro_torch.dist.sharding import FsdpLayout
        fsdp = FsdpLayout(full, world, model.tensor_parallel)
        params = fsdp.shard(full)
    else:
        params = shard_params(full, world)
    del full
    meta = {"total_params": total, "active_params": active}
    B = shape.global_batch

    if shape.kind == "train":
        robust = RobustConfig(rule=rule, b=b, q=b, layout=layout,
                              **({} if attack is None else
                                 {"attack": attack}))
        opt_cfg = OptConfig(name="sgd", lr=0.01)
        if B % m:
            raise ValueError(f"{cfg.name}/{shape.name}: batch {B} % m={m}")
        batch = {}
        if fsdp is not None:
            from repro_torch.train.streaming import (data_rows,
                                                     make_streaming_train_step)
            step = make_streaming_train_step(
                model, robust_cfg=robust, opt_cfg=opt_cfg, num_workers=m,
                mesh=world)
            for k, s in model.input_specs(shape).items():
                # every worker's rows, cut over data: the reference's
                # P(None, "data") on the (m, B/m, ...) stack
                whole = torch.zeros((m, B // m) + s.shape[1:],
                                    dtype=s.dtype, device="cuda")
                batch[k] = data_rows({k: whole}, world)[k].clone()
                del whole
            args = (params, init_opt_state(opt_cfg, params), batch, 0)
            return step, args, meta
        step = make_train_step(model, robust_cfg=robust, opt_cfg=opt_cfg,
                               num_workers=m, mesh=world)
        for k, s in model.input_specs(shape).items():
            # this rank's worker group, the (m, B/m, ...) stack the step
            # indexes: the reference's P(worker axes) on the stack
            group = torch.zeros((1, B // m) + s.shape[1:], dtype=s.dtype,
                                device="cuda")
            batch[k] = group.expand((m,) + group.shape[1:])
        args = (params, init_opt_state(opt_cfg, params), batch,
                torch.Generator())
        return step, args, meta

    if shape.kind == "prefill":
        sharded = m > 1 and B % m == 0
        rows = B // m if sharded else B
        batch = {k: torch.zeros((rows,) + s.shape[1:], dtype=s.dtype,
                                device="cuda")
                 for k, s in model.input_specs(shape).items()}

        def prefill(params, batch):
            with torch.no_grad(), _flash_prefill(), \
                    use_mesh(world, batch_sharded=sharded, fsdp=fsdp):
                logits, _ = model.forward(params, batch)
            return logits

        return prefill, (params, batch), meta

    ms = MeshServing(model, world, B)
    rows = ms.rows.stop - ms.rows.start
    cache = ms.cache(B, shape.seq_len, "cuda")
    tokens = torch.zeros((rows, 1), dtype=torch.int32, device="cuda")
    step = ms.step(fsdp=fsdp)

    def decode(params, cache, tokens, pos):
        with torch.no_grad():
            return step(params, cache, tokens, pos)

    return decode, (params, cache, tokens, shape.seq_len - 1), meta


def run_one(arch: str, shape_name: str, *, multi_pod: bool, layout: str,
            rule: str, b: int, remat: str, outdir: str,
            skip_existing: bool = False, mode: str = "vmap",
            forms: str = "nccl") -> dict:
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.trace_analysis import trace_cost
    mesh_name = "2x16x16" if multi_pod else "16x16"
    tag = f"{arch}__{shape_name}__{mesh_name}__{layout}__{rule}__{remat}"
    if mode != "vmap":
        tag += f"__{mode}"
    if forms != "nccl":
        tag += f"__{forms}"
    path = os.path.join(outdir, tag + ".json")
    if skip_existing and os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    os.makedirs(outdir, exist_ok=True)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "layout": layout, "rule": rule, "remat": remat, "mode": mode,
           "forms": forms, "ok": False}
    t0 = time.time()
    try:
        mesh = make_production_mesh(multi_pod=multi_pod)
        with fake_tensors():
            fn, args, meta = build_traced(arch, shape_name, mesh,
                                          layout=layout, rule=rule, b=b,
                                          remat=remat, mode=mode,
                                          forms=forms)
            rec.update(meta)
            t1 = time.time()
            cost = trace_cost(fn, *args, fold_loops=True)
            del fn, args
        rec["trace_s"] = time.time() - t1
        rec["flops"] = cost["flops"]
        rec["bytes_accessed"] = cost["bytes_accessed"]
        rec["argument_size_in_bytes"] = cost["argument_bytes"]
        rec["output_size_in_bytes"] = cost["output_bytes"]
        rec["temp_size_in_bytes"] = cost["peak_bytes"] - cost["argument_bytes"]
        rec["peak_bytes"] = cost["peak_bytes"]
        rec["dot_flops"] = cost["dot_flops"]
        rec["write_bytes"] = cost["write_bytes"]
        rec["collectives"] = {"bytes": cost["collective_bytes"],
                              "counts": cost["collective_counts"],
                              "total_bytes": cost["collective_total_bytes"]}
        rec["kernels"] = [{"name": n, "shape": list(s)}
                          for n, s in cost["kernels"]]
        rec["num_devices"] = mesh.size
        rec["ok"] = True
    except Exception as e:                             # noqa: BLE001
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    rec["total_s"] = time.time() - t0
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    status = "OK" if rec["ok"] else f"FAIL ({rec.get('error', '')[:120]})"
    print(f"[dryrun] {tag}: {status}  ({rec['total_s']:.1f}s)", flush=True)
    return rec


def main(argv=None):
    fake.prepare_host()               # before anything imports torch
    from repro_torch.core import registry
    from repro_torch.launch.mesh import make_production_mesh
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--layout", default="sharded",
                    choices=["replicated", "sharded"])
    ap.add_argument("--rule", default="phocas",
                    choices=registry.available_rules())
    ap.add_argument("--b", type=int, default=2)
    ap.add_argument("--remat", default="full",
                    choices=["none", "full", "dots"])
    ap.add_argument("--mode", default="vmap", choices=["vmap", "streaming"])
    ap.add_argument("--forms", default="nccl", choices=["nccl", "gloo"],
                    help="the collective forms traced (dist/collectives.py)")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    fake.init_fake_world(make_production_mesh(multi_pod=args.multi_pod).size)
    todo = list(pairs()) if args.all else [(args.arch, args.shape)]
    n_ok = 0
    for arch, shape in todo:
        rec = run_one(arch, shape, multi_pod=args.multi_pod,
                      layout=args.layout, rule=args.rule, b=args.b,
                      remat=args.remat, outdir=args.out,
                      skip_existing=args.skip_existing, mode=args.mode,
                      forms=args.forms)
        n_ok += bool(rec.get("ok"))
    print(f"[dryrun] {n_ok}/{len(todo)} OK")
    if n_ok != len(todo):
        raise SystemExit(1)


if __name__ == "__main__":
    main()
