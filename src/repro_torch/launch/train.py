"""Training launcher (port of ``repro/launch/train.py``): a thin
``ScenarioSpec`` builder over ``repro_torch.experiment.run_experiment`` —
flags in, spec out, one entry point for every topology (no
topology-specific branching lives here).  The flags and the spec they build
are the reference's, so one scenario file serves both packages; the run is
on ``cuda`` unless ``--device cpu`` is given.

  python -m repro_torch.launch.train --arch gemma2-2b-reduced --steps 100 \\
      --rule phocas --b 2 --attack gaussian --q 2 [--mesh 4x2] \\
      [--topology sync_ps|async_ps|streaming]

Scenarios are first-class files:

  # run a checked-in scenario
  python -m repro_torch.launch.train \\
      --scenario examples/scenarios/sync_ps_gaussian.json
  # write the spec the flags describe, without running it
  python -m repro_torch.launch.train --arch ... --dump-scenario my_run.json

``--metrics PATH`` writes a Prometheus-style snapshot of the run's metrics
(read it with ``repro_torch.obs.parse_exposition``), ``--telemetry PATH``
the JSONL record stream (summarize it with ``python -m
repro_torch.obs.report PATH``), and ``--profile-dir DIR`` a
``torch.profiler`` Chrome trace of the run (``DIR/trace.json``; on a mesh
``DIR/rank<r>/trace.json``).

``--mesh DxM`` runs sync_ps on D x M ``torch.distributed`` ranks (spawned
from one process, or under ``torchrun`` one a process): each data rank is
a worker, and an arch model computes tensor-parallel over the model axis,
each rank holding its blocks of the params and optimizer state (every
family; the paper's MLP and CNN compute whole on every model rank and
split only the aggregation).  ``REPRO_SEQ_SHARD=1`` shards the residual
stream's sequence over the model axis between layers (Megatron-SP; the
same values).
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

from repro_torch.compress import CompressionSpec, available_codecs
from repro_torch.core import registry
from repro_torch.core.attacks import AttackConfig
from repro_torch.core.robust import RobustConfig
from repro_torch.experiment import (DataSpec, ModelSpec, ScenarioSpec,
                                    SpecError, available_topologies,
                                    run_experiment)
from repro_torch.faults import FaultSpec, available_fault_kinds
from repro_torch.optim import OptConfig


def _parse_workers(text: str):
    """``0-2+7`` -> (0, 1, 2, 7): ``+``-separated ints or ``a-b`` ranges."""
    out = []
    for tok in text.split("+"):
        if "-" in tok:
            lo, hi = tok.split("-", 1)
            out.extend(range(int(lo), int(hi) + 1))
        else:
            out.append(int(tok))
    return tuple(out)


def _parse_fault(text: str) -> FaultSpec:
    """One ``--fault`` value -> FaultSpec.

    Comma-separated ``key=value`` pairs; the first bare token is the kind.
    Workers take ``+``-separated indices or ``a-b`` ranges.  ``inner=KIND``
    builds a pod wrapping KIND (the scalar params apply to the inner kind):

      --fault crash,workers=7+8,step=40
      --fault straggler,workers=5,delay_steps=2,jitter=1
      --fault pod,workers=0-3,inner=crash,step=60
    """
    kind, inner_kind, kw = "", "", {}
    for i, tok in enumerate(text.split(",")):
        tok = tok.strip()
        if i == 0 and "=" not in tok:
            kind = tok
        elif "=" in tok:
            k, v = tok.split("=", 1)
            if k == "workers":
                kw[k] = _parse_workers(v)
            elif k == "kind":
                kind = v
            elif k == "inner":
                inner_kind = v
            elif k == "p_drop":
                kw[k] = float(v)
            else:
                kw[k] = int(v)
        else:
            raise SpecError(f"--fault token {tok!r} is not key=value "
                            f"(in {text!r})")
    if not kind:
        raise SpecError(f"--fault {text!r} names no kind")
    if kind == "pod" or inner_kind:
        if not inner_kind:
            raise SpecError("--fault pod needs inner=KIND")
        workers = kw.pop("workers", ())
        return FaultSpec(kind="pod", workers=workers,
                         inner=FaultSpec(kind=inner_kind, **kw))
    return FaultSpec(kind=kind, **kw)


def _parse_compress(text: str) -> CompressionSpec:
    """One ``--compress`` value -> CompressionSpec.

    Comma-separated ``key=value`` pairs; the first bare token is the
    codec:

      --compress topk,ratio=0.01
      --compress signbit
    """
    codec, kw = "", {}
    for i, tok in enumerate(text.split(",")):
        tok = tok.strip()
        if i == 0 and "=" not in tok:
            codec = tok
        elif "=" in tok:
            k, v = tok.split("=", 1)
            if k == "codec":
                codec = v
            elif k == "ratio":
                kw[k] = float(v)
            else:
                raise SpecError(f"--compress key {k!r} unknown "
                                f"(valid: codec, ratio)")
        else:
            raise SpecError(f"--compress token {tok!r} is not key=value "
                            f"(in {text!r})")
    if not codec:
        raise SpecError(f"--compress {text!r} names no codec "
                        f"(valid: {', '.join(available_codecs())})")
    return CompressionSpec(codec=codec, **kw)


def _parse_topology_params(items) -> dict:
    out = {}
    for item in items or ():
        if "=" not in item:
            raise SpecError(f"--topology-param needs key=value, got {item!r}")
        k, v = item.split("=", 1)
        try:
            out[k] = int(v)
        except ValueError:
            try:
                out[k] = float(v)
            except ValueError:
                out[k] = v
    return out


def build_spec(args) -> ScenarioSpec:
    """Map CLI flags onto a ScenarioSpec (the only thing this CLI builds)."""
    workers = args.workers
    if args.mesh:
        from repro_torch.dist.mesh import parse_mesh
        d, _ = parse_mesh(args.mesh)
        if workers != d:
            print(f"[train] overriding --workers to mesh data size {d}")
            workers = d
    if args.global_batch % workers:
        raise SpecError(f"--global-batch {args.global_batch} not divisible "
                        f"by workers={workers}")
    defense = None
    if args.defense:
        from repro_torch.defense import DefenseConfig
        defense = DefenseConfig(reputation_decay=args.reputation_decay,
                                adapt_b=args.adapt_b,
                                telemetry_path=args.telemetry or None)
    return ScenarioSpec(
        name=f"{args.arch}-{args.rule}-{args.attack}",
        topology=args.topology,
        topology_params=_parse_topology_params(args.topology_param),
        model=ModelSpec(kind="arch", arch=args.arch, remat=args.remat),
        data=DataSpec(kind="tokens", seq_len=args.seq_len,
                      batch_per_worker=args.global_batch // workers),
        robust=RobustConfig(
            rule=args.rule, b=args.b, q=args.q or args.b,
            layout=args.layout, multikrum_k=args.multikrum_k,
            geomedian_iters=args.geomedian_iters, backend=args.backend),
        attack=AttackConfig(name=args.attack, num_byzantine=args.q),
        defense=defense,
        opt=OptConfig(name=args.optimizer, lr=args.lr),
        num_workers=workers,
        steps=args.steps,
        seed=args.seed,
        mesh=args.mesh,
        checkpoint_path=args.checkpoint,
        checkpoint_every=args.checkpoint_every if args.checkpoint else 0,
        telemetry_path=args.telemetry,
        faults=tuple(_parse_fault(f) for f in args.fault or ()),
        compression=(_parse_compress(args.compress) if args.compress
                     else CompressionSpec()),
    )


def make_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--scenario", default="",
                    help="run a ScenarioSpec JSON file (all other spec "
                         "flags are ignored)")
    ap.add_argument("--dump-scenario", default="",
                    help="write the spec the flags describe to this path "
                         "and exit without running")
    ap.add_argument("--arch", default="")
    ap.add_argument("--topology", default="sync_ps",
                    choices=available_topologies())
    ap.add_argument("--topology-param", action="append", metavar="K=V",
                    help="topology plugin parameter (repeatable), e.g. "
                         "staleness=4 for async_ps")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--global-batch", type=int, default=40)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--workers", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rule", default="phocas",
                    choices=registry.available_rules())
    ap.add_argument("--b", type=int, default=2)
    ap.add_argument("--layout", default="sharded")
    ap.add_argument("--attack", default="none",
                    choices=("none",) + registry.available_attacks())
    ap.add_argument("--q", type=int, default=0)
    ap.add_argument("--multikrum-k", type=int, default=None,
                    help="Multi-Krum selection size (default m-q-2)")
    ap.add_argument("--geomedian-iters", type=int, default=8)
    ap.add_argument("--optimizer", default="sgd")
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--remat", default="none")
    ap.add_argument("--mesh", default="",
                    help="data×model, e.g. 4x2: D x M torch.distributed "
                         "ranks, an arch model tensor-parallel over the "
                         "model axis; empty = one process")
    ap.add_argument("--backend", default="auto",
                    choices=("auto", "pallas", "xla"),
                    help="per-rule kernel dispatch: pallas = the Hopper "
                         "kernel, xla = the plain PyTorch path, auto = the "
                         "kernel on a CUDA device (rules with kernels: "
                         f"{', '.join(registry.kernel_rules())})")
    ap.add_argument("--use-kernels", action="store_true",
                    help="deprecated alias for --backend pallas")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--checkpoint", default="")
    ap.add_argument("--checkpoint-every", type=int, default=100,
                    help="checkpoint cadence in steps (with --checkpoint)")
    ap.add_argument("--resume", default="", metavar="CKPT",
                    help="restore params/opt/defense/rule from this "
                         "checkpoint (falls back to its rotated .prev "
                         "copy if corrupt) and continue training")
    ap.add_argument("--fault", action="append", metavar="SPEC",
                    help="inject a fault (repeatable): comma-separated "
                         "key=value with the kind first, e.g. "
                         "'crash,workers=7+8,step=40' or "
                         "'pod,workers=0-3,inner=crash,step=60'; kinds: "
                         f"{', '.join(available_fault_kinds())}")
    ap.add_argument("--compress", default="", metavar="SPEC",
                    help="gradient compression on the worker->server wire: "
                         "codec first, then key=value, e.g. "
                         "'topk,ratio=0.01' or 'signbit'; codecs: "
                         f"{', '.join(available_codecs())}")
    ap.add_argument("--defense", action="store_true",
                    help="enable the defense loop: per-worker suspicion "
                         "scores, EMA reputation with ejection/readmission, "
                         "online q-hat estimation")
    ap.add_argument("--adapt-b", action="store_true",
                    help="with --defense: feed the online q-hat back into "
                         "the rule's b/q (the step is re-built on "
                         "adaptation)")
    ap.add_argument("--reputation-decay", type=float, default=0.9,
                    help="EMA decay of the worker reputation state")
    ap.add_argument("--telemetry", default="",
                    help="JSONL path for per-step defense telemetry")
    ap.add_argument("--metrics", default="",
                    help="arm the obs layer: write a Prometheus-style "
                         "exposition snapshot to this path at run end "
                         "(implies span tracing; see repro_torch.obs)")
    ap.add_argument("--profile-dir", default="",
                    help="capture a torch.profiler Chrome trace of the run "
                         "into this directory (trace.json; rank<r>/ on a "
                         "mesh)")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = make_parser()
    args = ap.parse_args(argv)
    if args.use_kernels:
        print("[train] --use-kernels is deprecated; use --backend pallas")
        args.backend = "pallas"

    try:
        if args.scenario:
            spec = ScenarioSpec.load(args.scenario).validate()
        else:
            if not args.arch:
                ap.error("--arch is required (or pass --scenario FILE)")
            spec = build_spec(args).validate()
        if args.dump_scenario:
            spec.save(args.dump_scenario)
            print(f"[train] wrote {args.dump_scenario} "
                  f"({spec.name}: topology={spec.topology})")
            return
    except SpecError as e:
        ap.error(str(e))

    obs = None
    if args.metrics or args.profile_dir:
        from repro_torch.obs import ObsConfig
        obs = ObsConfig(enabled=True, trace=True,
                        metrics_path=args.metrics or None,
                        profile_dir=args.profile_dir or None)

    import torch.distributed as dist

    from repro_torch.obs.profile import profile_trace
    # A mesh run from one process spawns its ranks, and each rank opens its
    # own window (dist/launch.py); here the window would see no device work.
    spawns = bool(spec.mesh) and not dist.is_initialized()
    try:
        with profile_trace(None if spawns else args.profile_dir or None):
            result = run_experiment(spec, device=args.device, verbose=True,
                                    obs=obs, resume=args.resume or None)
    except SpecError as e:
        ap.error(str(e))
    if dist.is_initialized() and dist.get_rank() != 0:
        return
    if args.metrics:
        print(f"[train] wrote metrics snapshot {args.metrics}")
    if args.profile_dir:
        print(f"[train] wrote profiler trace under {args.profile_dir}")
    from repro_torch.tree import size
    print(f"[train] {spec.name}: {size(result.params):,} params, "
          f"topology={spec.topology} "
          f"rule={spec.robust.rule} b={result.robust_cfg.b} "
          f"attack={spec.effective_attack().name} "
          f"mesh={spec.mesh or 'none'} "
          f"defense={'on' if spec.defense else 'off'}")
    if result.history and "q_hat" in result.history[-1]:
        last = result.history[-1]
        print(f"[train] defense: q_hat={last['q_hat']} "
              f"active={last.get('n_active', '?')}/{spec.num_workers}")
    print("[train] done")


if __name__ == "__main__":
    main()
