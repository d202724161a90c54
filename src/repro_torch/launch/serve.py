"""Serving launcher (port of ``repro/launch/serve.py``, DESIGN.md §11).

Two paths behind one CLI:

* dense (default): static-batch greedy ``generate`` with batched prefill;
* engine (``--engine``, or implied by ``--replicas > 1``): the
  continuous-batching paged ``ServeEngine`` — ``--replicas k`` decodes with
  k model replicas aggregated per step by ``--robust-rule``, ``--corrupt n``
  replaces n replicas with garbage parameters to demonstrate the defense,
  and ``--telemetry`` streams the per-replica scores, reputation and
  ejection mask beside the engine's queue-depth records (JSONL).

The run is on ``cuda`` unless ``--device cpu`` is given.  ``--mesh DxM``
serves the dense tier on a (data, model) mesh of D x M ranks: from a
process with no ``torch.distributed`` world it spawns them (gloo, every
rank on the one device), under ``torchrun`` each process is a rank.  The
requests shard over the data axis, the KV heads, the SSM state's heads and
every family's layers (dense, MoE, MLA, SSM, hybrid, whisper's
encoder-decoder, the VLM) over the model axis; each rank builds only its
blocks of the params, the ranks taking turns; rank 0 prints the ``tok/s``
line and the tokens as without a mesh.  The paged engine takes no mesh.

``--metrics PATH`` arms the obs layer (the ``prefill``/``decode`` spans, the
engine's counters and gauges, ``serve_tokens_per_sec``) and writes its
Prometheus-style snapshot to PATH at the end; ``--profile-dir DIR`` writes a
``torch.profiler`` Chrome trace of the generation to ``DIR/trace.json``
(``DIR/rank<r>/trace.json`` on a mesh, where rank 0 alone writes the
snapshot).

  python -m repro_torch.launch.serve --arch granite-8b-reduced --batch 4 \\
      --prompt-len 8 --new-tokens 16
  python -m repro_torch.launch.serve --arch granite-8b-reduced --batch 4 \\
      --mesh 2x2 --device cpu
  python -m repro_torch.launch.serve --arch granite-8b-reduced --engine \\
      --replicas 3 --robust-rule phocas --corrupt 1 --max-batch 8 \\
      --telemetry results/serve.jsonl
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.experiment.runner import resolve_device
from repro_torch.models.registry import build_model
from repro_torch.serve import generate


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _obs_config(args):
    """ObsConfig from the --metrics/--profile-dir flags, or None."""
    if not (args.metrics or args.profile_dir):
        return None
    from repro_torch.obs import ObsConfig
    return ObsConfig(enabled=True, trace=True,
                     metrics_path=args.metrics or None,
                     profile_dir=args.profile_dir or None)


def _run_dense(args, model, params, device, mesh=None):
    from repro_torch.obs import make_recorder, set_default_recorder
    from repro_torch.obs.profile import profile_trace
    gen = torch.Generator(device=device).manual_seed(args.seed)
    prompts = torch.randint(0, model.cfg.vocab_size,
                            (args.batch, args.prompt_len), generator=gen,
                            device=device)
    lead = mesh is None or mesh.rank == 0
    # rank 0's recorder times generate's prefill/decode spans and writes
    # the telemetry and the snapshot
    obs = _obs_config(args) if lead else None
    with make_recorder((args.telemetry or None) if lead else None,
                       obs) as rec:
        set_default_recorder(rec if obs is not None else None)
        try:
            t0 = time.time()
            with profile_trace(args.profile_dir or None):
                out = generate(model, params, prompts, args.new_tokens,
                               mesh=mesh)
                _sync(device)
            dt = time.time() - t0
        finally:
            set_default_recorder(None)
        if not lead:
            return
        tok_s = args.batch * args.new_tokens / dt
        print(f"[serve] {args.arch}: generated {tuple(out.shape)} in "
              f"{dt:.2f}s ({tok_s:.1f} tok/s)")
        rec.log("serve", 0, arch=args.arch, batch=args.batch,
                prompt_len=args.prompt_len, new_tokens=args.new_tokens,
                wall_s=dt, tok_s=tok_s, mesh=args.mesh or "none")
        rec.gauge("serve_tokens_per_sec", tok_s)
    if args.metrics:
        print(f"[serve] wrote metrics snapshot {args.metrics}")
    print(out[:, args.prompt_len:])


def _run_engine(args, model, params, device):
    from repro_torch.obs import make_recorder
    from repro_torch.serve import (RobustDecoder, ServeEngine,
                                   corrupt_replica, make_replicas)

    decoder = None
    if args.replicas > 1:
        params = make_replicas(params, args.replicas)
        for i in range(args.corrupt):
            gen = torch.Generator(device=device).manual_seed(
                args.seed + 1000 + i)
            params = corrupt_replica(params, args.replicas - 1 - i, gen)
        decoder = RobustDecoder(rule=args.robust_rule, k=args.replicas,
                                device=device)
    elif args.corrupt:
        raise SystemExit("--corrupt needs --replicas > 1")

    max_seq_len = args.prompt_len + args.new_tokens
    rng = np.random.default_rng(args.seed)
    from repro_torch.obs.profile import profile_trace
    with make_recorder(args.telemetry or None, _obs_config(args)) as rec:
        engine = ServeEngine(model, params, max_slots=args.max_batch,
                             max_seq_len=max_seq_len, decoder=decoder,
                             telemetry=rec)
        for _ in range(args.batch):
            engine.submit(
                rng.integers(0, model.cfg.vocab_size,
                             (args.prompt_len,)).tolist(),
                args.new_tokens)
        t0 = time.time()
        with profile_trace(args.profile_dir or None):
            done = engine.run()
            _sync(device)
        dt = time.time() - t0
        rec.gauge("serve_tokens_per_sec",
                  sum(len(r.generated) for r in done) / max(dt, 1e-9))
    if args.metrics:
        print(f"[serve] wrote metrics snapshot {args.metrics}")
    toks = sum(len(r.generated) for r in done)
    lat = sorted(r.latency_ms() for r in done)
    mode = (f"robust k={args.replicas} {args.robust_rule}"
            if decoder is not None else "single")
    print(f"[serve] {args.arch} engine ({mode}): {len(done)} requests, "
          f"{toks} tokens in {dt:.2f}s ({toks / dt:.1f} tok/s, "
          f"p50 latency {lat[len(lat) // 2]:.0f}ms, "
          f"{engine.steps_run} engine steps)")
    if decoder is not None:
        rep = [round(x, 3) for x in decoder.rep_state["reputation"].tolist()]
        print(f"[serve] replica reputation: {rep} "
              f"ejected: {decoder.ejected_replicas()}")
    for r in done[: min(4, len(done))]:
        print(f"  rid={r.rid} -> {r.generated}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=4,
                    help="request count (dense: static batch)")
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--mesh", default="",
                    help="data×model, e.g. 4x2: serve the dense tier on "
                         "D x M ranks, requests over the data axis, the "
                         "model tensor-parallel over the model axis")
    ap.add_argument("--engine", action="store_true",
                    help="use the continuous-batching paged ServeEngine")
    ap.add_argument("--replicas", type=int, default=1,
                    help="k model replicas per decode step (> 1 implies "
                         "--engine and robust aggregation)")
    ap.add_argument("--robust-rule", default="phocas",
                    help="aggregation rule for replicated decode (any "
                         "registered rule)")
    ap.add_argument("--corrupt", type=int, default=0,
                    help="corrupt this many replicas with garbage params")
    ap.add_argument("--max-batch", type=int, default=8,
                    help="engine slot count (concurrent requests)")
    ap.add_argument("--telemetry", default="",
                    help="JSONL path for serve + robust-decode score "
                         "telemetry")
    ap.add_argument("--metrics", default="",
                    help="arm the obs layer: write a Prometheus-style "
                         "exposition snapshot to this path at run end "
                         "(implies span tracing; see repro_torch.obs)")
    ap.add_argument("--profile-dir", default="",
                    help="capture a torch.profiler Chrome trace of the run "
                         "into this directory (trace.json; rank<r>/ on a "
                         "mesh)")
    args = ap.parse_args(argv)
    engine = args.engine or args.replicas > 1
    if args.mesh and engine:
        raise SystemExit("--mesh serves the dense tier; the paged engine "
                         "takes no mesh")

    device = resolve_device(args.device)
    model = build_model(get_arch(args.arch))
    if args.mesh:
        import torch.distributed as dist

        from repro_torch.dist.mesh import make_host_mesh, parse_mesh
        d, mm = parse_mesh(args.mesh)
        if not dist.is_initialized():
            from repro_torch.dist.launch import spawn
            print(spawn(_serve_rank, d * mm,
                        sys.argv[1:] if argv is None else list(argv))[0],
                  end="")
            return
        from repro_torch.dist.sharding import init_blocks
        mesh = make_host_mesh(d, mm)
        params = init_blocks(model, args.seed, mesh, device)
        _run_dense(args, model, params, device, mesh)
        return
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = model.init(gen)
    if engine:
        _run_engine(args, model, params, device)
    else:
        _run_dense(args, model, params, device)


def _serve_rank(rank: int, world: int, argv) -> str:
    """One spawned rank of ``--mesh``: this CLI in the world made; returns
    what it printed, which the spawning process prints for rank 0."""
    import contextlib
    import io
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return out.getvalue()


if __name__ == "__main__":
    main()
