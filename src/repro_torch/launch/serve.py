"""Serving launcher (port of ``repro/launch/serve.py``, DESIGN.md §11).

Two paths behind one CLI:

* dense (default): static-batch greedy ``generate`` with batched prefill;
* engine (``--engine``, or implied by ``--replicas > 1``): the
  continuous-batching paged ``ServeEngine`` — ``--replicas k`` decodes with
  k model replicas aggregated per step by ``--robust-rule``, ``--corrupt n``
  replaces n replicas with garbage parameters to demonstrate the defense,
  and ``--telemetry`` streams the per-replica scores, reputation and
  ejection mask beside the engine's queue-depth records (JSONL).

The run is on ``cuda`` unless ``--device cpu`` is given.  ``--mesh`` (ROADMAP
queue 1 item 10b) and ``--metrics`` / ``--profile-dir`` (item 14) raise
``NotImplementedError``.

  python -m repro_torch.launch.serve --arch granite-8b-reduced --batch 4 \\
      --prompt-len 8 --new-tokens 16
  python -m repro_torch.launch.serve --arch granite-8b-reduced --engine \\
      --replicas 3 --robust-rule phocas --corrupt 1 --max-batch 8 \\
      --telemetry results/serve.jsonl
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.experiment.runner import resolve_device
from repro_torch.experiment.spec import not_ported
from repro_torch.models.registry import build_model
from repro_torch.serve import generate


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _run_dense(args, model, params, device):
    gen = torch.Generator(device=device).manual_seed(args.seed)
    prompts = torch.randint(0, model.cfg.vocab_size,
                            (args.batch, args.prompt_len), generator=gen,
                            device=device)
    t0 = time.time()
    out = generate(model, params, prompts, args.new_tokens)
    _sync(device)
    dt = time.time() - t0
    tok_s = args.batch * args.new_tokens / dt
    print(f"[serve] {args.arch}: generated {tuple(out.shape)} in {dt:.2f}s "
          f"({tok_s:.1f} tok/s)")
    if args.telemetry:
        from repro_torch.obs import make_recorder
        with make_recorder(args.telemetry) as rec:
            rec.log("serve", 0, arch=args.arch, batch=args.batch,
                    prompt_len=args.prompt_len,
                    new_tokens=args.new_tokens, wall_s=dt, tok_s=tok_s,
                    mesh="none")
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
    with make_recorder(args.telemetry or None) as rec:
        engine = ServeEngine(model, params, max_slots=args.max_batch,
                             max_seq_len=max_seq_len, decoder=decoder,
                             telemetry=rec)
        for _ in range(args.batch):
            engine.submit(
                rng.integers(0, model.cfg.vocab_size,
                             (args.prompt_len,)).tolist(),
                args.new_tokens)
        t0 = time.time()
        done = engine.run()
        _sync(device)
        dt = time.time() - t0
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
                    help="data×model, e.g. 4x2 (not ported: ROADMAP queue "
                         "1 item 10b)")
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
                    help="metrics exposition snapshot (not ported: ROADMAP "
                         "queue 1 item 14)")
    ap.add_argument("--profile-dir", default="",
                    help="profiler trace directory (not ported: ROADMAP "
                         "queue 1 item 14)")
    args = ap.parse_args(argv)
    if args.mesh:
        raise not_ported("serving on a device mesh (--mesh)", "item 10b")
    if args.metrics or args.profile_dir:
        raise not_ported("the metrics snapshot and profiler trace "
                         "(--metrics, --profile-dir)", "item 14")

    device = resolve_device(args.device)
    model = build_model(get_arch(args.arch))
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = model.init(gen)
    if args.engine or args.replicas > 1:
        _run_engine(args, model, params, device)
    else:
        _run_dense(args, model, params, device)


if __name__ == "__main__":
    main()
