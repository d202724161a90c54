#!/usr/bin/env python3
"""Probe SGD rates for the LM zoo cells of ``chip_smoke.py`` (phase 9).

    python3 tools/zoo_lr_probe.py                   # every cell, 0.5 0.1 0.02
    python3 tools/zoo_lr_probe.py C E --rates 0.5 0.05 --steps 10

Trains each named cell of ``chip_smoke.ZOO_CELLS`` (full width with its
depth cut, m workers, phocas b = q under omniscient, remat "full", bf16) on
sync_ps for ``--steps`` steps at each rate, and prints the first and last
loss and whether the loss fell.  A run that goes non-finite is reported, not
raised.  Needs a CUDA GPU; builds the kernels first.
"""
from __future__ import annotations

import argparse
import gc
import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("cells", nargs="*")
    ap.add_argument("--rates", type=float, nargs="+", default=[0.5, 0.1,
                                                               0.02])
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("zoo_lr_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [REPO, os.path.join(REPO, "src")]
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.models.registry import build_model
    torch.backends.cuda.matmul.allow_tf32 = False
    build.KERNELS.build_all()
    for cell in args.cells or list(cs.ZOO_CELLS):
        c = cs.ZOO_CELLS[cell]
        model = build_model(cs.arch_cfg(c.arch, c.layers), remat="full")
        batch_fn = cs.zoo_batch_fn(model.cfg, c.m, c.seq_len)
        for lr in args.rates:
            tag = f"probe cell {cell} {c.arch} lr {lr}"
            try:
                out = cs.lm_run(tag, cs.sync_plan(
                    model, batch_fn, m=c.m, b=c.b, steps=args.steps, lr=lr,
                    tag=f"probe-{cell}-{lr}"))
                losses = out["losses"]
                print(f"  {tag}: {losses[0]:.4f} -> {losses[-1]:.4f} "
                      f"(min {min(losses):.4f}), "
                      f"{'fell' if losses[-1] < losses[0] else 'DID NOT FALL'}")
                del out
            except cs.SmokeError as e:
                print(f"  {tag}: {e}")
            gc.collect()
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
