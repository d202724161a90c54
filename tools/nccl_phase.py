#!/usr/bin/env python3
"""Phase 15 of ``chip_smoke.py`` alone, with its 4-rank part run on any
host.

    python3 tools/nccl_phase.py       # on a machine with a GPU

Builds the kernels, then runs ``chip_smoke.nccl_phase()`` (part (i): a
1-rank NCCL world on ``cuda:0``; part (ii) only where the host has 4
cards) and then ``chip_smoke.nccl_part_two()`` itself, whose 4-rank world
takes the backend ``dist/launch.py::plan_world`` gives this host: NCCL,
one rank a card, on 4 cards; gloo, the 4 ranks on one card, on fewer, which
rehearses the part's code, holds and launches on a one-card host.  Prints
the card's name and power limit first.
"""
from __future__ import annotations

import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [REPO, os.path.join(REPO, "src")]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("nccl_phase: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch.kernels import build
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    print(f"torch {torch.__version__}, {torch.cuda.device_count()} card(s)")
    t0 = time.perf_counter()
    build.KERNELS.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    launches = chip_smoke.nccl_phase()
    print(f"phase 15: {time.perf_counter() - t0:.1f} s, launches {launches}",
          flush=True)
    if not launches:
        t0 = time.perf_counter()
        launches = chip_smoke.nccl_part_two()
        print(f"part (ii) on this host: {time.perf_counter() - t0:.1f} s, "
              f"launches {launches}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
