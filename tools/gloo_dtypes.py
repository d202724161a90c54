#!/usr/bin/env python3
"""Which collectives gloo takes for CUDA tensors of each float dtype.

    python3 tools/gloo_dtypes.py      # on a machine with a GPU

Two gloo ranks on the one card (the port's meshes with more ranks than
cards run every rank on one GPU over gloo: NCCL refuses two ranks a
device) try ``all_reduce``, the list form of ``all_gather``,
``all_to_all_single`` and ``broadcast`` (the gloo forms'), and the tensor
forms ``all_gather_into_tensor`` and ``reduce_scatter_tensor`` (the NCCL
forms', under the installed torch's name for them) on f32, bf16 and f16
tensors, and check the values; rank 0 prints one line a (collective,
dtype): "ok", "wrong values" or the error.  The card's name and power
limit come first.
"""
from __future__ import annotations

import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def _try(fn) -> str:
    try:
        return "ok" if fn() else "wrong values"
    except Exception as e:          # a refusal is the answer sought
        return f"refused: {type(e).__name__}: {str(e).splitlines()[0][:90]}"


def probe_rank(rank: int, world: int) -> list:
    import torch.distributed as dist

    from repro_torch.dist import collectives as C
    lines = []
    for dt in DTYPES:
        def reduce():
            x = torch.full((1024,), 1.5 + rank, dtype=dt, device="cuda")
            dist.all_reduce(x)
            return bool((x == sum(1.5 + r for r in range(world))).all())

        def gather():
            x = torch.full((1024,), float(rank), dtype=dt, device="cuda")
            parts = [torch.empty_like(x) for _ in range(world)]
            dist.all_gather(parts, x)
            return all(bool((p == r).all()) for r, p in enumerate(parts))

        def a2a():
            x = torch.arange(world * 8, dtype=dt, device="cuda") + rank
            y = torch.empty_like(x)
            dist.all_to_all_single(y, x)
            want = torch.cat([torch.arange(rank * 8, rank * 8 + 8, dtype=dt,
                                           device="cuda") + r
                              for r in range(world)])
            return torch.equal(y, want)

        def bcast():
            x = torch.full((1024,), float(rank + 3), dtype=dt, device="cuda")
            dist.broadcast(x, src=0)
            return bool((x == 3).all())

        def gather_tensor():
            x = torch.full((1024,), float(rank), dtype=dt, device="cuda")
            out = x.new_empty(world * 1024)
            C._all_gather_single(out, x)
            return all(bool((out[r * 1024:(r + 1) * 1024] == r).all())
                       for r in range(world))

        def scatter_tensor():
            x = torch.full((world * 1024,), 1.5 + rank, dtype=dt,
                           device="cuda")
            out = x.new_empty(1024)
            C._reduce_scatter_single(out, x)
            return bool((out == sum(1.5 + r for r in range(world))).all())

        for name, fn in (("all_reduce", reduce), ("all_gather", gather),
                         ("all_to_all_single", a2a), ("broadcast", bcast),
                         ("all_gather_tensor", gather_tensor),
                         ("reduce_scatter_tensor", scatter_tensor)):
            lines.append(f"{name:21s} {str(dt)[6:]:9s} {_try(fn)}")
    return lines


def main() -> int:
    if not torch.cuda.is_available():
        print("gloo_dtypes: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.dist.launch import spawn
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    print(f"torch {torch.__version__}, gloo, 2 ranks on one card")
    for line in spawn(probe_rank, 2)[0]:
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
