#!/usr/bin/env python3
"""Time another checkout (say the parent commit) against this one, in turns
on one GPU.

    git archive <commit> | tar -x -C build/other
    python3 tools/ab.py build/other steps
    python3 tools/ab.py build/other kernel phocas:20:2430826:8 \
        phocas:20:2430826:8:bf16 krum_gram:20:2430826

Each turn is a fresh process run from the root of its checkout, on that
checkout's ``src`` and kernels; the order is other, this, this, other.

``steps``: for each training cell of ``chip_smoke.py`` (MLP phocas and CNN
trmean, plain and defended, MLP krum plain and defended, CNN multikrum), one
warm-up ``run_experiment`` and then three timed ones: ms per untraced step,
host clock, over a run that ends in a device sync.

``kernel SPEC [SPEC ...]``, each ``SPEC`` ``NAME:M:D[:B][:DTYPE]``: the
kernel ``NAME`` (a ``build.SOURCES`` entry other than ``flash_attn``; ``B``
for all but ``krum_gram``) on an (M, D) matrix of 3 + N(0, 1) entries,
seeded, in ``DTYPE`` (f32, the default, bf16 or f16); every spec in each
turn.  Two times per spec and turn: the device time by this checkout's
``chip_smoke.time_ms`` in both turns (CUDA events, median of 15, L2
flushed, the wrapper's host time kept out), and the wall time per call over
200 calls issued back to back (host clock, ending in a sync), in which the
wrapper's host work shows wherever it exceeds the device's.  Beside them,
as a floor, the device time of ``u.sum(0)``, one library read of the same
bytes, timed the same way.

Needs a CUDA device.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = r"""
import dataclasses, json, os, sys, torch
sys.path.insert(0, os.getcwd()); sys.path.insert(0, os.path.join(os.getcwd(), "src"))
import chip_smoke as cs
from repro_torch.experiment import run_experiment
from repro_torch.kernels import build
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
build.KERNELS.build_all()
out = {}
for kind, defended, n, rule in (
        ("mlp", False, 8, None), ("cnn", False, 8, None),
        ("mlp", True, 16, None), ("cnn", True, 16, None),
        ("mlp", False, 8, "krum"), ("mlp", True, 16, "krum"),
        ("cnn", False, 8, "multikrum")):
    spec = (cs.vector_spec(kind, rule, n, defended) if rule
            else cs.paper_spec(kind, n, defended))
    spec = dataclasses.replace(spec, log_every=n)
    run_experiment(spec)
    tag = f"{kind} {spec.robust.rule}" + (" defended" if defended else "")
    out[tag] = [run_experiment(spec).wall_time / n * 1e3 for _ in range(3)]
print("RESULT " + json.dumps(out))
"""
KERNEL = r"""
import importlib.util, json, os, sys, time, torch
sys.path.insert(0, os.path.join(os.getcwd(), "src"))
from repro_torch.kernels import build
spec = importlib.util.spec_from_file_location("ab_timing", sys.argv[1])
timing = importlib.util.module_from_spec(spec)
spec.loader.exec_module(timing)
out = {}
build.KERNELS.build_all()
for arg in sys.argv[2:]:
    name, m, d, *rest = arg.split(":")
    m, d = int(m), int(d)
    b = int(rest.pop(0)) if rest and rest[0].isdigit() else None
    dtype = {"f32": torch.float32, "bf16": torch.bfloat16,
             "f16": torch.float16}[rest[0] if rest else "f32"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    u = (3.0 + torch.randn((m, d), generator=gen, device="cuda")).to(dtype)
    call = (lambda: build.launch_gram(u)) if b is None else \
        (lambda: build.launch(name, u, b))
    device_ms = timing.time_ms(call)
    for _ in range(20):
        call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        call()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / 200 * 1e3
    out[f"{arg} device ms"] = [device_ms]
    out[f"{arg} wall ms/call"] = [wall_ms]
    out[f"{arg} read ms"] = [timing.time_ms(lambda: u.sum(0))]
    del u
print("RESULT " + json.dumps(out))
"""


def turn(root: str, args: list) -> dict:
    code = STEPS if args[0] == "steps" else KERNEL
    extra = [] if args[0] == "steps" else \
        [os.path.join(REPO, "chip_smoke.py"), *args[1:]]
    res = subprocess.run([sys.executable, "-c", code, *extra], cwd=root,
                         capture_output=True, text=True, timeout=900)
    for line in res.stdout.splitlines():
        if line.startswith("RESULT "):
            return json.loads(line[7:])
    raise RuntimeError(f"turn in {root} failed:\n{res.stdout[-2000:]}\n"
                       f"{res.stderr[-4000:]}")


def main() -> int:
    args = sys.argv[2:]
    if (len(sys.argv) < 3 or args[0] not in ("steps", "kernel")
            or (args[0] == "kernel" and len(args) < 2)):
        print(__doc__, file=sys.stderr)
        return 2
    other = os.path.abspath(sys.argv[1])
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    print(" ".join(args), flush=True)
    turns = [("other", turn(other, args)), ("this", turn(REPO, args)),
             ("this", turn(REPO, args)), ("other", turn(other, args))]
    for key in turns[0][1]:
        cols = "  ".join(f"{who} " + "/".join(f"{x:.4f}" for x in t[key])
                         for who, t in turns)
        print(f"{key:40s} {cols}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
