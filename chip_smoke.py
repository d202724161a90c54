#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout

Phases, each of which fails the run (non-zero exit) on any wrong result:

1. build: compile the CUDA kernels from ``src/repro_torch/kernels/csrc``
   with nvcc for sm_90a and print the build time and ptxas's register report;
2. kernels: hold each kernel against its plain PyTorch version on the card at
   the paper models' widths, (20, 118,282) and (20, 2,430,826), for
   b in {0, 2, 6, 8, 9}, on adversarial matrices (exact duplicates, rows at
   +-1e20, NaN/+-inf entries, bitflip-corrupted rows), with max|diff| <= 1e-4
   (phocas mismatches allowed only at a boundary distance tie); time both at
   the main-path shapes beside the device-memory bound;
3. training: run the paper's MNIST MLP (784-128-128-10, m=20, 32 samples per
   worker, phocas b=8 under bitflip q=8) and CIFAR-10 CNN (32x32x3, m=20,
   trmean b=6 under gaussian q=6) through ``run_experiment`` on the card,
   check finite, decreasing losses and one kernel launch per step, and check
   that the kernel path's losses agree with the plain path's on a small run;
4. trace: for both models, the untraced step time and one torch.profiler run
   giving the device's busy share and its top kernels;
5. report: the card's name and power limit, one JSON line describing every
   kernel, and as the last line ``{"ok": true, "device": {...}}``.

TF32 is off for matmuls and cuDNN convolutions throughout.  Without a CUDA
device the script exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory (NVIDIA data sheet)
F32_OPS_PER_S = 67e12            # H100 SXM f32 outside the tensor cores
SHAPES = ((20, 118_282), (20, 2_430_826))   # MLP and CNN worker matrices
BS = (0, 2, 6, 8, 9)
ATOL = 1e-4
KERNEL_META = {
    "phocas": {"source": "src/repro_torch/kernels/csrc/phocas.cu",
               "replaces": "src/repro/kernels/phocas/kernel.py:106",
               "shape": SHAPES[0], "b": 8},
    "trmean": {"source": "src/repro_torch/kernels/csrc/trmean.cu",
               "replaces": "src/repro/kernels/trmean/kernel.py:108",
               "shape": SHAPES[1], "b": 6},
}


class SmokeError(AssertionError):
    """A check of this script failed."""


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeError(msg)


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def adversarial_matrices(m: int, d: int, gen: torch.Generator):
    """The inputs each kernel is held to, as (name, (m, d) f32 on cuda)."""
    from repro_torch.core.attacks import bitflip_attack
    base = 3.0 + torch.randn((m, d), generator=gen, device=gen.device)
    dups = torch.round(2.0 * base) / 2.0          # exact boundary ties
    big = base.clone()
    big[3] = -1e20
    big[11] = 1e20
    big[5, ::7] = -1e20
    nonfinite = base.clone()
    nonfinite[2, ::10] = float("nan")
    nonfinite[7, 1::10] = float("inf")
    nonfinite[9, 2::10] = float("-inf")
    nonfinite[4, 3::13] = float("nan")
    flipped = bitflip_attack(gen, base, 8, num_dims=d)
    return [("gauss", base), ("duplicates", dups), ("pm1e20", big),
            ("nan_inf", nonfinite), ("bitflip", flipped)]


def compare(name: str, u: torch.Tensor, b: int, got: torch.Tensor,
            ref: torch.Tensor) -> float:
    """Max |got - ref| over finite entries; fails on a mismatch."""
    for f in (torch.isnan, torch.isposinf, torch.isneginf):
        check(torch.equal(f(got), f(ref)),
              f"{name} b={b}: non-finite entries differ ({f.__name__})")
    fin = torch.isfinite(ref)
    diff = torch.zeros_like(ref)
    diff[fin] = (got[fin] - ref[fin]).abs()
    bad = torch.nonzero(diff > ATOL).flatten()
    if bad.numel() and name == "phocas" and b > 0:
        # Phocas is discontinuous at distance ties: a mismatch is allowed
        # only where the m-b and m-b+1 nearest distances tie.
        from repro_torch.core.selection import sorted_rows, worker_rows
        from repro_torch.kernels.trmean.ref import trmean_ref
        uf = torch.stack(sorted_rows(worker_rows(u[:, bad])))
        center = trmean_ref(u[:, bad], b)
        dist = torch.sort((uf - center).abs(), dim=0).values
        m = u.shape[0]
        gap = dist[m - b] - dist[m - b - 1]
        check(bool((gap < 1e-4).all()),
              f"phocas b={b}: {bad.numel()} coordinates differ by up to "
              f"{diff.max().item()} without a boundary tie")
        diff[bad] = 0.0
    elif bad.numel():
        raise SmokeError(f"{name} b={b}: {bad.numel()} coordinates differ, "
                         f"max {diff.max().item()}")
    return diff.max().item()


def time_ms(fn, *, reps: int = 15) -> float:
    """Median device time of ``fn()`` in ms, with the L2 cache flushed
    before each launch (the bound counts every byte from device memory)."""
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.int32, device="cuda")
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def bound_ms(m: int, d: int, elem_bytes: int) -> tuple:
    """Least time for the function: each input read once, each output
    written once, at the card's memory rate; m*d compares at its f32 rate."""
    t_bytes = (m * d * elem_bytes + d * 4) / HBM_BYTES_PER_S * 1e3
    t_ops = m * d / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def kernel_phase(gen: torch.Generator) -> dict:
    from repro_torch.kernels.phocas.kernel import phocas_hopper
    from repro_torch.kernels.phocas.ref import phocas_ref
    from repro_torch.kernels.trmean.kernel import trmean_hopper
    from repro_torch.kernels.trmean.ref import trmean_ref
    pairs = {"phocas": (phocas_hopper, phocas_ref),
             "trmean": (trmean_hopper, trmean_ref)}
    report = {k: {"max_abs_err": 0.0} for k in pairs}
    for m, d in SHAPES:
        for mname, u in adversarial_matrices(m, d, gen):
            for b in BS:
                for kname, (kernel, ref) in pairs.items():
                    got = kernel(u, b)
                    want = ref(u, b)
                    torch.cuda.synchronize()
                    err = compare(kname, u, b, got, want)
                    report[kname]["max_abs_err"] = max(
                        report[kname]["max_abs_err"], err)
                    if err:
                        print(f"  {kname} ({m}, {d}) {mname} b={b}: "
                              f"max|diff| {err:.3e}")
        u = adversarial_matrices(m, d, gen)[0][1]
        for dtype in (torch.bfloat16, torch.float16):
            x = u.to(dtype)
            for kname, (kernel, ref) in pairs.items():
                err = compare(kname, x, 8, kernel(x, 8), ref(x, 8))
                report[kname]["max_abs_err"] = max(
                    report[kname]["max_abs_err"], err)
        print(f"kernels == plain at ({m}, {d}) for b in {list(BS)} on "
              f"gauss/duplicates/pm1e20/nan_inf/bitflip, f32 (+bf16/f16 at "
              f"b=8): ok")
    for kname, (kernel, ref) in pairs.items():
        print(f"  {kname}: max|kernel - plain| = "
              f"{report[kname]['max_abs_err']:.3e} (limit {ATOL})")

    print("timing (median of 15, L2 flushed before each launch):")
    for m, d in SHAPES:
        u = adversarial_matrices(m, d, gen)[0][1]
        bnd, bound_by = bound_ms(m, d, 4)
        for b in (2, 6, 8):
            for kname, (kernel, ref) in pairs.items():
                k_ms = time_ms(lambda: kernel(u, b))
                p_ms = time_ms(lambda: ref(u, b), reps=5)
                print(f"  {kname:6s} m={m} d={d:>9,} b={b}: kernel "
                      f"{k_ms:.4f} ms  plain {p_ms:.3f} ms  bound "
                      f"{bnd * 1e3:.1f} us ({bound_by})  "
                      f"{bnd / k_ms:.1%} of bound")
                meta = KERNEL_META[kname]
                if (m, d) == meta["shape"] and b == meta["b"]:
                    report[kname].update(ms=k_ms, plain_ms=p_ms,
                                         bound_ms=bnd, bound_by=bound_by)
    return report


# ---------------------------------------------------------------------------
# phase 3: training through run_experiment
# ---------------------------------------------------------------------------

def paper_spec(kind: str, steps: int):
    from repro_torch.core.attacks import AttackConfig
    from repro_torch.core.robust import RobustConfig
    from repro_torch.experiment import DataSpec, ModelSpec, ScenarioSpec
    from repro_torch.optim import OptConfig
    if kind == "mlp":
        model = ModelSpec(kind="mlp", dims=(784, 128, 128, 10))
        data = DataSpec(dim=784, noise=0.8, batch_per_worker=32)
        robust = RobustConfig(rule="phocas", b=8, q=8)
        attack = AttackConfig(name="bitflip", num_byzantine=8)
    else:
        model = ModelSpec(kind="cnn", cnn_size=32, cnn_channels=3)
        data = DataSpec(dim=32 * 32 * 3, noise=1.0, batch_per_worker=32)
        robust = RobustConfig(rule="trmean", b=6, q=6)
        attack = AttackConfig(name="gaussian", num_byzantine=6)
    return ScenarioSpec(name=f"chip-smoke-{kind}", model=model, data=data,
                        robust=robust, attack=attack,
                        opt=OptConfig(name="sgd", lr=0.1), num_workers=20,
                        steps=steps, log_every=1)


def reset_counts(wrappers) -> None:
    for w in wrappers:
        w.launches = 0


def train_phase() -> dict:
    from repro_torch.experiment import run_experiment
    from repro_torch.kernels.phocas.kernel import phocas_hopper
    from repro_torch.kernels.trmean.kernel import trmean_hopper
    from repro_torch.tree import leaves
    wrappers = {"phocas": phocas_hopper, "trmean": trmean_hopper}
    launches = {}
    for kind, steps, kname in (("mlp", 30, "phocas"), ("cnn", 20, "trmean")):
        spec = paper_spec(kind, steps)
        reset_counts(wrappers.values())
        t0 = time.perf_counter()
        res = run_experiment(spec)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {k: w.launches for k, w in wrappers.items()}
        losses = [r["loss"] for r in res.history]
        d = sum(x.numel() for x in leaves(res.params))
        walls = [r["wall"] for r in res.history]
        step_ms = sorted(1e3 * (b - a) for a, b in zip(walls[1:], walls[2:]))
        print(f"{kind}: d={d:,} m=20 rule={spec.robust.rule} "
              f"b={spec.robust.b} attack={spec.attack.name} "
              f"q={spec.attack.num_byzantine} steps={steps}")
        print(f"  loss {losses[0]:.4f} -> {losses[-1]:.4f}  eval "
              f"{res.history[0]['eval']:.4f} -> {res.final_eval:.4f}  "
              f"step {step_ms[len(step_ms) // 2]:.2f} ms (median, host "
              f"clock, incl. loss readback and eval)  run {wall:.2f} s  "
              f"launches {counts}")
        check(len(losses) == steps, f"{kind}: {len(losses)} loss records")
        check(all(map(lambda x: x == x and abs(x) != float("inf"), losses)),
              f"{kind}: non-finite loss in {losses}")
        check(losses[-1] < losses[0],
              f"{kind}: loss did not decrease ({losses[0]} -> {losses[-1]})")
        check(counts[kname] == steps,
              f"{kind}: {kname} kernel launched {counts[kname]} times in "
              f"{steps} steps")
        check(sum(counts.values()) == steps,
              f"{kind}: unexpected launches {counts}")
        launches[kname] = counts[kname]

    # Small run: the kernel path agrees with the plain path step by step.
    from repro_torch.core.attacks import AttackConfig
    from repro_torch.core.robust import RobustConfig
    from repro_torch.experiment import DataSpec, ModelSpec, ScenarioSpec
    for rule in ("phocas", "trmean"):
        runs = {}
        for backend in ("pallas", "xla"):
            spec = ScenarioSpec(
                model=ModelSpec(kind="mlp"), data=DataSpec(dim=16,
                                                           batch_per_worker=4),
                robust=RobustConfig(rule=rule, b=2, backend=backend),
                attack=AttackConfig(name="signflip", num_byzantine=2),
                num_workers=8, steps=5, log_every=1)
            runs[backend] = run_experiment(spec)
        a = [r["loss"] for r in runs["pallas"].history]
        b = [r["loss"] for r in runs["xla"].history]
        rel = max(abs(x - y) / abs(y) for x, y in zip(a, b))
        check(rel <= 1e-5, f"{rule}: kernel-path losses {a} vs plain {b}")
        pa = leaves(runs["pallas"].params)
        pb = leaves(runs["xla"].params)
        perr = max((x - y).abs().max().item() for x, y in zip(pa, pb))
        check(perr <= 1e-5, f"{rule}: final params differ by {perr}")
        print(f"small run ({rule}, m=8, signflip): kernel path == plain "
              f"path, loss rel diff {rel:.2e}, params max diff {perr:.2e}")
    return launches


# ---------------------------------------------------------------------------
# phase 4: where a step's time goes
# ---------------------------------------------------------------------------

def trace_phase(steps: int = 8) -> None:
    """Per config: the untraced step time, then one traced run of the same
    steps (torch.profiler) for the device's busy share and its top kernels.
    Both runs record history only at the first and last step."""
    import dataclasses

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.experiment import run_experiment
    for kind in ("mlp", "cnn"):
        spec = dataclasses.replace(paper_spec(kind, steps), log_every=steps)
        run_experiment(spec)                                 # warm-up
        step_ms = run_experiment(spec).wall_time / steps * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            traced = run_experiment(spec).wall_time
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(e.self_device_time_total for e in kernels) / 1e6
        check(busy > 0, f"{kind}: the profiler saw no device time")
        print(f"{kind} trace ({steps} steps): untraced step {step_ms:.3f} ms;"
              f" traced loop {traced * 1e3:.1f} ms, kernels busy "
              f"{busy * 1e3:.1f} ms = {busy / traced:.1%} of it")
        for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]:
            print(f"    {e.self_device_time_total / busy / 1e6:6.1%}  "
                  f"n={e.count:4d}  {e.key[:100]}")


# ---------------------------------------------------------------------------

def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(REPO, "src"))
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}  device {torch.cuda.get_device_name(0)}")
    print("TF32 off: torch.backends.cuda.matmul.allow_tf32 = False, "
          "torch.backends.cudnn.allow_tf32 = False")

    t0 = time.perf_counter()
    build.KERNELS.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s for {build.SOURCES} "
          f"(nvcc, sm_90a, in parallel)")
    for out in build.KERNELS.ptxas.values():      # ptxas -v, per instance
        fn = frame = ""
        for line in out.splitlines():
            if "Compiling entry function" in line:
                fn = line.split("'")[1]
            elif "stack frame" in line:
                frame = line.strip()
            elif "registers" in line:
                print(f"  {fn}: {line.split(':', 1)[1].strip()}; {frame}")

    gen = torch.Generator(device="cuda").manual_seed(0)
    report = kernel_phase(gen)
    launches = train_phase()
    trace_phase()

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(smi)
    kernels = []
    for kname, meta in KERNEL_META.items():
        r = report[kname]
        kernels.append({
            "name": kname, "route": "cuda", "source": meta["source"],
            "replaces": meta["replaces"], "launches": launches[kname],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
