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
   (phocas mismatches allowed only at a boundary distance tie) and, for the
   counts kernels K3/K4, drop counts equal as integers; time each kernel and
   its plain version at the main-path shapes beside its bound;
3. training: run the paper's MNIST MLP (784-128-128-10, m=20, 32 samples per
   worker, SGD lr 0.1, phocas b=8 under bitflip q=8) and CIFAR-10 CNN
   (32x32x3, m=20, SGD lr 0.02, trmean b=6 under gaussian q=6) through
   ``run_experiment`` on the card, check finite, decreasing losses and one
   kernel launch per step; then the same models defended
   (``DefenseConfig()``: MLP phocas b=8 under signflip q=8, CNN trmean b=6
   under gaussian q=6), checking that every Byzantine worker ends ejected,
   one counts-kernel launch per step and one aggregate launch per step that
   began with a worker ejected; and check on small runs that the kernel path
   agrees with the plain path, plain and defended;
4. trace: for both models, plain and defended, the untraced step time and
   one torch.profiler run giving the device's busy share and its top
   kernels;
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
# Per kernel: its source, the TPU kernel it replaces, the main-path shape and
# b its numbers are reported at, and the compares it does per coordinate for
# m workers (the counts kernels rank every worker against every other).
KERNEL_META = {
    "phocas": {"source": "src/repro_torch/kernels/csrc/phocas.cu",
               "replaces": "src/repro/kernels/phocas/kernel.py:106",
               "shape": SHAPES[0], "b": 8, "compares": lambda m: m},
    "trmean": {"source": "src/repro_torch/kernels/csrc/trmean.cu",
               "replaces": "src/repro/kernels/trmean/kernel.py:108",
               "shape": SHAPES[1], "b": 6, "compares": lambda m: m},
    "phocas_counts": {
        "source": "src/repro_torch/kernels/csrc/phocas_counts.cu",
        "replaces": "src/repro/kernels/phocas/kernel.py:128",
        "shape": SHAPES[0], "b": 8, "compares": lambda m: m * (m - 1)},
    "trmean_counts": {
        "source": "src/repro_torch/kernels/csrc/trmean_counts.cu",
        "replaces": "src/repro/kernels/trmean/kernel.py:130",
        "shape": SHAPES[1], "b": 6, "compares": lambda m: m * (m - 1)},
}


def wrappers() -> dict:
    """Kernel name -> (wrapper with its launch count, plain version)."""
    from repro_torch.kernels.phocas.kernel import (phocas_counts_hopper,
                                                   phocas_hopper)
    from repro_torch.kernels.phocas.ref import phocas_counts_ref, phocas_ref
    from repro_torch.kernels.trmean.kernel import (trmean_counts_hopper,
                                                   trmean_hopper)
    from repro_torch.kernels.trmean.ref import trmean_counts_ref, trmean_ref
    return {"phocas": (phocas_hopper, phocas_ref),
            "trmean": (trmean_hopper, trmean_ref),
            "phocas_counts": (phocas_counts_hopper, phocas_counts_ref),
            "trmean_counts": (trmean_counts_hopper, trmean_counts_ref)}


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
    if bad.numel() and name.startswith("phocas") and b > 0:
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


def bound_ms(kname: str, m: int, d: int, elem_bytes: int) -> tuple:
    """Least time for the function: each input read once and each output
    written once (the (d,) f32 aggregate, and m counts for K3/K4) at the
    card's memory rate, or its compares at the card's f32 rate."""
    out_bytes = d * 4 + (m * 4 if kname.endswith("_counts") else 0)
    t_bytes = (m * d * elem_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = KERNEL_META[kname]["compares"](m) * d / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def compare_kernel(kname: str, u: torch.Tensor, b: int, got,
                   want) -> float:
    """compare() for the aggregate, and for K3/K4 equal integer counts."""
    if not kname.endswith("_counts"):
        return compare(kname, u, b, got, want)
    check(torch.equal(got[1], want[1]),
          f"{kname} b={b}: counts {got[1].tolist()} != plain "
          f"{want[1].tolist()}")
    return compare(kname, u, b, got[0], want[0])


def kernel_phase(gen: torch.Generator) -> dict:
    pairs = wrappers()
    report = {k: {"max_abs_err": 0.0} for k in pairs}
    for m, d in SHAPES:
        for mname, u in adversarial_matrices(m, d, gen):
            for b in BS:
                for kname, (kernel, ref) in pairs.items():
                    got = kernel(u, b)
                    want = ref(u, b)
                    torch.cuda.synchronize()
                    err = compare_kernel(kname, u, b, got, want)
                    report[kname]["max_abs_err"] = max(
                        report[kname]["max_abs_err"], err)
                    if err:
                        print(f"  {kname} ({m}, {d}) {mname} b={b}: "
                              f"max|diff| {err:.3e}")
        u = adversarial_matrices(m, d, gen)[0][1]
        for dtype in (torch.bfloat16, torch.float16):
            x = u.to(dtype)
            for kname, (kernel, ref) in pairs.items():
                err = compare_kernel(kname, x, 8, kernel(x, 8), ref(x, 8))
                report[kname]["max_abs_err"] = max(
                    report[kname]["max_abs_err"], err)
        print(f"kernels == plain at ({m}, {d}) for b in {list(BS)} on "
              f"gauss/duplicates/pm1e20/nan_inf/bitflip, f32 (+bf16/f16 at "
              f"b=8), counts equal: ok")
    for kname in pairs:
        print(f"  {kname}: max|kernel - plain| = "
              f"{report[kname]['max_abs_err']:.3e} (limit {ATOL})")

    print("timing (median of 15, L2 flushed before each launch):")
    for m, d in SHAPES:
        u = adversarial_matrices(m, d, gen)[0][1]
        for b in (2, 6, 8):
            for kname, (kernel, ref) in pairs.items():
                bnd, bound_by = bound_ms(kname, m, d, 4)
                k_ms = time_ms(lambda: kernel(u, b))
                p_ms = time_ms(lambda: ref(u, b), reps=5)
                print(f"  {kname:13s} m={m} d={d:>9,} b={b}: kernel "
                      f"{k_ms:.4f} ms  plain {p_ms:.3f} ms  bound "
                      f"{bnd * 1e3:.2f} us ({bound_by})  "
                      f"{bnd / k_ms:.1%} of bound")
                meta = KERNEL_META[kname]
                if (m, d) == meta["shape"] and b == meta["b"]:
                    report[kname].update(ms=k_ms, plain_ms=p_ms,
                                         bound_ms=bnd, bound_by=bound_by)
    return report


# ---------------------------------------------------------------------------
# phase 3: training through run_experiment
# ---------------------------------------------------------------------------

def paper_spec(kind: str, steps: int, defended: bool = False):
    """The paper's MLP or CNN cell at full width; ``defended`` puts the
    defense loop on (``DefenseConfig()``) and the MLP under signflip, since
    bitflip touches only 1,000 of its 118,282 dimensions."""
    from repro_torch.core.attacks import AttackConfig
    from repro_torch.core.robust import RobustConfig
    from repro_torch.defense import DefenseConfig
    from repro_torch.experiment import DataSpec, ModelSpec, ScenarioSpec
    from repro_torch.optim import OptConfig
    if kind == "mlp":
        model = ModelSpec(kind="mlp", dims=(784, 128, 128, 10))
        data = DataSpec(dim=784, noise=0.8, batch_per_worker=32)
        robust = RobustConfig(rule="phocas", b=8, q=8)
        attack = AttackConfig(name="signflip" if defended else "bitflip",
                              num_byzantine=8)
        lr = 0.1
    else:
        model = ModelSpec(kind="cnn", cnn_size=32, cnn_channels=3)
        data = DataSpec(dim=32 * 32 * 3, noise=1.0, batch_per_worker=32)
        robust = RobustConfig(rule="trmean", b=6, q=6)
        attack = AttackConfig(name="gaussian", num_byzantine=6)
        # At the paper's lr 0.1 the CNN's first 20 steps oscillate, with
        # the plain mean and no Byzantine worker too: the loss overshoots at
        # step 1 and spikes again near step 16, and cuDNN's run-to-run float
        # differences move the spike, so the last loss may exceed the first.
        # At 0.02 the loss falls steadily over these steps.
        lr = 0.02
    return ScenarioSpec(name=f"chip-smoke-{kind}", model=model, data=data,
                        robust=robust, attack=attack,
                        defense=DefenseConfig() if defended else None,
                        opt=OptConfig(name="sgd", lr=lr), num_workers=20,
                        steps=steps, log_every=1)


def launch_counts(run) -> tuple:
    """Run ``run()`` with every kernel's count set to 0 just before; return
    its result and the counts read just after."""
    ws = {k: w for k, (w, _) in wrappers().items()}
    for w in ws.values():
        w.launches = 0
    out = run()
    torch.cuda.synchronize()
    return out, {k: w.launches for k, w in ws.items()}


def train_run(kind: str, steps: int, defended: bool):
    """One full-width run through run_experiment; checks its losses and
    prints its outcome.  Returns (result, launch counts)."""
    from repro_torch.experiment import run_experiment
    from repro_torch.tree import leaves
    spec = paper_spec(kind, steps, defended)
    t0 = time.perf_counter()
    res, counts = launch_counts(lambda: run_experiment(spec))
    wall = time.perf_counter() - t0
    tag = f"{kind}{' defended' if defended else ''}"
    losses = [r["loss"] for r in res.history]
    d = sum(x.numel() for x in leaves(res.params))
    walls = [r["wall"] for r in res.history]
    step_ms = sorted(1e3 * (b - a) for a, b in zip(walls[1:], walls[2:]))
    print(f"{tag}: d={d:,} m=20 rule={spec.robust.rule} b={spec.robust.b} "
          f"attack={spec.attack.name} q={spec.attack.num_byzantine} "
          f"steps={steps}")
    print(f"  loss {losses[0]:.4f} -> {losses[-1]:.4f}  eval "
          f"{res.history[0]['eval']:.4f} -> {res.final_eval:.4f}  "
          f"step {step_ms[len(step_ms) // 2]:.2f} ms (median, host clock, "
          f"incl. loss readback and eval)  run {wall:.2f} s  "
          f"launches {counts}")
    check(len(losses) == steps, f"{tag}: {len(losses)} loss records")
    check(all(map(lambda x: x == x and abs(x) != float("inf"), losses)),
          f"{tag}: non-finite loss in {losses}")
    check(losses[-1] < losses[0],
          f"{tag}: loss did not decrease ({losses[0]} -> {losses[-1]})")
    return res, counts


def defended_checks(kind: str, res, counts: dict) -> None:
    """Every Byzantine worker (the first q) ends ejected; one counts-kernel
    launch per step; one aggregate-kernel launch per step that began with a
    worker ejected (the gate short-circuits while all are active)."""
    spec = res.spec
    m, q, steps = spec.num_workers, spec.attack.num_byzantine, spec.steps
    rule = spec.robust.rule
    active = res.defense_state["active"].tolist()
    n_active = [r["n_active"] for r in res.history]
    gated = sum(1 for n in n_active[:-1] if n < m)
    benign_out = sum(1 for a in active[q:] if a == 0)
    first = next((r["step"] for r in res.history if r["n_active"] < m), None)
    print(f"  defense: final q_hat {res.history[-1]['q_hat']}, active "
          f"{[int(a) for a in active]}, first ejection after step {first}, "
          f"{gated} gated steps, benign workers ejected: {benign_out}")
    check(all(a == 0 for a in active[:q]),
          f"{kind} defended: Byzantine workers not all ejected: {active}")
    want = {k: 0 for k in counts}
    want[f"{rule}_counts"] = steps
    want[rule] = gated
    check(counts == want, f"{kind} defended: launches {counts}, expected "
                          f"{want}")


def small_defended_spec(rule: str, backend: str, telemetry: str):
    from repro_torch.core.attacks import AttackConfig
    from repro_torch.core.robust import RobustConfig
    from repro_torch.defense import DefenseConfig
    from repro_torch.experiment import DataSpec, ModelSpec, ScenarioSpec
    return ScenarioSpec(
        model=ModelSpec(kind="mlp", dims=(32, 32, 10)),
        data=DataSpec(dim=32, batch_per_worker=16, seed=1),
        robust=RobustConfig(rule=rule, b=2, backend=backend),
        attack=AttackConfig(name="signflip", num_byzantine=2),
        defense=DefenseConfig(reputation_decay=0.6, warmup_steps=1),
        num_workers=8, steps=8, log_every=1, telemetry_path=telemetry)


def train_phase() -> dict:
    from repro_torch.core.attacks import AttackConfig
    from repro_torch.core.robust import RobustConfig
    from repro_torch.defense import read_jsonl
    from repro_torch.experiment import (DataSpec, ModelSpec, ScenarioSpec,
                                        run_experiment)
    from repro_torch.tree import leaves
    launches = {}
    for kind, steps, kname in (("mlp", 30, "phocas"), ("cnn", 20, "trmean")):
        _, counts = train_run(kind, steps, defended=False)
        check(counts[kname] == steps and sum(counts.values()) == steps,
              f"{kind}: launches {counts} in {steps} steps")
        launches[kname] = counts[kname]
    for kind, steps in (("mlp", 30), ("cnn", 20)):
        res, counts = train_run(kind, steps, defended=True)
        defended_checks(kind, res, counts)
        kname = f"{res.spec.robust.rule}_counts"
        launches[kname] = counts[kname]

    # Small runs: the kernel path agrees with the plain path step by step.
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

        recs, counts = {}, {}
        for backend in ("pallas", "xla"):
            path = os.path.join(REPO, "build", "chip_smoke",
                                f"{rule}-{backend}.jsonl")
            if os.path.exists(path):
                os.remove(path)
            _, counts[backend] = launch_counts(lambda: run_experiment(
                small_defended_spec(rule, backend, path)))
            recs[backend] = [r for r in read_jsonl(path)
                             if r["kind"] == "train"]
        check(counts["pallas"][f"{rule}_counts"] == 8,
              f"{rule}: kernel path launches {counts['pallas']}")
        check(sum(counts["xla"].values()) == 0,
              f"{rule}: plain path launches {counts['xla']}")
        ka, pa = recs["pallas"], recs["xla"]
        check(len(ka) == len(pa) == 8, f"{rule}: {len(ka)}/{len(pa)} records")
        rel = max(abs(x["loss"] - y["loss"]) / abs(y["loss"])
                  for x, y in zip(ka, pa))
        check(rel <= 1e-5, f"{rule} defended: losses differ by rel {rel}")
        for key in ("suspicion", "reputation", "active", "q_hat"):
            check([r[key] for r in ka] == [r[key] for r in pa],
                  f"{rule} defended: {key} differs between the kernel and "
                  f"the plain path")
        print(f"small defended run ({rule}, m=8, signflip q=2, 8 steps): "
              f"kernel path == plain path, loss rel diff {rel:.2e}, "
              f"suspicion/reputation/active/q_hat equal; final active "
              f"{[int(a) for a in ka[-1]['active']]}, q_hat "
              f"{ka[-1]['q_hat']}; kernel launches {counts['pallas']}")
    return launches


# ---------------------------------------------------------------------------
# phase 4: where a step's time goes
# ---------------------------------------------------------------------------

def trace_phase(steps: int = 8, defended_steps: int = 16) -> None:
    """Per config: the untraced step time, then one traced run of the same
    steps (torch.profiler) for the device's busy share and its top kernels.
    Both runs record history only at the first and last step.  The defended
    runs take more steps, so that about half of them run gated (the first
    ejection comes near step 7)."""
    import dataclasses

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.experiment import run_experiment
    for kind, defended, n in (("mlp", False, steps), ("cnn", False, steps),
                              ("mlp", True, defended_steps),
                              ("cnn", True, defended_steps)):
        spec = dataclasses.replace(paper_spec(kind, n, defended), log_every=n)
        tag = f"{kind}{' defended' if defended else ''}"
        run_experiment(spec)                                 # warm-up
        step_ms = run_experiment(spec).wall_time / n * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            traced = run_experiment(spec).wall_time
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(e.self_device_time_total for e in kernels) / 1e6
        check(busy > 0, f"{tag}: the profiler saw no device time")
        print(f"{tag} trace ({n} steps): untraced step {step_ms:.3f} ms;"
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
