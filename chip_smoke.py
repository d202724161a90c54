#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout

Phases, each of which fails the run (non-zero exit) on any wrong result:

1. build: compile the CUDA kernels from ``src/repro_torch/kernels/csrc``
   (K1-K4, K5 ``krum_gram.cu`` and K6 ``flash_attn.cu``) with nvcc for
   sm_90a, one nvcc each in parallel, and print the build time and ptxas's
   register report;
2. kernels: hold each kernel against its plain PyTorch version on the card at
   the paper models' widths, (20, 118,282) and (20, 2,430,826), on
   adversarial matrices (exact duplicates, rows at +-1e20, NaN/+-inf
   entries, bitflip-corrupted rows): K1-K4 for b in {0, 2, 6, 8, 9} with
   max|diff| <= 1e-4 (phocas mismatches allowed only at a boundary distance
   tie) and, for the counts kernels K3/K4, drop counts equal as integers;
   K3/K4 also on a tie-heavy matrix (values in {-1, 0, 1}, a constant row
   block, a row of alternating +-inf) for every b, counts equal as
   integers and the aggregate bit for bit; K1-K4 in the register bucket of
   every m in 1..64 at d = 4,099 (a partial last block) on adversarial and
   tie-heavy matrices for b in {0, 1, m/4, (m+1)//2 - 1}, the tie-heavy
   one bit for bit; then past the register kernels' m = 64, K1-K4's
   shared-memory variants at m in {65, 80, 96, 128, 200, 1024} and K1/K2
   also at 1,025, past the warp-register sort's 1,024, at d = 118,282 on
   the same matrices, for b in {0, 2, m/4, (m+1)//2 - 1};
   K5 also on Gaussian rows at scale 10 and at m in {5, 64, 100}, with NaN
   and inf at the same places, finite entries within 1e-6 * max + 1e-3 of
   the plain version evaluated in f64, symmetric and bitwise repeatable
   output; K1 and K3 at the serving run's logits (3, 8 x 49,152) with
   b = 1 on Gaussian logits and the adversarial matrices.  Time each kernel
   and its plain version at the main-path shapes beside its bound, K1 and
   K3 also at the serving logits and K1-K4 at m = 128, and K5 beside
   ``torch.mm(u, u.T)`` (TF32 off); K1 at each shape its design answers to
   (``K1_SHAPES``: the CNN width in f32 and bf16, the MLP width, the
   serving logits, m = 128 and 96), held to its plain version there and
   timed beside its bound and ``torch.sum(u, 0)``, one library read of the
   same bytes, as a floor;
3. training through ``run_experiment`` on the card, checking finite,
   decreasing losses and the kernel launches of every run:
   - the paper's MNIST MLP (784-128-128-10, m=20, 32 samples per worker,
     SGD lr 0.1, phocas b=8 under bitflip q=8) and CIFAR-10 CNN (32x32x3,
     m=20, SGD lr 0.02, trmean b=6 under gaussian q=6), one kernel launch
     per step; then the same models defended (``DefenseConfig()``: MLP
     phocas b=8 under signflip q=8, CNN trmean b=6 under gaussian q=6),
     checking that every Byzantine worker ends ejected, one counts-kernel
     launch per step and one aggregate launch per step that began with a
     worker ejected; the defended MLP again at m = 96 workers (phocas b = 24
     under signflip q = 24, 12 steps), whose K3 and K1 launches run the
     shared-memory variant; small runs where the kernel path must agree
     with the plain path, plain and defended;
   - the Fig. 2 classic-attack baselines under gaussian q=6: MLP krum (30
     steps), CNN multikrum (20 steps, lr 0.02) and MLP krum defended (30
     steps, every Byzantine worker ejected), one K5 launch per step each;
     small m=8 krum and multikrum runs whose kernel and plain paths select
     the same workers every step; one short run each of geomedian, mediam
     and mom, which have no kernel;
3b. the other topologies through ``run_experiment`` at full width, m = 20:
   - async_ps: the MLP (phocas b = 8 under bitflip q = 8, staleness 4,
     update_clip 10, 30 steps), the same defended under signflip q = 8,
     and the CNN (trmean b = 6 under gaussian q = 6, lr 0.02, 10 steps):
     synchronized step time, K1/K2/K3 launches, eval at the first and last
     record (it must rise), ejections;
   - streaming: the CNN with trmean and phocas b = 6 under gaussian q = 6,
     10 steps, against sync_ps on the same spec: step time and
     ``torch.cuda.max_memory_allocated`` (the streaming peak must be the
     lower);
   - faults: ``sync_ps_chaos.json``'s four faults on workers 4-7 of the MLP
     (phocas b = 8), 20 steps on sync_ps and async_ps: lost rounds, b_eff
     of each degraded round, the m' of every K1 launch; kill-and-resume
     (checkpoint every 5 steps, resume from step 10) equal to the
     uninterrupted run bit for bit, and again after corrupting the newest
     checkpoint (the restore falls back to ``.prev``);
   - compression: the MLP with topk 0.05 under bitplane_flip q = 4,
     streaming with int8, signvote with signbit: wire bytes a round
     against dense, finite losses;
   - all nine ``examples/scenarios/*.json``, unchanged, on the card;
4. trace: for both models, plain and defended, the CNN multikrum cell and
   the CNN on async_ps (trmean) and streaming (phocas), the untraced step
   time and one torch.profiler run giving the device's busy share and its
   top kernels;
5. flash attention: K6 against its plain version on the card (bf16 within
   3e-2 at granite-8b's prefill (8, 512, 32/8, 128), at (1, 4096, 32/8,
   128), at internvl2-26b's prefill (4, 512, 48/8, 128), at a tile edge
   (2, 129, 32/8, 128, window 64), at a gemma2-like (1, 2048, 8/4, 256,
   window 1024, cap 50) and at a ragged S = 96; f32 at hd 64 within
   2e-3), each call repeated bit for bit; timed beside its bound, its
   plain version and, at the granite shapes,
   ``scaled_dot_product_attention`` (which the port never calls) with the
   ratio K6 / SDPA, also at internvl2's shape;
6. serving: ``run_experiment`` of ``examples/scenarios/serve_gaussian.json``
   with granite-8b at full width (36 layers, bf16, random weights from the
   seed), k = 3 replicas (one corrupted), phocas b = 1, 8 slots, 16 requests
   of 512-token prompts and 32 new tokens; then the same requests through a
   single-replica engine on the honest parameters.  Checks: K6 launches =
   36 x 3 x prefill groups, one K3 launch per decode step and prefill
   group, every request's robust tokens equal to the single replica's, and
   exactly the corrupted replica ejected; then a shorter traced serving run
   for the device's busy share and K6's share of the prefill time;
7. LM training at full width through ``runner.plan_from_parts`` and the
   sync_ps loop, m workers of 2 x 128 tokens from the token stream, phocas
   b = q = 2 under omniscient q = 2, SGD lr 0.5, remat "full":
   - cell A, gemma2-2b (d_model 2304, 8/4 heads, hd 256, d_ff 9216, vocab
     256,000, window 4096 / global, softcaps, tied, bf16) cut to 2 layers
     (745.5 M parameters), m = 8: 10 steps, then defended 6 steps (one K3
     launch a step), then remat "none" and "dots" 2 steps each; peak
     device memory of each; a profiler trace of 3 steps; K1 and K3 on its
     (8, 745.5 M) f32 worker matrix (offsets past 2^31): both aggregates
     equal to their plain versions bit for bit on the first and last 2^22
     columns, K3's counts equal to the plain counts summed over column
     chunks, both timed on the whole matrix beside their bound;
   - cell B, deepseek-v2-lite-16b (MLA kv_lora 512, 64 routed experts
     top-6 and 2 shared, vocab 102,400, bf16) cut to 1 layer (1.004 B
     parameters), m = 8: 6 steps; K1 and K3 held and timed on its
     (8, 1.004 B) matrix as on cell A's; then 16 tokens decoded through
     the latent cache against the forward pass at capacity factor 8.0,
     within 0.1 in bf16;
   - per run: finite losses, the last below the first, K1 (K3 defended)
     launches equal to the steps, no K6 launch, peak below 80 GB;
   - the reference's ``examples/byzantine_train.py`` (gemma2-2b-reduced,
     m = 8, 20 steps) on sync_ps and streaming, mean beside phocas;
9. the rest of the LM zoo (after phase 7, before the report), each
   configuration freed before the next:
   - training at full width through ``runner.plan_from_parts`` and the
     sync_ps loop, bf16, phocas b = q under omniscient q, SGD at LM_LR
     (0.5), 0.1 for C and E (``tools/zoo_lr_probe.py``), remat "full",
     2 sequences a worker: cell C, mamba2-2.7b (d_model 2560,
     state 128, 80 SSD heads of 64) cut to 8 layers, m = 8, 512 tokens (two
     SSD chunks), 10 steps then 6 defended (one K3 launch a step); cell D,
     hymba-1.5b (window 1024 attention beside the SSD) cut to 8 layers,
     m = 8, 512 tokens, 10 steps; cell E, whisper-large-v3 cut to 4 + 4
     layers, m = 8, 128 decoder tokens and (2, 1500, 1280) f32 frame
     embeddings a worker drawn on the card from the step's seed, 10 steps;
     cell F, internvl2-26b cut to 1 layer, m = 4, b = q = 1, 512 tokens of
     which 256 are patches (embeddings drawn as E's), 6 steps.  Per run:
     finite losses, the last below the first, K1 (K3 defended) launches
     equal to the steps, no K6 launch, peak below 80 GB; the median step
     ms and the peak are printed, and the SSD's share of cell C's step
     (``ssd_chunked`` forward and backward timed at the cell's shapes);
     K1 and K3 held and timed on each cell's worker matrix as on cell A's
     ((8, 579.2 M), (8, 487.0 M), (8, 370.4 M) at b = 2 and (4, 1,584.8 M)
     at b = 1, all past 2^31 elements);
   - decode against forward in f32 at cells C-E's depth and full width,
     within atol 2e-3 + rtol 1e-3: mamba2's 512-step recurrence against
     the two-chunk SSD, hymba over 96 tokens, whisper's 32 tokens after
     ``prefill_cache`` on 1,500 frames;
   - serving at full depth in bf16, twice each with the tokens equal and
     the logits finite: ``generate`` on 4 prompts of 64 tokens + 32 new for
     mamba2-2.7b (64 layers) and hymba-1.5b (32), ``prefill_cache`` on
     4 x 1,500 frames and 32 greedy decode steps for whisper-large-v3
     (32 + 32), ``generate`` on 4 prompts of 512 tokens + 32 new for
     internvl2-26b (48 layers, 19.9 B parameters) with K6 launched 48
     times per prefill call; tokens/s and the ms of one decode step;
   (phase 5 also holds K6 at internvl2's prefill shape (4, 512, 48/8, 128)
   and times it beside SDPA);
10. the mesh (after phase 3b): one world of 20 gloo ranks on the card, one
   rank per device of the (data, model) mesh, the world also holding a
   (10, 2) grid's groups:
   - (i) aggregation through ``robust_aggregate_dist`` on the paper's
     worker matrices, (20, 118,282) and (20, 2,430,826) f32 drawn from the
     seed, rank r owning row r, in both layouts: phocas b = 8 and trmean
     b = 6 under signflip and omniscient q = 6, plain and defended (scores,
     one worker ejected), equal to ``aggregate_matrix`` on the whole matrix
     bit for bit; K3/K4's counts on the 20 slices, summed, equal to the
     whole matrix's as integers; krum and multikrum q = 6 (K5 on each
     slice) selecting as the local path; bitflip q = 8 on the MLP matrix
     against the local path on the slice-wise attacked matrix; the (10, 2)
     grid over the CNN's gradient tree (m = 10), model-sharded leaves cut
     to blocks and all_gathered; each kernel against its plain version
     on the matrices the mesh path launches it on (rank 0's slices, clean
     and under omniscient, and the padded wholes of the replicated layout:
     K1-K5 at (20, 5,915), (20, 121,542), (20, 118,300) and
     (20, 2,430,840), K1 on the grid's slice and whole); K1 timed on a
     (20, 121,542) slice, the a2a and all_gather of a CNN row timed;
   - (ii) ``run_experiment`` on "20x1" as each rank, sharded: the MLP
     phocas under bitflip, the CNN trmean under gaussian, the defended MLP
     under signflip (every Byzantine worker ejected) and MLP krum under
     gaussian, 10 steps each, and the MLP under signflip in the replicated
     layout for 5: finite falling losses, one K1/K2/K3/K5 launch a step on
     every rank, params bit-equal across ranks, step time and peak memory
     on rank 0; then one ``run_experiment`` of the sharded MLP from this
     process, which spawns its own 20 ranks; both 5-step runs held to the
     single-process run within rtol 1e-4, atol 1e-5; the spawn time of
     each world printed;
8. report: the card's name and power limit, one JSON line describing every
   kernel (launches include rank 0's in phase 10), and as the last line
   ``{"ok": true, "device": {...}}``.

TF32 is off for matmuls and cuDNN convolutions throughout.  Without a CUDA
device the script exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from typing import NamedTuple

import torch

REPO = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory (NVIDIA data sheet)
F32_OPS_PER_S = 67e12            # H100 SXM f32 outside the tensor cores
BF16_TC_OPS_PER_S = 989e12       # H100 SXM bf16/f16 tensor cores, dense
SHAPES = ((20, 118_282), (20, 2_430_826))   # MLP and CNN worker matrices
BS = (0, 2, 6, 8, 9)
ATOL = 1e-4
# Per kernel: its source, the TPU kernel it replaces, the main-path shape and
# b its numbers are reported at, and the compares it does per coordinate for
# m workers (K3 takes m distances, counts those below the best window's score
# and walks the workers once, about 4m; K4 counts the keys below its two
# thresholds and walks the workers once, about 8m).
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
        "shape": SHAPES[0], "b": 8, "compares": lambda m: 4 * m},
    "trmean_counts": {
        "source": "src/repro_torch/kernels/csrc/trmean_counts.cu",
        "replaces": "src/repro/kernels/trmean/kernel.py:130",
        "shape": SHAPES[1], "b": 6, "compares": lambda m: 8 * m},
    # K5 does m(m+1)/2 multiply-adds (two operations each) per coordinate
    # and writes an (m, m) f32 matrix; its numbers are at the CNN width.
    "krum_gram": {
        "source": "src/repro_torch/kernels/csrc/krum_gram.cu",
        "replaces": "src/repro/kernels/krum/kernel.py:36",
        "shape": SHAPES[1], "b": None, "compares": lambda m: m * (m + 1)},
    # K6's numbers are at granite-8b's prefill shape (flash_phase).
    "flash_attn": {
        "source": "src/repro_torch/kernels/csrc/flash_attn.cu",
        "replaces": "src/repro/kernels/flashattn/kernel.py:80"},
}
TRIM_KERNELS = ("phocas", "trmean", "phocas_counts", "trmean_counts")
GRAM_MS = (5, 64, 100)          # worker counts beyond the main path's m
# Worker counts past the register kernels' 64, where K1-K4 run their
# shared-memory variants; K1/K2 sort in one warp's registers up to
# build.WARP_SORT_MAX_M (1,024) and in shared memory past it (wide_phase
# also runs them at build.WARP_SORT_MAX_M + 1).
WIDE_MS = (65, 80, 96, 128, 200, 1024)
# K1's shapes (m, d, b, dtype): the CNN and MLP widths of the paper's runs,
# the serving run's logits, and past 64 workers m = 128 and the defended
# m = 96 run's.
K1_SHAPES = ((20, 2_430_826, 8, torch.float32),
             (20, 2_430_826, 8, torch.bfloat16),
             (20, 118_282, 8, torch.float32),
             (3, 8 * 49_152, 1, torch.float32),
             (128, 118_282, 32, torch.float32),
             (96, 118_282, 24, torch.float32))
SERVE_LOGITS = (3, 8 * 49_152)   # robust decode: k = 3 replicas x 8 slots'
                                 # granite-8b logits


def wrappers() -> dict:
    """Kernel name -> (wrapper with its launch count, plain version)."""
    from repro_torch.kernels.phocas.kernel import (phocas_counts_hopper,
                                                   phocas_hopper)
    from repro_torch.kernels.phocas.ref import phocas_counts_ref, phocas_ref
    from repro_torch.kernels.trmean.kernel import (trmean_counts_hopper,
                                                   trmean_hopper)
    from repro_torch.kernels.trmean.ref import trmean_counts_ref, trmean_ref
    from repro_torch.kernels.krum.kernel import pairwise_sq_dists_hopper
    from repro_torch.kernels.krum.ref import pairwise_sq_dists_ref
    from repro_torch.kernels.flashattn.kernel import flash_attention_hopper
    from repro_torch.kernels.flashattn.ref import flash_attention_ref
    return {"phocas": (phocas_hopper, phocas_ref),
            "trmean": (trmean_hopper, trmean_ref),
            "phocas_counts": (phocas_counts_hopper, phocas_counts_ref),
            "trmean_counts": (trmean_counts_hopper, trmean_counts_ref),
            "krum_gram": (pairwise_sq_dists_hopper, pairwise_sq_dists_ref),
            "flash_attn": (flash_attention_hopper, flash_attention_ref)}


class SmokeError(AssertionError):
    """A check of this script failed."""


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeError(msg)


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def adversarial_matrices(m: int, d: int, gen: torch.Generator):
    """The inputs each kernel is held to, as (name, (m, d) f32 on cuda).
    The special rows are taken modulo m, so any m >= 1 works."""
    from repro_torch.core.attacks import bitflip_attack
    base = 3.0 + torch.randn((m, d), generator=gen, device=gen.device)
    dups = torch.round(2.0 * base) / 2.0          # exact boundary ties
    big = base.clone()
    big[3 % m] = -1e20
    big[11 % m] = 1e20
    big[5 % m, ::7] = -1e20
    nonfinite = base.clone()
    nonfinite[2 % m, ::10] = float("nan")
    nonfinite[7 % m, 1::10] = float("inf")
    nonfinite[9 % m, 2::10] = float("-inf")
    nonfinite[4 % m, 3::13] = float("nan")
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
    before each launch (the bound counts every byte from device memory).
    A ~60 us spin kernel after the flush keeps the device busy while the
    host enqueues the start event and ``fn``'s launches, so a slow host
    (the wrapper's checks and allocations) does not show as device time."""
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.int32, device="cuda")
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(100_000)
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
    written once (the (d,) f32 aggregate, and m counts for K3/K4; the
    (m, m) f32 distances for K5) at the card's memory rate, or its compares
    (K5: multiply-adds, two operations each) at the card's f32 rate."""
    if kname == "krum_gram":
        out_bytes = m * m * 4
    else:
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


def tie_matrix(m: int, d: int, gen: torch.Generator) -> torch.Tensor:
    """Tie-heavy (m, d) f32 on cuda: values in {-1, 0, 1}, a constant row
    block and a row of alternating +-inf."""
    u = torch.randint(-1, 2, (m, d), generator=gen, device=gen.device).float()
    u[m // 3:m // 3 + max(1, m // 4)] = 0.0
    u[m - 1, ::2] = float("inf")
    u[m - 1, 1::2] = float("-inf")
    return u


def same(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Equal bit for bit, with NaN where the other has NaN."""
    return (torch.equal(torch.isnan(got), torch.isnan(want))
            and torch.equal(torch.nan_to_num(got), torch.nan_to_num(want)))


def tie_check(kname: str, u: torch.Tensor, b: int,
              label: str = "ties") -> None:
    """A kernel against its plain version on a tie-heavy matrix (or on
    another, named by ``label``): the aggregate equal bit for bit (NaN
    where the plain version has NaN) and, for a counts kernel, the counts
    equal as integers."""
    kernel, ref = wrappers()[kname]
    got, want = kernel(u, b), ref(u, b)
    torch.cuda.synchronize()
    tag = f"{kname} {label} {tuple(u.shape)} b={b}"
    if kname.endswith("_counts"):
        check(torch.equal(got[1], want[1]),
              f"{tag}: counts {got[1].tolist()} != plain {want[1].tolist()}")
        got, want = got[0], want[0]
    check(same(got, want), f"{tag}: aggregate differs")


def tie_phase(gen: torch.Generator) -> None:
    """K3 and K4 against their plain versions on the tie-heavy matrix, for
    every b."""
    for m, d in SHAPES:
        u = tie_matrix(m, d, gen)
        for b in BS:
            for kname in ("trmean_counts", "phocas_counts"):
                tie_check(kname, u, b)
    print(f"trmean_counts and phocas_counts == plain on the tie-heavy matrix "
          f"at {list(SHAPES)} for b in {list(BS)}: counts and aggregate equal "
          f"bit for bit: ok")


def kernel_phase(gen: torch.Generator) -> dict:
    pairs = {k: v for k, v in wrappers().items() if k in TRIM_KERNELS}
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
    tie_phase(gen)
    for kname in pairs:
        print(f"  {kname}: max|kernel - plain| = "
              f"{report[kname]['max_abs_err']:.3e} (limit {ATOL})")

    print("timing (median of 15, L2 flushed before each launch):")
    times = {}
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
                times[kname, d, b] = k_ms
    for m, d in SHAPES:
        print(f"  K4 / K2 at ({m}, {d:,}), b=6: "
              f"{times['trmean_counts', d, 6] / times['trmean', d, 6]:.2f}; "
              f"K3 / K1 at b=8: "
              f"{times['phocas_counts', d, 8] / times['phocas', d, 8]:.2f}")
    serve_logits_phase(gen, pairs, report)
    return report


def serve_logits_phase(gen: torch.Generator, pairs: dict,
                       report: dict) -> None:
    """K1 and K3 at the serving run's logits (3, 8 x 49,152) with b = 1, the
    shape robust decode gives them: each against its plain version on
    Gaussian logits and the adversarial matrices (counts equal as
    integers), then both timed beside their plain versions and bounds.  At
    this d K1's one-wave grid gives each thread a second column."""
    u = torch.randn(SERVE_LOGITS, generator=gen, device=gen.device)
    mats = [("logits", u)] + adversarial_matrices(*SERVE_LOGITS, gen)
    for kname in ("phocas", "phocas_counts"):
        kernel, ref = pairs[kname]
        for mname, x in mats:
            got = kernel(x, 1)
            want = ref(x, 1)
            torch.cuda.synchronize()
            err = compare_kernel(kname, x, 1, got, want)
            report[kname]["max_abs_err"] = max(report[kname]["max_abs_err"],
                                               err)
            if err:
                print(f"  {kname} {SERVE_LOGITS} {mname} b=1: max|diff| "
                      f"{err:.3e}")
    print(f"phocas and phocas_counts == plain at the serving logits "
          f"{SERVE_LOGITS} for b=1 on logits/gauss/duplicates/pm1e20/nan_inf/"
          f"bitflip, counts equal: ok")
    for kname in ("phocas", "phocas_counts"):
        kernel, ref = pairs[kname]
        bnd, bound_by = bound_ms(kname, *SERVE_LOGITS, 4)
        k_ms = time_ms(lambda: kernel(u, 1))
        p_ms = time_ms(lambda: ref(u, 1), reps=5)
        print(f"  {kname:13s} serving logits {SERVE_LOGITS} b=1: kernel "
              f"{k_ms:.4f} ms  plain {p_ms:.3f} ms  bound {bnd * 1e3:.2f} us "
              f"({bound_by})  {bnd / k_ms:.1%} of bound")


def register_phase(gen: torch.Generator, report: dict) -> None:
    """K1-K4 in the register bucket of every m in 1..64, at d = 4,099,
    against their plain versions: the tie-heavy matrix bit for bit, the
    others by compare_kernel, counts equal as integers."""
    from repro_torch.kernels import build
    pairs = {k: v for k, v in wrappers().items() if k in TRIM_KERNELS}
    d = 4099
    for m in range(1, build.REGISTER_BUCKETS[-1] + 1):
        bmax = (m + 1) // 2 - 1
        bs = sorted({0, 1, m // 4, bmax} & set(range(bmax + 1)))
        mats = adversarial_matrices(m, d, gen)
        for mname, u in mats + [("ties", tie_matrix(m, d, gen))]:
            for b in bs:
                for kname, (kernel, ref) in pairs.items():
                    if mname == "ties":
                        tie_check(kname, u, b)
                        continue
                    err = compare_kernel(kname, u, b, kernel(u, b), ref(u, b))
                    report[kname]["max_abs_err"] = max(
                        report[kname]["max_abs_err"], err)
    torch.cuda.synchronize()
    print(f"register buckets {build.REGISTER_BUCKETS}: {list(pairs)} == plain "
          f"at every m in 1..64, d = {d:,}, b in {{0, 1, m/4, (m+1)//2 - 1}} "
          f"on gauss/duplicates/pm1e20/nan_inf/bitflip, the tie-heavy matrix "
          f"bit for bit, counts equal: ok")


def k1_shape_phase(gen: torch.Generator, report: dict) -> None:
    """K1 at each of K1_SHAPES against its plain version, then timed beside
    its bound and ``torch.sum(u, 0)``, a library read of the same bytes
    under the same timing, as a floor."""
    from repro_torch.kernels.phocas.kernel import phocas_hopper
    from repro_torch.kernels.phocas.ref import phocas_ref
    print("K1 at its shapes (== plain; median of 15, L2 flushed):")
    for m, d, b, dtype in K1_SHAPES:
        u = (3.0 + torch.randn((m, d), generator=gen, device=gen.device)
             ).to(dtype)
        err = compare("phocas", u, b, phocas_hopper(u, b), phocas_ref(u, b))
        report["phocas"]["max_abs_err"] = max(report["phocas"]["max_abs_err"],
                                              err)
        bnd, bound_by = bound_ms("phocas", m, d, u.element_size())
        k_ms = time_ms(lambda: phocas_hopper(u, b))
        floor_ms = time_ms(lambda: torch.sum(u, 0))
        print(f"  phocas ({m}, {d:,}) b={b} {str(dtype)[6:]}: kernel "
              f"{k_ms:.4f} ms  sum(u, 0) {floor_ms:.4f} ms  bound "
              f"{bnd * 1e3:.2f} us ({bound_by})  {bnd / k_ms:.1%} of bound, "
              f"kernel / floor {k_ms / floor_ms:.2f}")


def wide_bs(m: int) -> list:
    bmax = (m + 1) // 2 - 1
    return sorted({0, 2, m // 4, bmax})


def wide_phase(gen: torch.Generator, report: dict) -> None:
    """K1-K4 past the register kernels' m = 64, on their shared-memory
    variants (K1/K2 also just past the warp-register sort):
    each against its plain version at d = 118,282 on the adversarial
    matrices and the tie-heavy matrix (there bit for bit) for b in {0, 2,
    m/4, (m+1)//2 - 1}, counts equal as integers; then each kernel's time
    beside its bound at m = 128."""
    from repro_torch.kernels import build
    pairs = {k: v for k, v in wrappers().items() if k in TRIM_KERNELS}
    d = SHAPES[0][1]
    switch_m = build.WARP_SORT_MAX_M + 1
    for m in (*WIDE_MS, switch_m):
        names = list(pairs) if m != switch_m else ["phocas", "trmean"]
        mats = adversarial_matrices(m, d, gen)
        for mname, u in mats:
            for b in wide_bs(m):
                for kname in names:
                    kernel, ref = pairs[kname]
                    got = kernel(u, b)
                    want = ref(u, b)
                    torch.cuda.synchronize()
                    err = compare_kernel(kname, u, b, got, want)
                    report[kname]["max_abs_err"] = max(
                        report[kname]["max_abs_err"], err)
                    if err:
                        print(f"  {kname} ({m}, {d}) {mname} b={b}: "
                              f"max|diff| {err:.3e}")
        del mats
        x = adversarial_matrices(m, d, gen)[0][1].to(torch.bfloat16)
        for kname in names:
            kernel, ref = pairs[kname]
            err = compare_kernel(kname, x, m // 4, kernel(x, m // 4),
                                 ref(x, m // 4))
            report[kname]["max_abs_err"] = max(
                report[kname]["max_abs_err"], err)
        u = tie_matrix(m, d, gen)
        for b in wide_bs(m):
            for kname in names:
                tie_check(kname, u, b)
        print(f"wide variant m={m}: {names} == plain at ({m}, {d:,}) for b "
              f"in {wide_bs(m)} on gauss/duplicates/pm1e20/nan_inf/bitflip "
              f"(+bf16 at b={m // 4}), counts equal; on the tie-heavy matrix "
              f"bit for bit: ok")
    m = 128
    u = adversarial_matrices(m, d, gen)[0][1]
    for kname, (kernel, ref) in pairs.items():
        b = m // 4
        bnd, bound_by = bound_ms(kname, m, d, 4)
        k_ms = time_ms(lambda: kernel(u, b))
        p_ms = time_ms(lambda: ref(u, b), reps=5)
        print(f"  {kname:13s} wide m={m} d={d:,} b={b}: kernel {k_ms:.4f} ms "
              f" plain {p_ms:.3f} ms  bound {bnd * 1e3:.2f} us ({bound_by})  "
              f"{bnd / k_ms:.1%} of bound")


def compare_gram(tag: str, u: torch.Tensor, got: torch.Tensor,
                 want: torch.Tensor, want64: torch.Tensor) -> tuple:
    """K5 against its plain version: NaN and +-inf at the same places, an
    exactly symmetric output, and finite entries within the reference's
    bound for the Gram form, 1e-6 * max + 1e-3 (the two sum the products in
    another order).  The finite entries are held to the plain version
    evaluated in f64 (``want64``, the same function on the same inputs):
    at d = 2,430,826 the f32 plain version's own rounding (``torch.mm``'s
    long f32 accumulations) reaches the bound by itself, so two f32
    evaluations cannot be told apart from a wrong kernel there; its
    distance from f64 is returned beside the kernel's.  Two stated
    exceptions: the max is taken over the finite n_i + n_j as well as over
    the distances, since the Gram form's rounding scales with the squared
    norms (on Gaussian rows at scale 10 the two are equal; on rows around 3
    the norms are ~5x the distances); and the diagonal is held to exactly 0
    in the kernel (its n_i is its own G_ii) where the plain version's
    n_i + n_i - 2 G_ii keeps the difference of two roundings of one sum.
    Returns max |diff| off the diagonal of the kernel and of the f32 plain
    version, each against f64."""
    for f in (torch.isnan, torch.isposinf, torch.isneginf):
        check(torch.equal(f(got), f(want)),
              f"krum_gram {tag}: non-finite entries differ ({f.__name__})")
    check(torch.equal(torch.nan_to_num(got), torch.nan_to_num(got.T)),
          f"krum_gram {tag}: output not symmetric")
    m = got.shape[0]
    diag = torch.diagonal(got)
    fin_diag = torch.isfinite(torch.diagonal(want))
    check(bool((diag[fin_diag] == 0).all()),
          f"krum_gram {tag}: a finite row's own distance is not 0")
    off = ~torch.eye(m, dtype=torch.bool, device=got.device)
    fin = torch.isfinite(want) & off
    if not fin.any():
        return 0.0, 0.0
    uf = u.float()
    sq = (uf * uf).sum(dim=1)
    pair = sq[:, None] + sq[None, :]
    scale = max(want[fin].abs().max().item(),
                pair[torch.isfinite(pair) & fin].abs().max().item())
    exact = want64[fin]
    err = (got[fin].double() - exact).abs().max().item()
    plain_err = (want[fin].double() - exact).abs().max().item()
    tol = 1e-6 * scale + 1e-3
    check(err <= tol, f"krum_gram {tag}: max|diff| {err} > {tol} (f32 "
                      f"plain version: {plain_err})")
    return err, plain_err


def gram_phase(gen: torch.Generator) -> dict:
    """K5 against its plain version at the paper's widths on the adversarial
    matrices and Gaussian rows at scale 10, at more worker counts, and in
    bf16/f16; then its time beside its bound, its plain version and the
    library's ``torch.mm(u, u.T)`` (TF32 off), which the port never calls."""
    kernel, ref = wrappers()["krum_gram"]
    report = {"max_abs_err": 0.0}
    plain_err = 0.0

    def run(tag, u):
        nonlocal plain_err
        got = kernel(u)
        want = ref(u)
        want64 = ref(u, torch.float64)
        torch.cuda.synchronize()
        err, perr = compare_gram(tag, u, got, want, want64)
        report["max_abs_err"] = max(report["max_abs_err"], err)
        plain_err = max(plain_err, perr)
        check(torch.equal(kernel(u).view(torch.int32), got.view(torch.int32)),
              f"krum_gram {tag}: not bitwise repeatable")

    for m, d in SHAPES:
        mats = adversarial_matrices(m, d, gen)
        mats.append(("gauss10", 10.0 * mats[0][1]))
        for mname, u in mats:
            run(f"({m}, {d}) {mname}", u)
        for dtype in (torch.bfloat16, torch.float16):
            run(f"({m}, {d}) {dtype}", mats[-1][1].to(dtype))
        print(f"krum_gram == plain at ({m}, {d}) on gauss/duplicates/pm1e20/"
              f"nan_inf/bitflip/gauss10, f32 (+bf16/f16): ok")
    for m in GRAM_MS:
        d = SHAPES[0][1]
        u = 10.0 * torch.randn((m, d), generator=gen, device="cuda")
        run(f"({m}, {d}) gauss10", u)
        u[m // 2, ::7] = float("nan")
        u[m - 1, 3::11] = float("inf")
        u[0] = 1e20
        run(f"({m}, {d}) nonfinite", u)
    print(f"krum_gram == plain for m in {list(GRAM_MS)} at d={SHAPES[0][1]:,}"
          f": ok; max|kernel - plain in f64| = {report['max_abs_err']:.3e}, "
          f"max|plain in f32 - plain in f64| = {plain_err:.3e} (limit "
          f"1e-6 * max + 1e-3)")
    for m, d in SHAPES:
        u = adversarial_matrices(m, d, gen)[0][1]
        bnd, bound_by = bound_ms("krum_gram", m, d, 4)
        k_ms = time_ms(lambda: kernel(u))
        p_ms = time_ms(lambda: ref(u))
        lib_ms = time_ms(lambda: torch.mm(u, u.T))
        print(f"  krum_gram     m={m} d={d:>9,}: kernel {k_ms:.4f} ms  plain "
              f"{p_ms:.4f} ms  torch.mm {lib_ms:.4f} ms  bound "
              f"{bnd * 1e3:.2f} us ({bound_by})  {bnd / k_ms:.1%} of bound")
        if (m, d) == KERNEL_META["krum_gram"]["shape"]:
            report.update(ms=k_ms, plain_ms=p_ms, bound_ms=bnd,
                          bound_by=bound_by, library_ms=lib_ms)
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


def vector_spec(kind: str, rule: str, steps: int, defended: bool = False):
    """The Fig. 2 classic-attack baselines at full width: ``rule`` (krum,
    multikrum, ...) under gaussian q = 6 (the paper's q for gaussian), on
    the MLP at lr 0.1 or the CNN at lr 0.02 (as the trmean cell, for the
    reason given in ``paper_spec``)."""
    import dataclasses

    from repro_torch.core.attacks import AttackConfig
    from repro_torch.core.robust import RobustConfig
    spec = paper_spec(kind, steps, defended)
    return dataclasses.replace(
        spec, name=f"chip-smoke-{kind}-{rule}",
        robust=RobustConfig(rule=rule, b=6, q=6),
        attack=AttackConfig(name="gaussian", num_byzantine=6))


def wide_spec():
    """The defended MLP cell at m = 96 workers, past the register kernels'
    64: phocas b = 24 under signflip q = 24 (a quarter of the workers
    Byzantine, b = q), 12 steps."""
    import dataclasses

    from repro_torch.core.attacks import AttackConfig
    from repro_torch.core.robust import RobustConfig
    spec = paper_spec("mlp", 12, defended=True)
    return dataclasses.replace(
        spec, name="chip-smoke-mlp-m96", num_workers=96,
        robust=RobustConfig(rule="phocas", b=24, q=24),
        attack=AttackConfig(name="signflip", num_byzantine=24))


def launch_counts(run) -> tuple:
    """Run ``run()`` with every kernel's count set to 0 just before; return
    its result and the counts read just after."""
    ws = {k: w for k, (w, _) in wrappers().items()}
    for w in ws.values():
        w.launches = 0
    out = run()
    torch.cuda.synchronize()
    return out, {k: w.launches for k, w in ws.items()}


def train_run(kind: str, steps: int, defended: bool, spec=None):
    """One full-width run through run_experiment (``spec``, by default the
    paper cell of ``paper_spec``); checks its losses and prints its outcome.
    Returns (result, launch counts)."""
    from repro_torch.experiment import run_experiment
    from repro_torch.tree import leaves
    spec = spec or paper_spec(kind, steps, defended)
    t0 = time.perf_counter()
    res, counts = launch_counts(lambda: run_experiment(spec))
    wall = time.perf_counter() - t0
    tag = f"{kind} {spec.robust.rule}{' defended' if defended else ''}"
    losses = [r["loss"] for r in res.history]
    d = sum(x.numel() for x in leaves(res.params))
    walls = [r["wall"] for r in res.history]
    step_ms = sorted(1e3 * (b - a) for a, b in zip(walls[1:], walls[2:]))
    print(f"{tag}: d={d:,} m={spec.num_workers} rule={spec.robust.rule} "
          f"b={spec.robust.b} "
          f"q={spec.robust.q} attack={spec.attack.name} "
          f"q_atk={spec.attack.num_byzantine} steps={steps}")
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


def ejection_report(kind: str, res) -> int:
    """Print the defense's outcome and check that every Byzantine worker
    (the first q) ends ejected; returns the count of gated steps."""
    spec = res.spec
    m, q = spec.num_workers, spec.attack.num_byzantine
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
    return gated


def defended_checks(kind: str, res, counts: dict) -> None:
    """Every Byzantine worker (the first q) ends ejected; one counts-kernel
    launch per step; one aggregate-kernel launch per step that began with a
    worker ejected (the gate short-circuits while all are active)."""
    spec = res.spec
    steps, rule = spec.steps, spec.robust.rule
    gated = ejection_report(kind, res)
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

    # Past m = 64: the defended MLP at m = 96 runs K3 and K1 on their
    # shared-memory variant.
    res, counts = train_run("mlp", 12, True, wide_spec())
    defended_checks("mlp", res, counts)
    check(counts["phocas"] > 0, f"mlp m=96: no gated step ran K1 ({counts})")
    print(f"  m=96 > 64: K3 {counts['phocas_counts']} and K1 "
          f"{counts['phocas']} launches on the shared-memory variant: ok")

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


class Recording:
    """Record, while active, every Krum score vector the rules compute
    (``aggregators._nearest_sums``, behind the raw and the gated scores on
    both backends) and every aggregate ``robust.aggregate_matrix`` returns,
    so that two runs can be compared selection by selection."""

    def __init__(self):
        self.scores, self.aggs = [], []

    def __enter__(self):
        from repro_torch.core import aggregators, robust
        self._saved = (aggregators._nearest_sums, robust.aggregate_matrix)
        nearest, aggregate = self._saved

        def rec_nearest(d2, k):
            out = nearest(d2, k)
            self.scores.append(out.detach().cpu())
            return out

        def rec_aggregate(*args, **kw):
            out = aggregate(*args, **kw)
            agg = out[0] if isinstance(out, tuple) else out
            self.aggs.append(agg.detach().cpu())
            return out

        aggregators._nearest_sums = rec_nearest
        robust.aggregate_matrix = rec_aggregate
        return self

    def __exit__(self, *exc):
        from repro_torch.core import aggregators, robust
        aggregators._nearest_sums, robust.aggregate_matrix = self._saved

    def selections(self, rule: str, k: int) -> list:
        from repro_torch.core.aggregators import lowest_scores
        if rule == "krum":
            return [int(torch.argmin(s)) for s in self.scores]
        return [lowest_scores(s, k).tolist() for s in self.scores]


def small_vector_runs(rule: str) -> None:
    """m = 8 runs of ``rule`` on the kernel and the plain backend, plain and
    defended: every step selects the same workers, and the aggregates agree
    within 1e-5 (the distances are summed in another order)."""
    from repro_torch.core.attacks import AttackConfig
    from repro_torch.core.robust import RobustConfig
    from repro_torch.defense import read_jsonl
    from repro_torch.experiment import (DataSpec, ModelSpec, ScenarioSpec,
                                        run_experiment)
    for defended in (False, True):
        recs, tel, counts = {}, {}, {}
        for backend in ("pallas", "xla"):
            if defended:
                path = os.path.join(REPO, "build", "chip_smoke",
                                    f"{rule}-{backend}.jsonl")
                if os.path.exists(path):
                    os.remove(path)
                spec = small_defended_spec(rule, backend, path)
            else:
                spec = ScenarioSpec(
                    model=ModelSpec(kind="mlp"),
                    data=DataSpec(dim=16, batch_per_worker=4),
                    robust=RobustConfig(rule=rule, q=2, backend=backend),
                    attack=AttackConfig(name="signflip", num_byzantine=2),
                    num_workers=8, steps=5, log_every=1)
            with Recording() as rec:
                _, counts[backend] = launch_counts(
                    lambda: run_experiment(spec))
            recs[backend] = rec
            if defended:
                tel[backend] = [r for r in read_jsonl(path)
                                if r["kind"] == "train"]
        tag = f"{rule}{' defended' if defended else ''}"
        steps = spec.steps
        check(counts["pallas"]["krum_gram"] == steps
              and sum(counts["pallas"].values()) == steps,
              f"small {tag}: kernel path launches {counts['pallas']}")
        check(sum(counts["xla"].values()) == 0,
              f"small {tag}: plain path launches {counts['xla']}")
        ka, pa = recs["pallas"], recs["xla"]
        sel = ka.selections(rule, 8 - 2 - 2)
        check(len(ka.scores) == len(pa.scores) == steps * (1 + defended),
              f"small {tag}: {len(ka.scores)}/{len(pa.scores)} score vectors")
        check(sel == pa.selections(rule, 8 - 2 - 2),
              f"small {tag}: selections differ: {sel} vs "
              f"{pa.selections(rule, 4)}")
        err = max((a - b).abs().max().item()
                  for a, b in zip(ka.aggs, pa.aggs))
        check(len(ka.aggs) == len(pa.aggs) == steps and err <= 1e-5,
              f"small {tag}: aggregates differ by {err}")
        if defended:
            a, b = tel["pallas"], tel["xla"]
            for key in ("active", "q_hat"):
                check([r[key] for r in a] == [r[key] for r in b],
                      f"small {tag}: {key} differs between the paths")
            for key in ("suspicion", "reputation"):
                d = max(abs(x - y) for ra, rb in zip(a, b)
                        for x, y in zip(ra[key], rb[key]))
                check(d <= 1e-5, f"small {tag}: {key} differs by {d}")
        print(f"small run ({tag}, m=8, signflip q=2, {steps} steps): kernel "
              f"path == plain path, selections {sel[:3]}... equal, "
              f"aggregates max diff {err:.2e}; kernel launches "
              f"{counts['pallas']['krum_gram']}")


def vector_phase() -> dict:
    """The vector-wise rules at full width through run_experiment: MLP krum
    and CNN multikrum under gaussian q = 6, MLP krum defended; one K5 launch
    per step in each.  Then the small kernel-vs-plain runs, and one short
    run of each rule that has no kernel (geomedian, mediam, mom)."""
    launches = {}
    for kind, rule, steps, defended in (("mlp", "krum", 30, False),
                                        ("cnn", "multikrum", 20, False),
                                        ("mlp", "krum", 30, True)):
        res, counts = train_run(kind, steps, defended,
                                vector_spec(kind, rule, steps, defended))
        want = {k: 0 for k in counts}
        want["krum_gram"] = steps
        check(counts == want, f"{kind} {rule}: launches {counts}, expected "
                              f"{want}")
        if defended:
            ejection_report(kind, res)
        elif kind == "mlp":
            launches["krum_gram"] = counts["krum_gram"]
    for rule in ("krum", "multikrum"):
        small_vector_runs(rule)
    for rule in ("geomedian", "mediam", "mom"):
        _, counts = train_run("mlp", 5, False,
                              vector_spec("mlp", rule, 5))
        check(sum(counts.values()) == 0,
              f"{rule} launched kernels: {counts}")
    return launches


# ---------------------------------------------------------------------------
# phase 3b: the other topologies, faults, resume and compression
# ---------------------------------------------------------------------------

CHAOS_WORKERS = (4, 5, 6, 7)     # sync_ps_chaos.json's faults, on these
STEP_SPANS = ("train_step", "degraded_round", "async_step",
              "streaming_step")


def chaos_faults() -> tuple:
    """The four faults of ``examples/scenarios/sync_ps_chaos.json`` (crash
    at step 2, straggler, flaky p 0.3, a silent pod), on workers 4-7."""
    from repro_torch.experiment import ScenarioSpec
    faults = ScenarioSpec.load(os.path.join(
        REPO, "examples", "scenarios", "sync_ps_chaos.json")).faults
    check(tuple(w for f in faults for w in f.workers) == CHAOS_WORKERS,
          f"sync_ps_chaos.json's faults moved: {faults}")
    return faults


def traced_run(tag: str, spec, spans: bool = True, **kw):
    """run_experiment of ``spec`` with its JSONL under
    build/chip_smoke/<tag>.jsonl, kernel counts set to 0 just before and
    read just after.  Returns (result, counts, records, step ms): with
    ``spans`` the recorder is on and the step ms is the median of the
    synchronized step spans, else the run's host-clock wall time over its
    steps (the reference's recorder cannot count fault retries while it
    mirrors the fault records' fields into gauges of the same name, so the
    fault runs go without it; ROADMAP queue 3)."""
    import dataclasses

    from repro_torch.defense import read_jsonl
    from repro_torch.experiment import run_experiment
    from repro_torch.obs import ObsConfig
    path = os.path.join(REPO, "build", "chip_smoke", f"{tag}.jsonl")
    if os.path.exists(path):
        os.remove(path)
    spec = dataclasses.replace(spec, telemetry_path=path)
    t0 = time.perf_counter()
    res, counts = launch_counts(lambda: run_experiment(
        spec, obs=ObsConfig() if spans else None, **kw))
    wall = time.perf_counter() - t0
    records = read_jsonl(path)
    if not spans:
        return res, counts, records, 1e3 * wall / spec.steps
    ms = sorted(r["ms"] for r in records
                if r["kind"] == "span" and r["name"] in STEP_SPANS)
    return res, counts, records, ms[len(ms) // 2]


def finite_params(tag: str, res) -> None:
    from repro_torch.tree import leaves
    check(all(bool(torch.isfinite(x).all()) for x in leaves(res.params)),
          f"{tag}: non-finite parameters")


def async_phase() -> None:
    """async_ps at full width: the MLP (phocas b = 8 under bitflip q = 8,
    staleness 4, update_clip 10, lr 0.1, 30 steps), the same run defended
    under signflip q = 8, and the CNN (trmean b = 6 under gaussian q = 6,
    lr 0.02, 10 steps).  One aggregate launch a step (K1 or K2), one K3
    launch a defended step; finite parameters and eval rising from the
    initial parameters' to the last step's."""
    import dataclasses

    from repro_torch.experiment import resolve
    for kind, steps, defended, kname in (("mlp", 30, False, "phocas"),
                                         ("mlp", 30, True, "phocas_counts"),
                                         ("cnn", 10, False, "trmean")):
        spec = dataclasses.replace(
            paper_spec(kind, steps, defended), topology="async_ps",
            topology_params={"staleness": 4, "update_clip": 10.0})
        tag = f"async {kind} {spec.robust.rule}" + (" defended" if defended
                                                     else "")
        # eval of the parameters the run starts from (AsyncPS seeds them
        # from spec.seed), then of each step's
        plan = resolve(spec)
        ev0 = float(plan.eval_fn(plan.model.init(
            torch.Generator(device="cuda").manual_seed(spec.seed))))
        res, counts, _, ms = traced_run(tag.replace(" ", "-"), spec)
        ev = [r["eval"] for r in res.history]
        line = (f"{tag} (m=20, staleness 4, {spec.attack.name} "
                f"q={spec.attack.num_byzantine}, {steps} steps): step "
                f"{ms:.2f} ms (median, synchronized span), eval {ev0:.4f} "
                f"at init, {ev[0]:.4f} after step 0, {ev[-1]:.4f} after the "
                f"last, launches {counts}")
        if defended:
            active = res.defense_state["active"].tolist()
            q = spec.attack.num_byzantine
            line += (f", ejected Byzantine {sum(a == 0 for a in active[:q])}"
                     f"/{q}, benign {sum(a == 0 for a in active[q:])}")
        print(line)
        finite_params(tag, res)
        check(counts[kname] == steps, f"{tag}: {kname} launches {counts}")
        check(ev[-1] > ev0, f"{tag}: eval did not rise ({ev0} -> {ev})")


def streaming_phase() -> None:
    """streaming at the CNN width (trmean and phocas b = 6 under gaussian
    q = 6, lr 0.02, 10 steps) against sync_ps on the same spec: step time
    and peak device memory (reset before each run); the streaming peak must
    be the lower one and its losses finite."""
    import dataclasses

    from repro_torch.core.robust import RobustConfig
    for rule in ("trmean", "phocas"):
        base = dataclasses.replace(
            paper_spec("cnn", 10),
            robust=RobustConfig(rule=rule, b=6, q=6))
        peaks, msd = {}, {}
        for topo in ("streaming", "sync_ps"):
            spec = dataclasses.replace(base, topology=topo)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            res, counts, _, msd[topo] = traced_run(
                f"{topo}-cnn-{rule}", spec)
            peaks[topo] = torch.cuda.max_memory_allocated()
            losses = [r["loss"] for r in res.history]
            check(all(x == x and abs(x) != float("inf") for x in losses),
                  f"{topo} cnn {rule}: non-finite loss {losses}")
            if topo == "streaming":
                check(sum(counts.values()) == 0,
                      f"streaming launched kernels: {counts}")
                s_loss = losses
        print(f"streaming cnn {rule} b=6 (m=20, gaussian q=6, 10 steps): "
              f"step {msd['streaming']:.2f} ms vs sync_ps "
              f"{msd['sync_ps']:.2f} ms; peak memory "
              f"{peaks['streaming'] / 2**20:.1f} MiB vs sync_ps "
              f"{peaks['sync_ps'] / 2**20:.1f} MiB "
              f"({peaks['streaming'] / peaks['sync_ps']:.2f}x); loss "
              f"{s_loss[0]:.4f} -> {s_loss[-1]:.4f}")
        check(peaks["streaming"] < peaks["sync_ps"],
              f"streaming cnn {rule}: peak {peaks} not below sync_ps")


def corrupt(path: str) -> None:
    with open(path, "r+b") as f:
        f.seek(30)
        f.write(b"\xff" * 8)


def fault_phase() -> None:
    """The chaos faults on the MLP (phocas b = 8 under bitflip q = 8, m =
    20, 20 steps) on sync_ps and async_ps: lost rounds, b_eff per degraded
    round and the m' of every K1 launch; then kill-and-resume on sync_ps
    (checkpoint every 5 steps, resume from step 10) equal to the
    uninterrupted run bit for bit, and again from a corrupted newest
    checkpoint, which falls back to its .prev."""
    import dataclasses

    from repro_torch.kernels import ops
    from repro_torch.tree import leaves
    faults = chaos_faults()
    for topo in ("sync_ps", "async_ps"):
        spec = dataclasses.replace(
            paper_spec("mlp", 20), faults=faults, topology=topo,
            topology_params=({"staleness": 4, "update_clip": 10.0}
                             if topo == "async_ps" else {}))
        k1_ms, k1 = [], ops.phocas_hopper

        def recording(u, b):
            k1_ms.append(u.shape[0])
            return k1(u, b)

        ops.phocas_hopper = recording
        try:
            res, counts, recs, ms = traced_run(f"faults-{topo}", spec,
                                               spans=False)
        finally:
            ops.phocas_hopper = k1
        frecs = [r for r in recs if r["kind"] == "fault"]
        lost = sum(1 for r in frecs if r.get("lost_round"))
        b_eff = sorted({(r["present"], r["b_eff"]) for r in frecs
                        if "b_eff" in r})
        present = sorted({r["present"] for r in frecs})
        print(f"faults {topo} mlp phocas b=8 (chaos on workers 4-7 of 20, "
              f"20 steps): {ms:.2f} ms a step (host clock, whole run incl. "
              f"init and eval), lost rounds {lost}, present "
              f"{present}, (m', b_eff) {b_eff or 'n/a (slots kept)'}, K1 "
              f"launches {counts['phocas']} at m' {sorted(set(k1_ms))}")
        finite_params(f"faults {topo}", res)
        check(counts["phocas"] == len(k1_ms) == 20 - lost,
              f"faults {topo}: K1 launches {counts}, {len(k1_ms)} seen")
        if topo == "sync_ps":
            check(bool(k1_ms) and max(k1_ms) < 20
                  and all(m < 20 for m, _ in b_eff),
                  f"faults sync_ps: K1 at m' {k1_ms}")

    ck = os.path.join(REPO, "build", "chip_smoke", "ckpt")
    for suffix in ("full", "run"):
        for ext in (".npz", ".json", ".prev.npz", ".prev.json"):
            if os.path.exists(f"{ck}-{suffix}{ext}"):
                os.remove(f"{ck}-{suffix}{ext}")
    from repro_torch.experiment import run_experiment
    base = dataclasses.replace(paper_spec("mlp", 20), faults=faults,
                               checkpoint_every=5)
    full = run_experiment(dataclasses.replace(
        base, checkpoint_path=ck + "-full"))
    killed = dataclasses.replace(base, steps=11, checkpoint_path=ck + "-run")
    run_experiment(killed)                      # checkpoints at 5 and 10
    resumed = run_experiment(dataclasses.replace(killed, steps=20),
                             resume=killed.checkpoint_path)
    same = all(torch.equal(a, b) for a, b in zip(leaves(resumed.params),
                                                  leaves(full.params)))
    check(same, "resume from step 10: params differ from the "
                "uninterrupted run")
    corrupt(killed.checkpoint_path + ".npz")    # the step-15 checkpoint
    again = run_experiment(dataclasses.replace(killed, steps=20),
                           resume=killed.checkpoint_path)
    same_prev = all(torch.equal(a, b) for a, b in zip(leaves(again.params),
                                                       leaves(full.params)))
    check(again.history[0]["step"] == 11 and same_prev,
          "resume from the .prev checkpoint: params differ")
    print(f"kill-and-resume (sync_ps mlp, chaos, checkpoint every 5): "
          f"resumed from step 10 == uninterrupted run bit for bit; newest "
          f"checkpoint corrupted -> .prev (step 10) used, again bit for bit")


def compression_phase() -> None:
    """The MLP (phocas b = 8) on sync_ps with topk ratio 0.05 under
    bitplane_flip q = 4; streaming with int8 under gaussian q = 4; signvote
    (lr 0.001, signSGD's step) with signbit under bitplane_flip q = 4: wire
    bytes a round against dense, finite losses, K1 once a step through the
    decoded matrix."""
    import dataclasses

    from repro_torch.compress import CompressionSpec
    from repro_torch.core.attacks import AttackConfig
    from repro_torch.core.robust import RobustConfig
    for topo, codec, rule, attack in (
            ("sync_ps", CompressionSpec(codec="topk", ratio=0.05), "phocas",
             "bitplane_flip"),
            ("streaming", CompressionSpec(codec="int8"), "phocas",
             "gaussian"),
            ("sync_ps", CompressionSpec(codec="signbit"), "signvote",
             "bitplane_flip")):
        spec = dataclasses.replace(
            paper_spec("mlp", 20), topology=topo, compression=codec,
            robust=RobustConfig(rule=rule, b=8, q=8),
            attack=AttackConfig(name=attack, num_byzantine=4))
        if rule == "signvote":
            # signSGD moves every coordinate by lr a step: at the MLP's
            # 0.1 the loss climbs from the first steps
            spec = dataclasses.replace(spec, opt=dataclasses.replace(
                spec.opt, lr=0.001))
        tag = f"compressed {topo} mlp {rule} {codec.codec}"
        res, counts, recs, ms = traced_run(tag.replace(" ", "-"), spec)
        wire = [r for r in recs if r["kind"] == "compress"]
        losses = [r["loss"] for r in res.history]
        print(f"{tag} ({attack} q=4, 20 steps): step {ms:.2f} ms, "
              f"{wire[-1]['bytes']:,} wire bytes a round vs "
              f"{wire[-1]['dense_bytes']:,} dense ({wire[-1]['ratio']:.4f}),"
              f" loss {losses[0]:.4f} -> {losses[-1]:.4f}, launches "
              f"{counts}")
        check(len(wire) == 20, f"{tag}: {len(wire)} compress records")
        check(all(x == x and abs(x) != float("inf") for x in losses),
              f"{tag}: non-finite loss {losses}")
        want = 20 if (topo, rule) == ("sync_ps", "phocas") else 0
        check(counts["phocas"] == want and sum(counts.values()) == want,
              f"{tag}: launches {counts}")


def scenario_phase() -> None:
    """All nine ``examples/scenarios/*.json`` through run_experiment on the
    card, unchanged: each completes with finite losses (or, on async_ps,
    finite parameters; on serve, its requests done)."""
    import glob

    from repro_torch.experiment import ScenarioSpec, run_experiment
    paths = sorted(glob.glob(os.path.join(REPO, "examples", "scenarios",
                                          "*.json")))
    check(len(paths) == 9, f"{len(paths)} scenarios")
    done = []
    for path in paths:
        spec = ScenarioSpec.load(path)
        res = run_experiment(spec)
        name = os.path.basename(path)
        if spec.topology == "serve":
            check(res.final_metrics["completed"] > 0, f"{name}: none done")
        else:
            finite_params(name, res)
            losses = [r["loss"] for r in res.history if "loss" in r]
            check(all(x == x and abs(x) != float("inf") for x in losses),
                  f"{name}: non-finite loss {losses}")
            check(len(res.history) == spec.steps, f"{name}: history")
        done.append(name[:-5])
    print(f"scenarios on the card: all {len(done)} complete ({', '.join(done)})")


def topology_phase() -> None:
    t0 = time.perf_counter()
    async_phase()
    streaming_phase()
    fault_phase()
    compression_phase()
    scenario_phase()
    print(f"phase 3b: {time.perf_counter() - t0:.1f} s")


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

    from repro_torch.core.robust import RobustConfig
    from repro_torch.experiment import run_experiment
    runs = []
    for kind, defended, n, rule in (
            ("mlp", False, steps, None), ("cnn", False, steps, None),
            ("mlp", True, defended_steps, None),
            ("cnn", True, defended_steps, None),
            ("cnn", False, steps, "multikrum")):
        spec = (vector_spec(kind, rule, n) if rule else
                paper_spec(kind, n, defended))
        runs.append((f"{kind} {spec.robust.rule}"
                     f"{' defended' if defended else ''}", spec, n))
    # phase 3b's CNN cells on the other topologies
    runs.append(("async_ps cnn trmean", dataclasses.replace(
        paper_spec("cnn", steps), topology="async_ps",
        topology_params={"staleness": 4, "update_clip": 10.0}), steps))
    runs.append(("streaming cnn phocas", dataclasses.replace(
        paper_spec("cnn", 4), topology="streaming",
        robust=RobustConfig(rule="phocas", b=6, q=6)), 4))
    for tag, spec, n in runs:
        spec = dataclasses.replace(spec, log_every=n)
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
        for e in kernels:              # the port's own kernels, wherever
            if "repro_torch::" in e.key:  # they rank
                print(f"    port kernel {e.self_device_time_total / busy / 1e6:6.1%}"
                      f" of busy, {e.self_device_time_total / 1e3 / n:.4f} ms"
                      f"/step  n={e.count:4d}  {e.key[:60]}")


# ---------------------------------------------------------------------------
# phase 5: flash attention against its plain version
# ---------------------------------------------------------------------------

# (name, B, S, H, Kv, hd, dtype, window, cap); S == T, causal.
FLASH_CASES = (
    ("granite_prefill", 8, 512, 32, 8, 128, torch.bfloat16, None, None),
    ("granite_4k", 1, 4096, 32, 8, 128, torch.bfloat16, None, None),
    ("internvl2_prefill", 4, 512, 48, 8, 128, torch.bfloat16, None, None),
    ("tile_edge", 2, 129, 32, 8, 128, torch.bfloat16, 64, None),
    ("gemma2_like", 1, 2048, 8, 4, 256, torch.bfloat16, 1024, 50.0),
    ("ragged96", 2, 96, 4, 2, 64, torch.bfloat16, None, None),
    ("granite_prefill_hd64_f32", 8, 512, 32, 8, 64, torch.float32, None,
     None),
    ("ragged96_f32", 2, 96, 4, 2, 64, torch.float32, None, None),
)
FLASH_TOL = {torch.float32: 2e-3, torch.bfloat16: 3e-2}


def flash_bound_ms(B, S, H, Kv, hd, dtype, window) -> tuple:
    """Least time for one call: q, k, v read once and o written once at the
    card's memory rate, or 4 * hd operations per unmasked (query, key) pair
    and head at the tensor cores' bf16 rate (f32: the f32 rate, as the
    kernel runs f32 outside the tensor cores)."""
    es = torch.tensor([], dtype=dtype).element_size()
    nbytes = (2 * B * S * H * hd + 2 * B * S * Kv * hd) * es
    w = window or S
    pairs = sum(min(i + 1, w) for i in range(S))
    ops = 4 * hd * B * H * pairs
    rate = BF16_TC_OPS_PER_S if dtype != torch.float32 else F32_OPS_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / rate * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations"), nbytes, ops


def flash_phase(gen: torch.Generator) -> dict:
    """K6 against its plain version on every case, a bitwise repeat of
    each call, then the time of the kernel, the plain version and (granite
    shapes) SDPA with GQA, the yardstick the port never calls."""
    import torch.nn.functional as F
    kernel, ref = wrappers()["flash_attn"]
    report = {"max_abs_err": 0.0}
    print("flash attention (causal, S == T; CUDA events, median of 15, L2 "
          "flushed):")
    for name, B, S, H, Kv, hd, dtype, window, cap in FLASH_CASES:
        q = torch.randn((B, S, H, hd), generator=gen, device="cuda").to(dtype)
        k = torch.randn((B, S, Kv, hd), generator=gen, device="cuda").to(dtype)
        v = torch.randn((B, S, Kv, hd), generator=gen, device="cuda").to(dtype)
        kw = dict(causal=True, window=window, cap=cap)
        got = kernel(q, k, v, **kw)
        want = ref(q, k, v, **kw)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got.float()).all()),
              f"flash {name}: non-finite output")
        err = (got.float() - want.float()).abs().max().item()
        check(err <= FLASH_TOL[dtype],
              f"flash {name}: max|kernel - plain| {err} > {FLASH_TOL[dtype]}")
        check(torch.equal(kernel(q, k, v, **kw), got),
              f"flash {name}: not bitwise repeatable")
        if dtype == torch.bfloat16:
            report["max_abs_err"] = max(report["max_abs_err"], err)
        bnd, bound_by, nbytes, ops = flash_bound_ms(B, S, H, Kv, hd, dtype,
                                                    window)
        k_ms = time_ms(lambda: kernel(q, k, v, **kw))
        p_ms = time_ms(lambda: ref(q, k, v, **kw), reps=5)
        line = (f"  {name:25s} ({B}, {S}, {H}/{Kv}, {hd}) {str(dtype)[6:]}"
                f" window={window} cap={cap}: max|diff| {err:.3e} (limit "
                f"{FLASH_TOL[dtype]}), repeat bitwise; kernel {k_ms:.4f} ms "
                f" plain {p_ms:.3f} ms  bound {bnd * 1e3:.2f} us "
                f"({bound_by}; {nbytes / 1e6:.1f} MB, {ops / 1e9:.1f} "
                f"GFLOP)  {bnd / k_ms:.1%} of bound")
        lib_ms = None
        if (name.startswith(("granite", "internvl2"))
                and dtype == torch.bfloat16):
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            sd = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                enable_gqa=True)
            torch.cuda.synchronize()
            sd_err = (sd.transpose(1, 2).float() - want.float()).abs().max()
            lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True))
            line += (f"  sdpa {lib_ms:.4f} ms (max|sdpa - plain| "
                     f"{sd_err.item():.3e}); K6 / SDPA {k_ms / lib_ms:.2f}")
        print(line)
        if name == "granite_prefill":
            report.update(ms=k_ms, plain_ms=p_ms, bound_ms=bnd,
                          bound_by=bound_by, library_ms=lib_ms)
    print(f"flash == plain on {len(FLASH_CASES)} cases (bf16 within 3e-2, "
          f"f32 within 2e-3), bitwise repeatable: ok")
    return report


# ---------------------------------------------------------------------------
# phase 6: serving granite-8b at full width
# ---------------------------------------------------------------------------

SERVE_PARAMS = {"replicas": 3, "max_slots": 8, "max_seq_len": 640,
                "block_tokens": 16, "num_requests": 16, "arrival_rate": 2.0,
                "prompt_len": 512, "max_new_tokens": 32}


def serve_spec(**overrides):
    """``examples/scenarios/serve_gaussian.json`` with granite-8b at full
    width and the serving load of SERVE_PARAMS (phocas b = 1, gaussian
    corrupting one replica, as the scenario has them)."""
    import dataclasses

    from repro_torch.experiment import ScenarioSpec
    spec = ScenarioSpec.load(os.path.join(REPO, "examples", "scenarios",
                                          "serve_gaussian.json"))
    return dataclasses.replace(
        spec, name="chip-smoke-serve-granite-8b",
        model=dataclasses.replace(spec.model, arch="granite-8b"),
        topology_params={**SERVE_PARAMS, **overrides})


def serve_outcome(tag: str, m: dict) -> None:
    print(f"  {tag}: completed {m['completed']:.0f}, tokens "
          f"{m['tokens']:.0f}, {m['tokens_per_sec']:.1f} tokens/s, latency "
          f"p50 {m['latency_p50_ms']:.1f} ms p99 {m['latency_p99_ms']:.1f} "
          f"ms, TTFT p50 {m['ttft_p50_ms']:.1f} ms, engine steps "
          f"{m['engine_steps']:.0f}"
          + (f", ejected replicas {m['ejected_replicas']:.0f}"
             if "ejected_replicas" in m else ""))


def serve_phase() -> dict:
    """The robust run through run_experiment, then the same arrivals
    through a single-replica engine on the honest parameters, whose prefill
    and decode calls it counts."""
    from repro_torch.configs import get_arch
    from repro_torch.experiment import run_experiment
    from repro_torch.experiment.topologies import (drive_arrivals,
                                                   poisson_arrivals)
    from repro_torch.models.registry import build_model
    from repro_torch.serve import RobustDecoder, ServeEngine, make_replicas
    from repro_torch.tree import leaves
    spec = serve_spec()
    tp = spec.topology_params
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res, counts = launch_counts(lambda: run_experiment(spec))
    wall = time.perf_counter() - t0
    m = res.final_metrics
    honest = res.params[0]
    n_params = sum(x.numel() for x in leaves(honest))
    cfg = get_arch(spec.model.arch)
    print(f"serving {cfg.name} ({cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.param_dtype}, "
          f"{n_params / 1e9:.2f} B parameters): "
          f"k=3 phocas b=1, replica 2 corrupted, 8 slots, "
          f"{tp['num_requests']} requests x {tp['max_new_tokens']} new "
          f"tokens, prompts of {tp['prompt_len']}, arrival rate "
          f"{tp['arrival_rate']}/step; run {wall:.1f} s incl. init, peak "
          f"device memory {torch.cuda.max_memory_allocated() / 2**30:.1f} "
          f"GiB; launches {counts}")
    serve_outcome("robust", m)
    active = res.defense_state["active"].tolist()
    robust = {r.rid: r.generated for r in res.requests}
    res.params = None                       # frees the corrupted replica
    check(m["completed"] == tp["num_requests"],
          f"serve: {m['completed']} of {tp['num_requests']} completed")
    check(active == [1.0, 1.0, 0.0] and m["ejected_replicas"] == 1,
          f"serve: active {active}, expected only replica 2 ejected")

    calls = {"prefill": 0, "decode": 0}
    engine = ServeEngine(build_model(cfg), honest,
                         max_slots=tp["max_slots"],
                         max_seq_len=tp["max_seq_len"],
                         block_tokens=tp["block_tokens"])
    for name in calls:
        inner = getattr(engine, f"_{name}_fn")

        def counted(*a, _inner=inner, _name=name):
            calls[_name] += 1
            return _inner(*a)
        setattr(engine, f"_{name}_fn", counted)
    due, prompts = poisson_arrivals(spec.seed, tp["num_requests"],
                                    tp["arrival_rate"], tp["prompt_len"],
                                    engine.model.cfg.vocab_size)
    t0 = time.perf_counter()
    _, single_counts = launch_counts(lambda: drive_arrivals(
        engine, due, prompts, tp["max_new_tokens"], spec.steps,
        spec.record_every()))
    s_wall = time.perf_counter() - t0
    single = {r.rid: r.generated for r in engine.scheduler.completed}
    s_tokens = sum(len(g) for g in single.values())
    print(f"  single replica (same arrivals, honest parameters): "
          f"{s_tokens / s_wall:.1f} tokens/s, {engine.steps_run} engine "
          f"steps, {calls['prefill']} prefill groups, {calls['decode']} "
          f"decode steps; launches {single_counts}")
    check(engine.steps_run == m["engine_steps"],
          f"serve: single engine ran {engine.steps_run} steps, robust "
          f"{m['engine_steps']}")
    groups, decodes = calls["prefill"], calls["decode"]
    layers = engine.model.cfg.num_layers
    check(single_counts["flash_attn"] == layers * groups,
          f"serve single: K6 launches {single_counts['flash_attn']} != "
          f"{layers} x {groups}")
    check(counts["flash_attn"] == layers * 3 * groups,
          f"serve: K6 launches {counts['flash_attn']} != {layers} x 3 x "
          f"{groups}")
    check(counts["phocas_counts"] == decodes + groups,
          f"serve: K3 launches {counts['phocas_counts']} != {decodes} decode "
          f"steps + {groups} prefill groups")
    check(0 < counts["phocas"] <= decodes + groups,
          f"serve: K1 launches {counts['phocas']} (gated steps)")
    same = sum(robust[rid] == single[rid] for rid in single)
    check(sorted(robust) == sorted(single) and same == len(single),
          f"serve: robust tokens equal single-replica tokens for {same} of "
          f"{len(single)} requests")
    print(f"  robust tokens == single-replica tokens for all {same} "
          f"requests; K6 launches {counts['flash_attn']} = {layers} x 3 x "
          f"{groups} prefill groups; K3 {counts['phocas_counts']} = {decodes} decode "
          f"steps + {groups} groups; K1 {counts['phocas']} (gated); only "
          f"replica 2 ejected: ok")
    # The reference's serve budget compares these two: one all-slots decode
    # call with k = 3 replicas against a single replica.
    single_ms = engine.time_decode_step(iters=10)
    triple = ServeEngine(engine.model, make_replicas(honest, 3),
                         max_slots=tp["max_slots"],
                         max_seq_len=tp["max_seq_len"],
                         block_tokens=tp["block_tokens"],
                         decoder=RobustDecoder(rule="phocas", k=3, b=1,
                                               device=engine.device))
    triple_ms = triple.time_decode_step(iters=10)
    print(f"  decode step over all {tp['max_slots']} slots (median of 10, "
          f"host clock, synchronized): single {single_ms:.2f} ms, k=3 "
          f"phocas {triple_ms:.2f} ms = {triple_ms / single_ms:.2f}x")
    del engine, triple, honest
    torch.cuda.empty_cache()
    return {"flash_attn": counts["flash_attn"]}


def serve_trace_phase() -> None:
    """One shorter robust serving run (8 requests x 8 new tokens) with the
    engine's spans on, under torch.profiler: the device's busy share of the
    run, its top kernels, and K6's share of the device time inside the
    prefill spans."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.experiment import run_experiment
    from repro_torch.obs import ObsConfig
    spec = serve_spec(num_requests=8, max_new_tokens=8)
    obs = ObsConfig(enabled=True, trace=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        res = run_experiment(spec, obs=obs)
    traced = res.wall_time
    events = prof.key_averages()
    # The spans appear on the device timeline too, as ranges around the
    # kernels they launched: kernels are the device events that are not.
    span_names = ("prefill", "decode")
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.key not in span_names]
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    check(busy > 0, "serve trace: the profiler saw no device time")
    serve_outcome("traced robust run (8 requests x 8 new tokens)",
                  res.final_metrics)
    launches = sum(e.count for e in kernels)
    steps = res.final_metrics["engine_steps"]
    print(f"  serve trace: serving loop {traced * 1e3:.1f} ms (host clock, "
          f"spans synchronized), kernels busy {busy * 1e3:.1f} ms = "
          f"{busy / traced:.1%} of it; {launches} kernel launches in "
          f"{steps:.0f} engine steps")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"    {e.self_device_time_total / busy / 1e6:6.1%}  "
              f"n={e.count:5d}  {e.key[:100]}")
    flash = sum(e.self_device_time_total for e in kernels
                if "flash_fwd" in e.key) / 1e6
    spans = {e.key: e.device_time_total / 1e6 for e in events
             if e.key in span_names}
    pre = spans.get("prefill", 0.0)
    print(f"  device time in spans (first to last kernel, idle gaps "
          f"included): prefill {pre * 1e3:.1f} ms, decode "
          f"{spans.get('decode', 0.0) * 1e3:.1f} ms; K6 {flash * 1e3:.2f} ms"
          + (f" = {flash / pre:.1%} of the prefill's device time"
             if pre > 0 else " (the profiler gave the prefill spans no "
                             "device time)"))
    check(flash > 0, "serve trace: no K6 time in the trace")


# ---------------------------------------------------------------------------
# phase 7: LM training at full width
# ---------------------------------------------------------------------------

# (arch, layers kept): gemma2-2b cut from 26 to one local/global period,
# deepseek-v2-lite-16b from 27 to one MoE + MLA layer.
LM_CELLS = {"A": ("gemma2-2b", 2), "B": ("deepseek-v2-lite-16b", 1)}
LM_M, LM_SEQS, LM_SEQ_LEN, LM_B = 8, 2, 128, 2   # byzantine_train.py's
LM_LR = 0.5              # byzantine_train.py's SGD rate (PERF.md §6)
LM_EDGE = 1 << 22        # K1/K3 held bit for bit on the first and last
                         # LM_EDGE columns of an LM's worker matrix
LM_COUNT_CHUNK = 1 << 24  # K3's plain counts summed over column chunks
                          # (a chunk's f32 count is an exact integer)
LM_DECODE = 16           # cell B: latent-cache decode length
LM_DECODE_ATOL = 0.1     # bf16 logits: test_torch_lm.py's bf16 bound


def arch_cfg(name: str, layers=None, dtype: str = "bfloat16", **changes):
    """``name``'s published config, cut to ``layers`` (enc-dec: encoder
    and decoder each), in ``dtype``, with ``changes``."""
    import dataclasses

    from repro_torch.configs import get_arch
    cfg = get_arch(name)
    cut = {} if layers is None else {"num_layers": layers}
    if cfg.is_encdec and layers is not None:
        cut["encoder_layers"] = layers
    return dataclasses.replace(cfg, param_dtype=dtype, compute_dtype=dtype,
                               **cut, **changes)


def lm_model(cell: str, remat: str = "full", **changes):
    from repro_torch.models.registry import build_model
    name, layers = LM_CELLS[cell]
    return build_model(arch_cfg(name, layers, **changes), remat=remat)


def sync_plan(model, batch_fn, *, m: int, b: int, steps: int,
              defended: bool = False, lr: float = LM_LR, tag: str,
              spans: bool = True):
    """A sync_ps plan through ``runner.plan_from_parts``: m workers, phocas
    b = q = ``b`` under omniscient q = ``b``, SGD at ``lr``; with ``spans``
    the recorder times each step (synchronized) into a JSONL under
    build/chip_smoke/."""
    from repro_torch.core.attacks import AttackConfig
    from repro_torch.core.robust import RobustConfig
    from repro_torch.defense import DefenseConfig
    from repro_torch.experiment.runner import plan_from_parts
    from repro_torch.obs import ObsConfig
    from repro_torch.optim import OptConfig
    path = os.path.join(REPO, "build", "chip_smoke", f"lm-{tag}.jsonl")
    if os.path.exists(path):
        os.remove(path)
    return plan_from_parts(
        model=model, batch_fn=batch_fn,
        robust_cfg=RobustConfig(rule="phocas", b=b, q=b,
                                attack=AttackConfig(name="omniscient",
                                                    num_byzantine=b)),
        opt_cfg=OptConfig(name="sgd", lr=lr),
        num_workers=m, steps=steps, seed=0, record_every=1,
        defense_cfg=DefenseConfig() if defended else None,
        telemetry_path=path if spans else None,
        obs=ObsConfig() if spans else None, device="cuda")


def lm_plan(cell: str, *, steps: int, remat: str = "full",
            defended: bool = False, lr: float = LM_LR, tag: str = "",
            spans: bool = True):
    """Cell ``cell``'s sync_ps plan (:func:`sync_plan`): LM_M workers of
    LM_SEQS sequences of LM_SEQ_LEN tokens from the token stream, phocas
    b = q = LM_B."""
    from repro_torch.data.pipeline import TokenStream
    model = lm_model(cell, remat)
    stream = TokenStream(vocab_size=model.cfg.vocab_size, seq_len=LM_SEQ_LEN,
                         global_batch=LM_M * LM_SEQS, seed=0,
                         device="cuda")
    return sync_plan(model, stream.batch, m=LM_M, b=LM_B, steps=steps,
                     defended=defended, lr=lr, tag=tag or cell, spans=spans)


def lm_run(tag: str, plan, remat: str = "full") -> dict:
    """Run ``plan`` with the kernel counts set to 0 just before and read
    just after, and the peak memory reset before; print and check its
    outcome (finite losses, no K6 launch, peak below the card's 80 GB).
    Returns the run's numbers."""
    import gc

    from repro_torch.defense import read_jsonl
    from repro_torch.experiment.topology import make_topology
    from repro_torch.tree import size
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res, counts = launch_counts(lambda: make_topology(plan.topology).run(plan))
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    ms = sorted(r["ms"] for r in read_jsonl(plan.telemetry_path)
                if r["kind"] == "span" and r["name"] in STEP_SPANS)
    losses = [r["loss"] for r in res.history if "loss" in r]
    rc = plan.robust_cfg
    out = {"d": size(res.params), "losses": losses,
           "step_ms": ms[len(ms) // 2], "peak_gib": peak / 2**30,
           "launches": counts, "res": res}
    print(f"{tag}: d={out['d']:,} m={plan.num_workers} {rc.rule} b={rc.b} "
          f"q={rc.q} {rc.attack.name} q_atk={rc.attack.num_byzantine} "
          f"lr={plan.opt_cfg.lr} remat={remat} steps={plan.steps}: loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}, step {out['step_ms']:.1f} "
          f"ms (median synchronized span; slowest {ms[-1]:.1f}), peak "
          f"{out['peak_gib']:.2f} GiB, run {wall:.1f} s, launches {counts}")
    check(len(losses) == plan.steps, f"{tag}: {len(losses)} loss records")
    check(all(x == x and abs(x) != float("inf") for x in losses),
          f"{tag}: non-finite loss in {losses}")
    check(counts["flash_attn"] == 0,
          f"{tag}: K6 launched in training ({counts})")
    check(peak < 80e9, f"{tag}: peak {peak / 1e9:.1f} GB")
    finite_params(tag, res)
    return out


def lm_cell(cell: str, steps: int, defended_steps: int = 0,
            remat_steps: int = 0) -> dict:
    """Train cell ``cell`` plain (remat "full"), then defended, then with
    remat "none" and "dots"; K1 (K3 defended) launches equal to the steps,
    the last loss below the first.  Returns the K1/K3 launch counts."""
    launches, _ = train_cell(
        f"cell {cell} {LM_CELLS[cell][0]}",
        lambda steps, tag, **kw: lm_plan(cell, steps=steps,
                                         tag=tag.replace("@", cell), **kw),
        LM_M, steps, defended_steps)
    name = LM_CELLS[cell][0]
    if remat_steps:
        peaks = {}
        for remat in ("none", "dots"):
            out = lm_run(f"cell {cell} {name} remat {remat}", lm_plan(
                cell, steps=remat_steps, remat=remat,
                tag=f"{cell}-{remat}"), remat)
            peaks[remat] = out["peak_gib"]
            check(out["launches"]["phocas"] == remat_steps
                  and out["losses"][-1] < out["losses"][0],
                  f"cell {cell} remat {remat}: launches "
                  f"{out['launches']}, losses {out['losses']}")
            launches["phocas"] += out["launches"]["phocas"]
            del out
        print(f"  remat peaks: none {peaks['none']:.2f} GiB, dots "
              f"{peaks['dots']:.2f} GiB")
    return launches


def train_cell(tag: str, plan_fn, m: int, steps: int,
               defended_steps: int = 0) -> tuple:
    """Train ``plan_fn(steps, tag)`` plain, then ``plan_fn(steps, tag,
    defended=True)``; K1 (K3 defended, and K1 on each gated step) launches
    equal to the steps, the last loss below the first (``tag``'s "@" in the
    JSONL names stands for the cell).  Returns the launch counts and the
    plain run's median step ms."""
    plain = lm_run(tag, plan_fn(steps, "@"))
    launches, step_ms = dict(plain["launches"]), plain["step_ms"]
    check(launches["phocas"] == steps and sum(launches.values()) == steps,
          f"{tag}: launches {launches} in {steps} steps")
    losses = plain["losses"]
    check(losses[-1] < losses[0], f"{tag}: loss did not decrease ({losses})")
    del plain
    if defended_steps:
        out = lm_run(f"{tag} defended", plan_fn(defended_steps, "@-defended",
                                                defended=True))
        c = out["launches"]
        gated = sum(1 for r in out["res"].history[:-1] if r["n_active"] < m)
        check(c["phocas_counts"] == defended_steps and c["phocas"] == gated
              and sum(c.values()) == defended_steps + gated,
              f"{tag} defended: launches {c}, {gated} gated steps")
        check(out["losses"][-1] < out["losses"][0],
              f"{tag} defended: loss did not decrease")
        print(f"  defended: final active "
              f"{[int(a) for a in out['res'].defense_state['active']]}, "
              f"q_hat {out['res'].history[-1]['q_hat']}")
        for k, v in c.items():
            launches[k] = launches.get(k, 0) + v
        del out
    return launches, step_ms


def lm_trace(cell: str, steps: int = 3) -> None:
    """One torch.profiler run of ``steps`` of cell ``cell`` (after a run of
    the same steps as warm-up): the device's busy share of the loop and its
    top kernels."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.experiment.topology import make_topology
    make_topology("sync_ps").run(lm_plan(cell, steps=steps, spans=False))
    plan = lm_plan(cell, steps=steps, spans=False)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        make_topology("sync_ps").run(plan)
        torch.cuda.synchronize()
        loop = time.perf_counter() - t0
    events = prof.key_averages()
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    check(busy > 0, f"cell {cell} trace: the profiler saw no device time")
    print(f"cell {cell} trace ({steps} steps): loop {loop * 1e3:.1f} ms, "
          f"kernels busy {busy * 1e3:.1f} ms = {busy / loop:.1%} of it")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"    {e.self_device_time_total / busy / 1e6:6.1%}  "
              f"n={e.count:5d}  {e.key[:100]}")
    host = [e for e in events
            if e.device_type == torch.autograd.DeviceType.CPU]
    for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:8]:
        print(f"    host {e.self_cpu_time_total / 1e3 / steps:9.1f} ms/step"
              f"  n={e.count:6d}  {e.key[:80]}")


def k1_lm_phase(tag: str, plan) -> None:
    """K1 and K3 on the (m, D) worker matrix of ``plan`` at its phocas b
    (the gradients of its first batch at the initial parameters, the
    plan's attack's rows written in place): each aggregate equal to its
    plain version bit for bit on the matrix's first and last LM_EDGE
    columns (the last at element offsets past 2^31), read from the whole
    matrix's launch; K3's counts equal to the plain counts summed as
    integers over column chunks of the whole matrix; then both timed on
    the whole matrix beside their bound."""
    import gc

    from repro_torch.core.attacks import make_attack, writing_in_place
    from repro_torch.core.robust import flatten_stacked
    from repro_torch.data.pipeline import make_worker_batches
    from repro_torch.kernels.phocas.kernel import (phocas_counts_hopper,
                                                   phocas_hopper)
    from repro_torch.kernels.phocas.ref import phocas_counts_ref, phocas_ref
    model, b = plan.model, plan.robust_cfg.b
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    batch = make_worker_batches(plan.batch_fn(0), plan.num_workers)
    grads, _ = torch.func.vmap(torch.func.grad_and_value(model.loss),
                               in_dims=(None, 0))(params, batch)
    u = flatten_stacked(grads)
    del grads, params
    gen = torch.Generator(device="cuda").manual_seed(1)
    with writing_in_place():
        u = make_attack(plan.robust_cfg.attack)(gen, u, 0)
    gc.collect()
    torch.cuda.empty_cache()
    m, d = u.shape
    tag = f"{tag} ({m}, {d:,}) f32, b={b}"
    check(m * d > 2**31, f"{tag}: m*d = {m * d} not past 2^31")
    got1 = phocas_hopper(u, b)
    got3, counts = phocas_counts_hopper(u, b)
    for where, cols in (("last", slice(d - LM_EDGE, d)),
                        ("first", slice(0, LM_EDGE))):
        check(same(got1[cols], phocas_ref(u[:, cols], b)),
              f"{tag}: K1 differs from its plain version on the {where} "
              f"{LM_EDGE:,} columns")
        check(same(got3[cols], phocas_counts_ref(u[:, cols], b)[0]),
              f"{tag}: K3's aggregate differs from its plain version on "
              f"the {where} {LM_EDGE:,} columns")
    del got1, got3
    plain = torch.zeros(m, dtype=torch.int64, device="cuda")
    for s in range(0, d, LM_COUNT_CHUNK):
        plain += phocas_counts_ref(u[:, s:s + LM_COUNT_CHUNK],
                                   b)[1].long()
    check(int(plain.sum()) == b * d,
          f"{tag}: plain counts sum to {int(plain.sum())}, not b*d")
    check(torch.equal(counts, plain.float()),
          f"{tag}: K3 counts {counts.tolist()} != plain {plain.tolist()}")
    t = time_ms(lambda: phocas_hopper(u, b), reps=5)
    t3 = time_ms(lambda: phocas_counts_hopper(u, b), reps=5)
    floor = time_ms(lambda: torch.sum(u, 0), reps=5)
    b1, by1 = bound_ms("phocas", m, d, 4)
    b3, by3 = bound_ms("phocas_counts", m, d, 4)
    print(f"K1 and K3 at {tag}, element offsets to {m * d:,} (past 2^31 = "
          f"{2**31:,}): aggregates equal to the plain versions bit for bit "
          f"on the first and last {LM_EDGE:,} columns; K3 counts "
          f"{plain.tolist()} equal to the plain counts over "
          f"{-(-d // LM_COUNT_CHUNK)} column chunks (compared as K3's f32 "
          f"output); K1 {t:.3f} ms (bound {b1:.3f} ms by {by1}, "
          f"{100 * b1 / t:.0f}%), K3 {t3:.3f} ms (bound {b3:.3f} ms by "
          f"{by3}, {100 * b3 / t3:.0f}%), torch.sum(u, 0) {floor:.3f} ms")
    del u, counts
    gc.collect()
    torch.cuda.empty_cache()


def decode_vs_forward(tag: str, model, n: int, tol: tuple) -> None:
    """``n`` tokens of ``model`` (random weights from the seed) decoded one
    by one through its cache against one forward pass over them (enc-dec:
    after ``prefill_cache`` on its frames), within ``tol`` = (atol, rtol)."""
    from repro_torch.models import encdec
    cfg = model.cfg
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    gen = torch.Generator(device="cuda").manual_seed(2)
    toks = torch.randint(0, cfg.vocab_size, (2, n), generator=gen,
                         device="cuda")
    batch = {"tokens": toks}
    with torch.no_grad():
        cache = model.init_cache(2, n, "cuda")
        if cfg.is_encdec:
            batch["audio_embeds"] = 0.1 * torch.randn(
                (2, cfg.encoder_seq_len, cfg.frontend_dim), generator=gen,
                device="cuda")
            encdec.prefill_cache(params, cfg, cache, batch["audio_embeds"])
        full, _ = model.forward(params, batch)
        outs = []
        for t in range(n):
            lg, cache = model.decode_step(params, cache, toks[:, t:t + 1], t)
            outs.append(lg[:, 0])
    inc = torch.stack(outs, 1)
    atol, rtol = tol
    diff = (inc - full).abs()
    over = (diff - (atol + rtol * full.abs())).max().item()
    agree = (inc.argmax(-1) == full.argmax(-1)).float().mean().item()
    print(f"{tag}: {n} tokens through the cache vs the forward pass: "
          f"max|diff| {diff.max().item():.3e} (bound {atol} + {rtol}|logit|, "
          f"worst margin {-over:.3e}), greedy tokens agree {100 * agree:.0f}%"
          f", |logits| <= {full.abs().max().item():.2f}")
    check(over <= 0, f"{tag}: past the bound by {over}")
    check(bool(torch.isfinite(inc).all()), f"{tag}: non-finite logits")


def lm_example_phase() -> None:
    """The reference's examples/byzantine_train.py through run_experiment on
    the card: gemma2-2b-reduced, m = 8, phocas b = q = 2 under omniscient
    (sync_ps) or gaussian (streaming), 20 steps; mean under the same attack
    beside it.  Phocas's loss must fall."""
    from repro_torch.core.attacks import AttackConfig
    from repro_torch.core.robust import RobustConfig
    from repro_torch.experiment import (DataSpec, ModelSpec, ScenarioSpec,
                                        run_experiment)
    from repro_torch.optim import OptConfig
    for topo, attack in (("sync_ps", "omniscient"), ("streaming",
                                                     "gaussian")):
        out = {}
        for rule, b in (("phocas", 2), ("mean", 0)):
            spec = ScenarioSpec(
                name=f"byz-{rule}", topology=topo,
                model=ModelSpec(kind="arch", arch="gemma2-2b-reduced"),
                data=DataSpec(kind="tokens", seq_len=128,
                              batch_per_worker=2),
                robust=RobustConfig(rule=rule, b=b, q=2),
                attack=AttackConfig(name=attack, num_byzantine=2),
                opt=OptConfig(name="sgd", lr=0.5), num_workers=8, steps=20,
                log_every=1)
            res, counts = launch_counts(lambda: run_experiment(spec))
            out[rule] = [r["loss"] for r in res.history]
            check(counts["flash_attn"] == 0,
                  f"example {topo} {rule}: K6 launched ({counts})")
        ph, mn = out["phocas"], out["mean"]
        print(f"byzantine_train.py on {topo} ({attack} q=2, m=8, 20 steps): "
              f"phocas loss {ph[0]:.3f} -> {ph[-1]:.3f}; mean {mn[0]:.3f} "
              f"-> {mn[-1]:.3f}")
        check(all(x == x and abs(x) != float("inf") for x in ph),
              f"example {topo}: non-finite phocas loss {ph}")
        check(ph[-1] < ph[0], f"example {topo}: phocas loss did not fall")


def lm_phase() -> dict:
    """Phase 7: cells A and B, K1 at the LM shape, cell B's decode and the
    reference's LM example.  Returns the K1/K3 launches of the cells."""
    t0 = time.perf_counter()
    launches = lm_cell("A", steps=10, defended_steps=6, remat_steps=2)
    lm_trace("A")
    k1_lm_phase("cell A", lm_plan("A", steps=1, spans=False))
    for k, v in lm_cell("B", steps=6).items():
        launches[k] = launches.get(k, 0) + v
    k1_lm_phase("cell B", lm_plan("B", steps=1, spans=False))
    decode_vs_forward("cell B decode, bf16, capacity factor 8.0",
                      lm_model("B", "none", capacity_factor=8.0), LM_DECODE,
                      (LM_DECODE_ATOL, 0))
    lm_example_phase()
    print(f"phase 7: {time.perf_counter() - t0:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# phase 9: the rest of the LM zoo at full width
# ---------------------------------------------------------------------------

class ZooCell(NamedTuple):
    arch: str
    layers: int         # kept (whisper: encoder and decoder each)
    m: int              # workers, each of LM_SEQS sequences
    b: int              # phocas b = q = the attack's q
    steps: int
    defended_steps: int
    seq_len: int
    lr: float           # SGD; LM_LR unless its loss did not fall there


# mamba2 and whisper rise at LM_LR within 10 steps and fall at 0.1
# (``tools/zoo_lr_probe.py``; PERF.md §6, PR 20).
ZOO_CELLS = {
    "C": ZooCell("mamba2-2.7b", 8, 8, 2, 10, 6, 512, 0.1),  # 2 SSD chunks
    "D": ZooCell("hymba-1.5b", 8, 8, 2, 10, 0, 512, LM_LR),
    "E": ZooCell("whisper-large-v3", 4, 8, 2, 10, 0, 128, 0.1),
    "F": ZooCell("internvl2-26b", 1, 4, 1, 6, 0, 512, LM_LR),  # m = 8: 76 GB
}
ZOO_DECODE = {"C": 512, "D": 96, "E": 32}   # f32 decode-vs-forward tokens
ZOO_DECODE_TOL = (2e-3, 1e-3)   # test_decode_matches_forward's atol, rtol
ZOO_SERVE = (4, 64, 32)         # generate: prompts, prompt tokens, new ones
ZOO_VLM_PROMPT = 512            # internvl2-26b's prompt tokens


def zoo_batch_fn(cfg, m: int, seq_len: int):
    """The token stream's batch of step s, plus the stub frontends' patch
    or frame embeddings (0.1 * N(0, 1), f32) drawn on the card from a
    generator seeded with s."""
    from repro_torch.data.pipeline import TokenStream
    stream = TokenStream(vocab_size=cfg.vocab_size, seq_len=seq_len,
                         global_batch=m * LM_SEQS, seed=0, device="cuda")

    def batch_fn(step: int) -> dict:
        batch = stream.batch(step)
        gen = torch.Generator(device="cuda").manual_seed(step)
        n = m * LM_SEQS
        if cfg.num_patches:
            batch["patch_embeds"] = 0.1 * torch.randn(
                (n, cfg.num_patches, cfg.vit_dim), generator=gen,
                device="cuda")
        if cfg.is_encdec:
            batch["audio_embeds"] = 0.1 * torch.randn(
                (n, cfg.encoder_seq_len, cfg.frontend_dim), generator=gen,
                device="cuda")
        return batch

    return batch_fn


def zoo_train(cell: str) -> tuple:
    """Cell ``cell`` on sync_ps at full width with its depth cut, remat
    "full", plain then defended; then K1 and K3 held on its worker matrix
    (:func:`k1_lm_phase`).  Returns the K1/K3 launches of the runs and the
    plain run's median step ms."""
    import gc

    from repro_torch.models.registry import build_model
    c = ZOO_CELLS[cell]
    model = build_model(arch_cfg(c.arch, c.layers), remat="full")
    batch_fn = zoo_batch_fn(model.cfg, c.m, c.seq_len)

    def plan(steps, tag, **kw):
        return sync_plan(model, batch_fn, m=c.m, b=c.b, steps=steps,
                         lr=c.lr, tag=tag.replace("@", cell), **kw)

    out = train_cell(f"cell {cell} {c.arch} ({c.layers} layers, {LM_SEQS} x "
                     f"{c.seq_len} tokens)", plan, c.m, c.steps,
                     c.defended_steps)
    gc.collect()
    torch.cuda.empty_cache()
    k1_lm_phase(f"cell {cell}", plan(1, "@-k1", spans=False))
    return out


def ssd_share(step_ms: float) -> None:
    """The SSD's device time in cell C's step: one layer's ``ssd_chunked``
    forward, and forward plus backward, under the worker vmap at the
    cell's shapes (CUDA events); remat "full" runs the forward twice a
    step, so a step spends layers x (fwd + fwd&bwd) in it."""
    from repro_torch.models.ssm import _dims, ssd_chunked
    c = ZOO_CELLS["C"]
    layers, m, seq = c.layers, c.m, c.seq_len
    cfg = arch_cfg(c.arch, layers)
    _, h = _dims(cfg)
    gen = torch.Generator(device="cuda").manual_seed(3)
    shape = (m, LM_SEQS, seq)
    xbar = torch.randn(shape + (h, cfg.ssm_head_dim), generator=gen,
                       device="cuda")
    dA = -torch.rand(shape + (h,), generator=gen, device="cuda")
    B, C = (torch.randn(shape + (cfg.ssm_state,), generator=gen,
                        device="cuda").bfloat16() for _ in range(2))

    def loss(xbar, dA, B, C):
        y, state = ssd_chunked(xbar, dA, B, C)
        return y.sum() + state.sum()

    fwd = torch.func.vmap(lambda *a: ssd_chunked(*a)[0])
    both = torch.func.vmap(torch.func.grad(loss, argnums=(0, 1, 2, 3)))
    f_ms = time_ms(lambda: fwd(xbar, dA, B, C), reps=5)
    g_ms = time_ms(lambda: both(xbar, dA, B, C), reps=5)
    share = layers * (f_ms + g_ms) / step_ms
    print(f"cell C SSD (ssd_chunked under the worker vmap, ({m}, "
          f"{LM_SEQS}, {seq}, {h}, {cfg.ssm_head_dim}), state "
          f"{cfg.ssm_state}, 2 chunks): forward {f_ms:.3f} ms, forward + "
          f"backward {g_ms:.3f} ms a layer; {layers} layers x (fwd + "
          f"fwd&bwd) = {layers * (f_ms + g_ms):.1f} ms = {share:.1%} of "
          f"the {step_ms:.1f} ms step")


def zoo_generate(name: str) -> dict:
    """``name`` at full depth and width in bf16, random weights from the
    seed: ``generate`` on ZOO_SERVE's prompts twice (whisper: generate
    would ignore the audio, so ``prefill_cache`` on 1,500 frames a prompt
    and greedy ``decode_step`` calls), the second call timing each decode
    step and checking its logits; tokens equal across the calls.  Returns
    the K6 launches of the two calls and the prefill calls they made."""
    import dataclasses
    import gc

    from repro_torch.models import encdec
    from repro_torch.models.registry import build_model
    from repro_torch.serve import generate
    from repro_torch.serve.engine import batched_prefill_supported
    from repro_torch.tree import size
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(arch_cfg(name))
    cfg = model.cfg
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    nb, s0, new = ZOO_SERVE
    if cfg.num_patches:
        s0 = ZOO_VLM_PROMPT
    elif cfg.is_encdec:
        s0 = 1                                      # the start token
    gen = torch.Generator(device="cuda").manual_seed(4)
    prompts = torch.randint(0, cfg.vocab_size, (nb, s0), generator=gen,
                            device="cuda")
    audio = (0.1 * torch.randn((nb, cfg.encoder_seq_len, cfg.frontend_dim),
                               generator=gen, device="cuda")
             if cfg.is_encdec else None)
    steps = []            # (tokens in the call, ms) of the timed call
    finite = []

    def timed(p, c, t, pos):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, c = model.decode_step(p, c, t, pos)
        torch.cuda.synchronize()
        steps.append((t.shape[1], (time.perf_counter() - t0) * 1e3))
        finite.append(torch.isfinite(lg).all())
        return lg, c

    def run(step):
        if not cfg.is_encdec:
            return generate(dataclasses.replace(model, decode_step=step),
                            params, prompts, new)
        cache = encdec.prefill_cache(params, cfg,
                                     model.init_cache(nb, new, "cuda"),
                                     audio)
        tok, out = prompts, [prompts]
        for t in range(new):
            lg, cache = step(params, cache, tok, t)
            tok = lg[:, -1].argmax(-1)[:, None]
            out.append(tok)
        return torch.cat(out, 1)

    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        first, counts = launch_counts(lambda: run(model.decode_step))
        wall = time.perf_counter() - t0
        second, counts2 = launch_counts(lambda: run(timed))
    check(torch.equal(first, second), f"{name} generate: tokens differ "
          f"between two identical calls")
    check(all(bool(f) for f in finite), f"{name} generate: non-finite "
          f"logits")
    dec = sorted(ms for n, ms in steps if n == 1)
    prefills = (0 if cfg.is_encdec or not batched_prefill_supported(cfg, s0)
                else 1)
    work = (f"{nb} x {cfg.encoder_seq_len} frames through prefill_cache, "
            f"a start token + {new} greedy decode steps" if cfg.is_encdec
            else f"{nb} prompts of {s0} tokens + {new} new ("
            f"{'batched prefill' if prefills else 'stepwise prompt'})")
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"{name} serving, full depth ({cfg.num_layers} layers"
          f"{' + %d encoder' % cfg.encoder_layers if cfg.is_encdec else ''}"
          f", {size(params) / 1e9:.2f} B parameters, bf16): {work}: "
          f"{nb * new / wall:.1f} new tokens/s ({wall:.2f} s a call), one "
          f"decode step {dec[len(dec) // 2]:.2f} ms (median of {len(dec)}, "
          f"synchronized), peak {peak:.2f} GiB; tokens equal across two "
          f"calls; launches {counts}")
    out = {k: counts[k] + counts2[k] for k in counts}
    out["prefills"] = 2 * prefills
    del params
    return out


def zoo_phase() -> dict:
    """Phase 9: configs C-F train under phocas at full width, cell C also
    defended, and K1/K3 held on each one's worker matrix; decode against
    forward in f32 on C-E; full-depth serving of all four.  Returns the
    kernel launches of its training and serving runs."""
    import gc

    from repro_torch.models.registry import build_model
    t0 = time.perf_counter()
    launches = {}
    for cell in ZOO_CELLS:
        counts, step_ms = zoo_train(cell)
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        if cell == "C":
            ssd_share(step_ms)
        gc.collect()
        torch.cuda.empty_cache()
    for cell, n in ZOO_DECODE.items():
        c = ZOO_CELLS[cell]
        decode_vs_forward(
            f"cell {cell} {c.arch} decode, f32, {c.layers} layers",
            build_model(arch_cfg(c.arch, c.layers, "float32")), n,
            ZOO_DECODE_TOL)
        gc.collect()
        torch.cuda.empty_cache()
    for cell in ZOO_CELLS:
        name = ZOO_CELLS[cell].arch
        c = zoo_generate(name)
        if name == "internvl2-26b":
            layers = arch_cfg(name).num_layers
            check(c["flash_attn"] == layers * c["prefills"]
                  and c["prefills"] == 2,
                  f"{name} generate: K6 launches {c['flash_attn']} != "
                  f"{layers} x {c['prefills']} prefill calls")
        else:
            check(c["flash_attn"] == 0, f"{name} generate: K6 launched")
        for k, v in c.items():
            if k != "prefills":
                launches[k] = launches.get(k, 0) + v
        gc.collect()
        torch.cuda.empty_cache()
    print(f"phase 9: {time.perf_counter() - t0:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# phase 10: the mesh, one torch.distributed rank per mesh device
# ---------------------------------------------------------------------------

MESH_RANKS = 20                  # the paper's m = 20 workers, one a rank
MESH_SEED = 11
MESH_TRIM = (("phocas", 8), ("trmean", 6))
MESH_EJECTED = 19                # the worker the defended cases eject
MESH_GRID = (10, 2)              # (data, model): the model-axis cases
MESH_TP_B = 3                    # b of the model-axis cases (m = 10)
MESH_TOL = (1e-4, 1e-5)          # rtol, atol: mesh run vs single process


def mesh_rows(d: int, rows) -> torch.Tensor:
    """Rows ``rows`` of a (20, d) f32 worker matrix on the card, row i drawn
    from its own seed, so that a rank draws its row alone."""
    return torch.stack([torch.randn(
        d, generator=torch.Generator(device="cuda").manual_seed(
            MESH_SEED * 1000 + i), device="cuda") for i in rows])


def mesh_training_specs() -> dict:
    """Part (ii)'s runs on "20x1" in the sharded layout: (spec, the kernel
    each step launches)."""
    import dataclasses

    from repro_torch.core.attacks import AttackConfig
    return {
        "mlp phocas bitflip": (dataclasses.replace(
            paper_spec("mlp", 10), mesh="20x1"), "phocas"),
        "cnn trmean gaussian": (dataclasses.replace(
            paper_spec("cnn", 10), mesh="20x1"), "trmean"),
        "mlp phocas defended": (dataclasses.replace(
            paper_spec("mlp", 10, defended=True), mesh="20x1"),
            "phocas_counts"),
        "mlp krum gaussian": (dataclasses.replace(
            vector_spec("mlp", "krum", 10), mesh="20x1"), "krum_gram"),
        "mlp phocas signflip replicated": (mesh_compare_spec("replicated"),
                                           "phocas"),
    }


def mesh_compare_spec(layout: str):
    """The MLP under signflip q = 8 on "20x1" for 5 steps, in ``layout``
    (the single-process run is the same spec with no mesh)."""
    import dataclasses

    from repro_torch.core.attacks import AttackConfig
    from repro_torch.core.robust import RobustConfig
    return dataclasses.replace(
        paper_spec("mlp", 5), mesh="20x1",
        attack=AttackConfig(name="signflip", num_byzantine=8),
        robust=RobustConfig(rule="phocas", b=8, q=8, layout=layout))


def _digest(params) -> str:
    import hashlib

    from repro_torch.tree import leaves
    h = hashlib.sha256()
    for x in leaves(params):
        h.update(x.detach().contiguous().view(torch.uint8).cpu().numpy())
    return h.hexdigest()


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def mesh_plain_holds(tag: str, u: torch.Tensor, kernels) -> None:
    """Each of ``kernels`` ((name, b) pairs; b is ignored for K5) on the
    (m, d) matrix ``u`` that the mesh path hands it, against its plain
    version on ``u``: K1-K4's aggregates bit for bit and K3/K4's counts as
    integers (``tie_check``), K5's distances through ``compare_gram``.
    These launches are not counted: part (ii) counts its own."""
    for kname, b in kernels:
        if kname != "krum_gram":
            tie_check(kname, u, b, label=f"mesh {tag}")
            continue
        kernel, ref = wrappers()[kname]
        got, want, want64 = kernel(u), ref(u), ref(u, torch.float64)
        torch.cuda.synchronize()
        compare_gram(f"mesh {tag} {tuple(u.shape)}", u, got, want, want64)


def mesh_aggregation(mesh, grid, out: dict) -> None:
    """Part (i), on every rank: the engine in both layouts on the paper's
    worker matrices against ``aggregate_matrix`` on the whole matrix (rank
    0 holds it), bit for bit; the summed K3/K4 counts as integers; the
    K5-based krum and multikrum; bitflip on slices; the (10, 2) grid over
    the CNN's gradient tree; then K1 and the collectives timed.  Rank 0
    also holds every kernel against its plain version on the matrices the
    mesh path launches it on: its (20, D/20) slice, clean and under the
    omniscient attack, and the padded (20, D) whole of the replicated
    layout; on the grid, K1 on its (10, D'/10) slice and (10, D') whole."""
    import dataclasses

    import torch.distributed as dist
    import torch.nn.functional as F

    from repro_torch.core.aggregators import psum_counts
    from repro_torch.core.attacks import (AttackConfig, bitflip_attack,
                                          make_attack)
    from repro_torch.core.robust import (RobustConfig, _flat_padded,
                                         aggregate_matrix,
                                         aggregate_stacked_tree,
                                         robust_aggregate_dist,
                                         slice_generator)
    from repro_torch.dist.collectives import (all_to_all_scatter,
                                              cut_to_blocks, gather_slices,
                                              gather_workers, join_blocks,
                                              model_cuts, worker_slice_index)
    from repro_torch.kernels import ops
    from repro_torch.kernels.phocas.kernel import phocas_hopper
    from repro_torch.tree import leaves, unflatten
    rank, m = mesh.rank, MESH_RANKS
    wa, ma = mesh.axes(("data",)), mesh.axes(("model",))
    gen = torch.Generator(device="cuda").manual_seed(MESH_SEED)
    active = torch.ones(m, device="cuda")
    active[MESH_EJECTED] = 0.0
    lines = out.setdefault("lines", [])

    def held(tag, got, want, scores=None, want_scores=None, exact=True):
        # Multi-Krum's mean of the same rows may round differently on a
        # slice than on the whole matrix; a different selection would move
        # it by O(1).
        ok = (_same_bits(got, want) if exact else
              torch.allclose(got, want, rtol=1e-6, atol=1e-6))
        if scores is not None:
            ok = ok and _same_bits(scores, want_scores)
        check(ok, f"mesh {tag}: differs from aggregate_matrix on the whole "
                  f"matrix (max |diff| {(got - want).abs().max().item()})")

    for tag, (_, d) in (("mlp", SHAPES[0]), ("cnn", SHAPES[1])):
        row = mesh_rows(d, [rank])[0]
        whole = (F.pad(mesh_rows(d, range(m)), (0, (-d) % m))
                 if rank == 0 else None)
        n = 0
        cases = [(rule, b, atk, layout, defended)
                 for rule, b in MESH_TRIM
                 for atk in ("signflip", "omniscient")
                 for layout in ("sharded", "replicated")
                 for defended in (False, True)]
        cases += [(rule, 0, "signflip", layout, False)
                  for rule in ("krum", "multikrum")
                  for layout in ("sharded", "replicated")]
        for rule, b, atk, layout, defended in cases:
            cfg = RobustConfig(rule=rule, b=b, q=6, layout=layout,
                               attack=AttackConfig(name=atk,
                                                   num_byzantine=6))
            act = active if defended else None
            res = robust_aggregate_dist({"g": row}, cfg, wa, ma, gen,
                                        active=act, with_scores=defended,
                                        step=0)
            agg, scores = res if defended else (res, None)
            if rank == 0:
                want = aggregate_matrix(whole, cfg, gen, active=act,
                                        with_scores=defended)
                want, want_scores = want if defended else (want, None)
                held(f"{tag} {rule} b={b} {atk} {layout}"
                     f"{' defended' if defended else ''}", agg["g"],
                     want[:d], scores, want_scores,
                     exact=rule != "multikrum")
            n += 1
        # K3/K4's drop counts on the slices, summed, against the whole
        # matrix's: equal as integers.
        flat = F.pad(row, (0, (-d) % m))
        piece = all_to_all_scatter(flat, wa)
        for rule, b in MESH_TRIM:
            _, counts = getattr(ops, f"{rule}_with_counts")(piece, b)
            counts, ncoords = psum_counts(
                counts, torch.tensor(float(piece.shape[1]), device="cuda"),
                wa + ma)
            if rank == 0:
                _, want = getattr(ops, f"{rule}_with_counts")(whole, b)
                check(torch.equal(counts, want) and
                      int(ncoords) == whole.shape[1],
                      f"mesh {tag} {rule}: summed counts {counts.tolist()} "
                      f"!= {want.tolist()}")
        if rank == 0:
            every = [(k, b) for k, b in MESH_TRIM]
            every += [(f"{k}_counts", b) for k, b in MESH_TRIM]
            every.append(("krum_gram", 0))
            omni = make_attack(AttackConfig(name="omniscient",
                                            num_byzantine=6))
            for label, u in (("slice", piece),
                             ("omniscient slice", omni(gen, piece, 0)),
                             ("whole", whole)):
                mesh_plain_holds(f"{tag} {label}", u, every)
            lines.append(f"  {tag}: K1-K5 on rank 0's {tuple(piece.shape)} "
                         f"slice (clean and omniscient) and the padded "
                         f"{tuple(whole.shape)} whole equal to their plain "
                         f"versions (K1-K4 bit for bit, K3/K4 counts as "
                         f"integers, K5 within compare_gram's bound)")
            lines.append(f"  {tag} (20, {d:,}): {n} cases (phocas b=8, "
                         f"trmean b=6 under signflip/omniscient q=6, plain "
                         f"and defended with worker {MESH_EJECTED} ejected; "
                         f"krum/multikrum q=6) in both layouts equal to "
                         f"aggregate_matrix bit for bit (multikrum: the "
                         f"same rows' mean within 1e-6); K3/K4 counts summed "
                         f"over 20 slices equal as integers")
    # Bitflip q = 8 on the MLP matrix: each slice's leading 1,000
    # coordinates, from the slice's generator.
    d = SHAPES[0][1]
    row = mesh_rows(d, [rank])[0]
    cfg = RobustConfig(rule="phocas", b=8, layout="sharded",
                       attack=AttackConfig(name="bitflip", num_byzantine=8))
    agg = robust_aggregate_dist({"g": row}, cfg, wa, ma, gen, step=0)["g"]
    if rank == 0:
        whole = F.pad(mesh_rows(d, range(m)), (0, (-d) % m))
        s = whole.shape[1] // m
        for i in range(m):
            whole[:, i * s:(i + 1) * s] = bitflip_attack(
                slice_generator(gen, 0, i, "cuda"), whole[:, i * s:(i + 1) * s],
                8, 1000)
        want = aggregate_matrix(whole, dataclasses.replace(
            cfg, attack=AttackConfig()))
        held("mlp bitflip q=8 on slices", agg, want[:d])
        lines.append(f"  mlp bitflip q=8 sharded: {m} x 1,000 coordinates "
                     f"hit ({m} slices of {s:,}), equal to aggregate_matrix "
                     f"on the slice-wise attacked matrix bit for bit")

    # The (10, 2) grid over the CNN's gradient tree (m = 10): a model-
    # sharded leaf contributes this rank's block, the aggregate is
    # all_gathered over the model axis, as in the train step.
    from repro_torch.models.cnn import build_cnn_model
    gwa, gma = grid.axes(("data",)), grid.axes(("model",))
    like = build_cnn_model(in_ch=3, size=32).init(
        torch.Generator(device="cuda").manual_seed(0))
    shapes = [x.shape for x in leaves(like)]

    def worker_tree(w):
        g = torch.Generator(device="cuda").manual_seed(MESH_SEED * 100 + w)
        return unflatten(like, [torch.randn(sh, generator=g, device="cuda")
                                for sh in shapes])

    cuts = model_cuts(like, grid)
    check(any(c is not None for c in cuts), "no CNN leaf is model-sharded")
    local = cut_to_blocks(worker_tree(worker_slice_index(gwa)), cuts)
    stacked = (unflatten(like, [torch.stack(xs) for xs in zip(
        *[leaves(worker_tree(w)) for w in range(MESH_GRID[0])])])
               if rank == 0 else None)
    flat, _ = _flat_padded(local, MESH_GRID[0], torch.float32)
    piece, whole = all_to_all_scatter(flat, gwa), gather_workers(flat, gwa)
    if rank == 0:
        for label, u in (("grid slice", piece), ("grid whole", whole)):
            mesh_plain_holds(label, u, [("phocas", MESH_TP_B)])
    for layout in ("sharded", "replicated"):
        cfg = RobustConfig(rule="phocas", b=MESH_TP_B, layout=layout,
                           attack=AttackConfig(name="signflip",
                                               num_byzantine=MESH_TP_B))
        agg = leaves(join_blocks(
            robust_aggregate_dist(local, cfg, gwa, gma, gen, step=0), cuts))
        if rank == 0:
            want = leaves(aggregate_stacked_tree(stacked, cfg, gen))
            for a, w in zip(agg, want):
                held(f"(10, 2) CNN tree {layout}", a, w)
    if rank == 0:
        nshard = sum(c is not None for c in cuts)
        lines.append(f"  (10, 2) grid, CNN gradient tree (m = 10, {nshard} "
                     f"of {len(cuts)} leaves model-sharded): phocas "
                     f"b={MESH_TP_B} under signflip in both layouts equal "
                     f"to aggregate_stacked_tree bit for bit; K1 on "
                     f"rank 0's {tuple(piece.shape)} slice and "
                     f"{tuple(whole.shape)} whole equal to its plain "
                     f"version bit for bit")

    # Timings: K1 on rank 0's (20, 121,542) CNN slice with the other ranks
    # waiting, and the a2a / all_gather of the CNN row on every rank.
    d = SHAPES[1][1]
    flat = F.pad(mesh_rows(d, [rank])[0], (0, (-d) % m))
    piece = all_to_all_scatter(flat, wa)
    dist.barrier()
    if rank == 0:
        k1 = time_ms(lambda: phocas_hopper(piece, 8))
        bnd, by = bound_ms("phocas", m, piece.shape[1], 4)
        out["k1_slice"] = (tuple(piece.shape), k1, bnd, by)
    dist.barrier()
    for name, fn in (("a2a", lambda: all_to_all_scatter(flat, wa)),
                     ("all_gather", lambda: gather_slices(piece[0], wa))):
        times = []
        for _ in range(6):
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        times.sort()
        out[f"{name}_ms"] = times[len(times) // 2]


def mesh_training(out: dict) -> None:
    """Part (ii), on every rank: run_experiment of each spec as this rank
    of the world; per run the launches (counted just around the run), the
    losses, the params' digest, and on rank 0 the step times, the peak
    memory, the params and the defense's mask."""
    import torch.distributed as dist

    from repro_torch.experiment import run_experiment
    from repro_torch.tree import leaves
    runs = {}
    for tag, (spec, _) in mesh_training_specs().items():
        dist.barrier()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res, counts = launch_counts(lambda: run_experiment(spec))
        call = time.perf_counter() - t0
        walls = [r["wall"] for r in res.history]
        step_ms = sorted(1e3 * (b - a) for a, b in zip(walls[1:], walls[2:]))
        runs[tag] = {
            "losses": [r["loss"] for r in res.history],
            "counts": counts, "digest": _digest(res.params),
            "n_active": [r.get("n_active") for r in res.history],
            "times": (call, res.wall_time, 1e3 * walls[0])}
        if dist.get_rank() == 0:
            runs[tag].update(
                step_ms=step_ms[len(step_ms) // 2],
                peak=torch.cuda.max_memory_allocated(),
                params=[x.cpu() for x in leaves(res.params)],
                active=(None if res.defense_state is None else
                        res.defense_state["active"].tolist()))
    out["runs"] = runs


def mesh_warm() -> dict:
    """The world's first cuBLAS GEMM and first ``torch.func`` gradient
    under ``vmap``, each timed barrier to barrier on every rank: the set-up
    that every rank does at once on the one card before part (ii)'s first
    step (seconds)."""
    import torch.distributed as dist
    x = torch.randn(32, 784, device="cuda")
    w = torch.randn(784, 128, device="cuda")

    def grads():
        def loss(w, x):
            return (x @ w).square().sum()
        return torch.func.vmap(torch.func.grad(loss), in_dims=(None, 0))(
            w, x.expand(2, -1, -1))

    times = {}
    for name, fn in (("gemm", lambda: x @ w), ("vmap(grad)", grads)):
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        dist.barrier()
        times[name] = time.perf_counter() - t0
    return times


def mesh_rank(rank: int, world: int, t_spawn: float) -> dict:
    """One rank of phase 10's world: parts (i) and (ii); returns its
    results to the parent."""
    import torch.distributed as dist

    from repro_torch.dist.mesh import make_host_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.init()
    torch.zeros(1, device="cuda")
    mesh = make_host_mesh(data=MESH_RANKS, model=1)
    grid = make_host_mesh(*MESH_GRID)
    dist.barrier()
    out = {"spawn_s": time.time() - t_spawn}
    t0 = time.perf_counter()
    mesh_aggregation(mesh, grid, out)
    out["part_i_s"] = time.perf_counter() - t0
    out["warm_s"] = mesh_warm()
    t0 = time.perf_counter()
    mesh_training(out)
    out["part_ii_s"] = time.perf_counter() - t0
    return out


def mesh_phase() -> dict:
    """Phase 10: one 20-rank world on the card runs parts (i) and (ii);
    then one run_experiment from this process spawns its own ranks.
    Returns rank 0's launches of the training runs."""
    import dataclasses

    from repro_torch.dist.launch import spawn
    from repro_torch.experiment import run_experiment
    from repro_torch.tree import leaves
    t0 = time.perf_counter()
    ranks = spawn(mesh_rank, MESH_RANKS, time.time())
    r0 = ranks[0]
    print(f"spawn: the phase's world of {MESH_RANKS} ranks (gloo, one card) "
          f"ready {r0['spawn_s']:.2f} s after the spawn")
    warm = ", ".join(f"first {k} {v:.2f} s" for k, v in r0["warm_s"].items())
    print(f"mesh world: part (i) {r0['part_i_s']:.1f} s, then on all "
          f"{MESH_RANKS} ranks at once {warm}, part (ii) "
          f"{r0['part_ii_s']:.1f} s, world {time.perf_counter() - t0:.1f} s")
    print("mesh (i) aggregation on the (20, 1) mesh:")
    for line in r0["lines"]:
        print(line)
    shape, k1, bnd, by = r0["k1_slice"]
    print(f"  K1 on a {shape} slice: {k1:.4f} ms, bound {bnd * 1e3:.2f} us "
          f"({by}), {bnd / k1:.1%} of bound; a2a of a CNN row "
          f"{r0['a2a_ms']:.2f} ms, all_gather of its slice "
          f"{r0['all_gather_ms']:.2f} ms (rank 0, host clock, median)")

    print("mesh (ii) training through run_experiment on '20x1':")
    specs = mesh_training_specs()
    launches: dict = {}
    for tag, run in r0["runs"].items():
        kname = specs[tag][1]
        losses = run["losses"]
        steps = len(losses)
        check(all(x == x and abs(x) != float("inf") for x in losses),
              f"mesh {tag}: non-finite loss in {losses}")
        check(losses[-1] < losses[0],
              f"mesh {tag}: loss did not decrease ({losses})")
        for r, rk in enumerate(ranks):
            check(rk["runs"][tag]["digest"] == run["digest"],
                  f"mesh {tag}: rank {r}'s params differ from rank 0's")
            c = rk["runs"][tag]["counts"]
            if kname == "phocas_counts":
                gated = sum(1 for n in run["n_active"][:-1] if n < MESH_RANKS)
                want = {k: 0 for k in c}
                want.update(phocas_counts=steps, phocas=gated)
            else:
                want = {k: (steps if k == kname else 0) for k in c}
            check(c == want, f"mesh {tag}: rank {r} launches {c}, expected "
                             f"{want}")
        for k, v in run["counts"].items():
            launches[k] = launches.get(k, 0) + v
        extra = ""
        if run["active"] is not None:
            q = specs[tag][0].attack.num_byzantine
            check(all(a == 0 for a in run["active"][:q]),
                  f"mesh {tag}: Byzantine workers not all ejected: "
                  f"{run['active']}")
            extra = f", active {[int(a) for a in run['active']]}"
        call, loop, first = run["times"]
        print(f"  {tag}: loss {losses[0]:.4f} -> {losses[-1]:.4f}, step "
              f"{run['step_ms']:.2f} ms (median, synchronized, rank 0; the "
              f"first {first:.0f} ms; the loop {loop:.2f} s of the call's "
              f"{call:.2f} s), peak {run['peak'] / 2**30:.2f} GiB (rank 0), "
              f"launches {run['counts']} on each of {MESH_RANKS} ranks, "
              f"params bit-equal across ranks{extra}")

    # The single-process entry point spawns its own ranks: the sharded
    # layout's run, and the world's replicated one, against the
    # single-process run of the same spec.
    rtol, atol = MESH_TOL
    local = run_experiment(dataclasses.replace(mesh_compare_spec("sharded"),
                                               mesh=""))
    t1 = time.perf_counter()
    spawned = run_experiment(mesh_compare_spec("sharded"))
    call = time.perf_counter() - t1
    walls = [r["wall"] for r in spawned.history]
    print(f"spawn: run_experiment(mesh='20x1') from this process, "
          f"{MESH_RANKS} ranks: call {call:.1f} s, of which the run's loop "
          f"{spawned.wall_time:.1f} s (its first step {walls[0]:.1f} s, the "
          f"next four {walls[-1] - walls[0]:.2f} s) and spawn and set-up "
          f"{call - spawned.wall_time:.1f} s")
    want_l = [r["loss"] for r in local.history]
    want_p = leaves(local.params)
    for layout, losses, params in (
            ("sharded", [r["loss"] for r in spawned.history],
             leaves(spawned.params)),
            ("replicated", r0["runs"]["mlp phocas signflip replicated"][
                "losses"], r0["runs"]["mlp phocas signflip replicated"][
                "params"])):
        loss_ok = torch.allclose(torch.tensor(losses), torch.tensor(want_l),
                                 rtol=rtol, atol=atol)
        perr = max((a.cuda() - b).abs().max().item()
                   for a, b in zip(params, want_p))
        par_ok = all(torch.allclose(a.cuda(), b, rtol=rtol, atol=atol)
                     for a, b in zip(params, want_p))
        check(loss_ok and par_ok and losses[-1] < losses[0],
              f"mesh {layout}: losses {losses} vs single process "
              f"{want_l}, params max diff {perr}")
        how = "spawned by run_experiment" if layout == "sharded" else \
            "the world's"
        print(f"  mlp signflip {layout} (5 steps, {how}) vs the "
              f"single-process run: losses within rtol {rtol} atol {atol}, "
              f"params max diff {perr:.2e}")
    print(f"phase 10: {time.perf_counter() - t0:.1f} s")
    return launches


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
    register_phase(gen, report)
    wide_phase(gen, report)
    k1_shape_phase(gen, report)
    report["krum_gram"] = gram_phase(gen)
    launches = train_phase()
    launches.update(vector_phase())
    topology_phase()
    for k, v in mesh_phase().items():
        launches[k] = launches.get(k, 0) + v
    trace_phase()
    report["flash_attn"] = flash_phase(gen)
    launches.update(serve_phase())
    serve_trace_phase()
    for k, v in lm_phase().items():
        launches[k] += v
    for k, v in zoo_phase().items():
        launches[k] += v

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
            "bound_by": r["bound_by"], "library_ms": r.get("library_ms")})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
