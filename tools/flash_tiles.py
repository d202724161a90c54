#!/usr/bin/env python3
"""Time tile shapes of the flash-attention kernel K6 against each other.

    python3 tools/flash_tiles.py     # from the root of a checkout, on a GPU

Builds ``src/repro_torch/kernels/csrc/flash_attn.cu`` once per tile shape
(the ``MmaTiles`` constants: query rows per block BQ, keys per tile BK),
all nvcc runs in parallel, and prints ptxas's
registers and spills for each bf16 instance.  Each build is held to the
plain version (bf16 within 3e-2) and must repeat bit for bit.  Then the
builds are timed in turns (ABC...CBA: two readings each; CUDA events,
median of 15, L2 flushed) in bf16 at granite-8b's head layout (32/8 heads,
hd 128): chip_smoke.py's prefill shape (8, 512), one serving prefill group
(2, 512) and (1, 4096), beside ``scaled_dot_product_attention``.  Prints the
card's name and power limit first.  Exits non-zero without a GPU.
"""
from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VARIANTS = ((64, 64), (128, 64), (64, 32))            # (BQ, BK)
CASES = ((8, 512), (2, 512), (1, 4096))                # (B, S), S == T
TILES = """struct MmaTiles {
  static constexpr int BQ = 64;
  static constexpr int BK = 64;
};"""


def tiles(bq: int, bk: int) -> str:
    return TILES.replace("BQ = 64", f"BQ = {bq}").replace("BK = 64",
                                                         f"BK = {bk}")


def build_variants(build) -> dict:
    """Tag -> loaded library, one nvcc per tile shape in parallel."""
    src = (build.CSRC / "flash_attn.cu").read_text()
    if TILES not in src:
        raise SystemExit("flash_attn.cu's MmaTiles is not the one this "
                         "script substitutes")
    procs = []
    for bq, bk in VARIANTS:
        tag = f"BQ{bq}_BK{bk}"
        d = os.path.join(REPO, "build", "flash_tiles", tag)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(build.CSRC, d)
        with open(os.path.join(d, "flash_attn.cu"), "w") as f:
            f.write(src.replace(TILES, tiles(bq, bk)))
        lib = os.path.join(d, "libflash_attn.so")
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", lib,
               os.path.join(d, "flash_attn.cu")]
        procs.append((tag, lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    libs = {}
    for tag, lib, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {tag}:\n{out}")
        fn = ""
        for line in out.splitlines():
            if "Compiling entry function" in line:
                fn = line.split("'")[1]
            elif "bfloat16" in fn and "mma" in fn and (
                    "registers" in line or "spill" in line):
                hd = re.search(r"Li(\d+)E", fn).group(1)
                print(f"  {tag} bf16 hd {hd}: {line.split(':')[-1].strip()}")
        so = ctypes.CDLL(lib)
        so.repro_flash_attn.argtypes = build._argtypes("flash_attn")
        so.repro_flash_attn.restype = ctypes.c_int
        libs[tag] = so
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_tiles: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(REPO, "src"))
    sys.path.insert(0, REPO)
    import torch.nn.functional as F

    from chip_smoke import check, time_ms
    from repro_torch.kernels import build
    from repro_torch.kernels.flashattn.kernel import flash_attention_hopper
    from repro_torch.kernels.flashattn.ref import flash_attention_ref
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    libs = build_variants(build)
    tags = list(libs)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for B, S in CASES:
        q, k, v = (torch.randn((B, S, heads, 128), generator=gen,
                               device="cuda").bfloat16()
                   for heads in (32, 8, 8))
        want = flash_attention_ref(q, k, v)
        times = {t: [] for t in tags}
        for tag in tags + tags[::-1]:
            build.KERNELS.libs["flash_attn"] = libs[tag]
            got = flash_attention_hopper(q, k, v)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            check(err <= 3e-2, f"{tag} ({B}, {S}): max|diff| {err}")
            check(torch.equal(flash_attention_hopper(q, k, v), got),
                  f"{tag} ({B}, {S}): not bitwise repeatable")
            times[tag].append(time_ms(lambda: flash_attention_hopper(q, k, v)))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        sdpa = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True))
        print(f"({B}, {S}, 32/8, 128) bf16 causal, ms:" + "".join(
            f"  {t} {a:.4f}/{b:.4f}" for t, (a, b) in times.items())
            + f"  sdpa {sdpa:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
