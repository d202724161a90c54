"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for Hopper (``sm_90a``) into its own
shared library with a plain C interface, at first use, under ``build/kernels/``
at the root of the checkout (git-ignored).  The library name carries a hash of
the sources and flags, so an edited kernel is rebuilt and a stale one is never
loaded.  ``build_all`` starts one ``nvcc`` per source, all at once.

Libraries are loaded with ``ctypes``.  The aggregate entry points have the
signature ``int fn(const void* u, void* out, int m, long long d, int b, int
dtype, void* stream)``; the ``*_counts`` ones take a ``void* counts`` (an (m,)
int32 buffer, zeroed) after ``out``.  Each enqueues one launch on ``stream``
and returns ``cudaGetLastError()``.  :func:`launch` checks the matrix, passes
PyTorch's current stream and raises on a non-zero code.  The Krum Gram kernel
has its own signature, ``int repro_krum_gram(const void* u, void* out, void*
scratch, int m, long long d, int nblocks, int dtype, void* stream)``: no b, an
(m, m) output, and a scratch buffer of per-block partial sums; it takes any m
(:func:`check_gram_matrix`, :func:`launch_gram`).  There is no fallback: a
missing ``nvcc``, a failed build or a failed launch raises.

Nothing here runs at import time; the CPU tests import this module freely.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("trmean", "phocas", "trmean_counts", "phocas_counts", "krum_gram")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Kernel dtype codes (csrc/selection.cuh kF32 / kF16 / kBF16).
DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
MAX_M = 64            # the kernels' largest register bucket (selection.cuh)
GRAM_TILE = 64        # columns of one staged tile (krum_gram.cu kGramTile)
GRAM_BLOCKS_PER_SM = 8
GRAM_SCRATCH_FLOATS = 1 << 24   # cap on the partial sums' buffer (64 MiB)

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
_COUNTS_ARGTYPES = _ARGTYPES[:2] + [ctypes.c_void_p] + _ARGTYPES[2:]
_GRAM_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                  ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                  ctypes.c_void_p]


def _has_counts(name: str) -> bool:
    return name.endswith("_counts")


def _argtypes(name: str) -> list:
    if name == "krum_gram":
        return _GRAM_ARGTYPES
    return _COUNTS_ARGTYPES if _has_counts(name) else _ARGTYPES


class KernelCompileError(RuntimeError):
    """nvcc is missing or refused a source."""


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    found = shutil.which("nvcc") or str(Path(cuda_home) / "bin" / "nvcc")
    if not Path(found).exists():
        raise KernelCompileError(
            "nvcc not found (looked on PATH and in $CUDA_HOME/bin); the "
            "CUDA kernels are built from csrc/ at first use")
    return found


def _library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.iterdir()):
        if src.suffix in (".cu", ".cuh"):
            h.update(src.name.encode())
            h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


class _Kernels:
    """The loaded libraries of one process, and what their build printed."""

    def __init__(self):
        self.libs: Dict[str, ctypes.CDLL] = {}
        self.ptxas: Dict[str, str] = {}

    def build_all(self) -> Dict[str, Path]:
        """Compile every source not yet built, one nvcc each, in parallel."""
        paths = {name: _library_path(name) for name in SOURCES}
        todo = [n for n, p in paths.items() if not p.exists()]
        if not todo:
            return paths
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs: List[tuple] = []
        for name in todo:
            tmp = paths[name].with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs.append((name, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for name, tmp, proc in procs:
            out, _ = proc.communicate()
            self.ptxas[name] = out
            if proc.returncode != 0:
                failed.append(f"--- {name}.cu (exit {proc.returncode}) ---\n"
                              f"{out}")
                continue
            os.replace(tmp, paths[name])
        if failed:
            raise KernelCompileError("nvcc failed:\n" + "\n".join(failed))
        return paths

    def library(self, name: str) -> ctypes.CDLL:
        lib = self.libs.get(name)
        if lib is None:
            path = self.build_all()[name]
            lib = ctypes.CDLL(str(path))
            fn = getattr(lib, f"repro_{name}")
            fn.argtypes = _argtypes(name)
            fn.restype = ctypes.c_int
            self.libs[name] = lib
        return lib


KERNELS = _Kernels()


def check_gram_matrix(u: torch.Tensor) -> None:
    """Validate an (m, d) worker matrix for the Krum Gram kernel (any m)."""
    if u.dim() != 2:
        raise ValueError(f"expected an (m, d) matrix, got shape "
                         f"{tuple(u.shape)}")
    if u.shape[0] < 1 or u.shape[1] < 1:
        raise ValueError(f"empty worker matrix of shape {tuple(u.shape)}")
    if u.dtype not in DTYPE_CODES:
        raise ValueError(f"kernels take {list(DTYPE_CODES)}, got {u.dtype}")


def check_matrix(u: torch.Tensor, b: int) -> None:
    """Validate an (m, d) worker matrix and trim count for a kernel."""
    check_gram_matrix(u)
    m, d = u.shape
    if not 0 <= b <= (m + 1) // 2 - 1:
        raise ValueError(f"b={b} out of range for m={m}")
    if m > MAX_M:
        raise ValueError(f"kernels support m <= {MAX_M} workers, got m={m}")


def _check_cuda(name: str, u: torch.Tensor) -> None:
    if u.device.type != "cuda":
        raise ValueError(f"{name} kernel needs a CUDA tensor, got "
                         f"{u.device}")
    if not u.is_contiguous():
        raise ValueError(f"{name} kernel needs a contiguous (m, d) matrix")


def gram_blocks(m: int, d: int, sms: int) -> int:
    """Blocks of the Gram kernel's first launch: enough to fill the card,
    no more than there are 64-column tiles, and few enough that the partial
    sums (m(m+1)/2 per block) fit ``GRAM_SCRATCH_FLOATS``."""
    tiles = -(-d // GRAM_TILE)
    cap = max(1, GRAM_SCRATCH_FLOATS // (m * (m + 1) // 2))
    return max(1, min(tiles, GRAM_BLOCKS_PER_SM * sms, cap))


def launch_gram(u: torch.Tensor) -> torch.Tensor:
    """Launch ``repro_krum_gram`` on a CUDA (m, d) matrix; returns the
    (m, m) f32 squared distances."""
    _check_cuda("krum_gram", u)
    m, d = u.shape
    sms = torch.cuda.get_device_properties(u.device).multi_processor_count
    nblocks = gram_blocks(m, d, sms)
    out = torch.empty((m, m), dtype=torch.float32, device=u.device)
    scratch = torch.empty((nblocks * (m * (m + 1) // 2),),
                          dtype=torch.float32, device=u.device)
    fn = KERNELS.library("krum_gram").repro_krum_gram
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        rc = fn(u.data_ptr(), out.data_ptr(), scratch.data_ptr(), m, d,
                nblocks, DTYPE_CODES[u.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"krum_gram kernel launch failed with CUDA error "
                           f"{rc} (m={m}, d={d}, nblocks={nblocks}, "
                           f"dtype={u.dtype})")
    return out


def launch(name: str, u: torch.Tensor, b: int):
    """Launch ``repro_<name>`` on a CUDA (m, d) matrix.

    Returns the (d,) f32 aggregate, and for a ``*_counts`` kernel also the
    (m,) drop counts, accumulated in int32 and returned as f32.
    """
    _check_cuda(name, u)
    m, d = u.shape
    out = torch.empty((d,), dtype=torch.float32, device=u.device)
    bufs = [out]
    if _has_counts(name):
        bufs.append(torch.zeros((m,), dtype=torch.int32, device=u.device))
    fn = getattr(KERNELS.library(name), f"repro_{name}")
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        rc = fn(u.data_ptr(), *(x.data_ptr() for x in bufs), m, d, b,
                DTYPE_CODES[u.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error "
                           f"{rc} (m={m}, d={d}, b={b}, dtype={u.dtype})")
    if len(bufs) == 1:
        return out
    return out, bufs[1].float()
