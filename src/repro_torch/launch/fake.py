"""The dry run's stand-ins for the card and the mesh: fake CUDA tensors on
any host, and a fake ``torch.distributed`` world in one process.

``launch/dryrun.py`` traces one rank's program on ``FakeTensorMode``
tensors on device ``cuda``, so that every route the card takes (the
hand-written kernels, the staged collectives) is the route traced, and
nothing runs.  Where torch is built for CUDA that needs nothing more.  A
CPU-only build has no CUDA device guard and no CUDA hooks, and PyTorch's
Python indexing and its autograd engine refuse a fake ``cuda`` tensor
without them.  :func:`prepare_host` then compiles ``fake_cuda.cpp`` with the
host's C++ compiler against the installed torch's headers (at first use,
into ``build/host/`` at the root of the checkout, git-ignored) and loads it:
it registers a guard for one CUDA device that holds no state, and hooks that
report CUDA built and available to ATen's accelerator queries.  No memory,
stream or kernel comes with them, and ``torch.cuda.is_available()`` stays
False.  ATen reads its hooks once, when torch is first imported, so on such
a build :func:`prepare_host` must run before anything imports torch; it
raises where it comes too late.

:func:`init_fake_world` makes a world of any size in this process on
torch's ``fake`` backend, whose collectives return at once and leave their
outputs as they are: rank 0 of a 512-rank mesh makes its process groups and
runs its collectives on fake tensors.  The backend lives under a private
path (``torch.testing._internal.distributed.fake_pg``), imported here and
nowhere else.

Importing this module imports nothing of torch.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import importlib.util
import os
import shutil
import subprocess
import sys
from pathlib import Path

SOURCE = Path(__file__).resolve().parent / "fake_cuda.cpp"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "host"
CXX_FLAGS = ("-std=c++20", "-O1", "-shared", "-fPIC", "-w")

_LOADED = []


def _torch_dir() -> Path:
    spec = importlib.util.find_spec("torch")
    if spec is None or not spec.submodule_search_locations:
        raise RuntimeError("torch is not installed")
    return Path(spec.submodule_search_locations[0])


def cuda_build() -> bool:
    """Whether the installed torch is built for CUDA (read off its
    libraries, without importing it)."""
    return any((_torch_dir() / "lib").glob("libtorch_cuda*.so*"))


def _library_path(torch_dir: Path) -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    h.update(str(torch_dir).encode())
    version = torch_dir / "version.py"
    if version.exists():
        h.update(version.read_bytes())
    return BUILD_DIR / f"libfake_cuda-{h.hexdigest()[:16]}.so"


def _build(torch_dir: Path) -> Path:
    path = _library_path(torch_dir)
    if path.exists():
        return path
    cxx = os.environ.get("CXX") or shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (CXX, c++ or g++) to build the "
                           "dry run's fake CUDA device for a CPU-only torch")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)         # released when closed
        if not path.exists():
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            lib = torch_dir / "lib"
            cmd = [cxx, *CXX_FLAGS, f"-I{torch_dir / 'include'}", "-o",
                   str(tmp), str(SOURCE), f"-L{lib}", "-lc10",
                   "-ltorch_cpu", f"-Wl,-rpath,{lib}"]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"building {SOURCE.name} failed:\n"
                                   f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, path)
    return path


def prepare_host() -> None:
    """Make fake ``cuda`` tensors usable in this process: nothing on a
    CUDA build of torch; on a CPU-only build, build and load
    ``fake_cuda.cpp``, which must happen before torch is imported."""
    if _LOADED or cuda_build():
        return
    if "torch" in sys.modules:
        import torch
        if torch.accelerator.current_accelerator() is not None and \
                torch.accelerator.current_accelerator().type == "cuda":
            return
        raise RuntimeError(
            "the dry run needs fake CUDA tensors, which a CPU-only torch "
            "gives only when launch/fake.py::prepare_host runs before "
            "torch is imported: run python -m repro_torch.launch.dryrun, "
            "or call prepare_host first in a fresh process")
    lib = ctypes.CDLL(str(_build(_torch_dir())), mode=ctypes.RTLD_GLOBAL)
    lib.repro_register_fake_cuda()
    _LOADED.append(lib)


def init_fake_world(size: int) -> None:
    """Make this process rank 0 of a ``size``-rank world on the fake
    backend (nothing if such a world is up already)."""
    import torch.distributed as dist
    if dist.is_initialized():
        if not in_fake_world():
            raise RuntimeError("a real torch.distributed world is up; the "
                               "dry run traces only in a fake one")
        if dist.get_world_size() != size:
            raise RuntimeError(f"the fake world has "
                               f"{dist.get_world_size()} ranks, not {size}")
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)


def in_fake_world() -> bool:
    """Whether this process is a rank of a world on the fake backend."""
    import torch.distributed as dist
    return (dist.is_available() and dist.is_initialized()
            and dist.get_backend() == "fake")
