"""Profiling hooks (port of ``repro/obs/profile.py``): the step's cost count,
device memory, and the ``--profile-dir`` trace window.

The Recorder samples FLOPs/bytes once per step function and device memory
per log interval, so the numbers land next to loss/latency in the same
metrics snapshot.  Everything degrades to empty dicts where nothing can be
read — profiling must never fail a run.
"""
from __future__ import annotations

import contextlib
import os
import sys
from typing import Dict, Optional

import torch


def _detached(x):
    """A generator's copy at the same state (the counting call draws from
    it, the run must not see those draws); anything else as it is."""
    if isinstance(x, torch.Generator):
        twin = torch.Generator(device=x.device)
        twin.set_state(x.get_state())
        return twin
    return x


def compiled_cost(step_fn, *args) -> Dict[str, float]:
    """FLOPs / bytes of one call of ``step_fn(*args)``.

    The reference lowers and compiles the step and reads XLA's
    ``cost_analysis()``; there is no compile here, so this calls the step
    once (call it once per distinct step function, not per step) under the
    dry run's counter, ``launch/trace_analysis.py::trace_cost``:

    * ``flops``: ``torch.utils.flop_counter.FlopCounterMode`` over the
      call — the matmuls and convolutions of the forward and the backward
      pass as autograd runs them; under the step's ``torch.func.vmap`` the
      mode sees the batched ops, so the m workers' products count once
      each (m times one worker's);
    * ``bytes``: the operand and result bytes of every aten op that is not
      a view or a bare allocation;
    * the hand-written kernels, launched through ``ctypes`` where neither
      count sees them, add their own operations and bytes — those their
      bounds are computed from (``kernels/build.py::counting_costs``; K1
      reads m·D elements and writes D f32, and does m compares a
      coordinate).

    The call must not disturb the run: a ``torch.Generator`` argument is
    replaced by a copy at its state, the outputs are dropped, the steps
    take their inputs without changing them (``apply_updates`` and the
    defense updates return new trees), and the CUDA allocator's cached
    blocks are released afterwards (a full-size LM step needs most of the
    card, and the count's freed blocks would fragment it).  The call is
    inside a ``record_function("step_cost")`` range that waits for its
    device work, which tells its kernels apart from the steps' in a
    profiler trace.
    Returns ``{}`` if the count fails (a line on stderr says why), except
    inside a ``torch.distributed`` world, where the error is raised: the
    other ranks may be waiting in one of the count's collectives, and a
    rank that went on would leave them there.
    """
    from torch.profiler import record_function

    from repro_torch.launch.trace_analysis import trace_cost
    args = tuple(_detached(a) for a in args)
    try:
        with record_function("step_cost"):
            cost = trace_cost(_synchronized, step_fn, *args)
    except Exception as e:      # profiling never fails a run alone
        import torch.distributed as dist
        if dist.is_available() and dist.is_initialized():
            raise
        print(f"[obs] step cost not counted: {type(e).__name__}: {e}",
              file=sys.stderr)
        return {}
    finally:
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            # hand the call's cached blocks back: the run's first step
            # then allocates as it would have without the count
            torch.cuda.empty_cache()
    return {"flops": cost["flops"], "bytes": cost["bytes_accessed"]}


def _synchronized(step_fn, *args):
    """``step_fn(*args)``, its device work waited for; returns nothing (the
    count drops the outputs)."""
    step_fn(*args)
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def device_memory_stats() -> Dict[str, float]:
    """Live/peak device memory in bytes of the current CUDA device, from
    ``torch.cuda.memory_stats()``, or ``{}`` (no CUDA device in use, as the
    reference's CPU backend has no allocator stats)."""
    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return {}
    stats = torch.cuda.memory_stats()
    out = {}
    for key, name in (("allocated_bytes.all.current", "bytes_in_use"),
                      ("allocated_bytes.all.peak", "peak_bytes_in_use")):
        v = stats.get(key)
        if v is not None:
            out[name] = float(v)
    return out


def _rank_dir(profile_dir: str) -> str:
    """``profile_dir``, or its ``rank<r>`` subdirectory inside a
    ``torch.distributed`` world (every rank writes its own trace)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return os.path.join(profile_dir, f"rank{dist.get_rank()}")
    return profile_dir


@contextlib.contextmanager
def profile_trace(profile_dir: Optional[str]):
    """A ``torch.profiler.profile`` window (CPU and, with a GPU, CUDA
    activity) over the wrapped block, written as a Chrome trace
    (``trace.json``, open it in Perfetto or ``chrome://tracing``) under
    ``profile_dir``, or its ``rank<r>`` subdirectory on a mesh.

    No-op when ``profile_dir`` is falsy (the default path: launch CLIs
    wrap their whole run in this unconditionally).  Spans opened inside
    the window appear as ``record_function`` ranges (obs/trace.py).  A
    window that cannot start or be written degrades to running
    unprofiled, with one line on stderr, rather than raising.
    """
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    out_dir = _rank_dir(profile_dir)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = None
    try:
        os.makedirs(out_dir, exist_ok=True)
        prof = profile(activities=activities)
        prof.__enter__()
    except Exception as e:
        print(f"[obs] profiler window not started in {out_dir}: "
              f"{type(e).__name__}: {e}", file=sys.stderr)
        prof = None
    try:
        yield
    finally:
        if prof is not None:
            try:
                prof.__exit__(None, None, None)
                prof.export_chrome_trace(os.path.join(out_dir,
                                                      "trace.json"))
            except Exception as e:
                print(f"[obs] profiler trace not written to {out_dir}: "
                      f"{type(e).__name__}: {e}", file=sys.stderr)


def sample_into(recorder, prefix: str = "device") -> None:
    """Drop current device-memory stats into ``recorder`` gauges
    (``device_bytes_in_use``, ``device_peak_bytes_in_use``).  Cheap no-op
    when metrics are off."""
    if not getattr(recorder, "metrics_enabled", False):
        return
    for name, v in device_memory_stats().items():
        recorder.gauge(f"{prefix}_{name}", v)
