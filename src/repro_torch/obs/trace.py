"""Span-based tracer (port of ``repro/obs/trace.py``, DESIGN.md §12).

Spans are host-side wall-clock intervals with nesting: entering a span
pushes its name onto a thread-local stack, so a span opened inside another
records under the joined path (``"engine_step/decode"``), and the closed
span lands in the Recorder's ``span_ms`` histogram (labeled by path) plus —
when a JSONL sink is attached — as one ``kind="span"`` record.

**Async-dispatch contract.**  CUDA work is launched asynchronously: the
Python call that enqueues a step returns before the device finishes, so a
naive ``perf_counter`` pair around it times the *dispatch*, not the work.
A span therefore exposes :meth:`Span.sync`: pass it the step's output and
it calls ``torch.cuda.synchronize()`` **only when tracing is enabled** (the
reference calls ``jax.block_until_ready``) — instrumented loops stay fully
async in production (the no-op span's ``sync`` is identity, costs one
attribute lookup, allocates nothing).

An enabled span also enters ``torch.profiler.record_function(name)``, so
the same spans show up as named ranges in a ``torch.profiler`` trace, where
the reference enters a ``jax.profiler`` annotation.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, Optional

_tls = threading.local()


def _stack() -> list:
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


class _NullSpan:
    """The shared zero-cost span: returned for every ``span()`` call while
    tracing is off.  A singleton so disabled instrumentation allocates
    nothing per call (pinned by tests/test_obs.py)."""
    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    @staticmethod
    def sync(x):
        return x


NULL_SPAN = _NullSpan()


class Span:
    """One enabled timed span; create via ``Recorder.span(name, ...)``."""
    __slots__ = ("_recorder", "name", "labels", "step_num", "path",
                 "_t0", "_annotation")

    def __init__(self, recorder, name: str, labels: Dict[str, object],
                 step_num: Optional[int] = None):
        self._recorder = recorder
        self.name = name
        self.labels = labels
        self.step_num = step_num
        self.path = name
        self._t0 = 0.0
        self._annotation = None

    def __enter__(self) -> "Span":
        stack = _stack()
        stack.append(self.name)
        self.path = "/".join(stack)
        from torch.profiler import record_function
        self._annotation = record_function(self.name)
        self._annotation.__enter__()
        self._t0 = time.perf_counter()
        return self

    def sync(self, x):
        """Wait for the device's queued work (tracing is on, so the span
        should time the computation, not the dispatch).  Returns ``x`` so
        call sites can wrap the step expression in place."""
        import torch
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        return x

    def __exit__(self, *exc) -> bool:
        ms = (time.perf_counter() - self._t0) * 1e3
        if self._annotation is not None:
            self._annotation.__exit__(*exc)
            self._annotation = None
        stack = _stack()
        if stack and stack[-1] == self.name:
            stack.pop()
        self._recorder._span_done(self.path, ms, self.labels,
                                  self.step_num)
        return False
